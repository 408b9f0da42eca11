"""Serialized serving artifacts (`torch.export`).

Counterpart of the JAX package's `export_artifact.py`. Deployment of the
mesh-serving decode and of the latent sampler without model code:
`export_decode_program` traces the three-level sparse decode (one latent
-> compact near-surface payload) with `torch.export` and serializes it
(`torch.export.save`) beside a JSON header of the geometry parameters
the host consumer needs (res, b2, caps). A server loads it with
`load_decode_program` and calls it on raw latent vectors: the decoder's
weights are constants of the program.

The artifact is a zip with two entries:
  meta.json   — {"latent_size", "res", "b1", "b2", "cap1", "cap2", "cap3",
                 "safety", "safety3", "out_dtype", "payload",
                 "quant_scale", "platforms"} (the reference's keys)
  program.bin — the `torch.export.save` serialization of the program

`platforms` is the device the program was traced on, `["cuda"]` or
`["cpu"]`, and the program runs there. The JAX package cross-compiles
for another platform from the host (platforms=("tpu",)); a `torch.export`
program holds the device of its constants, so any other value raises.

Loading needs no model code: `load_decode_program` and
`load_sampler_program` import nothing of `models/` and take no
parameters. This module imports only `ops.fused_eval_op`, which
registers the custom op `sdfldm::fused_eval` (kernel #1) that a program
traced through `ops.cuda_kernels.KernelApply` calls: it is the runtime
the programs need, as the JAX artifacts need the runtime that holds the
Pallas lowering. `DecodeArtifact.grid` and `.mesh` import the host
reconstruction (`ops.grid_eval`) and the mesher (`serve`) when called.
"""

from __future__ import annotations

import io
import json
import pathlib
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

# registers sdfldm::fused_eval, the op a KernelApply program calls
from latent_diffusion_models_for_shape_sdfs_torch.ops import (  # noqa: F401
    fused_eval_op)


def _platforms(device: torch.device,
               platforms: Optional[Sequence[str]]) -> list:
    """[device.type]; raises ValueError when `platforms` names another."""
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(f"platforms={list(platforms)!r}: a torch.export "
                         f"program runs on the device it was traced on, "
                         f"here [{device.type!r}]")
    return [device.type]


def _closure_modules(obj, found: list, seen: set) -> list:
    """The nn.Modules `obj` reaches through function closures and
    containers, in order of discovery (each once)."""
    if id(obj) in seen:
        return found
    seen.add(id(obj))
    if isinstance(obj, torch.nn.Module):
        found.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _closure_modules(v, found, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _closure_modules(v, found, seen)
    elif callable(obj) and getattr(obj, "__closure__", None):
        for cell in obj.__closure__:
            try:
                _closure_modules(cell.cell_contents, found, seen)
            except ValueError:          # an empty cell
                pass
    return found


class _Program(torch.nn.Module):
    """fn as a module for torch.export. The modules fn's closures hold
    (a denoiser) are registered as its submodules, so their parameters
    are lifted once as the program's parameters, not once per use as
    constants: a DDIM-50 trace with CFG uses each weight 100 times."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.held = torch.nn.ModuleList(_closure_modules(fn, [], set()))

    def forward(self, x):
        return self.fn(x)


def _owns_storage(t: torch.Tensor) -> bool:
    return (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def _export_zip(fn, example: torch.Tensor, meta: dict,
                path: Optional[str]) -> bytes:
    """Trace fn(example) with torch.export, zip it with meta.json; write
    the zip to `path` when given. Returns its bytes.

    Every weight fn reaches is lifted as a constant of the program. A
    constant that is a view (a slice of a folded weight) is replaced by a
    dense copy first: torch.export.save writes a CUDA view as its own
    elements but records the view's offset and strides into the storage,
    so it would load as other numbers."""
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), (example,), strict=False)
    for k, t in ep.constants.items():
        if isinstance(t, torch.Tensor) and not _owns_storage(t):
            ep.constants[k] = t.clone(memory_format=torch.contiguous_format)
    prog = io.BytesIO()
    torch.export.save(ep, prog)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=2))
        zf.writestr("program.bin", prog.getvalue())
    blob = buf.getvalue()
    if path is not None:
        pathlib.Path(path).write_bytes(blob)
    return blob


def _load_zip(blob_or_path) -> tuple:
    """(meta, callable program) of an artifact's bytes or path."""
    if isinstance(blob_or_path, (str, pathlib.Path)):
        blob = pathlib.Path(blob_or_path).read_bytes()
    else:
        blob = blob_or_path
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        meta = json.loads(zf.read("meta.json"))
        ep = torch.export.load(io.BytesIO(zf.read("program.bin")))
    return meta, ep.module().requires_grad_(False)


def export_decode_program(apply_fn, latent_size: int, res: int,
                          caps: tuple, safety: float = 1.2,
                          safety3: float = 2.0,
                          out_dtype: str = "int8",
                          platforms: Optional[Sequence[str]] = None,
                          path: Optional[str] = None,
                          device="cuda") -> bytes:
    """Serialize the sparse serving decode for one-latent requests.

    Program signature: z [latent_size] f32 ->
      (c1 [nb1^3], c2 [cap1, (b1/b2)^3], idx1 [cap1],
       vals2 [cap2, b2^3], ids2 [cap2], n1, n2, n3)
    — the compact v2 payload serve.serve_meshes ships (minus its row
    bucketing, which a traced program cannot do: the payload is
    cap-sized). out_dtype="int8" (default) is the sign-preserving
    quantized payload; the dequantization scale is stored in meta.
    `apply_fn` evaluates on `device` (default cuda), where the program is
    traced and runs: ops.cuda_kernels.make_kernel_apply's wrapper puts
    kernel #1 in the program as the op sdfldm::fused_eval, with the
    packed weights as its constants.
    """
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        _decode_grid_hier3_impl, hier3_int8_scale)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
        resolve_device)

    dev = resolve_device(device)
    plats = _platforms(dev, platforms)
    cap1, cap2, cap3 = caps

    def run(z):
        (c1, c2, i1, v2, i2), n1, n2, n3 = _decode_grid_hier3_impl(
            apply_fn, z, res, 16, 4, 2, cap1, cap2, cap3,
            safety=safety, safety3=safety3, layout="sparse2",
            out_dtype=out_dtype)
        return c1, c2, i1, v2, i2, n1, n2, n3

    meta = {"latent_size": latent_size, "res": res, "b1": 16, "b2": 4,
            "cap1": cap1, "cap2": cap2, "cap3": cap3,
            "safety": safety, "safety3": safety3,
            "out_dtype": out_dtype, "payload": "sparse2",
            "quant_scale": (hier3_int8_scale(res, 4, safety)
                            if out_dtype in ("int8", "int4") else None),
            "platforms": plats}
    return _export_zip(run, torch.zeros(latent_size, device=dev), meta,
                       path)


class CapacityExceeded(RuntimeError):
    """A latent's surface shell overflowed the artifact's static caps."""


def _host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy (bf16 payloads widen to f32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class DecodeArtifact:
    """Loaded serving artifact: callable latent -> (grid | payload)."""

    def __init__(self, meta: dict, fn):
        self.meta = meta
        self._fn = fn
        self.device = torch.device(meta["platforms"][0])

    def payload(self, z) -> tuple:
        """z [latent_size] -> (c1, c2, idx1, vals2, ids2, n1, n2, n3), on
        the program's device."""
        return self._fn(torch.as_tensor(z, dtype=torch.float32,
                                        device=self.device))

    def grid(self, z, check_capacity: bool = True) -> np.ndarray:
        """Full x-major [res]^3 host grid via sparse reconstruction.

        Raises CapacityExceeded when the latent's surface shell
        overflows the capacities of the artifact: the program has static
        caps and CANNOT escalate like serve.serve_meshes — a silently
        clamped payload would mean silently missing geometry. Re-export
        with larger caps for such shapes (or pass check_capacity=False to
        accept truncation).
        """
        from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
            sparse2_to_grid)
        c1, c2, i1, v2, i2, n1, n2 = self._payload_checked(
            z, check_capacity)
        m = self.meta
        return sparse2_to_grid(c1, c2, i1, v2, i2, n1, n2,
                               m["res"], m["b1"], m["b2"],
                               dequant_scale=m.get("quant_scale"))

    def _payload_checked(self, z, check_capacity: bool) -> tuple:
        """The payload on the host, its counts clamped to the caps;
        raises CapacityExceeded on overflow unless check_capacity is
        False."""
        c1, c2, i1, v2, i2, n1, n2, n3 = self.payload(z)
        n1, n2, n3 = int(n1), int(n2), int(n3)
        m = self.meta
        if check_capacity and (n1 > m["cap1"] or n2 > m["cap2"]
                               or n3 > m["cap3"]):
            raise CapacityExceeded(
                f"surface shell overflows exported caps: active "
                f"l1/l2/l3 = {n1}/{n2}/{n3} vs caps {m['cap1']}/"
                f"{m['cap2']}/{m['cap3']}; the exported program cannot "
                f"escalate — re-export with larger caps")
        return (*(_host(a) for a in (c1, c2, i1, v2, i2)),
                min(n1, m["cap1"]), min(n2, m["cap2"]))

    def mesh(self, z, iso: float = 0.0,
             check_capacity: bool = True) -> tuple:
        """z -> (verts, faces) through the mesher (payload-direct at
        iso=0 when the native library is built — serve.py's host path;
        dense reconstruction otherwise). Raises CapacityExceeded on
        surface-shell overflow (see grid())."""
        m = self.meta
        if (m.get("b1"), m["b2"]) != (16, 4):  # non-default export
            from latent_diffusion_models_for_shape_sdfs_torch.ops \
                .isosurface import extract_mesh
            return extract_mesh(
                self.grid(z, check_capacity=check_capacity), iso=iso)
        from latent_diffusion_models_for_shape_sdfs_torch.serve import (
            _mesh_v2_payload)
        c1, c2, i1, v2, i2, n1, n2 = self._payload_checked(
            z, check_capacity)
        verts, faces, _mesher = _mesh_v2_payload(
            c1, c2, i1, v2, i2, n1, n2, m["res"], iso,
            m.get("quant_scale"))
        return verts, faces


def export_sampler_program(denoise_fn, schedule, num: int,
                           latent_size: int, steps: int = 50,
                           sampler: str = "ddim",
                           mu=None, sigma=None,
                           platforms: Optional[Sequence[str]] = None,
                           path: Optional[str] = None) -> bytes:
    """Serialize the latent sampler.

    Program signature: z_T [num, latent_size] f32 (caller-provided
    standard normal) -> z_0 [num, latent_size] f32 in DECODER latent
    space (the stage-2 normalization moments mu/sigma are baked in when
    given) — pairs with the decode artifact for a no-model-code noise ->
    latents -> meshes serving stack. Denoiser weights reachable from
    `denoise_fn` (incl. any CFG/conditioning closure from
    diffusion.sampler.guided_denoise_fn) become constants. `sampler`:
    "ddim" (steps as given, eta=0) or "dpm" (DPM-Solver++(2M), pair with
    steps ~10). Traced and run on the schedule's device. Deterministic:
    the output depends only on z_T.
    """
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler \
        import ddim_sample, dpm_solver_sample

    dev = schedule.device
    plats = _platforms(dev, platforms)
    sample_fn = {"ddim": ddim_sample, "dpm": dpm_solver_sample}[sampler]
    mu_c = None if mu is None else torch.as_tensor(
        mu, dtype=torch.float32, device=dev)
    sigma_c = None if sigma is None else torch.as_tensor(
        sigma, dtype=torch.float32, device=dev)

    def run(z_T):
        z = sample_fn(denoise_fn, schedule, None, num, latent_size,
                      steps=steps, z_init=z_T)
        if mu_c is not None:
            z = z * sigma_c + mu_c
        return z

    meta = {"kind": "sampler", "num": num, "latent_size": latent_size,
            "steps": steps, "sampler": sampler,
            "timesteps": int(schedule.timesteps),
            "unnormalized": mu is not None, "platforms": plats}
    return _export_zip(run, torch.zeros(num, latent_size, device=dev),
                       meta, path)


class SamplerArtifact:
    """Loaded sampler artifact: z_T [num, L] -> z_0 [num, L]."""

    def __init__(self, meta: dict, fn):
        self.meta = meta
        self._fn = fn
        self.device = torch.device(meta["platforms"][0])

    def sample(self, z_T) -> np.ndarray:
        z_T = torch.as_tensor(z_T, dtype=torch.float32, device=self.device)
        if tuple(z_T.shape) != (self.meta["num"], self.meta["latent_size"]):
            raise ValueError(
                f"z_T shape {tuple(z_T.shape)} != exported "
                f"({self.meta['num']}, {self.meta['latent_size']})")
        return self._fn(z_T).cpu().numpy()

    def sample_seed(self, seed: int) -> np.ndarray:
        """Convenience: draw z_T from a host numpy Generator (the JAX
        artifact's draw for the same seed)."""
        rng = np.random.default_rng(seed)
        z_T = rng.standard_normal(
            (self.meta["num"], self.meta["latent_size"])).astype(
                np.float32)
        return self.sample(z_T)


def load_sampler_program(blob_or_path) -> SamplerArtifact:
    return SamplerArtifact(*_load_zip(blob_or_path))


def load_decode_program(blob_or_path) -> DecodeArtifact:
    return DecodeArtifact(*_load_zip(blob_or_path))
