"""Mesh serving from stored latents: the port's `serve.serve_meshes` over
closed-loop batches.

Set-up reads the decoder and its codes from the configuration's pack,
hands them to the port's kernel #1 path (`make_kernel_apply`), builds the
native mesher once into the checkout, and serves a warm-up batch. The
window then serves batches of `batch` latents, each drawn anew from the
seed, one after another; every mesh is delivered to the host as vertices
and faces and kept in memory until the next batch, with a seeded sample
of them (and the largest) kept for the check.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import time

import numpy as np
import torch

from benchmark.checks import Laps
from benchmark.reference import decoder as ref
from benchmark.yardstick import (bound, eval_macs_per_point,
                                 eval_weight_bytes, hier3_points)

ROOT = pathlib.Path(__file__).resolve().parents[2]


def build_mesher() -> None:
    """The native mesher library at $LDM_SDF_NATIVE_MC_LIB (a fixed path
    inside the checkout), built once with g++."""
    lib = pathlib.Path(os.environ["LDM_SDF_NATIVE_MC_LIB"])
    if lib.exists():
        return
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", str(ROOT / "native" / "marching_cubes"
                                    / "clib.cpp"), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, lib)


class Driver:

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 seconds: float):
        from latent_diffusion_models_for_shape_sdfs_torch.config import (
            DecoderConfig)
        from latent_diffusion_models_for_shape_sdfs_torch.models.decoder \
            import SdfDecoder
        from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels \
            import make_kernel_apply
        from latent_diffusion_models_for_shape_sdfs_torch.serve import (
            serve_meshes)
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.dec = dec = cfg["ad"]["decoder"]
        self.phases = lap = Laps(device)
        if device.type == "cuda":
            build_mesher()
        lap("mesher")
        self.params, codes = ref.load_pack(ROOT / cfg["pack"], device)
        self.codes = codes
        lap("pack")
        decoder = SdfDecoder(DecoderConfig(**dict(dec, latent_in=tuple(
            dec["latent_in"]))))
        self.apply = make_kernel_apply(decoder, {k: v.cpu() for k, v in
                                                 self.params.items()},
                                       device=device)
        self.serve = serve_meshes
        self.seed = seed
        self.rng = np.random.default_rng([seed, 2])
        self.pick = np.random.default_rng([seed, 3])
        self.batch, self.res = traffic["batch"], traffic["res"]
        lap("decoder")
        warm = self.rng.choice(len(codes), traffic["warmup_latents"],
                               replace=False)
        self._serve(warm[:1], keep=False)
        lap("first_mesh")
        self._serve(warm[1:], keep=False)
        lap("warmup")
        self.kept: list = []         # [(code index, verts, faces)]
        self.largest = None
        self.seen = 0
        self.requested = 0
        self.delivered = 0
        self.failed = 0
        self.stats: list = []

    def _serve(self, idx: np.ndarray, keep: bool = True) -> int:
        """Serve one batch; returns the meshes delivered."""
        lat = [self.codes[int(i)] for i in idx]
        n = 0
        for i, (verts, faces, st) in zip(idx, self.serve(
                self.apply, lat, res=self.res,
                out_dtype=self.traffic["out_dtype"], device=self.dev)):
            if st["mesher"] != "native-payload" and self.dev.type == "cuda":
                raise RuntimeError(f"mesher {st['mesher']}, not the native "
                                   "payload mesher")
            n += 1
            if not keep:
                continue
            self.failed += int(st["capacity_exceeded"])
            self.stats.append(st)
            self._keep(int(i), verts, faces)
        if keep:
            self.requested += len(idx)
            self.delivered += n
        return n

    def _keep(self, i: int, verts, faces) -> None:
        """A seeded reservoir of `check_meshes` meshes, and the largest."""
        k = self.traffic["check_meshes"]
        self.seen += 1
        item = (i, verts, faces)
        if self.largest is None or len(verts) > len(self.largest[1]):
            self.largest = item
        if len(self.kept) < k:
            self.kept.append(item)
        else:
            j = int(self.pick.integers(0, self.seen))
            if j < k:
                self.kept[j] = item

    def _draw(self) -> np.ndarray:
        return self.rng.choice(len(self.codes), self.batch, replace=False)

    def run(self, seconds: float) -> dict:
        """Whole batches until `seconds` have passed: the window over the
        meshes delivered."""
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            n += self._serve(self._draw())
        window = time.perf_counter() - t0
        return {"serve_ms_per_mesh": 1e3 * window / n}

    def traced(self) -> tuple:
        """(warm-up, work): the work serves one batch drawn here, the same
        each time it is called."""
        batch = self._draw()

        def work():
            self.stats = []
            self._serve(batch)
        return (lambda: self._serve(self._draw()[:8], keep=False)), work

    def needed_points(self) -> list:
        """Points the three-level decode needs, a served shape each."""
        return [hier3_points(int(s["active_l1"]), int(s["active_l2"]),
                             int(s["active_l3"]), self.res)
                for s in self.stats]

    def eval_bound_s(self) -> float:
        """Kernel #1's least time over the traced batch's shapes: each
        shape's needed points at its operations bound (four launches,
        each reading the weights once)."""
        macs = eval_macs_per_point(self.dec)
        wb = 4 * eval_weight_bytes(self.dec)
        return sum(bound(n, macs, wb)[0] for n in self.needed_points()) / 1e3

    def eval_flops(self) -> float:
        return 2.0 * eval_macs_per_point(self.dec) * sum(self.needed_points())

    # ------------------------------------------------------------ check
    def free(self) -> None:
        del self.apply
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def counts(self) -> tuple:
        """(meshes asked for, meshes never delivered or cut at their
        capacities)."""
        return self.requested, (self.requested - self.delivered
                                + self.failed)

    def _meshes(self) -> list:
        out = list(self.kept)
        if self.largest is not None and not any(m is self.largest
                                                for m in out):
            out.append(self.largest)
        return out

    def _points(self, verts, faces, gen) -> torch.Tensor:
        """Up to `check_points` vertices and as many face centroids, drawn
        from the seed."""
        k = self.traffic["check_points"]
        v = torch.from_numpy(np.ascontiguousarray(verts, np.float32))
        f = torch.from_numpy(np.ascontiguousarray(faces, np.int64))
        pts = []
        if len(v):
            pts.append(v[torch.randint(0, len(v), (min(k, len(v)),),
                                       generator=gen)])
        if len(f):
            tri = f[torch.randint(0, len(f), (min(k, len(f)),),
                                  generator=gen)]
            pts.append(v[tri].mean(dim=1))
        return (torch.cat(pts) if pts else torch.zeros(0, 3)).to(self.dev)

    def _sdf(self, i: int, pts: torch.Tensor, product: str) -> torch.Tensor:
        z = self.codes[i].float()[None].expand(len(pts), -1)
        out = []
        with torch.no_grad():
            for a in range(0, len(pts), 1 << 17):
                out.append(ref.forward(self.params, self.dec,
                                       z[a:a + (1 << 17)],
                                       pts[a:a + (1 << 17)], None,
                                       product=product))
        return torch.cat(out) if out else torch.zeros(0, device=self.dev)

    def _has_surface(self, i: int) -> bool:
        """Whether the reference's SDF changes sign on a coarse grid."""
        r = self.traffic["surface_res"]
        ax = torch.linspace(-1.0, 1.0, r, device=self.dev)
        grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
        d = self._sdf(i, grid.reshape(-1, 3), "fp32")
        return bool((d < 0).any() and (d >= 0).any())

    def check(self) -> dict:
        """The widest gap of the reference's SDF at the sampled meshes'
        vertices and face centroids (infinite for an empty mesh where the
        reference has a surface), and the requests the window never
        answered."""
        gen = torch.Generator().manual_seed(self.seed)
        gap = 0.0
        self._pts = []
        for i, verts, faces in self._meshes():
            pts = self._points(verts, faces, gen)
            self._pts.append((i, pts))
            if len(pts):
                gap = max(gap, float(self._sdf(i, pts, "fp32").abs().max()))
            elif self._has_surface(i):
                gap = float("inf")
        return {"surface_gap": gap,
                "missing": self.requested - self.delivered}

    def control(self) -> dict:
        """The control: the reference with fp8 products, read at the same
        points (after check()): its widest gap from the fp32 reference.
        The control answers every request."""
        gap = 0.0
        for i, pts in self._pts:
            if len(pts):
                gap = max(gap, float((self._sdf(i, pts, "fp8")
                                      - self._sdf(i, pts, "fp32")).abs()
                                     .max()))
        return {"surface_gap": gap, "missing": 0}
