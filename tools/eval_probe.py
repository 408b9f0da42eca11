"""Probe the single-latent eval kernel (#1, csrc/fused_eval.cu) on the card:
which part of it binds.

    python3 tools/eval_probe.py [--out PATH]

Builds the kernel and variants of its source (the engine header,
csrc/eval_engine.cuh, pasted in), each with a part taken out or changed,
into csrc/build/probe/:
  - "no MMA": no wgmma; the weight copies, epilogues and pipeline alone;
  - "no copies": no bulk copy (each stage's barrier expects 0 bytes); the
    products on whatever the slots hold, and the pipeline;
  - "no epilogue": no stores of the hidden layers' activations (the final
    layer's fold stays);
  - "pipeline only": neither products nor copies;
  - the kernel with 3 and 4 ring stages instead of 5, and with clusters
    of 1 CTA instead of 2.
Times each at 2^20 points and over one 256^3 shape's four serve launches
(4,096 + 65,536 + 131,072 + 524,288 points) on the committed trained chair
decoder, checks the complete kernels against the plain version, and
prints one line per variant, the card and the bound. Needs one CUDA card;
`--out` writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
SHAPE_POINTS = (4096, 65536, 131072, 524288)


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"csrc/fused_eval.cu or eval_engine.cuh "
                           f"changed: {old[:60]!r} not found; update "
                           "tools/eval_probe.py")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """name -> source text of each probed variant."""
    def no_mma(t):
        return _rep(t, "      Wgmma<NW>::run(acc,",
                    "      if (false) Wgmma<NW>::run(acc,")

    def no_copy(t):
        t = _rep(t, "mbar_expect_tx(full, bytes * STAGE_SLABS);",
                 "mbar_expect_tx(full, 0u);")
        return _rep(t, "bulk_copy(ring.slots",
                    "if (false) bulk_copy(ring.slots")

    def no_epilogue(t):
        return _rep(t, "    layer_epilogue<NW>(acc,",
                    "    if (false) layer_epilogue<NW>(acc,")

    def stages(t, s):
        return _rep(t, "constexpr int STAGES = 5;",
                    f"constexpr int STAGES = {s};")

    def cluster(t, c):
        return _rep(t, "constexpr int CLUSTER = 2;",
                    f"constexpr int CLUSTER = {c};")

    return {"kernel": src, "no MMA": no_mma(src), "no copies": no_copy(src),
            "no epilogue": no_epilogue(src),
            "pipeline only": no_copy(no_mma(src)),
            "3 stages": stages(src, 3), "4 stages": stages(src, 4),
            "cluster of 1": cluster(src, 1)}


COMPLETE = ("kernel", "3 stages", "4 stages", "cluster of 1")


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("eval_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        fast_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        load_stage1_pack)

    # the engine header pasted in place of its include, so that a variant
    # can patch the engine too (and its library's hash covers the patch)
    engine = (_build.CSRC / "eval_engine.cuh").read_text()
    vs = variants(_rep((_build.CSRC / "fused_eval.cu").read_text(),
                       '#include "eval_engine.cuh"\n',
                       engine.replace("#pragma once\n", "")))
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    libs, errors = {}, []

    def build(i, name):
        try:
            f = probe_dir / f"fused_eval_probe{i}.cu"
            f.write_text(vs[name])
            libs[name] = _build.build(str(f.relative_to(_build.CSRC)))
        except Exception as e:          # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i, n))
               for i, n in enumerate(vs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sd, codes = load_stage1_pack(ROOT / "runs" / "scale_chairs6k"
                                 / "stage1_pack.npz")
    decoder = SdfDecoder(DecoderConfig())
    z = torch.from_numpy(codes[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 20
    xyz = torch.rand(n, 3, generator=gen, device=dev) * 2 - 1
    shape = [torch.rand(m, 3, generator=gen, device=dev) * 2 - 1
             for m in SHAPE_POINTS]
    # the products that run per point: layer 0's xyz columns, the skip
    # layer's hidden and xyz columns, every other layer in full
    L = decoder.cfg.latent_size
    macs = sum((3 if i == 0 else d_in - L if skip else d_in) * out
               for i, (d_in, out, skip) in enumerate(decoder.layer_dims()))
    bound_ms = 2.0 * macs * n / PEAK_BF16_FLOPS * 1e3
    bound_shape = bound_ms * sum(SHAPE_POINTS) / n
    print(f"[probe] {card}; 2^20 points, {macs} MAC/point, bound "
          f"{bound_ms:.3f} ms; one 256^3 shape {sum(SHAPE_POINTS)} points, "
          f"bound {bound_shape:.3f} ms (operations)", flush=True)
    want, results = None, {}
    for name, lib in libs.items():
        # route the wrapper to this variant's library
        _build._LOADED["fused_eval.cu"] = ctypes.CDLL(str(lib))
        k = ck.make_kernel_apply(decoder, sd)
        rows = ck.hoisted_rows(k.ew, k.meta, z)
        got = k.launch(xyz, rows)
        torch.cuda.synchronize()
        err = None
        if name in COMPLETE:
            if want is None:
                want = fast_apply(k.ew, z, xyz)
            err = float((got - want).abs().max())
            if err > 5e-3:
                raise RuntimeError(f"{name}: max |kernel-plain| {err}")
        ms = time_ms(lambda: k.launch(xyz, rows), 20)
        ms_shape = time_ms(lambda: [k.launch(p, rows) for p in shape], 20)
        results[name] = dict(ms_2p20=ms, ms_shape=ms_shape, max_abs_err=err,
                             **k.config())
        print(f"[probe] {name:14s} {ms:.3f} ms per 2^20 "
              f"({100 * bound_ms / ms:.1f}% of bound), {ms_shape:.3f} ms "
              f"per shape, {results[name]}", flush=True)
    _build._LOADED.pop("fused_eval.cu", None)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, bound_ms=bound_ms,
                                            bound_ms_shape=bound_shape,
                                            macs_per_point=macs,
                                            variants=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
