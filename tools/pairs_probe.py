"""Probe the per-point-latent eval kernel (#2, csrc/fused_eval_pairs.cu) on
the card: which part of it binds.

    python3 tools/pairs_probe.py [--out PATH]

Builds the kernel and variants of its source, each with a part taken out,
into csrc/build/:
  - "no MMA": no wgmma; the weight copies and the pipeline alone;
  - "no copies": no bulk copy (each stage's barrier expects 0 bytes); the
    products on whatever the slots hold, and the pipeline;
  - "pipeline only": neither;
  - the kernel with clusters of 1 and 4 CTAs instead of 2, and with 1 and
    4 slabs per ring stage instead of 2.
Times each at 2^19 points of the committed multicat decoder (rows of 64
codes read by shuffled shape ids, the flat decode's launch shape), checks
the complete kernels against the plain version, and prints one line per
variant, the card and the bound. Needs one CUDA card; `--out` writes the
numbers as JSON.
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


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"csrc/fused_eval_pairs.cu changed: {old[:60]!r} "
                           "not found; update tools/pairs_probe.py")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """name -> source text of each probed variant."""
    def no_mma(t):
        return _rep(t, "      Wgmma<NW>::run(acc,",
                    "      if (false) Wgmma<NW>::run(acc,")

    def no_copy(t):
        t = _rep(t, "mbar_expect_tx(full, bytes * STAGE_SLABS);",
                 "mbar_expect_tx(full, 0u);")
        return _rep(t, "              bulk_copy(",
                    "              if (false) bulk_copy(")

    def slabs(t, g):
        return _rep(t, "constexpr int STAGE_SLABS = 2;",
                    f"constexpr int STAGE_SLABS = {g};")

    def cluster(t, c):
        return _rep(t, "constexpr int CLUSTER = 2;",
                    f"constexpr int CLUSTER = {c};")

    return {"kernel": src, "no MMA": no_mma(src), "no copies": no_copy(src),
            "pipeline only": no_copy(no_mma(src)),
            "cluster of 1": cluster(src, 1), "cluster of 4": cluster(src, 4),
            "1 slab per stage": slabs(src, 1),
            "4 slabs per stage": slabs(src, 4)}


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
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pairs_probe: no CUDA card", file=sys.stderr)
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

    vs = variants((_build.CSRC / "fused_eval_pairs.cu").read_text())
    slabs = {"1 slab per stage": 1, "4 slabs per stage": 4}
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    libs, errors = {}, []

    def build(i, name):
        try:
            f = probe_dir / f"fused_eval_pairs_probe{i}.cu"
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
    sd, codes = load_stage1_pack(ROOT / "runs" / "multicat6k"
                                 / "stage1_pack.npz")
    decoder = SdfDecoder(DecoderConfig())
    zs = torch.from_numpy(codes[:64]).to(dev)
    rng = np.random.default_rng(3)
    n = 1 << 19
    sids = torch.from_numpy(rng.permutation(np.arange(n) % 64).astype(
        np.int32)).to(dev)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).to(dev)
    # every product runs per point: layer 0's and the skip layer's full
    # input (latent, xyz, hidden) included
    macs = sum(d_in * out for d_in, out, _ in decoder.layer_dims())
    bound_ms = 2.0 * macs * n / PEAK_BF16_FLOPS * 1e3
    print(f"[probe] {card}; 2^19 points, {macs} MAC/point, bound "
          f"{bound_ms:.3f} ms (operations)", flush=True)
    want, results = None, {}
    for name, lib in libs.items():
        # route the wrapper to this variant's library, packing for its
        # slabs per stage
        _build._LOADED["fused_eval_pairs.cu"] = ctypes.CDLL(str(lib))
        ck.PAIRS_LAYOUT["stage_slabs"] = slabs.get(name, 2)
        k = ck.make_kernel_apply_pairs(decoder, sd)
        table = k.table(zs)
        got = k.launch(table, sids, xyz)
        torch.cuda.synchronize()
        err = None
        if name == "kernel" or "slab" in name or "cluster" in name:
            if want is None:
                want = fast_apply(k.ew, zs[sids.long()], xyz)
            err = float((got - want).abs().max())
            if err > 5e-3:
                raise RuntimeError(f"{name}: max |kernel-plain| {err}")
        ms = time_ms(lambda: k.launch(table, sids, xyz), 20)
        results[name] = dict(ms=ms, max_abs_err=err, **k.config())
        print(f"[probe] {name:18s} {ms:.3f} ms ({100 * bound_ms / ms:.1f}% "
              f"of bound), {results[name]}", flush=True)
    _build._LOADED.pop("fused_eval_pairs.cu", None)
    ck.PAIRS_LAYOUT["stage_slabs"] = 2
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, bound_ms=bound_ms,
                                            macs_per_point=macs,
                                            variants=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
