"""Probe the GEMM engine of kernel #4 (csrc/fused_train.cu: tn_gemm_kernel
for the forward and dgrad roles, mn_wgrad_kernel for the wgrad role) on
the card: which part of it binds.

    python3 tools/train_gemm_probe.py [--out PATH]

Builds the kernel and variants of its source, each with a part taken out
or changed, into csrc/build/probe/:
  - "no output store": the epilogue into shared memory, no TMA store (the
    wgrad role: no partial stores);
  - "no epilogue": the products and the pipeline; nothing is stored (the
    dgrad's keep-bit loads and its column sums over the unwritten output
    tile stay);
  - "no wgmma": the loads, the pipeline and the epilogue on zeros;
  - "no TMA": no operand copy into the ring (each stage's barrier expects
    0 bytes); the products on whatever the ring holds, and the epilogue
    (with its output stores, keep bits and column partials);
  - "1 consumer warpgroup": 64-row tiles, one consumer warpgroup;
  - "no column sums": the dgrad without its column read-back and partial
    stores (its barrier stays; the partials are left unwritten);
  - "no keep-bit store": the forward computes its keep bits but does not
    store them; "no keep bits": neither computes nor stores them.
Times each at 2^20 x 512 x 512 in four roles: forward with dropout 0.2,
forward without dropout (the Philox work taken out at run time), both
writing keep bits as the pass's forward launches do, dgrad (masked by keep
bits, with column partials), and wgrad (partials over 16,384-point
chunks); checks the complete kernels' outputs against the plain versions;
prints one line per variant and role with the card and the bounds (bytes:
each input read once, each output written once). Needs one CUDA card;
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
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"csrc/fused_train.cu changed: {old[:60]!r} not "
                           "found; update tools/train_gemm_probe.py")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """name -> source text of each probed variant."""
    def no_store(t):
        t = _rep(t, "        *reinterpret_cast<float2*>(out + 8 * j) =",
                 "        if (false) *reinterpret_cast<float2*>(out + 8 * j) =")
        t = _rep(t, "        *reinterpret_cast<float2*>(out + 8LL * p.n + 8 * j) =",
                 "        if (false)\n"
                 "        *reinterpret_cast<float2*>(out + 8LL * p.n + 8 * j) =")
        return _rep(t, "          tma_store_2d(&map_o,",
                    "          if (false) tma_store_2d(&map_o,")

    def no_epilogue(t):
        return _rep(no_store(t), "      tn_epilogue<BN, EPI>(acc,",
                    "      if (false) tn_epilogue<BN, EPI>(acc,")

    def no_wgmma(t):
        t = _rep(t, "          Wgmma<BN, 1>::run(",
                 "          if (false) Wgmma<BN, 1>::run(")
        return _rep(t, "          Wgmma<BN>::run(acc,",
                    "          if (false) Wgmma<BN>::run(acc,")

    def no_tma(t):
        t = _rep(t, "mbar_expect_tx(f, (TN_BM + BN) * WG_BK * 2);",
                 "mbar_expect_tx(f, 0u);")
        t = _rep(t, "            tma_load_2d(s + b * WG_BOX_BYTES, &map_g,",
                 "            if (false) tma_load_2d(s + b * WG_BOX_BYTES, "
                 "&map_g,")
        t = _rep(t, "            tma_load_2d(s + WG_A_BYTES + b * WG_BOX_BYTES,",
                 "            if (false) tma_load_2d(s + WG_A_BYTES + b * "
                 "WG_BOX_BYTES,")
        t = _rep(t, "mbar_expect_tx(f, (TN_BM + BN) * TN_BK * 2);",
                 "mbar_expect_tx(f, 0u);")
        t = _rep(t, "          tma_load_2d(s, &map_a,",
                 "          if (false) tma_load_2d(s, &map_a,")
        return _rep(t, "          tma_load_2d(s + TN_A_BYTES, &map_b,",
                    "          if (false) tma_load_2d(s + TN_A_BYTES, &map_b,")

    def one_wg(t):
        return _rep(t, "constexpr int TN_WGS = 2;", "constexpr int TN_WGS = 1;")

    def no_keep_store(t):
        t = _rep(t, "      if (EPI == EPI_FWD && p.keep != nullptr)\n"
                 "        stage_keep<BN>(", "      if (false)\n"
                 "        stage_keep<BN>(")
        return _rep(t, "        if (EPI == EPI_FWD && p.keep != nullptr)\n"
                    "          bulk_store(", "        if (false)\n"
                    "          bulk_store(")

    def no_keep(t):
        return _rep(no_keep_store(t), """      kb[j / 8] |= keep_flags(s0) >> (15 - j % 8) |
                   keep_flags(s1) >> (7 - j % 8);""", "")

    def no_colsum(t):
        for call in ("dgrad_column_sums<BN, true>(obuf_p, cbuf, p, wm0, wg, "
                     "tid % 128);",
                     "dgrad_column_sums<BN, false>(obuf_p, cbuf, p, wm0, wg, "
                     "tid % 128);",
                     "dgrad_column_sums_out<BN>(cbuf, p, m0, n0,\n"
                     "                                    96 * wg + 32 * "
                     "(warp % 4 - 1) + lane);"):
            t = _rep(t, call, "(void)cbuf;")
        return t

    return {"kernel": src, "no output store": no_store(src),
            "no epilogue": no_epilogue(src),
            "no wgmma": no_wgmma(src), "no TMA": no_tma(src),
            "1 consumer warpgroup": one_wg(src),
            "no column sums": no_colsum(src),
            "no keep-bit store": no_keep_store(src),
            "no keep bits": no_keep(src)}


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
        print("train_gemm_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        fused_train as ft)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        train_gemm as tg)

    vs = variants((_build.CSRC / "fused_train.cu").read_text())
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    libs, errors = {}, []

    def build(i, name):
        try:
            f = probe_dir / f"fused_train_probe{i}.cu"
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
    m, k, n = 1 << 20, 512, 512
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    h = torch.relu(torch.randn(m, k, generator=gen, device=dev)).to(bf)
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5).to(bf)
    rows = torch.randn(1, n, generator=gen, device=dev)
    g = (torch.randn(m, n, generator=gen, device=dev) * 1e-3).to(bf)
    wt = w.t().contiguous()
    k_split = tg.wgrad_chunk(m)
    ops_ms = 2.0 * m * n * k / PEAK_BF16_FLOPS * 1e3
    # forward: h in; h' and its keep bits out. dgrad: g and the keep bits
    # in; g' and its column partials (f32, a row per 128 points) out
    fwd_bytes = 2.0 * m * k + 2.0 * m * n + m * n / 8
    dgrad_bytes = 2.0 * m * n + m * k / 8 + 2.0 * m * k + 4.0 * (m // 128) * k
    bounds = {"forward, dropout 0.2": max(ops_ms, fwd_bytes /
                                          PEAK_HBM_BYTES * 1e3),
              "forward, dropout 0": max(ops_ms, fwd_bytes /
                                        PEAK_HBM_BYTES * 1e3),
              "dgrad": max(ops_ms, dgrad_bytes / PEAK_HBM_BYTES * 1e3),
              "wgrad": max(ops_ms, (4.0 * m * 512 + 4.0 * (m // k_split)
                                    * n * k) / PEAK_HBM_BYTES * 1e3)}
    bits = {}               # the keep bits of h, in each variant's layout

    def keep_bits():
        key = tg.TN_LAYOUT["bm"]
        if key not in bits:
            bits[key] = tg.pack_keep_bits(h > 0)
        return bits[key]

    roles = {"forward, dropout 0.2":
             (lambda: ft.gemm_fwd(h, w, rows, m, seed=9, rate=0.2,
                                  keep_bits=True)[0],
              lambda: ft.gemm_fwd_reference(h, w, rows, m, seed=9, rate=0.2)),
             "forward, dropout 0":
             (lambda: ft.gemm_fwd(h, w, rows, m, keep_bits=True)[0],
              lambda: ft.gemm_fwd_reference(h, w, rows, m)),
             "dgrad": (lambda: ft.gemm_dgrad(g, wt, keep_bits(), 1.25)[0],
                       lambda: ft.gemm_dgrad_reference(g, wt, keep_bits(),
                                                       1.25)),
             "wgrad": (lambda: ft.gemm_wgrad(g, h, k_split),
                       lambda: ft.gemm_wgrad_reference(g, h, k_split))}
    print(f"[probe] {card}; 2^20 x 512 x 512; bounds {bounds} ms (products "
          f"{ops_ms:.3f} ms)", flush=True)
    layout = dict(tg.TN_LAYOUT)
    wlayout = dict(tg.WGRAD_LAYOUT)
    results = {}
    for name, lib in libs.items():
        # route the wrapper to this variant's library and layouts
        cdll = ctypes.CDLL(str(lib))
        for fn, lay, model in ((cdll.ft_gemm_layout, layout, tg.TN_LAYOUT),
                               (cdll.ft_wgrad_layout, wlayout,
                                tg.WGRAD_LAYOUT)):
            got = (ctypes.c_int * len(lay))()
            fn(got)
            model.update(zip(lay, got))
        _build._LOADED["fused_train.cu"] = cdll
        results[name] = {}
        for role, (fn, plain) in roles.items():
            err = None
            if name in ("kernel", "1 consumer warpgroup"):
                want = plain().float()
                err = float((fn().float() - want).abs().max())
                if err > 1e-2 * float(want.abs().max()):
                    raise RuntimeError(f"{name}, {role}: max |kernel-plain| "
                                       f"{err}")
            ms = time_ms(fn, 20)
            results[name][role] = dict(ms=ms, max_abs_err=err)
            print(f"[probe] {name:22s} {role:22s} {ms:.3f} ms "
                  f"({100 * bounds[role] / ms:.1f}% of its bound "
                  f"{bounds[role]:.3f} ms), max err {err}", flush=True)
    _build._LOADED.pop("fused_train.cu", None)
    tg.TN_LAYOUT.update(layout)
    tg.WGRAD_LAYOUT.update(wlayout)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, bounds_ms=bounds,
                                            products_ms=ops_ms,
                                            variants=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
