"""Probe kernels #3/#3b's layer entries (csrc/relu_dropout.cu) on the card:
the forward's tile path and the backward's plan.

    python3 tools/relu_dropout_probe.py [--out PATH]

Builds the source and a variant of it with no Philox draw (every mask
word the same constant: what #3 costs without the mask's arithmetic)
into csrc/build/probe/ and times `bias_relu_dropout_fwd` through each at
[2^20, 512] (the row path) and [2^20, 253] (the tile path), and the
standalone pair (`relu_dropout_fwd`, `relu_dropout_bwd` on bf16) through
the source. Then times
`relu_dropout_bwd_out` through the shipped source at both widths under
other plans than `bwd_plan`'s (the fixed grid's CTAs; the row path's and
the tile path's rows a tile), each checked against the plain version (gb
bit for bit, db equal to `db_kernel_order` of its plan). Prints one line
a case with the card and the bytes bound; `--out` writes JSON. Needs one
CUDA card.
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
PEAK_HBM_BYTES = 3.35e12
N_ROWS = 1 << 20
RATE = 0.2


def time_ms(fn, reps: int = 20) -> float:
    import torch
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
        print("relu_dropout_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        _build, relu_dropout as rd)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    src = (_build.CSRC / "relu_dropout.cu").read_text()
    draws = ("philox::dropout_bits(r, c0 / 4, key)",
             "philox::dropout_bits(r, c0 / 4 + 1, key)",
             "philox::dropout_bits(r0 + rr, gi, key)")
    if not all(d in src for d in draws):
        raise RuntimeError(f"relu_dropout.cu lacks one of {draws}")
    no_philox = src
    for d in draws:
        no_philox = no_philox.replace(d, "make_uint4(~key, ~key, ~key, ~key)")
    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    libs, errors = {}, []

    def build(name, text):
        try:
            f = probe_dir / f"relu_dropout_{name.replace(' ', '_')}.cu"
            f.write_text(text)
            libs[name] = _build.build(str(f.relative_to(_build.CSRC)))
        except Exception as e:   # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=a)
               for a in (("shipped", src), ("no Philox", no_philox))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    out: dict = {"card": card, "fwd": {}, "bwd": {}}
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = {}
    for cols in (512, 253):
        yf = torch.randn(N_ROWS, cols, generator=gen, device=dev)
        b = torch.randn(cols, generator=gen, device=dev)
        g = torch.randn(N_ROWS, cols, generator=gen, device=dev).to(
            torch.bfloat16)
        ops[cols] = (yf, b, g)
    bound = {c: 6.0 * N_ROWS * c / PEAK_HBM_BYTES * 1e3 for c in ops}
    print(f"[probe] {card}; [2^20, cols], bytes bound (6 B an element) "
          + ", ".join(f"{c}: {bound[c]:.3f} ms" for c in ops), flush=True)
    for rows, lib in sorted(libs.items(), reverse=True):
        _build._LOADED["relu_dropout.cu"] = ctypes.CDLL(str(lib))
        for cols, (yf, b, g) in ops.items():
            want = rd.bias_relu_dropout_reference(yf, b, 1, RATE)
            same = torch.equal(rd.bias_relu_dropout_fwd(yf, b, 1, RATE),
                               want)
            ms = time_ms(lambda: rd.bias_relu_dropout_fwd(yf, b, 1, RATE))
            out["fwd"][f"{rows}, {cols}"] = dict(
                ms=ms, share=bound[cols] / ms, same=same)
            print(f"[probe] #3 forward, {rows}, {cols} wide: "
                  f"{ms:.4f} ms ({100 * bound[cols] / ms:.1f}% of bound), "
                  f"equal to the plain version: {same}", flush=True)
            del want
            if rows != "shipped":
                continue
            h = (yf + b).to(torch.bfloat16)
            sa = dict(fwd=time_ms(lambda: rd.relu_dropout_fwd(h, 1, RATE)),
                      bwd=time_ms(lambda: rd.relu_dropout_bwd(h, g, 1, RATE)),
                      bound_fwd=4.0 * h.numel() / PEAK_HBM_BYTES * 1e3,
                      bound_bwd=bound[cols])
            out[f"standalone {cols}"] = sa
            print(f"[probe] standalone bf16 pair, {cols} wide: forward "
                  f"{sa['fwd']:.4f} ms (bound {sa['bound_fwd']:.3f}), "
                  f"backward {sa['bwd']:.4f} (bound {sa['bound_bwd']:.3f})",
                  flush=True)
            del h
    _build._LOADED.pop("relu_dropout.cu", None)

    def bwd(out_t, g, plan):
        rows, cols = out_t.shape
        gb = torch.empty_like(out_t)
        db = torch.empty(cols, dtype=torch.float32, device=dev)
        part = torch.empty(plan.ctas, cols, dtype=torch.float32, device=dev)
        rc = rd._lib().relu_dropout_bwd_out_launch(
            out_t.data_ptr(), g.data_ptr(), gb.data_ptr(), part.data_ptr(),
            db.data_ptr(), rows, cols, float(rd._scale(RATE, torch.bfloat16)),
            int(plan.vec), plan.tile_rows, plan.lanes, plan.ctas,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"plan {plan}: cudaError {rc}")
        return gb, db

    for cols, (yf, b, g) in ops.items():
        o = rd.bias_relu_dropout_fwd(yf, b, 1, RATE)
        gb_p, _ = rd.relu_dropout_bwd_out_reference(o, g, RATE)
        base = rd.bwd_plan(N_ROWS, cols)
        tiles = [base.tile_rows] + ([32, 128] if base.vec else [16, 24])
        plans = {rd.BwdPlan(base.vec, t, base.lanes, c)
                 for t in tiles for c in (264, 528, 1056, 2112)}
        for plan in sorted(plans, key=lambda p: (p.tile_rows, p.ctas)):
            gb, db = bwd(o, g, plan)
            same = (torch.equal(gb, gb_p)
                    and torch.equal(db, rd.db_kernel_order(gb, plan)))
            ms = time_ms(lambda: bwd(o, g, plan))
            out["bwd"][f"{cols}: {plan.tile_rows} rows, {plan.ctas} CTAs"] = \
                dict(ms=ms, share=bound[cols] / ms, same=same,
                     shipped=plan == base)
            print(f"[probe] #3b {cols} wide, {'row' if plan.vec else 'tile'}"
                  f" path, {plan.tile_rows} rows a tile, {plan.lanes} lanes, "
                  f"{plan.ctas} CTAs{' (bwd_plan)' if plan == base else ''}: "
                  f"{ms:.4f} ms ({100 * bound[cols] / ms:.1f}% of bound), "
                  f"gb and db as the plan's order: {same}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
