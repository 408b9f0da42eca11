"""Time the bf16 autograd route's relu+dropout layers (kernels #3/#3b and
the passes around them) for one checkout of the repository, so that two
commits can be compared on one card.

    python3 tools/relu_dropout_compare.py --checkout DIR [--out PATH]

DIR is a checkout of a commit (for example a `git archive` unpacked into
a git-ignored directory). The script imports the port and chip_smoke.py
from DIR, builds DIR's csrc/relu_dropout.cu and measures, on config 3's
8x512 bf16 decoder with dropout 0.2:

- `chain`: what the route runs between a hidden layer's fp32 product and
  its bf16 output, and between its incoming cotangent and the bf16
  operand of dgrad/wgrad, at [2^20, 512] and [2^20, 253]. Where DIR has
  the layer entries (`bias_relu_dropout_fwd`, `relu_dropout_bwd_out`)
  those two launches; else the parent's passes: the in-place bias add,
  the cast to bf16 and #3; #3b, the cast to fp32 (the cast's backward),
  the cast back to bf16 and the db sum. Each beside its bytes bound (6 B
  an element each way);
- `layer`: one hidden layer's forward + backward at 2^20 rows (512 ->
  512 and 512 -> 253) as DIR's decoder runs it;
- `bank`: 10 steps of the autograd route from the chair bank (config 3's
  batch, DIR's `make_bank_step`) on the card's clock (steps 1-9), and one
  more step's peak memory (`torch.cuda.max_memory_allocated` after a
  reset) and its rise over what was allocated before it.

Prints one JSON line; --out also writes it to PATH. Run it once per
checkout, in turns (parent, change, change, parent), in one call of the
card, and compare within that call. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

N_ROWS = 1 << 20
RATE = 0.2


def chain(rd, bl, dev, cs, cols: int) -> dict:
    """ms of the passes between the product and the layer's output, and
    between the cotangent and the products' operand, at [2^20, cols]."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(cols)
    yf = torch.randn(N_ROWS, cols, generator=gen, device=dev)
    b = torch.randn(cols, generator=gen, device=dev)
    g = torch.randn(N_ROWS, cols, generator=gen, device=dev).to(
        torch.bfloat16)
    bound = 6.0 * yf.numel() / cs.PEAK_HBM_BYTES * 1e3
    if hasattr(rd, "bias_relu_dropout_fwd"):
        out = rd.bias_relu_dropout_fwd(yf, b, 1, RATE)
        fwd = cs.time_ms(lambda: rd.bias_relu_dropout_fwd(yf, b, 1, RATE), 20)
        bwd = cs.time_ms(lambda: rd.relu_dropout_bwd_out(out, g, RATE), 20)
        return dict(form="layer entries", fwd=fwd, bwd=bwd, bound=bound,
                    kernel_fwd=fwd, kernel_bwd=bwd)
    y = yf.clone()
    h = y.to(torch.bfloat16)

    def fwd_chain():
        y.add_(b)
        return rd.relu_dropout_fwd(y.to(torch.bfloat16), 1, RATE)

    def bwd_chain():
        g2 = rd.relu_dropout_bwd(h, g, 1, RATE).float()
        return g2.to(torch.bfloat16), g2.sum(0)

    return dict(form="parent passes", fwd=cs.time_ms(fwd_chain, 20),
                bwd=cs.time_ms(bwd_chain, 20), bound=bound,
                kernel_fwd=cs.time_ms(
                    lambda: rd.relu_dropout_fwd(h, 1, RATE), 20),
                kernel_bwd=cs.time_ms(
                    lambda: rd.relu_dropout_bwd(h, g, 1, RATE), 20))


def layer(rd, bl, dev, cs, d_in: int, d_out: int) -> float:
    """ms of one hidden layer's forward + backward at 2^20 rows."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(d_in + d_out)
    x = torch.randn(N_ROWS, d_in, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    w = (torch.randn(d_out, d_in, generator=gen, device=dev)
         / d_in ** 0.5).requires_grad_()
    b = torch.randn(d_out, generator=gen, device=dev).requires_grad_()
    g = torch.randn(N_ROWS, d_out, generator=gen, device=dev).to(
        torch.bfloat16)
    if hasattr(bl, "bf16_linear_relu_dropout"):
        def fwd():
            return bl.bf16_linear_relu_dropout(x, w, b, 1, RATE)
    else:
        def fwd():
            return rd.relu_dropout(bl.bf16_linear(x, w, b).to(
                torch.bfloat16), 1, RATE)

    def step():
        x.grad = w.grad = b.grad = None
        fwd().backward(g)
    return cs.time_ms(step, 10)


def bank_route(dev, cs) -> dict:
    """ms/step of 10 autograd-route steps from the chair bank, and the peak
    memory of one more."""
    import dataclasses
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder \
        import init_ad_state, make_bank_step
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import load_stage1_pack
    ad3 = ExperimentConfig.load(cs.ROOT / "configs"
                                / "config3_chairs_joint").ad
    sd, codes = load_stage1_pack(cs.ROOT.joinpath(*cs.PACK))
    shapes = analytic.make_synthetic_split("chair", 6145, seed=11)[:6144]
    bank = adv.bank_from_chairs(shapes, 11, cs.BANK_N, device=dev)
    auto = dataclasses.replace(ad3, num_scenes=len(shapes), num_epochs=1,
                               device_data=True, use_pallas=False)
    st = init_ad_state(auto, params=sd, codes=codes, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(auto.seed)
    step = make_bank_step(st.decoder, auto, bank, gen)
    ids = torch.from_numpy(np.random.default_rng(auto.seed + 1).permutation(
        len(shapes))[:704].astype(np.int64)).to(dev).reshape(11, -1)
    events, l1 = [], []
    for i in range(10):
        m = step(st, ids[i], 0.0, 1000 + i)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        l1.append(m["loss_l1"])
    torch.cuda.synchronize()
    ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step(st, ids[10], 0.0, 1010)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    return dict(ms_per_step=ms, loss_l1=[float(v) for v in l1],
                peak_gib=peak / 2 ** 30, step_rise_gib=(peak - before)
                / 2 ** 30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("relu_dropout_compare: no CUDA card", file=sys.stderr)
        return 2
    root = args.checkout.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl, relu_dropout as rd)
    if not pathlib.Path(rd.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"port not from {root}: {rd.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(checkout=str(args.checkout), card=card,
               chain={c: chain(rd, bl, dev, cs, c) for c in (512, 253)},
               layer={f"{i}->{o}": layer(rd, bl, dev, cs, i, o)
                      for i, o in ((512, 512), (512, 253))})
    torch.cuda.empty_cache()
    out["bank"] = bank_route(dev, cs)
    line = json.dumps(out)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
