"""Time the bf16 decoder's hidden layers on the card in both forms: on the
bf16 tensor cores (ops.bf16_linear) and in the plain form (fp32 products
of the same bf16 values, TF32 off; bf16_linear_reference), and hold one
config-3 training step of the first against the second.

    python3 tools/bf16_linear_probe.py [--out PATH]

For each hidden layer of config 3's 8x512 decoder at 64 x 16,384 = 2^20
rows: the forward and backward of one layer (autograd, a bf16-valued fp32
cotangent) in each form, and each of its three products alone (forward,
dgrad, wgrad), on CUDA events; the sums over the eight hidden layers are
what a training step spends in them. Then one step's loss and gradients
from the committed chair pack on six batches drawn from the chair bank
of chairs 0-63, four with their own codes (the optimum) and two with
the codes of chairs 64-127, through chip_smoke.tc_vs_plain_step: the
tensor cores against the plain form, and each form's distance from the
float64 witness per gradient, recorded; each mix of the three products
on the tensor cores and in the plain form, and a fault (ROLE_MIXES), by
its distance from the witness on the same six batches; and the
forward's fp32 sums at a 512 x 512 layer against float64, per element
in fp32 ulps of the sum of the terms' magnitudes (mean signed error,
mean error toward zero, rms, max) with the share of bf16 roundings that
differ from the exact sum's.
Prints the card's name and power
limit; needs one CUDA card; `--out` writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_ROWS = 1 << 20


# (forward, dgrad, wgrad): True on the tensor cores, False as the plain
# fp32 product; the forward "bf16" as a tensor-core product rounded to
# bf16 before the bias (a fault: the fp32 output dropped), to show what a
# gate on the distance from the witness sees of one
ROLE_MIXES = {
    "all plain": (False, False, False),
    "forward on the tensor cores": (True, False, False),
    "dgrad on the tensor cores": (False, True, False),
    "wgrad on the tensor cores": (False, False, True),
    "all on the tensor cores": (True, True, True),
    "all on the tensor cores, forward rounded to bf16 (a fault)":
        ("bf16", True, True),
}


def role_mix(bl, fwd_tc, dgrad_tc: bool, wgrad_tc: bool):
    """A hidden layer as ops.bf16_linear computes it, with each product
    on the tensor cores or as the plain fp32 product of the same bf16
    values (ROLE_MIXES)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16

    class Mix(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            x2, wb = x.reshape(-1, x.shape[-1]), w.to(bf16)
            ctx.save_for_backward(x2, wb)
            ctx.x_shape = x.shape
            with bl._tensor_core_flags():
                y = (torch.mm(x2, wb.t()).float() if fwd_tc == "bf16"
                     else torch.mm(x2, wb.t(), out_dtype=f32) if fwd_tc
                     else torch.mm(x2.float(), wb.float().t()))
            return y.add_(b).reshape(*x.shape[:-1], w.shape[0])

        @staticmethod
        def backward(ctx, g):
            x2, wb = ctx.saved_tensors
            g2 = g.reshape(-1, g.shape[-1])
            gb = g2.to(bf16)
            with bl._tensor_core_flags():
                dx = (torch.mm(gb, wb) if dgrad_tc
                      else torch.mm(g2, wb.float()).to(bf16))
                dw = (torch.mm(gb.t(), x2) if wgrad_tc
                      else torch.mm(g2.t(), x2.float()).to(bf16))
            return dx.reshape(ctx.x_shape), dw.float(), g2.sum(0)

    return Mix.apply


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bf16_linear_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl)
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder \
        import init_ad_state
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import load_stage1_pack

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[card] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    ad = ExperimentConfig.load(ROOT / "configs" / "config3_chairs_joint").ad
    sd, codes = load_stage1_pack(ROOT.joinpath(*cs.PACK))
    decoder = SdfDecoder(ad.decoder)
    decoder.load_state_dict(sd)
    decoder.to(dev)
    plan = decoder.layer_dims()[:-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"card": card, "layers": []}
    total = {"tc": 0.0, "plain": 0.0}

    def layer_pass(fn, x, w, b, g):
        def run():
            xi = x.detach().requires_grad_()
            wi, bi = w.detach().requires_grad_(), b.detach().requires_grad_()
            fn(xi, wi, bi).backward(g)
        return run

    for layer, (d_in, d_out, _) in enumerate(plan):
        lin = getattr(decoder, f"lin{layer}")
        w = lin.weight().detach()
        b = lin.b.detach()
        x = torch.randn(N_ROWS, d_in, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(N_ROWS, d_out, generator=gen, device=dev).to(
            torch.bfloat16).float()
        wb, gb, xf, wf = w.to(torch.bfloat16), g.to(torch.bfloat16), \
            x.float(), w.to(torch.bfloat16).float()
        row = {"layer": layer, "in": d_in, "out": d_out}
        for form, fn in (("tc", bl.bf16_linear),
                         ("plain", bl.bf16_linear_reference)):
            row[form] = cs.time_ms(layer_pass(fn, x, w, b, g), 5)
            total[form] += row[form]
        with bl._tensor_core_flags():
            row["tc_products"] = [cs.time_ms(f, 5) for f in (
                lambda: torch.addmm(b, x, wb.t(), out_dtype=torch.float32),
                lambda: torch.mm(gb, wb), lambda: torch.mm(gb.t(), x))]
            # the forward as a product and a separate bias add
            row["tc_mm_then_add"] = cs.time_ms(lambda: torch.mm(
                x, wb.t(), out_dtype=torch.float32).add_(b), 5)
        row["plain_products"] = [cs.time_ms(f, 5) for f in (
            lambda: torch.mm(xf, wf.t()), lambda: torch.mm(g, wf),
            lambda: torch.mm(g.t(), xf))]
        out["layers"].append(row)
        print(f"[layer] lin{layer} {d_in}->{d_out} x {N_ROWS} rows: forward "
              f"+ backward {row['tc']:.3f} ms on the tensor cores, "
              f"{row['plain']:.3f} plain; products (fwd, dgrad, wgrad) "
              + ", ".join(f"{t:.3f}" for t in row["tc_products"]) + " vs "
              + ", ".join(f"{t:.3f}" for t in row["plain_products"])
              + f" ms; the forward as mm + add {row['tc_mm_then_add']:.3f} "
              f"ms [{card}]", flush=True)
        del x, g, wb, gb, xf, wf
        torch.cuda.empty_cache()
    out["total"] = total
    print(f"[layers] the {len(plan)} hidden layers, forward + backward: "
          f"{total['tc']:.2f} ms on the tensor cores, {total['plain']:.2f} "
          f"plain: {total['plain'] - total['tc']:.2f} ms less a step "
          f"[{card}]", flush=True)

    # the forward's fp32 sums against float64 at a 512 x 512 layer:
    # lin1's weights, post-relu bf16 inputs
    wb = decoder.lin1.weight().detach().to(torch.bfloat16)
    x = torch.randn(N_ROWS, 512, generator=gen, device=dev).relu_().to(
        torch.bfloat16)
    y64 = x.double() @ wb.double().t()
    # errors in fp32 ulps of the sum of the terms' magnitudes, the scale
    # an fp32 accumulator of these terms works at
    ulp = torch.ldexp(torch.ones_like(y64), torch.frexp(
        x.double() @ wb.double().abs().t())[1] - 24)
    exact = cs.round_to_odd_f32(y64).to(torch.bfloat16)
    with bl._tensor_core_flags():
        y_tc = torch.mm(x, wb.t(), out_dtype=torch.float32)
    out["accumulation"] = {}
    for form, y in (("tc", y_tc), ("plain", torch.mm(x.float(),
                                                       wb.float().t()))):
        e = (y.double() - y64) / ulp
        out["accumulation"][form] = a = dict(
            mean=float(e.mean()),
            toward_zero=float((-e * y64.sign()).mean()),
            rms=float(e.square().mean().sqrt()),
            max=float(e.abs().max()),
            bf16_differs=float((y.to(torch.bfloat16) != exact).double(
            ).mean()))
        print(f"[accumulation] 512 x 512 forward, {N_ROWS} rows, {form}: "
              f"fp32 sum - float64 sum in fp32 ulps of the sum of |terms|: "
              f"mean "
              f"{a['mean']:+.4f}, toward zero {a['toward_zero']:+.4f}, rms "
              f"{a['rms']:.4f}, max {a['max']:.1f}; bf16 rounding differs "
              f"from the exact sum's for {a['bf16_differs']:.3e} of the "
              f"elements [{card}]", flush=True)
    del x, y64, ulp, exact, y_tc, e, y
    torch.cuda.empty_cache()

    # steps held to the plain form and to the float64 witness, on batches
    # from the chair bank: four with the chairs' own codes (the optimum),
    # two with other chairs' codes
    S, P = ad.scenes_per_batch, ad.samples_per_scene
    shapes = analytic.make_synthetic_split("chair", 6145, seed=11)[:S]
    bank = adv.bank_from_chairs(shapes, 11, P, device=dev)
    cfg = dataclasses.replace(ad, num_scenes=S)
    state = init_ad_state(cfg, params=sd, codes=codes[:S], device=dev)
    ids = torch.arange(S, device=dev)
    other = torch.from_numpy(codes[S:2 * S]).to(dev)
    out["step"] = []
    batches = []
    torch.cuda.reset_peak_memory_stats()
    for k, (case, table) in enumerate(
            [("the chairs' own codes", state.codes)] * 4
            + [("other chairs' codes", other)] * 2):
        xyz, sdf = bank.sample_batch(gen, ids, P)
        batches.append((case, table, xyz, sdf, 4242 + k))
        out["step"].append(cs.tc_vs_plain_step(
            state.decoder, cfg, table, ids, xyz, sdf, 0.0, 4242 + k,
            f"step {k}", card, case, None))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[step] peak device memory {out['peak_gib']:.2f} GiB", flush=True)

    # which product carries the distance from the float64 witness: each
    # role on the tensor cores alone, all three, and a fault
    out["roles"] = {}
    for name, roles in ROLE_MIXES.items():
        hidden = role_mix(bl, *roles)
        rows = []
        for case, table, xyz, sdf, seed in batches:
            _, g = cs.step_grads(state.decoder, cfg, table, ids, xyz, sdf,
                                 0.0, seed, hidden)
            _, g64 = cs.step_grads(state.decoder, cfg, table, ids, xyz, sdf,
                                   0.0, seed, cs.bf16_linear_float64)
            d = cs.grad_distance(g, g64)
            worst = max(d, key=d.get)
            rows.append(dict(case=case, worst=worst, dist=d[worst],
                             per_grad=d))
            del g, g64
        out["roles"][name] = rows
        print(f"[roles] {name}: distance from the float64 witness, worst "
              "gradient per batch (4 own codes, 2 other): "
              + ", ".join(f"{r['worst']} {r['dist']:.2e}" for r in rows)
              + f" [{card}]", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
