"""Time kernel #4's pass and the fused route from the on-device bank for
one checkout of the repository, so that two commits can be compared on
one card.

    python3 tools/train_pass_compare.py --checkout DIR [--bank] [--out PATH]
        [--same-as PATH ...]

DIR is a checkout of a commit (for example a `git archive` unpacked into
a git-ignored directory). The script imports the port and chip_smoke.py
from DIR, builds DIR's csrc/fused_train.cu and runs DIR's own
[fused_train] measurements on chip_smoke.py's batch (config 3's `ad`
block, chairs 0-63 of the committed pack's split, 64 x 16,384 points,
dropout 0.2): the pass against its plain version (loss and the worst
gradient, relative), the pass's time over 5 passes, one traced pass split
by role (`train_roles`), and the engine's roles alone at 2^20 x 512 x 512
(`train_gemms`). It also times the wgrad role alone at 2^20 x 512 x 512
(16,384-point chunks) through DIR's wrapper, or through the C entry point
of the mma.sync kernel that the commits before the TMA + wgmma wgrad role
had. It records the SHA-256 of the loss and of every g one pass stores
(each g the wgrad role reads, and the last dgrad's output, g_0), whatever
the checkout's dgrad returns; --same-as compares them with those of
earlier runs' JSON (for example the parent's): equal digests, bit-equal
results. With --bank it runs DIR's [bank] phase (`bank_phase`: one fused
epoch of 96 steps from the chair bank, timed on the card's clock, then
traced). Prints one JSON line; --out also writes it to PATH.

Run it once per checkout, in turns (parent, change, change, parent), in
one call of the card, and compare within that call. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys


def wgrad_alone(ft, dev, cs) -> dict:
    """ms of one wgrad launch at 2^20 x 512 x 512 (f32 partials over
    16,384-point chunks) beside its bound."""
    import torch
    m = n = k = 512
    pts, k_split = 1 << 20, 16384
    gen = torch.Generator(device=dev).manual_seed(5)
    g = (torch.randn(pts, m, generator=gen, device=dev) * 1e-3).to(
        torch.bfloat16)
    h = torch.relu(torch.randn(pts, k, generator=gen, device=dev)).to(
        torch.bfloat16)
    if hasattr(ft, "gemm_wgrad"):
        def run():
            return ft.gemm_wgrad(g, h, k_split)
    else:                       # the mma.sync kernel's entry point
        part = torch.empty(pts // k_split, m * n, dtype=torch.float32,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            ft._call("ft_gemm_wgrad", g.data_ptr(), m, h.data_ptr(), n, m, n,
                     pts, k_split, part.data_ptr(), stream)
            return part
    got = run().reshape(-1, m, n)
    want = torch.bmm(g.float().reshape(-1, k_split, m).transpose(1, 2),
                     h.float().reshape(-1, k_split, n))
    err = float((got - want).abs().max()) / float(want.abs().max())
    bnd, by = cs.gemm_bound(m, n, pts, 2 * pts * (m + n),
                            4 * (pts // k_split) * m * n)
    return dict(ms=cs.time_ms(run, 20), bound_ms=bnd, bound_by=by,
                rel_err=err)


def g_digests(ft, cs, ft_args) -> dict:
    """SHA-256 of the loss and of every g one pass stores: the g each
    wgrad launch reads (the final layer's, then each dgrad's but the
    last) and the last dgrad's output (g_0), in pass order."""
    wgrad, dgrad = ft.gemm_wgrad, ft.gemm_dgrad
    digests, last = [], {}

    def wgrad_hook(g, *args):
        digests.append(cs._digest(g))
        return wgrad(g, *args)

    def dgrad_hook(*args, **kw):
        out = dgrad(*args, **kw)
        last["g"] = out[0] if isinstance(out, tuple) else out
        return out

    ft.gemm_wgrad, ft.gemm_dgrad = wgrad_hook, dgrad_hook
    try:
        loss = ft.fused_train_loss_grads(*ft_args)[0]
    finally:
        ft.gemm_wgrad, ft.gemm_dgrad = wgrad, dgrad
    digests.append(cs._digest(last["g"]))
    return dict(loss=cs._digest(loss), g=digests)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", type=pathlib.Path, required=True)
    ap.add_argument("--bank", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--same-as", type=pathlib.Path, nargs="*", default=[])
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import chip_smoke as cs
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset \
        import SdfDataset
    if not pathlib.Path(cs.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"chip_smoke not from {root}: {cs.__file__}")
    # the batch first: its process pool starts before CUDA does
    ad0 = ExperimentConfig.load(root / "configs" / "config3_chairs_joint").ad
    S, P = ad0.scenes_per_batch, ad0.samples_per_scene
    dataset = SdfDataset.from_analytic(cs.train_split(), 20_000, seed=0,
                                       workers=8)
    batch = next(dataset.epoch_batches(np.random.default_rng(0), S, P))

    import torch
    if not torch.cuda.is_available():
        print("train_pass_compare: no CUDA card", file=sys.stderr)
        return 2
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        fused_train as ft)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder \
        import precompute_eval_weights
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import load_stage1_pack
    if not pathlib.Path(ft.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"port not from {root}: {ft.__file__}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    sd, codes = load_stage1_pack(root.joinpath(*cs.PACK))
    ids = torch.from_numpy(batch.scene_ids.astype(np.int64)).to(dev)
    xyz = torch.from_numpy(batch.xyz).to(dev)
    sdf = torch.from_numpy(batch.sdf).to(dev)
    ew = precompute_eval_weights(SdfDecoder(ad0.decoder),
                                 {k: v.to(dev) for k, v in sd.items()},
                                 torch.bfloat16)
    z_far = torch.from_numpy(codes[64:128]).to(dev)[ids]
    ft_args = (ew, z_far, xyz, sdf, S * P, ad0.clamp_dist, cs.RATE, 4242)
    got = ft.fused_train_loss_grads(*ft_args)
    want = ft.fused_train_reference(*ft_args)
    worst = 0.0
    for a, b in zip(got[2], want[2]):
        for key in b:
            worst = max(worst, float((a[key] - b[key]).abs().max())
                        / max(float(b[key].abs().max()), 1e-30))
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    del got, want
    digests = g_digests(ft, cs, ft_args)
    ft_args = (ew, torch.from_numpy(codes[:64]).to(dev)[ids], xyz, sdf,
               S * P, ad0.clamp_dist, cs.RATE, 4242)
    ms = cs.time_ms(lambda: ft.fused_train_loss_grads(*ft_args), 5)
    out = dict(checkout=str(args.checkout), card=card, pass_ms=ms,
               loss_rel=loss_rel, worst_grad_rel=worst, digests=digests,
               roles=cs.train_roles(ft, ft_args, card),
               gemm=cs.train_gemms(ft, dev, card),
               wgrad_alone=wgrad_alone(ft, dev, cs))
    out["roles"].pop("top", None)
    cs.log(f"[compare] {args.checkout}: #4 {ms:.3f} ms a 64 x 16,384 step, "
           f"loss rel {loss_rel:.1e}, worst gradient rel {worst:.1e}; wgrad "
           f"{out['roles']['wgrad']['ms']:.3f} ms in "
           f"{out['roles']['wgrad']['launches']} launches; one 2^20 x 512 x "
           f"512 wgrad launch {out['wgrad_alone']['ms']:.3f} ms (bound "
           f"{out['wgrad_alone']['bound_ms']:.3f}) [{card}]")
    del ew, ft_args, xyz, sdf
    torch.cuda.empty_cache()
    if args.bank:
        bk = cs.bank_phase(dev, card, math.nan, ms)
        out["bank"] = dict(ms_per_step=bk["fused"]["ms_per_step"],
                           trace=bk["fused"]["trace"],
                           step0_loss_l1=bk["fused"]["step0_loss_l1"])
    for other in args.same_as:
        theirs = json.loads(other.read_text())["digests"]
        same = dict(loss=theirs["loss"] == digests["loss"],
                    g=[a == b for a, b in zip(theirs["g"], digests["g"])]
                    if len(theirs["g"]) == len(digests["g"]) else False)
        out.setdefault("same_as", {})[str(other)] = same
        cs.log(f"[compare] {args.checkout} vs {other}: loss bit-equal "
               f"{same['loss']}; each stored g (top down, g_0 last) "
               f"bit-equal {same['g']}")
    line = json.dumps(out, default=str)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
