"""ops.bf16_linear's padded layout: on the card the bf16 decoder's hidden
layers run on columns padded with zeros to multiples of 8 (lin0's 259
inputs to 264, lin3's 253 outputs to 256, the skip layer's two pieces to
256 + 264), so that cuBLAS takes its Hopper kernels.

(a) the fact the output pad rests on: kernels #3/#3b key their mask by
column group, not by the row's width, so a padded row keeps the logical
row's mask and the pad columns stay 0; (b) the layouts, run as fp32
products of the same bf16 values, agree with the unpadded plain version
to fp32 summation error (emulated in float64), every pad column of every
output and cotangent exactly 0; (c) whole training steps on the padded
layout agree with the unpadded ones, their gradients in the parameters'
shapes; (d) widths already multiples of 8 are left as they are. The CPU
route itself stays unpadded (tests/test_torch_bf16_linear.py); these
tests ask for the layout explicitly (`ops.bf16_linear.pads`)."""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.ops import bf16_linear as bl
from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

torch.set_num_threads(2)

BF = torch.bfloat16
U32 = 2.0 ** -24          # fp32 unit roundoff
ULP_BF16 = 2.0 ** -7      # bf16 spacing relative to the value, at most
RATE = 0.2
ROLES = ("fwd", "dgrad", "wgrad")


def _padded(before) -> dict:
    """The padded products counted since `before` (a copy of the launch
    record), by role."""
    new = profiling.LAUNCHES - before
    return {k: new[f"bf16_linear.{k}.padded"] for k in ROLES}


def _pad_rows(t: torch.Tensor, runs: tuple) -> torch.Tensor:
    """t [..., sum(runs)] stored on the layout: each run padded."""
    pieces, c = [], 0
    for r in runs:
        pieces.append(bl.pad_columns([t[..., c:c + r]]))
        c += r
    return torch.cat(pieces, dim=-1)


def _pad_mask(runs: tuple) -> torch.Tensor:
    """bool [stored]: True at the layout's pad columns."""
    return torch.cat([torch.arange(bl.padded_width(r)) >= r for r in runs])


# ------------------------------------- (a) the mask of a padded row

@pytest.mark.parametrize("width", [253, 109])
@pytest.mark.parametrize("row0", [0, 4097, (1 << 32) - 2])
def test_padded_row_keeps_the_logical_rows_mask(width, row0):
    """dropout_keep_bits at the padded width, cut to the logical one,
    equals it at the logical width (rows across the counter's 32-bit
    halves too); #3's and #3b's layer entries on a zero-padded product
    and bias give the logical output, gradient and db bit for bit, and 0
    in every pad column."""
    wide = bl.padded_width(width)
    assert wide > width
    assert torch.equal(rd.dropout_keep_bits(5, wide, 11, row0)[:, :width],
                       rd.dropout_keep_bits(5, width, 11, row0))
    rng = np.random.default_rng(width)
    yf = torch.from_numpy(rng.normal(size=(70, width)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=width).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(70, width)).astype(np.float32)).to(
        BF)
    pad = (0, wide - width)
    out = rd.bias_relu_dropout_fwd(yf, b, 11, RATE)
    out_p = rd.bias_relu_dropout_fwd(F.pad(yf, pad), F.pad(b, pad), 11, RATE)
    assert torch.equal(out_p[:, :width], out)
    assert not out_p[:, width:].any()
    gb, db = rd.relu_dropout_bwd_out(out, g, RATE)
    gb_p, db_p = rd.relu_dropout_bwd_out(out_p, F.pad(g, pad), RATE)
    assert torch.equal(gb_p[:, :width], gb) and torch.equal(db_p[:width], db)
    assert not gb_p[:, width:].any() and not db_p[width:].any()


# -------------------- (b) the layouts against the plain version in f64

LAYERS = {"lin0": ((259,), 512), "lin3": ((512,), 253),
          "skip": ((253, 259), 512)}


def _close(emul64, got, abs_sum, k, bf16_out):
    """got within fp32 summation error of the float64 sum (k terms), plus
    one bf16 spacing where the result is rounded to bf16."""
    want = emul64.float()
    if bf16_out:
        want = want.to(BF).float()
    tol = k * U32 * abs_sum.float() + (ULP_BF16 * want.abs()
                                       if bf16_out else 0)
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("form", ["linear", "relu_dropout"])
def test_padded_layout_agrees_with_the_plain_version(layer, form):
    """One hidden layer on its padded layout, its fp32 products of padded
    bf16 operands, against the unpadded layer's products emulated in
    float64 (exact products, float64 sums): the output, dx, dW and db
    within fp32 summation error; every pad column of the output, the
    cotangent #3b emits and dx exactly 0; dW and db in the parameters'
    shapes."""
    runs, out = LAYERS[layer]
    d_in, N = sum(runs), 300
    rng = np.random.default_rng(d_in + out)
    x = torch.from_numpy(rng.normal(size=(N, d_in)).astype(np.float32)).to(BF)
    w = torch.from_numpy((rng.normal(size=(out, d_in)) / np.sqrt(d_in))
                         .astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.normal(size=out).astype(np.float32)
                         ).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(N, out)).astype(np.float32)).to(BF)
    xp = _pad_rows(x, runs).requires_grad_()
    gp = bl.pad_columns([g])
    n0 = profiling.LAUNCHES.copy()
    if form == "linear":
        y = bl.bf16_linear(xp, w, b, runs)
        y.backward(gp.float())
        gb = gp
    else:
        y = bl.bf16_linear_relu_dropout(xp, w, b, 5, RATE, runs)
        y.backward(gp)
        gb = rd.relu_dropout_bwd_out(y.detach(), gp, RATE)[0]
        assert not gb[:, out:].any()
    assert _padded(n0) == {"fwd": 1, "dgrad": 1, "wgrad": 1}
    assert y.shape == (N, bl.padded_width(out))
    assert not y[:, out:].detach().any()
    assert not xp.grad[:, _pad_mask(runs)].any()
    assert w.grad.shape == w.shape and b.grad.shape == b.shape
    x64, w64 = x.double(), w.detach().to(BF).double()
    fwd64 = x64 @ w64.t()
    if form == "linear":
        _close(fwd64 + b.detach().double(), y.detach()[:, :out],
               x64.abs() @ w64.abs().t() + b.detach().double().abs(),
               d_in + 1, False)
    else:
        want = rd.bias_relu_dropout_reference(fwd64.float(), b.detach(), 5,
                                              RATE)
        # one fp32 rounding of the sum apart, at most one bf16 step of h,
        # and the scale's rounding after it
        diff = (y.detach()[:, :out].float() - want.float()).abs()
        assert bool((diff <= 2 * ULP_BF16 * want.float().abs()).all())
    g64 = gb[:, :out].double()
    _close(g64 @ w64, bl.logical_columns(xp.grad, runs), g64.abs()
           @ w64.abs(), out, True)
    _close(g64.t() @ x64, w.grad, g64.abs().t() @ x64.abs(), N, True)
    _close(g64.sum(0), b.grad, g64.abs().sum(0), N, False)


# ----------------------- (c) training steps on the padded layout

def _ad_cfg(**decoder):
    dec = dict(latent_size=8, hidden_dim=32, num_layers=4,
               compute_dtype="bfloat16", dropout_prob=0.2)
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(**{**dec, **decoder}),
                         num_scenes=3, scenes_per_batch=2,
                         samples_per_scene=64, clamp_dist=1.0)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    S, P = cfg.scenes_per_batch, cfg.samples_per_scene
    ids = torch.from_numpy(rng.permutation(cfg.num_scenes)[:S])
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    sdf = torch.from_numpy((0.3 * rng.normal(size=(S, P))).astype(
        np.float32))
    return ids, xyz.to(BF), sdf


def _steps(cfg, padded: bool, monkeypatch, n=2):
    """n training steps from one state, with the hidden layers on the
    padded layout or not: (losses, the last step's gradients, the state
    after, the padded products counted over the steps)."""
    monkeypatch.setattr(bl, "pads", lambda t: padded)
    st = tad.init_ad_state(cfg, seed=2, device="cpu")
    step = tad.make_ad_train_step(st.decoder, cfg)
    n0 = profiling.LAUNCHES.copy()
    losses = [float(step(st, *_batch(cfg, i), 0.0, i)["loss"])
              for i in range(n)]
    grads = {k: p.grad for k, p in st.decoder.named_parameters()}
    grads["codes"] = st.codes.grad
    after = dict(st.decoder.state_dict(), codes=st.codes.detach())
    return losses, grads, after, _padded(n0)


# (decoder plan, padded layers a step): latent 8 + xyz 3 = 11 inputs
STEP_PLANS = {
    "skip": (dict(latent_in=(2,), use_dropout=True, dropout_impl="pallas"),
             3),                        # lin0 (11), lin1 (21 out), lin2
    "skip_no_dropout": (dict(latent_in=(2,), use_dropout=False), 3),
    "xyz_in_all": (dict(latent_in=(), xyz_in_all=True, use_dropout=True,
                        dropout_impl="pallas"), 4),   # 29 + 3 each layer
}


@pytest.mark.parametrize("plan", sorted(STEP_PLANS))
def test_padded_training_steps_agree_with_unpadded(plan, monkeypatch):
    """Two autograd training steps of the bf16 decoder on the padded
    layout against the same steps unpadded: the losses within 1e-5, the
    second step's gradients within 1e-2 of each one's max (a bf16
    rounding of an activation may flip with the fp32 sum's order), every
    gradient in its parameter's shape; the launch record counts each
    padded layer's three products a step, and nothing unpadded."""
    kw, layers = STEP_PLANS[plan]
    cfg = _ad_cfg(**kw)
    l1, g1, _, n1 = _steps(cfg, True, monkeypatch)
    l2, g2, _, n2 = _steps(cfg, False, monkeypatch)
    assert n1 == {k: 2 * layers for k in n1} and not any(n2.values())
    assert l1 == pytest.approx(l2, rel=1e-5)
    for k, r in g2.items():
        assert g1[k].shape == r.shape
        assert float((g1[k] - r).abs().max()) <= 1e-2 * float(
            r.abs().max()), k


def test_padded_eval_forward_and_code_gradient(monkeypatch):
    """A frozen bf16 decoder in eval mode (the reconstruction's use): the
    padded forward and z's gradient against the unpadded ones; the
    padded layers make their forward and dgrad products, no wgrad."""
    cfg = _ad_cfg(latent_in=(2,))
    st = tad.init_ad_state(cfg, seed=4, device="cpu")
    dec = st.decoder.eval().requires_grad_(False)
    rng = np.random.default_rng(4)
    z0 = torch.from_numpy(rng.normal(size=(3, 40, 8)).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32))
    out = []
    for padded in (True, False):
        monkeypatch.setattr(bl, "pads", lambda t: padded)
        n0 = profiling.LAUNCHES.copy()
        z = z0.clone().requires_grad_()
        pred = dec(z, xyz)
        pred.abs().sum().backward()
        out.append((pred.detach(), z.grad,
                    _padded(n0)))
    (p1, gz1, n1), (p2, gz2, n2) = out
    assert n1 == {"fwd": 3, "dgrad": 3, "wgrad": 0} and not any(n2.values())
    assert p1.shape == p2.shape and gz1.shape == gz2.shape
    assert float((p1 - p2).abs().max()) <= 1e-2 * float(p2.abs().max())
    assert float((gz1 - gz2).abs().max()) <= 1e-2 * float(gz2.abs().max())


# ------------------------------ (d) aligned widths stay as they are

@pytest.mark.parametrize("form", ["linear", "relu_dropout"])
def test_aligned_layout_is_the_unpadded_layer(form):
    """A layout whose widths are multiples of 8 (the 512-wide layers) is
    the unpadded layer bit for bit, and counts no padded product."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(96, 512)).astype(np.float32)).to(BF)
    w0 = torch.from_numpy((rng.normal(size=(512, 512)) / 23).astype(
        np.float32))
    b0 = torch.from_numpy(rng.normal(size=512).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(96, 512)).astype(np.float32)).to(BF)
    n0 = profiling.LAUNCHES.copy()
    out = []
    for runs in ((256, 256), None):
        xi = x.clone().requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        if form == "linear":
            y = bl.bf16_linear(xi, w, b, runs)
            y.backward(g.float())
        else:
            y = bl.bf16_linear_relu_dropout(xi, w, b, 3, RATE, runs)
            y.backward(g)
        out.append([y.detach(), xi.grad, w.grad, b.grad])
    for a, r in zip(*out):
        assert torch.equal(a, r)
    assert not any(_padded(n0).values())


def test_aligned_decoder_steps_are_unpadded(monkeypatch):
    """A decoder whose widths are all multiples of 8 (latent 13 + xyz 3
    = 16 inputs, 32 - 16 before the skip) takes the same steps with the
    padded layout asked for as without, bit for bit, and counts no padded
    product."""
    cfg = _ad_cfg(latent_size=13, latent_in=(2,), use_dropout=True,
                  dropout_impl="pallas")
    l1, g1, a1, n1 = _steps(cfg, True, monkeypatch)
    l2, g2, a2, _ = _steps(cfg, False, monkeypatch)
    assert not any(n1.values())
    assert l1 == l2
    assert all(torch.equal(g1[k], g2[k]) for k in g2)
    assert all(torch.equal(a1[k], a2[k]) for k in a2)
