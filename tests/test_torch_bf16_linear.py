"""ops.bf16_linear: the bf16 decoder's hidden layers as bf16 x bf16
products with fp32 accumulation, as the JAX package's bf16 branch forms
them (`models/decoder.py:60-67`), against the plain form, fp32 products
of bf16-valued tensors (`bf16_linear_reference`).

(a) the precondition that makes the two forms agree: every operand of a
hidden layer's three products is bf16-valued in a training step; (b) on
the CPU the autograd function is the plain version bit for bit, and so is
a whole training step; (c) the tensor cores' arithmetic (exact products,
fp32 sums), emulated in float64, agrees with the plain version to fp32
summation error; (d) the fp32 decoder is untouched. The same comparisons
on the card are in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models import (
    decoder as decoder_module)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import bf16_linear as bl
from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad

torch.set_num_threads(2)

BF = torch.bfloat16
U32 = 2.0 ** -24          # fp32 unit roundoff
ULP_BF16 = 2.0 ** -7      # bf16 spacing relative to the value, at most


def _bf16_valued(t: torch.Tensor) -> bool:
    t = t.detach()
    return torch.equal(t.to(BF).to(t.dtype), t)


def _ad_cfg(S, P, **decoder):
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        latent_size=8, hidden_dim=32, num_layers=4, compute_dtype="bfloat16",
        **decoder), num_scenes=3, scenes_per_batch=S, samples_per_scene=P,
        clamp_dist=1.0)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    S, P = cfg.scenes_per_batch, cfg.samples_per_scene
    ids = torch.from_numpy(rng.permutation(cfg.num_scenes)[:S])
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    sdf = torch.from_numpy((0.3 * rng.normal(size=(S, P))).astype(
        np.float32))
    return ids, xyz.to(BF), sdf


# ------------------------------------------------ (a) the precondition

@pytest.mark.parametrize("n", [128, 133])          # 2^7 and 2^7 + 5
@pytest.mark.parametrize("use_tanh", [False, True])
@pytest.mark.parametrize("latent_in,xyz_in_all", [((), False), ((2,), False),
                                                  ((2,), True)])
@pytest.mark.parametrize("dropout", ["pallas", "xla", "off"])
def test_hidden_operands_are_bf16_valued(dropout, latent_in, xyz_in_all,
                                         use_tanh, n, monkeypatch):
    """One autograd training step of the bf16 decoder: every hidden layer's
    x, bf16(W) and cotangent g equal their bf16 round trips; the head's
    g does so only when n = S * P is a power of two and use_tanh is off.
    With kernel dropout the hidden layers take the route configs 3-5
    take, bf16_linear_relu_dropout; it is substituted by its composition
    (bf16_linear_relu_dropout_reference) so that the product's operands
    can be recorded, and the two are equal bit for bit
    (tests/test_torch_relu_dropout_layer.py)."""
    cfg = _ad_cfg(1, n, latent_in=latent_in, xyz_in_all=xyz_in_all,
                  use_tanh=use_tanh, use_dropout=dropout != "off",
                  dropout_prob=0.2,
                  dropout_impl="xla" if dropout == "off" else dropout)
    seen = {"hidden": [], "head": []}

    def recorder(fn, kind):
        def wrapped(x, w, b):
            y = fn(x, w, b)
            rec = {"x": x.detach(), "w": w.detach().to(BF)}
            y.register_hook(lambda g: rec.__setitem__("g", g.detach()))
            seen[kind].append(rec)
            return y
        return wrapped

    hidden = recorder(bl.bf16_linear, "hidden")
    if dropout == "pallas":
        monkeypatch.setattr(
            decoder_module, "bf16_linear_relu_dropout",
            lambda x, w, b, seed, rate, layout:
            bl.bf16_linear_relu_dropout_reference(x, w, b, seed, rate,
                                                  linear=hidden))
    else:
        monkeypatch.setattr(decoder_module, "bf16_linear", hidden)
    monkeypatch.setattr(hd, "bf16_head", recorder(hd.bf16_head, "head"))
    st = tad.init_ad_state(cfg, seed=1, device="cpu")
    step = tad.make_ad_train_step(st.decoder, cfg)
    step(st, *_batch(cfg), 0.0, 3)
    assert len(seen["hidden"]) == cfg.decoder.num_layers
    assert len(seen["head"]) == 1
    for rec in seen["hidden"]:
        assert rec["x"].dtype == BF and _bf16_valued(rec["x"].float())
        assert _bf16_valued(rec["w"].float())
        assert rec["g"].dtype == torch.float32 and _bf16_valued(rec["g"])
    g_head = seen["head"][0]["g"]
    assert bool((g_head != 0).any())
    assert _bf16_valued(g_head) == (n & (n - 1) == 0 and not use_tanh)


# ---------------------------------- (b) the CPU route is the plain version

@pytest.mark.parametrize("shape", [(300, 259, 512), (300, 512, 253),
                                   (257, 512, 512), (2, 70, 64, 48)])
@pytest.mark.parametrize("grads", ["all", "weights"])
def test_cpu_route_is_the_plain_version_bit_for_bit(shape, grads):
    """y, dx, dW, db of bf16_linear on the CPU equal autograd of the plain
    version bit for bit, for a bf16-valued cotangent (as every hidden
    layer's is): the same fp32 products and sums, the same roundings."""
    *rows, d_in, d_out = shape
    rng = np.random.default_rng(d_in)
    x = torch.from_numpy(rng.normal(size=(*rows, d_in)).astype(
        np.float32)).to(BF)
    w0 = torch.from_numpy(rng.normal(size=(d_out, d_in)).astype(
        np.float32) / np.sqrt(d_in))
    b0 = torch.from_numpy(rng.normal(size=d_out).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(*rows, d_out)).astype(
        np.float32)).to(BF).float()
    out = []
    for fn in (bl.bf16_linear, bl.bf16_linear_reference):
        xi = x.clone().requires_grad_(grads == "all")
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(xi, w, b)
        y.backward(g)
        out.append([y.detach(), w.grad, b.grad]
                   + ([xi.grad] if grads == "all" else []))
    for a, r in zip(*out):
        assert a.dtype == r.dtype and torch.equal(a, r)
    assert out[0][0].dtype == torch.float32
    if grads == "all":
        assert out[0][3].dtype == BF


@pytest.mark.parametrize("dropout", ["pallas", "off"])
def test_cpu_training_steps_equal_the_plain_form(dropout, monkeypatch):
    """Three autograd steps of the bf16 decoder (skip layer, dropout)
    through bf16_linear equal, bit for bit, the same steps with every
    hidden layer's product through the plain version: loss, every
    parameter and the codes. With kernel dropout the route is
    bf16_linear_relu_dropout against its composition with the plain
    product (bf16_linear_relu_dropout_reference); without, bf16_linear
    against the plain product."""
    cfg = _ad_cfg(2, 64, latent_in=(2,), use_dropout=dropout != "off",
                  dropout_impl="pallas")
    runs = []
    for hidden in (bl.bf16_linear, bl.bf16_linear_reference):
        if dropout == "off":
            monkeypatch.setattr(decoder_module, "bf16_linear", hidden)
        elif hidden is bl.bf16_linear_reference:
            monkeypatch.setattr(
                decoder_module, "bf16_linear_relu_dropout",
                lambda x, w, b, seed, rate, layout:
                bl.bf16_linear_relu_dropout_reference(
                    x, w, b, seed, rate, linear=bl.bf16_linear_reference))
        st = tad.init_ad_state(cfg, seed=2, device="cpu")
        step = tad.make_ad_train_step(st.decoder, cfg)
        losses = [float(step(st, *_batch(cfg, i), float(i), i)["loss"])
                  for i in range(3)]
        runs.append((losses, st.decoder.state_dict(), st.codes.detach()))
    (l1, sd1, c1), (l2, sd2, c2) = runs
    assert l1 == l2
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert torch.equal(c1, c2)


# ---------------------- (c) the tensor cores' arithmetic, emulated in f64

def test_tensor_core_arithmetic_agrees_with_plain_version():
    """Exact products of the bf16 operands summed in float64 and rounded
    to fp32 (to bf16 for dx, dW), against the plain version's fp32
    products: each element within K * 2^-24 of its sum of |products|
    (fp32 summation error), plus one bf16 spacing where the result is
    rounded to bf16."""
    rng = np.random.default_rng(0)
    N, K, O = 512, 512, 253
    x = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(BF)
    w = torch.from_numpy((rng.normal(size=(O, K)) / np.sqrt(K)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(size=O).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, O)).astype(np.float32)).to(
        BF).float()
    xr = x.float().requires_grad_()
    wr = w.clone().requires_grad_()
    y_ref = bl.bf16_linear_reference(xr, wr, b)
    y_ref.backward(g)
    dx_ref, dw_ref = xr.grad.to(BF), wr.grad
    x64, w64, g64 = x.double(), w.to(BF).double(), g.double()

    def close(emul64, ref, abs_sum, k, bf16_out):
        want = emul64.float()
        if bf16_out:
            want = want.to(BF).float()
        tol = k * U32 * abs_sum.float() + (ULP_BF16 * want.abs()
                                           if bf16_out else 0)
        assert bool(((ref.float() - want).abs() <= tol).all())

    close(x64 @ w64.t() + b.double(), y_ref.detach(),
          x64.abs() @ w64.abs().t() + b.double().abs(), K + 1, False)
    close(g64 @ w64, dx_ref, g64.abs() @ w64.abs(), O, True)
    close(g64.t() @ x64, dw_ref, g64.abs().t() @ x64.abs(), N, True)


# ----------------------------------------------- flags, input checks

@pytest.mark.parametrize("reduced", [(False, False), (False, True),
                                     (True, True)])
def test_flags_are_put_back_also_when_the_block_raises(reduced):
    """_tensor_core_flags turns bf16 reduced-precision reduction off inside,
    keeps its split-K half and TF32 as they were, and restores the flag
    after, also on an exception; from each setting of the two halves that
    torch accepts (split-K off needs reduced precision off)."""
    m = torch.backends.cuda.matmul

    def flags():
        return (m.allow_bf16_reduced_precision_reduction,
                m.allow_bf16_reduced_precision_reduction_split_k,
                m.allow_tf32)

    saved = flags()
    try:
        m.allow_bf16_reduced_precision_reduction = reduced
        before = flags()
        assert before[:2] == reduced
        with pytest.raises(RuntimeError):
            with bl._tensor_core_flags():
                assert flags() == (False,) + before[1:]
                raise RuntimeError("inside")
        assert flags() == before
    finally:
        m.allow_bf16_reduced_precision_reduction = saved[:2]


def test_bf16_linear_takes_bf16_inputs_only():
    with pytest.raises(ValueError, match="bfloat16"):
        bl.bf16_linear(torch.zeros(4, 3), torch.zeros(2, 3), torch.zeros(2))


# ------------------------------------------- (d) fp32 stays as it was

@pytest.mark.parametrize("plan", [dict(latent_in=(2,)),
                                  dict(latent_in=(), use_tanh=True,
                                       xyz_in_all=True)])
def test_fp32_decoder_is_untouched(plan, monkeypatch):
    """compute_dtype float32: the forward equals F.linear layer by layer
    with TF32 off, bit for bit, and never reaches bf16_linear."""
    def refuse(*a):
        raise AssertionError("fp32 decoder reached bf16_linear")

    monkeypatch.setattr(decoder_module, "bf16_linear", refuse)
    torch.manual_seed(0)
    dec = SdfDecoder(tcfg.DecoderConfig(latent_size=8, hidden_dim=32,
                                        num_layers=4, use_dropout=False,
                                        **plan)).eval()
    z, xyz = torch.randn(200, 8), torch.rand(200, 3) * 2 - 1
    assert not torch.backends.cuda.matmul.allow_tf32
    got = dec(z, xyz)
    inp = torch.cat([z, xyz], -1)
    x = inp
    plan_dims = dec.layer_dims()
    for layer, (_, _, skip) in enumerate(plan_dims):
        if skip:
            x = torch.cat([x, inp], -1)
        elif dec.cfg.xyz_in_all and layer != 0:
            x = torch.cat([x, xyz], -1)
        lin = getattr(dec, f"lin{layer}")
        x = F.linear(x, lin.weight(), lin.b)
        if layer < len(plan_dims) - 1:
            x = torch.relu(x)
    if dec.cfg.use_tanh:
        x = torch.tanh(x)
    assert torch.equal(got, x[:, 0])
