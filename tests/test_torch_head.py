"""ops.head: the bf16 decoder's scalar head (512 -> 1) as one autograd
function over csrc/head.cu's two kernels, held on the CPU to the plain
form it replaces on the card, `bf16_linear_reference` under autograd.

(a) the function on the CPU is the plain form bit for bit: pred, dx, dW
and db, for every subset of the inputs autograd asks gradients of, at
row shapes of one and two dimensions and cotangents that are not
bf16-valued; (b) the decoder, whose bf16 head goes through the function
on either device, equals the former composition (the head through
`bf16_linear_reference`) bit for bit over training steps, an eval forward
and a reconstruction's gradient; (c) an fp32 head keeps WNLinear's fp32
product, and the CPU launches nothing. The same comparisons on the card
are in tests/test_torch_gpu.py. No JAX."""

import itertools

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models import (
    decoder as decoder_module)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear import (
    bf16_linear_reference)
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

torch.set_num_threads(2)

BF = torch.bfloat16
INPUTS = ("x", "w", "b")
SUBSETS = [s for k in (1, 2, 3) for s in itertools.combinations(INPUTS, k)]


def _operands(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(*rows, cols)).astype(
        np.float32)).to(BF)
    w = torch.from_numpy((rng.normal(size=(1, cols)) / np.sqrt(cols))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=1).astype(np.float32))
    return x, w, b


def _cotangent(rows, kind, seed):
    """[*rows, 1] fp32: the loss's +-1/n or 0, or random fp32 values;
    neither bf16-valued."""
    rng = np.random.default_rng(seed + 1)
    n = int(np.prod(rows))
    if kind == "loss":
        g = rng.choice([-1.0, 0.0, 1.0], size=(*rows, 1)) / (n + 3)
    else:
        g = rng.normal(size=(*rows, 1))
    return torch.from_numpy(g.astype(np.float32))


def _grads(fn, x, w, b, g, wants):
    xs = x.clone().requires_grad_("x" in wants)
    ws = w.clone().requires_grad_("w" in wants)
    bs = b.clone().requires_grad_("b" in wants)
    y = fn(xs, ws, bs)
    y.backward(g)
    return y.detach(), {k: t.grad for k, t in zip(INPUTS, (xs, ws, bs))}


# ------------------------------- (a) the function is the plain form

@pytest.mark.parametrize("rows,cols", [((300,), 512), ((2, 70), 512),
                                       ((257,), 264), ((5,), 8)])
@pytest.mark.parametrize("wants", SUBSETS, ids="+".join)
@pytest.mark.parametrize("kind", ["loss", "random"])
def test_function_is_the_plain_form_bit_for_bit(rows, cols, wants, kind):
    """pred and every gradient autograd asks for, against autograd of
    bf16_linear_reference on the same inputs: the same dtype, shape and
    bits; the others None."""
    x, w, b = _operands(rows, cols, cols + len(rows))
    g = _cotangent(rows, kind, cols)
    y, got = _grads(hd.bf16_head, x, w, b, g, wants)
    y_ref, ref = _grads(bf16_linear_reference, x, w, b, g, wants)
    assert y.dtype == torch.float32 and y.shape == (*rows, 1)
    assert torch.equal(y, y_ref)
    for k in INPUTS:
        if k not in wants:
            assert got[k] is None and ref[k] is None
            continue
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])
    if "x" in wants:
        assert got["x"].dtype == BF


def test_function_keeps_no_fp32_copy_of_x():
    """The function saves x itself (the storage the layer before keeps)
    and bf16(w), and nothing fp32 of x's size."""
    x, w, b = _operands((64,), 512, 0)
    x.requires_grad_()
    w.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        hd.bf16_head(x, w, b)
    assert [t.dtype for t in saved] == [BF, BF]
    assert saved[0].data_ptr() == x.data_ptr()
    assert saved[1].shape == (1, 512)


def test_function_refuses_what_it_does_not_take():
    x, w, b = _operands((4,), 16, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        hd.bf16_head(x.float(), w, b)
    with pytest.raises(ValueError, match=r"\[1, C\]"):
        hd.bf16_head(x, w.expand(2, 16), b)
    with pytest.raises(ValueError, match=r"\[1, C\]"):
        hd.bf16_head(x, w.to(BF), b)


# ------------------------ (b) the decoder through the function

def _ad_cfg(**decoder):
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        latent_size=8, hidden_dim=64, num_layers=4, compute_dtype="bfloat16",
        **decoder), num_scenes=3, scenes_per_batch=2, samples_per_scene=48,
        clamp_dist=1.0)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    S, P = cfg.scenes_per_batch, cfg.samples_per_scene
    ids = torch.from_numpy(rng.permutation(cfg.num_scenes)[:S])
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    sdf = torch.from_numpy((0.3 * rng.normal(size=(S, P))).astype(
        np.float32))
    return ids, xyz.to(BF), sdf


@pytest.mark.parametrize("plan", [
    dict(latent_in=(2,), use_dropout=True, dropout_impl="pallas"),
    dict(latent_in=(2,), use_dropout=True, dropout_impl="xla"),
    dict(latent_in=(), use_dropout=False, use_tanh=True),
    dict(latent_in=(2,), use_dropout=False, xyz_in_all=True)],
    ids=["pallas", "xla", "tanh", "xyz_in_all"])
def test_decoder_through_the_function_equals_the_former_composition(
        plan, monkeypatch):
    """Three autograd steps with the head through bf16_head equal, bit for
    bit, the same steps with the head through bf16_linear_reference (the
    former composition, WNLinear's bf16 form): losses, every parameter,
    the codes; the function ran once a step, and nothing was launched."""
    cfg = _ad_cfg(**plan)
    before = profiling.LAUNCHES.copy()
    runs, calls = [], []
    real = hd.bf16_head

    def counted(*a):
        calls.append(1)
        return real(*a)

    for head in (counted, bf16_linear_reference):
        monkeypatch.setattr(hd, "bf16_head", head)
        st = tad.init_ad_state(cfg, seed=4, device="cpu")
        step = tad.make_ad_train_step(st.decoder, cfg)
        losses = [float(step(st, *_batch(cfg, i), float(i), 10 + i)["loss"])
                  for i in range(3)]
        runs.append((losses, st.decoder.state_dict(), st.codes.detach()))
    (l1, sd1, c1), (l2, sd2, c2) = runs
    assert len(calls) == 3
    assert l1 == l2
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert torch.equal(c1, c2)
    assert profiling.LAUNCHES == before


def test_decoder_forward_alone_and_dx_alone(monkeypatch):
    """An eval forward (no gradient) and a reconstruction's gradient of
    the codes alone (the decoder frozen) through the function equal the
    former composition bit for bit, and reach the function."""
    torch.manual_seed(0)
    dec = SdfDecoder(tcfg.DecoderConfig(
        latent_size=8, hidden_dim=64, num_layers=4, latent_in=(2,),
        use_dropout=False, compute_dtype="bfloat16")).eval()
    for p in dec.parameters():
        p.requires_grad_(False)
    z0 = torch.randn(3, 1, 8) / 3
    xyz = torch.rand(3, 40, 3) * 2 - 1
    sdf = torch.randn(3, 40) * 0.1
    out, calls = [], []
    real = hd.bf16_head

    def counted(*a):
        calls.append(1)
        return real(*a)

    for head in (counted, bf16_linear_reference):
        monkeypatch.setattr(hd, "bf16_head", head)
        with torch.no_grad():
            pred = dec(z0.expand(3, 40, 8), xyz)
        z = z0.clone().requires_grad_()
        loss = torch.abs(dec(z.expand(3, 40, 8), xyz) - sdf).sum() / 120
        gz, = torch.autograd.grad(loss, z)
        out.append((pred, gz))
    assert len(calls) == 2
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# --------------------------- (c) where the kernels engage

def test_the_kernels_take_bf16_card_rows_of_whole_16_bytes_only():
    """takes() is False on the CPU (any dtype) and on the meta device;
    bf16_head on the CPU takes any width (the plain form's arithmetic)
    and refuses the meta device."""
    for t in (torch.zeros(4, 512, dtype=BF), torch.zeros(4, 512),
              torch.zeros(4, 512, dtype=BF, device="meta")):
        assert not hd.takes(t)
    assert hd.MAX_COLS == 2048
    x, w, b = _operands((5,), 13, 0)
    assert torch.equal(hd.bf16_head(x, w, b), bf16_linear_reference(x, w, b))
    with pytest.raises(ValueError, match="meta"):
        hd.bf16_head(x.to("meta"), w.to("meta"), b.to("meta"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cpu_decoder_launches_nothing_and_keeps_the_plain_form(
        dtype, monkeypatch):
    """A CPU training step: a bf16 head goes through bf16_head (the plain
    form's arithmetic) and not WNLinear.forward, an fp32 head through
    WNLinear.forward and not bf16_head; nothing is launched."""
    heads, seen = [], []
    real_head = hd.bf16_head
    real = decoder_module.WNLinear.forward

    def head(x, w, b):
        heads.append(x.dtype)
        return real_head(x, w, b)

    def spy(self, x):
        seen.append(x.dtype)
        return real(self, x)

    monkeypatch.setattr(hd, "bf16_head", head)
    monkeypatch.setattr(decoder_module.WNLinear, "forward", spy)
    cfg = tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        latent_size=8, hidden_dim=64, num_layers=4, compute_dtype=dtype,
        use_dropout=False), num_scenes=3, scenes_per_batch=2,
        samples_per_scene=48, clamp_dist=1.0)
    before = profiling.LAUNCHES.copy()
    st = tad.init_ad_state(cfg, seed=4, device="cpu")
    step = tad.make_ad_train_step(st.decoder, cfg)
    ids, xyz, sdf = _batch(cfg, 0)
    step(st, ids, xyz.float(), sdf, 0.0, 1)
    if dtype == "bfloat16":
        assert heads == [BF] and seen == []
    else:
        assert heads == [] and seen and set(seen) == {torch.float32}
    assert profiling.LAUNCHES == before
