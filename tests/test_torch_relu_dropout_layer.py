"""The bf16 decoder's hidden layer with relu + dropout as one function
(`ops.bf16_linear.bf16_linear_relu_dropout`) and kernels #3/#3b's layer
entries (`ops.relu_dropout.bias_relu_dropout_fwd`, `relu_dropout_bwd_out`)
on the CPU, where they run their plain versions.

(a) the forward's plain version is relu_dropout_reference of bf16(yf + b),
and the layer's forward the composition it replaces, bit for bit;
(b) the backward from the output equals the x-reading backward bit for
bit, also on zeros, -0, NaN, infinities, subnormal and tiny values, and
out > 0 iff keep & (x > 0) for every bf16 value; (c) db, by torch's sum
and in the kernel's fixed order (`db_kernel_order`, checked against a
literal transcription of the kernel's loops), within 2^-17 of each
column's sum of |terms| of the float64 sum; (d) three autograd training
steps through the layer equal the composition's bit for bit; (e) given
JAX's mask, the layer's forward and VJP equal the JAX package's WNLinear
bf16 branch + relu_dropout. The kernels themselves are held to these
plain versions in tests/test_torch_gpu.py on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    WNLinear as JaxWNLinear)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.pallas_kernels import (
    _dropout_keep_mask_xla, relu_dropout as jax_relu_dropout)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models import (
    decoder as decoder_module)
from latent_diffusion_models_for_shape_sdfs_torch.ops import bf16_linear as bl
from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

torch.set_num_threads(2)

BF = torch.bfloat16
U32 = 2.0 ** -24
DB_TOL = 2.0 ** -17
WIDTHS = [512, 253, 37]             # the 8x512 decoder's two, and odd
ROWS = [131, 69]                    # not a multiple of either tile (32, 64)


def _layer_operands(rows, cols, seed=0):
    rng = np.random.default_rng(seed + rows + cols)
    yf = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32))
    yf[::7] = 0.0
    b = torch.from_numpy(rng.normal(size=cols).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(rows, cols)).astype(
        np.float32)).to(BF)
    return yf, b, g


# ------------------------------------------------------------ (a) forward

@pytest.mark.parametrize("cols", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_forward_is_relu_dropout_of_the_rounded_sum(cols, rows, rate):
    """bias_relu_dropout_fwd == relu_dropout_reference(bf16(yf + b)), and
    the layer's forward == the composition, bit for bit."""
    yf, b, _ = _layer_operands(rows, cols)
    out = rd.bias_relu_dropout_fwd(yf, b, 11, rate)
    assert out.dtype == BF
    assert torch.equal(out, rd.relu_dropout_reference((yf + b).to(BF), 11,
                                                      rate))
    rng = np.random.default_rng(cols)
    x = torch.from_numpy(rng.normal(size=(rows, 48)).astype(np.float32)).to(
        BF)
    w = torch.from_numpy(rng.normal(size=(cols, 48)).astype(np.float32) / 7)
    assert torch.equal(bl.bf16_linear_relu_dropout(x, w, b, 11, rate),
                       bl.bf16_linear_relu_dropout_reference(x, w, b, 11,
                                                             rate))


# ----------------------------------------------------------- (b) backward

def _special_bf16(rows, cols, seed):
    """Normals with zeros, -0, NaN, +-inf, the smallest subnormal, the
    smallest normal and other tiny values strewn in."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(rows, cols)).astype(np.float32)
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 2.0 ** -133,
                        -2.0 ** -133, 2.0 ** -126, 2.0 ** -130, 1e-38,
                        3.3e38, -1e-30], np.float32)
    idx = rng.random((rows, cols)) < 0.3
    v[idx] = rng.choice(special, int(idx.sum()))
    return torch.from_numpy(v).to(BF)


@pytest.mark.parametrize("cols", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_backward_from_output_is_the_masked_cotangent(cols, rows, rate):
    """gb from the forward's output == relu_dropout_bwd_reference at the
    pre-activation, bit for bit, on special values in x and in g; db its
    column sums in fp32."""
    x = _special_bf16(rows, cols, cols)
    g = _special_bf16(rows, cols, cols + 1)
    out = rd.relu_dropout_reference(x, 5, rate)
    gb, db = rd.relu_dropout_bwd_out(out, g, rate)
    want = rd.relu_dropout_bwd_reference(x, g, 5, rate)
    assert gb.dtype == BF
    assert torch.equal(gb.view(torch.int16), want.view(torch.int16))
    torch.testing.assert_close(db, gb.float().sum(0), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.2, 0.5, 0.9, 0.99])
def test_output_positive_iff_kept_and_positive_for_every_bf16(rate):
    """out > 0 <=> keep & (x > 0) over all 65,536 bf16 bit patterns of x:
    a kept positive times scale >= 1 stays positive (subnormals too), and
    NaN, -0 and negatives give +0; so the backward needs no mask."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(BF).reshape(256, 256)
    out = rd.relu_dropout_reference(x, 3, rate)
    keep = rd.dropout_keep_mask(256, 256, 3, rate)
    assert torch.equal(out.float() > 0, keep & (x.float() > 0))
    assert bool((out.view(torch.int16)[~(out.float() > 0)] == 0).all())


def test_layer_entries_check_their_inputs():
    yf, b, g = _layer_operands(8, 16)
    with pytest.raises(ValueError, match="float32"):
        rd.bias_relu_dropout_fwd(yf.to(BF), b, 1, 0.2)
    with pytest.raises(ValueError, match="b "):
        rd.bias_relu_dropout_fwd(yf, b[:-1], 1, 0.2)
    out = rd.bias_relu_dropout_fwd(yf, b, 1, 0.2)
    with pytest.raises(ValueError, match="bfloat16"):
        rd.relu_dropout_bwd_out(out, g.float(), 0.2)
    with pytest.raises(ValueError, match="g "):
        rd.relu_dropout_bwd_out(out, g[:-1], 0.2)
    with pytest.raises(ValueError, match="bfloat16"):
        bl.bf16_linear_relu_dropout(yf, torch.zeros(4, 16), torch.zeros(4),
                                    1, 0.2)
    n0 = profiling.LAUNCHES.copy()
    rd.relu_dropout_bwd_out(out, g, 0.2)
    assert profiling.LAUNCHES == n0


# ----------------------------------------------------------------- (c) db

def _db_ok(db, gb):
    exact = gb.double().sum(0)
    return bool(((db.double() - exact).abs()
                 <= DB_TOL * gb.double().abs().sum(0)).all())


def _db_literal(gb, plan):
    """The kernel's loops (csrc/relu_dropout.cu bwd_out_*_kernel and
    colsum_reduce_kernel) written out in float32 scalars."""
    a = gb.float().numpy()
    rows, cols = a.shape
    R, L, G = plan.tile_rows, plan.lanes, plan.ctas
    tiles = -(-rows // R)
    f = np.float32
    part = np.zeros((G, cols), np.float32)
    for blk in range(G):
        for c in range(cols):
            outer = [f(0)] * L
            for t in range(blk, tiles, G):
                for lane in range(L):
                    inner = f(0)
                    for r in range(t * R + lane, min(rows, (t + 1) * R), L):
                        inner = f(inner + a[r, c])
                    outer[lane] = f(outer[lane] + inner)
            s = outer[0]
            for lane in range(1, L):
                s = f(s + outer[lane])
            part[blk, c] = s
    per = -(-G // 32)
    db = np.zeros(cols, np.float32)
    for c in range(cols):
        sl = []
        for s_ in range(32):
            lo, hi = s_ * per, min(G, s_ * per + per)
            outer = f(0)
            for i0 in range(lo, hi, 16):
                inner = f(0)
                for i in range(i0, min(i0 + 16, hi)):
                    inner = f(inner + part[i, c])
                outer = f(outer + inner)
            sl.append(outer)
        w = 16
        while w >= 1:
            for s_ in range(w):
                sl[s_] = f(sl[s_] + sl[s_ + w])
            w //= 2
        db[c] = sl[0]
    return torch.from_numpy(db)


@pytest.mark.parametrize("plan", [
    rd.BwdPlan(True, 64, 4, 3), rd.BwdPlan(True, 16, 3, 2),
    rd.BwdPlan(False, 32, 1, 5), rd.BwdPlan(False, 8, 1, 40)])
def test_db_order_model_is_the_kernels_loops(plan):
    """db_kernel_order (vectorised, zero-padded) equals the kernel's loops
    transcribed literally, bit for bit, with CTAs that take several tiles,
    lanes that do not divide the tile and a ragged last tile."""
    gb = _special_bf16(333, 6, 2).nan_to_num(0.0, 0.0, 0.0)
    assert torch.equal(rd.db_kernel_order(gb, plan), _db_literal(gb, plan))


@pytest.mark.parametrize("cols", WIDTHS)
@pytest.mark.parametrize("rows", [69, 5000])
@pytest.mark.parametrize("aligned", [True, False])
def test_db_within_tolerance_of_float64(cols, rows, aligned):
    """db in the kernel's order for the plan the kernel would take, and
    (below 128 rows, where any order's depth stays under 128) the plain
    version's torch sum: each column within 2^-17 of its sum of |terms|
    from the float64 sum of the same bf16 values. The kernel order's
    depth (in-tile rows, tiles a CTA, lanes, 16 + 2 partial blocks, 5
    tree levels) stays under 128 at 2^20 rows too, so 2^-17 holds
    whatever the signs (test_bwd_plan_fits_the_kernel)."""
    rng = np.random.default_rng(rows)
    g = torch.from_numpy((rng.normal(size=(rows, cols)) + 0.3).astype(
        np.float32)).to(BF)
    out = torch.from_numpy(rng.normal(size=(rows, cols)).astype(
        np.float32)).to(BF)
    gb, db = rd.relu_dropout_bwd_out_reference(out, g, 0.2)
    plan = rd.bwd_plan(rows, cols, aligned)
    assert _db_ok(rd.db_kernel_order(gb, plan), gb)
    if rows < 128:
        assert _db_ok(db, gb)


@pytest.mark.parametrize("rows,cols,aligned", [
    (1 << 20, 512, True), (1 << 20, 253, True), ((1 << 20) + 131, 512, True),
    (1 << 20, 512, False), (77, 8, True), (5, 2048, True), (5, 2056, True),
    (1000, 5000, True)])
def test_bwd_plan_fits_the_kernel(rows, cols, aligned):
    """Each plan keeps the kernel's constraints: tiles of a multiple of 8
    rows, the row path only at 16-byte rows of <= 256 threads' 8 columns,
    the tile path's two bf16 tiles and column sums in shared memory, a
    grid of at most 528 CTAs none of which is idle; and the depth of
    db's summation at the canonical widths under 128 terms."""
    plan = rd.bwd_plan(rows, cols, aligned)
    tiles = -(-rows // plan.tile_rows)
    assert plan.tile_rows % 8 == 0 and 1 <= plan.ctas <= min(tiles, 528)
    if plan.vec:
        assert aligned and cols % 8 == 0
        assert plan.lanes * (cols // 8) <= 256
    else:
        assert plan.lanes == 1
        assert 2 * rd._region(plan.tile_rows * cols, 2) + 4 * cols \
            <= rd._SMEM_MAX
    if rows >= 1 << 20:
        depth = (-(-plan.tile_rows // plan.lanes) + -(-tiles // plan.ctas)
                 + plan.lanes + 16 + -(-plan.ctas // 32 // 16) + 5)
        assert depth < 128


def test_bwd_plan_refuses_rows_no_tile_holds():
    with pytest.raises(ValueError, match="shared memory"):
        rd.bwd_plan(10, 20000, False)


# ------------------------------------- (d) training steps, bit for bit

def _ad_cfg(**decoder):
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        compute_dtype="bfloat16", use_dropout=True, dropout_impl="pallas",
        dropout_prob=0.2, **decoder), num_scenes=3, scenes_per_batch=2,
        samples_per_scene=64, clamp_dist=1.0)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    S, P = cfg.scenes_per_batch, cfg.samples_per_scene
    ids = torch.from_numpy(rng.permutation(cfg.num_scenes)[:S])
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    sdf = torch.from_numpy((0.3 * rng.normal(size=(S, P))).astype(
        np.float32))
    return ids, xyz.to(BF), sdf


@pytest.mark.parametrize("plan", [
    dict(latent_size=8, hidden_dim=32, num_layers=4, latent_in=(2,)),
    dict(latent_size=13, hidden_dim=64, num_layers=3, latent_in=(2,)),
    dict(latent_size=8, hidden_dim=32, num_layers=4, latent_in=(2,),
         xyz_in_all=True)])
def test_training_steps_equal_the_composition(plan, monkeypatch):
    """Three autograd steps of a bf16 decoder with a skip layer and
    dropout, its hidden layers through bf16_linear_relu_dropout (the route
    configs 3-5 take), equal the same steps with that layer substituted
    by its composition, bf16_linear_relu_dropout_reference (bf16_linear,
    the cast and relu_dropout: the form before the layer): loss, every
    parameter and the codes."""
    cfg = _ad_cfg(**plan)
    calls = []
    runs = []
    for layer in (bl.bf16_linear_relu_dropout,
                  bl.bf16_linear_relu_dropout_reference):
        monkeypatch.setattr(
            decoder_module, "bf16_linear_relu_dropout",
            lambda *a, layer=layer: calls.append(layer) or layer(*a))
        st = tad.init_ad_state(cfg, seed=2, device="cpu")
        step = tad.make_ad_train_step(st.decoder, cfg)
        losses = [float(step(st, *_batch(cfg, i), float(i), i)["loss"])
                  for i in range(3)]
        runs.append((losses, st.decoder.state_dict(), st.codes.detach()))
    (l1, sd1, c1), (l2, sd2, c2) = runs
    n = 3 * cfg.decoder.num_layers
    assert calls == [bl.bf16_linear_relu_dropout] * n + [
        bl.bf16_linear_relu_dropout_reference] * n
    assert l1 == l2
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert torch.equal(c1, c2)


@pytest.mark.parametrize("xyz_in_all", [False, True])
def test_kernel_dropout_route_reads_no_product_seam(xyz_in_all, monkeypatch):
    """A bf16 training step with kernel dropout sends every hidden layer
    through bf16_linear_relu_dropout, with no layout on the CPU, even
    with the decoder's bf16_linear replaced: the route depends on the
    configuration alone."""
    cfg = _ad_cfg(latent_size=8, hidden_dim=32, num_layers=4,
                  latent_in=(2,), xyz_in_all=xyz_in_all)
    layers = []
    fused = decoder_module.bf16_linear_relu_dropout

    def refuse(*a):
        raise AssertionError("the kernel-dropout route reached bf16_linear")

    def seen(x, w, b, seed, rate, runs):
        layers.append((tuple(w.shape), runs))
        return fused(x, w, b, seed, rate, runs)

    monkeypatch.setattr(decoder_module, "bf16_linear", refuse)
    monkeypatch.setattr(decoder_module, "bf16_linear_relu_dropout", seen)
    st = tad.init_ad_state(cfg, seed=2, device="cpu")
    step = tad.make_ad_train_step(st.decoder, cfg)
    step(st, *_batch(cfg, 0), 0.0, 1)
    hidden = st.decoder.layer_dims()[:-1]
    assert layers == [((out, d_in), None) for d_in, out, _ in hidden]


def test_layer_saves_its_output_not_the_pre_activation():
    """The layer keeps x, bf16(W) and its own output for the backward: no
    fp32 or bf16 pre-activation."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32)).to(
        BF).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(16, 24)).astype(
        np.float32)).requires_grad_()
    b = torch.zeros(16, requires_grad=True)
    out = bl.bf16_linear_relu_dropout(x, w, b, 1, 0.2)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(40, 24), (16, 24), (40, 16)]
    assert [t.dtype for t in saved] == [BF, BF, BF]
    assert torch.equal(saved[2], out.detach())


# -------------------------------- (e) against the JAX package, its mask

@pytest.mark.parametrize("d_in,d_out", [(48, 64), (64, 37)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_layer_matches_jax_with_its_mask(d_in, d_out, rate, monkeypatch):
    """Given JAX's own mask (as tests/test_torch_relu_dropout.py feeds
    it), the layer's output and its gradients in x, W and b equal JAX's
    WNLinear bf16 branch (weight norm off, so W = v^T) + relu_dropout and
    its VJP. The products are exact (bf16 operands) and only the fp32 sum
    order differs, so each output is held within one bf16 spacing of
    JAX's plus twice the fp32 sum error bound (K * 2^-24 of the sum of
    |terms|, times scale); db, an fp32 sum of the same bf16 values, to
    rows * 2^-24 of its sum of |terms|."""
    rows = 69
    rng = np.random.default_rng(d_in + d_out)
    x_np = rng.normal(size=(rows, d_in)).astype(np.float32)
    v_np = (rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)
    b_np = rng.normal(size=d_out).astype(np.float32) * 0.1
    g_np = rng.normal(size=(rows, d_out)).astype(np.float32)
    seed = jnp.asarray(7, jnp.int32)
    lin = JaxWNLinear(d_out, use_weight_norm=False)

    def jax_layer(x, v, b):
        y = lin.apply({"params": {"v": v, "b": b}}, x)
        return jax_relu_dropout(y.astype(jnp.bfloat16), seed, rate)

    xj = jnp.asarray(x_np).astype(jnp.bfloat16)
    yj, vjp = jax.vjp(jax_layer, xj, jnp.asarray(v_np), jnp.asarray(b_np))
    gj = vjp(jnp.asarray(g_np).astype(jnp.bfloat16))
    mask = torch.from_numpy(np.array(
        _dropout_keep_mask_xla((rows, d_out), seed, rate)))
    monkeypatch.setattr(rd, "dropout_keep_mask", lambda *a, **k: mask)

    x = torch.from_numpy(x_np).to(BF).requires_grad_()
    w = torch.from_numpy(v_np.T.copy()).requires_grad_()
    b = torch.from_numpy(b_np).requires_grad_()
    out = bl.bf16_linear_relu_dropout(x, w, b, 7, rate)
    out.backward(torch.from_numpy(g_np).to(BF))

    scale = 1.0 / (1.0 - rate)
    x64, w64 = x.detach().double(), w.detach().to(BF).double()
    g64 = out.detach().double().gt(0) * torch.from_numpy(g_np).to(
        BF).double() * scale

    def close(got, ref, bound):
        got, ref = got.double(), torch.from_numpy(
            np.array(ref.astype(jnp.float32))).double()
        tol = 2.0 ** -7 * torch.maximum(got.abs(), ref.abs()) + 2 * bound
        assert bool(((got - ref).abs() <= tol).all())

    close(out.detach(), yj,
          scale * d_in * U32 * (x64.abs() @ w64.abs().t()
                                + b.detach().double().abs()))
    close(x.grad, gj[0], d_out * U32 * (g64.abs() @ w64.abs()))
    close(w.grad.t(), gj[1], rows * U32 * (x64.abs().t() @ g64.abs()))
    db_ref = torch.from_numpy(np.array(gj[2])).double()
    assert bool(((b.grad.double() - db_ref).abs()
                 <= 2 * rows * U32 * g64.abs().sum(0)).all())
