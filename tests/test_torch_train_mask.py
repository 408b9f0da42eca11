"""Kernel #4's keep bits and column partials, on the CPU.

The forward of the fused train pass (csrc/fused_train.cu: the engine's
forward epilogue, layer0_kernel) writes one keep bit per element of each
hidden activation, bf16(h) > 0, in the tile-native layout modelled by
ops/train_gemm.py (`keep_bit`, `pack_keep_bits`); the dgrad masks with
those bits instead of reading h_prev, and emits each tile's column sums of
the g it writes (`column_partials_reference`), from which the pass takes
db, gsum and the xyz-weighted sums that a separate kernel used to re-read
g for. Checked here: the layout against the engine's accumulator map, the
pack/unpack pair, the plain versions against the forms they replace, and
the pass's dataflow through the roles' plain versions against the JAX
package's Pallas kernel in interpret mode (rate 0; tolerances as
tests/test_torch_fused_train.py: loss 1e-4 relative, every gradient 1e-2
of its largest entry). The kernels are held against these plain versions
on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_train import (
    fused_train_loss_grads as jax_fused)
from latent_diffusion_models_for_shape_sdfs_tpu.train import auto_decoder as jad
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
from latent_diffusion_models_for_shape_sdfs_torch.ops import train_gemm as tg
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.ops.relu_dropout import (
    dropout_keep_mask)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    params_from_jax)

import jax

torch.set_num_threads(2)
BF = torch.bfloat16


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).to(BF)


# ----------------------------------------------------------- the layout

WIDTH = {128: 384, 256: 512}       # an activation width of each tile width


@pytest.mark.parametrize("bn", [128, 256])
def test_keep_layout_covers_every_element_once(bn):
    """Every (row, col) of an [M, n] activation (two row tiles; three
    column tiles of width 128 or two of 256) has its own (word, bit), and
    together they fill the M n / 32 words."""
    m, n = 256, WIDTH[bn]
    assert tg.tile_width(n) == bn
    seen = {tg.keep_bit(r, c, n) for r in range(m) for c in range(n)}
    assert seen == {(w, b) for w in range(m * n // 32) for b in range(32)}


@pytest.mark.parametrize("bn", [128, 256])
def test_keep_layout_follows_the_accumulator_map(bn):
    """The bit of accumulator i of each engine thread (acc_coords, the map
    test_accumulator_map_and_dropout_exchange models) lies in the thread's
    own BN/64 consecutive words, where keep_acc_bit puts it, for tiles in
    every position of a [256, n] activation: the forward epilogue writes
    and the dgrad reads the bits of the values they hold."""
    m, n = 256, WIDTH[bn]
    nt = n // bn
    for tile in range(m // 128 * nt):
        m0, n0 = (tile // nt) * 128, (tile % nt) * bn
        words = set()
        for wg in range(2):
            for warp in range(4):
                for lane in range(32):
                    first = tg.keep_word(tile, wg, warp, lane, bn)
                    mine = set()
                    for i in range(bn // 2):
                        r, c = tg.acc_coords(warp, lane, i)
                        got = tg.keep_bit(m0 + 64 * wg + r, n0 + c, n)
                        w, b = tg.keep_acc_bit(i)
                        assert got == (first + w, b)
                        mine.add(got)
                        words.add(got[0])
                    assert mine == {(first + w, b) for w in range(bn // 64)
                                    for b in range(32)}
        assert words == set(range(tile * 128 * bn // 32,
                                  (tile + 1) * 128 * bn // 32))


def test_keep_bits_of_a_column_block_are_the_kernels_flag_shifts():
    """keep_acc_bit places column block j's four bits where the kernel's
    shifts of the two pairs' flags (bits 15 and 31) put them: pair (r0, c
    | c + 1) >> (15 - j % 8), pair (r1, c | c + 1) >> (7 - j % 8)."""
    for j in range(32):
        jj = j % 8
        want = {0: 15 - (15 - jj), 1: 31 - (15 - jj), 2: 15 - (7 - jj),
                3: 31 - (7 - jj)}
        for e in range(4):
            assert tg.keep_acc_bit(4 * j + e) == (j // 8, want[e])


def test_integer_keep_flags_are_bf16_positive():
    """The kernel's flags of a packed bf16 pair, ((s & 0x7fff7fff) +
    0x7fff7fff) & ~s & 0x80008000 (bits 15 and 31), are its halves' bf16
    > 0 for all 65,536 values of either half but NaN (the forward never
    stores NaN: fmaxf(NaN, 0) is 0)."""
    half = np.arange(1 << 16, dtype=np.uint32)
    value = (half << 16).view(np.float32)
    other = np.uint32(0x3F80)           # 1.0 in the other half
    for s, bit in ((half | other << 16, 15), (half << 16 | other, 31)):
        flags = ((s & 0x7FFF7FFF) + np.uint32(0x7FFF7FFF)) & ~s & 0x80008000
        got = (flags >> bit) & 1 == 1
        ok = ~np.isnan(value)
        assert np.array_equal(got[ok], (value > 0)[ok])


@pytest.mark.parametrize("m,n", [(128, 128), (256, 256), (384, 512),
                                 (128, 384)])
def test_pack_unpack_round_trip(m, n):
    """unpack(pack(mask)) is the mask, and each element's bit sits where
    keep_bit puts it (bit 31 included: the words are int32)."""
    rng = np.random.default_rng(m + n)
    keep = torch.from_numpy(rng.random((m, n)) < 0.5)
    words = tg.pack_keep_bits(keep)
    assert words.dtype == torch.int32 and words.shape == (m * n // 32,)
    assert torch.equal(tg.unpack_keep_bits(words, m, n), keep)
    w = words.numpy().view(np.uint32)
    for r, c in [(0, 0), (m - 1, n - 1), (7, 8), (8, 7), (127, 1),
                 (m // 2 + 3, n // 2 + 5)]:
        wd, b = tg.keep_bit(r, c, n)
        assert bool((w[wd] >> b) & 1) == bool(keep[r, c]), (r, c)


def test_pack_rejects_shapes_the_engine_does_not_tile():
    with pytest.raises(ValueError, match="multiple of 128"):
        tg.pack_keep_bits(torch.zeros(100, 128, dtype=torch.bool))
    with pytest.raises(ValueError, match="width"):
        tg.pack_keep_bits(torch.zeros(128, 192, dtype=torch.bool))
    with pytest.raises(ValueError, match="words"):
        tg.unpack_keep_bits(torch.zeros(4, dtype=torch.int32), 128, 128)


# ------------------------------------------------ the roles' plain versions


@pytest.mark.parametrize("scale", [1.0, 1.25])
def test_dgrad_from_bits_equals_the_hprev_form(scale):
    """gemm_dgrad_reference masked by pack_keep_bits(h_prev > 0) equals
    the former where(h_prev > 0, (g wt^T) * scale, 0) bit for bit, with
    zeros, negatives and -0 in h_prev."""
    m, k, n = 384, 256, 256
    rng = np.random.default_rng(11)
    g, wt = _bf16(rng, (m, k), 1e-3), _bf16(rng, (n, k), 1 / np.sqrt(k))
    hprev = torch.relu(_bf16(rng, (m, n)))
    hprev[0, :8] = -0.0
    hprev[1, :8] = -1.0
    got = ft.gemm_dgrad_reference(g, wt, tg.pack_keep_bits(hprev > 0), scale)
    want = torch.where(hprev > 0, (g.float() @ wt.float().T) * scale,
                       0.0).to(BF)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("with_xyz", [False, True])
def test_column_partials_sum_to_the_per_scene_sums(rows, with_xyz):
    """column_partials_reference (tiles of 128 points as the dgrad emits
    them, of 64 as the final layer's kernel does) summed per scene equal
    the per-scene sums the removed colsum kernel gave: sum g (db, gsum)
    and sum bf16(xyz) g (dW_x), to f32 summation order."""
    S, P, n = 3, 512, 256
    rng = np.random.default_rng(rows)
    g = _bf16(rng, (S * P, n), 1e-3)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S * P, 3)).astype(np.float32))
    part = ft.column_partials_reference(g, xyz if with_xyz else None, rows)
    nsum = 4 if with_xyz else 1
    assert part.shape == (S * P // rows, nsum * n)
    per_scene = part.reshape(S, P // rows, nsum, n).sum(1)
    gs = g.float().reshape(S, P, n)
    want = [gs.sum(1)]
    if with_xyz:
        xb = xyz.to(BF).float().reshape(S, P, 3)
        want += [(xb[..., c:c + 1] * gs).sum(1) for c in range(3)]
    want = torch.stack(want, 1)
    torch.testing.assert_close(per_scene, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_cpu_forward_role_writes_the_keep_bits_of_its_output(rate):
    """gemm_fwd(..., keep_bits=True) on CPU tensors: the same output as
    without, and the bits of bf16(out) > 0."""
    m, k, n, p = 512, 128, 256, 256
    rng = np.random.default_rng(5)
    h = torch.relu(_bf16(rng, (m, k)))
    w = _bf16(rng, (n, k), 1 / np.sqrt(k))
    rows = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32))
    out, bits = ft.gemm_fwd(h, w, rows, p, seed=3, rate=rate, keep_bits=True)
    assert torch.equal(out, ft.gemm_fwd(h, w, rows, p, seed=3, rate=rate))
    assert torch.equal(bits, tg.pack_keep_bits(out > 0))
    assert torch.equal(tg.unpack_keep_bits(bits, m, n), out > 0)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_cpu_layer0_is_its_plain_version(rate):
    """layer0 on CPU tensors: relu(+dropout) of the scene's row plus the
    xyz term, rounded to bf16, and the keep bits of that output."""
    S, P, n = 2, 256, 128
    rng = np.random.default_rng(6)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S * P, 3)).astype(
        np.float32)).to(BF)
    wx = _bf16(rng, (n, 3))
    rows = torch.from_numpy(rng.normal(size=(S, n)).astype(np.float32))
    out, bits = ft.layer0(xyz, rows, wx, P, seed=-9, rate=rate)
    a = torch.relu(rows.repeat_interleave(P, 0) + xyz.float() @ wx.float().T)
    if rate:
        keep = dropout_keep_mask(S * P, n, -9, rate)
        a = torch.where(keep, a * (1.0 / (1.0 - rate)), 0.0)
    assert torch.equal(out, a.to(BF))
    assert torch.equal(bits, tg.pack_keep_bits(out > 0))


# -------------------------------------- the pass's dataflow vs the Pallas kernel


def _jax_setup(S=2, P=512, L=16, H=128, layers=3, skip=(2,), seed=0):
    """tests/test_torch_fused_train.py's set-up."""
    kw = dict(num_scenes=S + 1, scenes_per_batch=S, samples_per_scene=P,
              clamp_dist=0.2, use_pallas=True)
    dkw = dict(latent_size=L, hidden_dim=H, num_layers=layers,
               latent_in=skip, use_dropout=False)
    jc = jcfg.AdConfig(decoder=jcfg.DecoderConfig(**dkw), **kw)
    tc = tcfg.AdConfig(decoder=tcfg.DecoderConfig(**dkw), **kw)
    jdec = JaxDecoder(jc.decoder)
    jst = jad.init_ad_state(jc, jdec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    ids = rng.permutation(S + 1)[:S]
    xyz = rng.uniform(-1, 1, (S, P, 3)).astype(np.float32)
    sdf = (0.15 * rng.normal(size=(S, P))).astype(np.float32)
    return jc, tc, jdec, jst, ids, xyz, sdf


def _pass_through_roles(ew, z, xyz, sdf, n_samples, clamp, rate, seed):
    """The CUDA pass's dataflow with each launch's plain version: hidden
    widths padded to multiples of 128 as the pass pads them; layer0 and
    the forward role write keep bits; the final layer emits its column
    partials per 64 points; each dgrad masks with the bits and emits its
    partials per 128 points (xyz-weighted where the layer below has w_x);
    db, gsum and dW_x come from the partials summed per scene."""
    S, P, _ = xyz.shape
    N = S * P
    n_lin = len(ew.layers)
    scale = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    zf = z.float()
    xb = xyz.reshape(N, 3).to(BF)
    true_out = [lay.b.shape[0] for lay in ew.layers]
    width = [ft._pad_to(w) for w in true_out[:-1]] + [1]
    layers = []
    for i, lay in enumerate(ew.layers):
        k_in = width[i - 1] if i > 0 else 0
        layers.append(dict(
            w_h=None if lay.w_h is None else ft._pad2(lay.w_h, width[i], k_in),
            w_z=None if lay.w_z is None else ft._pad2(lay.w_z, width[i],
                                                      z.shape[1]),
            w_x=None if lay.w_x is None else ft._pad2(lay.w_x, width[i], 3),
            b=F.pad(lay.b.float(), (0, width[i] - true_out[i]))))

    def rows(lay):
        return lay["b"] + zf.to(BF).float() @ lay["w_z"].float().T

    h, bits = ft.layer0(xb, rows(layers[0]), layers[0]["w_x"], P,
                        ft.layer_seed(seed, 0), rate)
    hs, bs = [h], [bits]
    for i in range(1, n_lin - 1):
        lay = layers[i]
        skip = lay["w_z"] is not None
        h, bits = ft.gemm_fwd(hs[-1], lay["w_h"],
                              rows(lay) if skip else lay["b"][None], P,
                              xb if skip else None,
                              lay["w_x"] if skip else None,
                              ft.layer_seed(seed, i), rate, keep_bits=True)
        hs.append(h)
        bs.append(bits)
    last = layers[-1]
    pred = (hs[-1].float() @ last["w_h"].float().T)[:, 0] + last["b"]
    diff = (torch.clamp(pred, -clamp, clamp)
            - torch.clamp(sdf.reshape(N), -clamp, clamp))
    loss = diff.abs().sum() / n_samples
    dpred = torch.where(pred.abs() < clamp, torch.sign(diff) / n_samples, 0.0)
    gl = dpred.to(BF).float()[:, None]
    grads = [None] * n_lin
    grads[-1] = {"w_h": (gl.T @ hs[-1].float())[:, :true_out[-2]],
                 "b": gl.sum(0)}
    g = torch.where(hs[-1] > 0, (gl @ last["w_h"].float()) * scale,
                    0.0).to(BF)
    part = ft.column_partials_reference(
        g, xb if layers[-2]["w_x"] is not None else None, ft.FINAL_ROWS)
    dz = torch.zeros_like(zf)
    for i in range(n_lin - 2, -1, -1):
        lay, wi, wt = layers[i], width[i], true_out[i]
        nsum = part.shape[1] // wi
        per_scene = part.reshape(S, -1, nsum, wi).sum(1)
        gr = {"b": per_scene[:, 0].sum(0)[:wt]}
        if lay["w_z"] is not None:
            gsum = per_scene[:, 0]
            gr["w_z"] = (gsum.T @ zf)[:wt]
            gr["w_x"] = per_scene[:, 1:4].sum(0).T[:wt]
            dz = dz + gsum.to(BF).float() @ lay["w_z"].float()
        if i > 0:
            gr["w_h"] = (g.float().T @ hs[i - 1].float())[
                :wt, :ew.layers[i].w_h.shape[1]]
            g, part = ft.gemm_dgrad(
                g, lay["w_h"].T.contiguous(), bs[i - 1], scale,
                xb if layers[i - 1]["w_x"] is not None else None)
        grads[i] = gr
    return loss, dz, grads


def _close(ours, ref, name):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    err = np.abs(ours - ref).max()
    assert err <= 1e-2 * np.abs(ref).max() + 1e-12, (name, err)


@pytest.mark.parametrize("skip", [(2,), (1,)])
def test_pass_dataflow_matches_pallas_interpret(skip):
    """Loss, dz and every folded gradient of the bits-and-partials
    dataflow against the JAX package's fused kernel in interpret mode,
    with the skip layer on top (its g from the final layer's partials,
    xyz-weighted) and below (from a dgrad's)."""
    jc, tc, jdec, jst, ids, xyz, sdf = _jax_setup(skip=skip)
    params = jax.tree.map(np.asarray, jst.params)
    z = np.asarray(jst.codes)[ids]
    N = xyz.shape[0] * xyz.shape[1]
    l_j, dz_j, g_j = jax_fused(jdec, params, jnp.asarray(z),
                               jnp.asarray(xyz), jnp.asarray(sdf), N,
                               jc.clamp_dist, 0.0, jnp.asarray(0, jnp.int32))
    ew = precompute_eval_weights(SdfDecoder(tc.decoder),
                                 params_from_jax(params), BF)
    loss, dz, grads = _pass_through_roles(
        ew, torch.from_numpy(z), torch.from_numpy(xyz),
        torch.from_numpy(sdf), N, tc.clamp_dist, 0.0, 0)
    assert abs(float(loss) - float(l_j)) <= 1e-4 * abs(float(l_j))
    _close(dz.numpy(), dz_j, "dz")
    for i, gr in enumerate(grads):
        gj = g_j[f"lin{i}"]
        assert set(gr) == set(gj), i
        _close(gr["b"].numpy(), gj["b"][0], f"lin{i}.b")
        if "w_h" in gr:
            _close(gr["w_h"].numpy(), np.asarray(gj["w_h"]).T, f"lin{i}.w_h")
        if "w_z" in gr:
            _close(gr["w_z"].numpy(), np.asarray(gj["w_z"]).T, f"lin{i}.w_z")
            _close(gr["w_x"].numpy(), np.asarray(gj["w_x"])[:3].T,
                   f"lin{i}.w_x")


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_pass_dataflow_matches_the_plain_pass(rate):
    """The same dataflow against fused_train_reference, dropout on and
    off, 8 x 256 hidden layers: the roles' plain versions compose to the
    plain pass (f32 summation order and the bf16 roundings it flips)."""
    torch.manual_seed(0)
    dec = SdfDecoder(tcfg.DecoderConfig(latent_size=16, hidden_dim=256,
                                        use_dropout=False))
    ew = precompute_eval_weights(dec, dec.state_dict(), BF)
    S, P = 2, 256
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.normal(size=(S, 16)).astype(np.float32) / 4)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    sdf = torch.from_numpy((0.15 * rng.normal(size=(S, P))).astype(
        np.float32))
    args = (ew, z, xyz, sdf, S * P, 0.1, rate, 77)
    loss, dz, grads = _pass_through_roles(*args)
    l_r, dz_r, g_r = ft.fused_train_reference(*args)
    assert abs(float(loss) - float(l_r)) <= 1e-4 * abs(float(l_r))
    _close(dz.numpy(), dz_r.numpy(), "dz")
    for i, (a, b) in enumerate(zip(grads, g_r)):
        assert set(a) == set(b), i
        for k in b:
            _close(a[k].numpy(), b[k].numpy(), f"lin{i}.{k}")


def test_pass_refuses_points_per_scene_off_the_tile():
    """The pass tiles each scene's points by the engine's 128 rows."""
    ew = precompute_eval_weights(SdfDecoder(tcfg.DecoderConfig(
        latent_size=8, hidden_dim=128, num_layers=2, use_dropout=False)),
        SdfDecoder(tcfg.DecoderConfig(latent_size=8, hidden_dim=128,
                                      num_layers=2, use_dropout=False))
        .state_dict(), BF)
    with pytest.raises(ValueError, match="multiple"):
        ft.fused_train_loss_grads(ew, torch.zeros(2, 8),
                                  torch.zeros(2, 200, 3), torch.zeros(2, 200),
                                  400, 0.1, 0.0, 0)


def test_pad_keeps_the_layout_for_padded_widths():
    """A width the pass pads to a multiple of 128 (253 -> 256) packs and
    unpacks like any other: the padded columns are zeros, so their bits
    are clear."""
    rng = np.random.default_rng(2)
    h = F.pad(torch.relu(_bf16(rng, (256, 253))), (0, 3))
    bits = tg.pack_keep_bits(h > 0)
    back = tg.unpack_keep_bits(bits, 256, 256)
    assert torch.equal(back, h > 0) and not bool(back[:, 253:].any())
