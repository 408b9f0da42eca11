"""The per-point-latent decoder-eval kernel (ops.cuda_kernels pairs
wrapper, csrc/fused_eval_pairs.cu) and its plain version.

On the CPU: the port's bf16 fast_apply over z rows against JAX's; the
wrapper's plain paths (rows, and rows by index) against the JAX Pallas
pairs kernel (in interpret mode) on the plans of
tests/test_pallas_kernels.py with a ragged N; the flat decode's grouping
through the indexed route against the gathered one; and the kernel's data
layout (the slab stream of [W_h] and [W_z | W_x], the per-CTA shares of
its multicast copies, the ring slots and tile buffers read through wgmma
descriptors, the five-column layer table) through an emulation of what
the kernel copies and reads. tests/test_torch_gpu.py launches the kernel
on the card.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops import (
    fused_decoder as jfd)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.pallas_kernels import (
    make_pallas_apply_pairs)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    PAIRS_LAYOUT, make_kernel_apply, make_kernel_apply_pairs,
    pack_weights_pairs, pairs_latent_widths, slab_order)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack, params_from_jax)

torch.set_num_threads(2)

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "multicat6k" / "stage1_pack.npz")

# the plans of tests/test_pallas_kernels.py: (config kwargs, seed, ragged n)
PLANS = {
    "small": (dict(latent_size=16, hidden_dim=128, num_layers=3,
                   latent_in=(2,), use_dropout=False), 0, 700),
    "tanh": (dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
                  use_tanh=True, use_dropout=False), 2, 300),
    "canonical": (dict(use_dropout=False), 1, 2048 + 131),
}


def _setup(name):
    """JAX decoder and params, the port's decoder and state dict, z rows
    [n, L] (one latent per point) and xyz [n, 3], from a seed."""
    kw, seed, n = PLANS[name]
    jdec = JaxDecoder(jcfg.DecoderConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    L = kw.get("latent_size", 256)
    zr = (rng.normal(size=(n, L)) / np.sqrt(L)).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    dec = SdfDecoder(tcfg.DecoderConfig(**kw))
    return jdec, params, dec, params_from_jax(params), zr, xyz


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fast_apply_over_z_rows_matches_jax(name):
    """The kernel's plain version: bf16 fast_apply with a latent row per
    point, against JAX's fast_apply on the same rows (JAX's oracle of its
    pairs kernel). Same rounding points, summation order aside."""
    jdec, params, dec, sd, zr, xyz = _setup(name)
    jew = jfd.precompute_eval_weights(jdec, params, jnp.bfloat16)
    want = np.asarray(jfd.fast_apply(jew, jnp.asarray(zr), jnp.asarray(xyz)))
    ew = precompute_eval_weights(dec, sd, torch.bfloat16)
    got = fast_apply(ew, torch.from_numpy(zr), torch.from_numpy(xyz)).numpy()
    assert got.shape == (xyz.shape[0],)
    np.testing.assert_allclose(got, want, atol=5e-3)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pairs_apply_cpu_matches_pallas_interpret(name):
    jdec, params, dec, sd, zr, xyz = _setup(name)
    want = np.asarray(make_pallas_apply_pairs(jdec, params, tile=1024,
                                              interpret=True)(
        jnp.asarray(zr), jnp.asarray(xyz)))
    n0 = profiling.LAUNCHES.copy()
    apply = make_kernel_apply_pairs(dec, sd, device="cpu")
    got = apply(torch.from_numpy(zr), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert apply.launches == 0          # the CPU path launches nothing
    assert profiling.LAUNCHES == n0


def test_pairs_apply_with_equal_rows_matches_single_latent_apply():
    """Every row the same latent: the pairs path computes the single-latent
    path's function (tests/test_pallas_kernels.py:94-105)."""
    _, _, dec, sd, zr, xyz = _setup("small")
    z = torch.from_numpy(zr[0])
    rows = z.expand(xyz.shape[0], -1)
    pairs = make_kernel_apply_pairs(dec, sd, device="cpu")
    single = make_kernel_apply(dec, sd, device="cpu")
    torch.testing.assert_close(pairs(rows, torch.from_numpy(xyz)),
                               single(z, torch.from_numpy(xyz)),
                               atol=1e-2, rtol=0)


def _core_offsets(rows, k, lbo, sbo):
    """Element offsets wgmma reads for a [rows, k] K-major operand without
    swizzle from its descriptor's (LBO, SBO): 8x8 core matrices of 128
    bytes, the next 8 inputs lbo bytes on, the next 8 rows sbo bytes on."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(k)[None, :]
    return ((r // 8) * sbo + (c // 8) * lbo + (r % 8) * 16 + (c % 8) * 2) // 2


def _tile_off(m, c):
    """csrc/fused_eval_pairs.cu tile_off: where the epilogue and the latent
    load store element (point m, input c) of a tile buffer."""
    return ((c // 8) * 8 + m // 8) * 64 + (m % 8) * 8 + c % 8


def _emulate_pairs_kernel(ew, codes, sids, xyz, cluster):
    """What csrc/fused_eval_pairs.cu computes, from the bytes it copies and
    reads, in fp32 on the CPU. The latent tile is built as the kernel
    builds it (code rows by id, bf16 xyz, zeros) at _tile_off; for every
    k16 step the ring slot is filled from the slab stream by the cluster's
    `cluster` shares, and each warpgroup's B operand, like A from the
    activation or latent tile, is read back through its descriptor. The
    zero slabs that pad a layer to whole ring stages read latent step 0.
    The last hidden layer's h, which the kernel keeps in registers for the
    final dot product, is read back from the emulated tile."""
    w, rows, meta, lt, lzx = pack_weights_pairs(ew)
    w = w.float()
    lay = PAIRS_LAYOUT
    n_pts = xyz.shape[0]
    tiles = -(-n_pts // 64)
    m = torch.arange(64)[:, None]
    # the latent tile: [code row | 0 | bf16 xyz | 0], points past N zero
    zl = torch.zeros(tiles * 64, lzx)
    zl[:n_pts, :codes.shape[1]] = codes.to(torch.bfloat16).float()[sids]
    zl[:n_pts, lt:lt + 3] = xyz.to(torch.bfloat16).float()
    zt = torch.zeros(tiles, 64 * lzx)
    zt[:, _tile_off(m, torch.arange(lzx)[None, :]).reshape(-1)] = \
        zl.reshape(tiles, 64 * lzx)
    act = torch.zeros(tiles, 64 * 512)
    a_idx = _core_offsets(64, 16, lay["tile_lbo"], lay["tile_sbo"])
    for i, (k, n, kz, w_off, row_off) in enumerate(meta.tolist()):
        if i == len(meta) - 1:
            h = act[:, _tile_off(m, torch.arange(k)[None, :])]
            acc = h @ w[w_off:w_off + k] + rows[row_off]
            break
        nw, slab = n // 2, n * 16
        b_idx = _core_offsets(nw, 16, lay["slab_lbo"], lay["slab_sbo"])
        acc = torch.zeros(tiles, 64, n)
        g = lay["stage_slabs"]
        zsteps = -(-kz // (16 * g)) * g
        for t in range(k // 16 + zsteps):
            slot = torch.full((lay["slot_bytes"] // 2,), float("nan"))
            share = slab // cluster
            for r in range(cluster):           # each CTA's multicast share
                src = w_off + t * slab + r * share
                slot[r * share:(r + 1) * share] = w[src:src + share]
            b = torch.cat([slot[hw * (nw // 8) * lay["slab_sbo"] // 2
                                + b_idx] for hw in range(2)])   # [n, 16]
            tz = t - k // 16
            a_buf, a_t = (act, t) if tz < 0 else (zt, tz if tz < kz // 16
                                                  else 0)
            a = a_buf[:, a_t * 2 * lay["tile_lbo"] // 2 + a_idx]  # [T, 64, 16]
            acc = acc + a @ b.T
        h = torch.relu(acc + rows[row_off:row_off + n]).to(
            torch.bfloat16).float()
        act[:, _tile_off(m, torch.arange(n)[None, :]).reshape(-1)] = \
            h.reshape(tiles, 64 * n)
    out = acc.reshape(-1)[:n_pts]
    return torch.tanh(out) if ew.use_tanh else out


def _pairs_inputs(name):
    """(ew, codes [S, L], sids [n], xyz [n, 3]) for a plan: the trained
    multicat decoder with 777 points over its first 64 codes in shuffled
    order, or a plan of _setup with 64 random latents."""
    if name == "trained":
        sd, codes = load_stage1_pack(PACK)
        dec = SdfDecoder(tcfg.DecoderConfig())
        codes, n = codes[:64], 777
    else:
        _, _, dec, sd, zr, _ = _setup(name)
        n = zr.shape[0]
        codes = (np.random.default_rng(5).normal(size=(64, zr.shape[1]))
                 / np.sqrt(zr.shape[1])).astype(np.float32)
    rng = np.random.default_rng(7)
    sids = torch.from_numpy(rng.permutation(np.arange(n) % 64)).int()
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    ew = precompute_eval_weights(dec, sd, torch.bfloat16)
    return ew, torch.from_numpy(codes), sids, xyz


@pytest.mark.parametrize("name", ["small", "tanh", "trained"])
def test_pairs_packed_layout_reproduces_plain_version(name):
    """The slab stream, the latent tile (L padded to 8, xyz after it, lzx
    a multiple of 16: the tanh plan's L = 8 gives 16), bias-only rows and
    the layer table, copied in 1, 2 or 4 shares and read back through the
    kernel's descriptors, hold the same function as fast_apply in bf16
    over codes[sids], ragged tail included."""
    ew, codes, sids, xyz = _pairs_inputs(name)
    want = fast_apply(ew, codes[sids.long()], xyz)
    for cluster in (1, 2, 4):
        got = _emulate_pairs_kernel(ew, codes, sids, xyz, cluster)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=5e-3, rtol=0)


def test_pairs_pack_table():
    """The layer table of the canonical plan: per layer (k, n, kz, w_off,
    row_off) with the 253-wide layer padded to 256, latent slabs of lzx
    272 at layer 0 and the skip layer (17 slabs and a zero slab: whole
    ring stages of 2), every layer's slabs where the previous layer's end,
    16-byte aligned."""
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False))
    ew = precompute_eval_weights(dec, dec.state_dict(), torch.bfloat16)
    w, rows, meta, lt, lzx = pack_weights_pairs(ew)
    assert (lt, lzx) == (256, 272) and meta.shape == (9, 5)
    assert meta[:, 1].tolist() == [512, 512, 512, 256, 512, 512, 512, 512, 1]
    assert meta[:, 0].tolist() == [0, 512, 512, 512, 256, 512, 512, 512, 512]
    assert [i for i in range(9) if meta[i, 2]] == [0, 4]
    assert set(meta[:, 2].tolist()) == {0, 272}
    assert PAIRS_LAYOUT["stage_slabs"] == 2
    sizes = (meta[:, 0] + np.where(meta[:, 2] > 0, 288, 0)) * meta[:, 1]
    sizes[-1] = 512
    np.testing.assert_array_equal(meta[1:, 3], np.cumsum(sizes)[:-1])
    assert w.numel() == sizes.sum() and w.dtype == torch.bfloat16
    assert all(off % 8 == 0 for off in meta[:, 3])       # 16-byte aligned
    assert rows.numel() == int(meta[:, 1].sum()) and rows.dtype == torch.float32
    torch.testing.assert_close(rows[meta[4, 4]:meta[4, 4] + 512],
                               ew.layers[4].b)
    # the skip layer's first latent slab: W_z's columns 0-15 in slab order
    off = meta[4, 3] + 256 * 512
    torch.testing.assert_close(w[off:off + 512 * 16],
                               slab_order(ew.layers[4].w_z[:, :16]))
    # its 17th latent slab: W_x in columns lt..lt+2 of lzx, the rest zero;
    # then one zero slab
    xs = w[meta[5, 3] - 2 * 512 * 16:meta[5, 3] - 512 * 16].float()
    want = torch.zeros(512, 16)
    want[:, :3] = ew.layers[4].w_x.float()
    torch.testing.assert_close(xs, slab_order(want))
    assert not w[meta[5, 3] - 512 * 16:meta[5, 3]].any()


def test_slab_order_element_positions():
    """slab_order puts W[r, 16j + kk] at slab j, ((r // 8) * 2 + kk // 8) *
    64 + (r % 8) * 8 + kk % 8: the positions that the kernel's slab
    descriptor (LBO 128 B, SBO 256 B) reads."""
    n, k = 24, 48
    wt = torch.arange(n * k, dtype=torch.float32).reshape(n, k)
    flat = slab_order(wt)
    for r in range(n):
        for c in range(k):
            j, kk = divmod(c, 16)
            pos = j * n * 16 + ((r // 8) * 2 + kk // 8) * 64 + (r % 8) * 8 \
                + kk % 8
            assert flat[pos] == wt[r, c]
    idx = _core_offsets(n, 16, PAIRS_LAYOUT["slab_lbo"],
                        PAIRS_LAYOUT["slab_sbo"])
    torch.testing.assert_close(flat[n * 16:2 * n * 16][idx], wt[:, 16:32])


@pytest.mark.parametrize("latent,want", [(8, (8, 16)), (16, (16, 32)),
                                         (253, (256, 272)), (256, (256, 272)),
                                         (512, (512, 528))])
def test_pairs_latent_widths(latent, want):
    assert pairs_latent_widths(latent) == want


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pairs_indexed_cpu_matches_gathered_rows(name):
    """The indexed route on the CPU: fast_apply over codes[sids] bit for
    bit, and JAX's Pallas pairs kernel (interpret mode) over the gathered
    rows to 5e-3; shape ids in any order, S = 1 included."""
    jdec, params, dec, sd, zr, xyz = _setup(name)
    apply = make_kernel_apply_pairs(dec, sd, device="cpu")
    rng = np.random.default_rng(11)
    for S in (1, 64):
        codes = (rng.normal(size=(S, zr.shape[1])) / np.sqrt(zr.shape[1])
                 ).astype(np.float32)
        sids = rng.integers(0, S, xyz.shape[0]).astype(np.int32)
        got = apply.indexed(torch.from_numpy(codes), torch.from_numpy(sids),
                            torch.from_numpy(xyz))
        torch.testing.assert_close(
            got, fast_apply(apply.ew, torch.from_numpy(codes[sids]),
                            torch.from_numpy(xyz)), atol=0, rtol=0)
        want = np.asarray(make_pallas_apply_pairs(
            jdec, params, tile=1024, interpret=True)(
            jnp.asarray(codes[sids]), jnp.asarray(xyz)))
        np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert apply.launches == 0


def test_eval_pairs_grouped_indexed_route_matches_gathered_route():
    """_eval_pairs_grouped takes the indexed call when the evaluator has
    one: in balanced groups (and in one call under the group size), the
    same values bit for bit as gathering each group's rows."""
    _, _, dec, sd, _, _ = _setup("small")
    apply = make_kernel_apply_pairs(dec, sd, device="cpu")
    calls = []

    def gathered(z_rows, xyz):
        calls.append(len(xyz))
        return apply(z_rows, xyz)

    rng = np.random.default_rng(3)
    zs = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    sids = torch.from_numpy(rng.integers(0, 5, 301).astype(np.int32))
    xyz = torch.from_numpy(rng.uniform(-1, 1, (301, 3)).astype(np.float32))
    for group in (64, 1024):
        calls.clear()
        want = tge._eval_pairs_grouped(gathered, zs, sids, xyz, group)
        got = tge._eval_pairs_grouped(apply, zs, sids, xyz, group)
        assert calls == ([61] * 5 if group == 64 else [301])
        assert torch.equal(got, want)


def test_make_kernel_apply_pairs_checks(monkeypatch):
    _, _, dec, sd, zr, xyz = _setup("tanh")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_kernel_apply_pairs(dec, sd)
    apply = make_kernel_apply_pairs(dec, sd, device="cpu")
    with pytest.raises(ValueError, match="z_rows"):
        apply(torch.from_numpy(zr[:5]), torch.from_numpy(xyz))
    with pytest.raises(ValueError, match="weights on"):
        apply(torch.from_numpy(zr).to("meta"), torch.from_numpy(xyz))
    codes, x = torch.from_numpy(zr[:4]), torch.from_numpy(xyz)
    with pytest.raises(ValueError, match="sids"):
        apply.indexed(codes, torch.zeros(5, dtype=torch.int32), x)
    with pytest.raises(ValueError, match="codes"):
        apply.indexed(codes[:, :5], torch.zeros(len(x), dtype=torch.int32), x)
    big = SdfDecoder(tcfg.DecoderConfig(latent_size=520, hidden_dim=64,
                                        num_layers=2, latent_in=()))
    with pytest.raises(ValueError, match="latent size"):
        pack_weights_pairs(precompute_eval_weights(big, big.state_dict()))
