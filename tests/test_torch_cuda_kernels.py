"""The fused decoder-eval kernel (ops.cuda_kernels, csrc/fused_eval.cu).

On the CPU: the wrapper's plain path against the JAX Pallas kernel (in
interpret mode) on the plans of tests/test_pallas_kernels.py, and the
kernel's data layout (the slab stream of [W_h] and [W_x | 0], the per-CTA
shares of its multicast copies, the ring slots, activation and xyz tiles
read through wgmma descriptors, the layer table, the per-launch rows)
through an emulation of what the kernel copies and reads.
tests/test_torch_gpu.py launches the kernel on the card.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.pallas_kernels import (
    make_pallas_apply)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    EVAL_LAYOUT, hoisted_rows, make_kernel_apply, pack_weights, slab_order)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack, params_from_jax)

torch.set_num_threads(2)

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "scale_chairs6k" / "stage1_pack.npz")

# the plans of tests/test_pallas_kernels.py: (config kwargs, seed, n)
PLANS = {
    "small": (dict(latent_size=16, hidden_dim=128, num_layers=3,
                   latent_in=(2,), use_dropout=False), 0, 700),
    "tanh": (dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
                  use_tanh=True, use_dropout=False), 2, 300),
    "canonical": (dict(use_dropout=False), 1, 2048 + 131),
}


def _setup(name):
    kw, seed, n = PLANS[name]
    jdec = JaxDecoder(jcfg.DecoderConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    L = kw.get("latent_size", 256)
    z = (rng.normal(size=L) / np.sqrt(L)).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    dec = SdfDecoder(tcfg.DecoderConfig(**kw))
    return jdec, params, dec, params_from_jax(params), z, xyz


@pytest.mark.parametrize("name", sorted(PLANS))
def test_kernel_apply_cpu_matches_pallas_interpret(name):
    jdec, params, dec, sd, z, xyz = _setup(name)
    want = np.asarray(make_pallas_apply(jdec, params, tile=1024,
                                        interpret=True)(
        jnp.asarray(z), jnp.asarray(xyz)))
    n0 = profiling.LAUNCHES.copy()
    apply = make_kernel_apply(dec, sd, device="cpu")
    got = apply(torch.from_numpy(z), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert apply.launches == 0          # the CPU path launches nothing
    assert profiling.LAUNCHES == n0


def _core_offsets(rows, k, lbo, sbo):
    """Element offsets wgmma reads for a [rows, k] K-major operand without
    swizzle from its descriptor's (LBO, SBO): 8x8 core matrices of 128
    bytes, the next 8 inputs lbo bytes on, the next 8 rows sbo bytes on."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(k)[None, :]
    return ((r // 8) * sbo + (c // 8) * lbo + (r % 8) * 16 + (c % 8) * 2) // 2


def _tile_off(m, c):
    """csrc/fused_eval.cu tile_off: where the epilogue and store_xyz put
    element (point m, input c) of a tile buffer."""
    return ((c // 8) * 8 + m // 8) * 64 + (m % 8) * 8 + c % 8


def _xyz_tiles(xyz, tiles):
    """The kernel's xyz tiles [tiles, 64 * 16] as store_xyz writes them:
    bf16 x, y, z in columns 0-2, zeros elsewhere and past N."""
    xl = torch.zeros(tiles * 64, EVAL_LAYOUT["xyz_cols"])
    xl[:xyz.shape[0], :3] = xyz.to(torch.bfloat16).float()
    xt = torch.zeros(tiles, 64 * EVAL_LAYOUT["xyz_cols"])
    m = torch.arange(64)[:, None]
    c = torch.arange(EVAL_LAYOUT["xyz_cols"])[None, :]
    xt[:, _tile_off(m, c).reshape(-1)] = xl.reshape(tiles, -1)
    return xt


def _read_slab(w, off, n, cluster):
    """The [n, 16] B operand of the slab at `off` in the stream, as the
    kernel's two warpgroups read it: the ring slot filled by the cluster's
    `cluster` multicast shares, each warpgroup's half of the rows read
    back through its descriptor (slot bytes past the slab stay NaN)."""
    lay = EVAL_LAYOUT
    slab, share = n * 16, n * 16 // cluster
    slot = torch.full((lay["slot_bytes"] // 2,), float("nan"))
    for r in range(cluster):
        slot[r * share:(r + 1) * share] = w[off + r * share:
                                            off + (r + 1) * share]
    nw = n // 2
    idx = _core_offsets(nw, 16, lay["slab_lbo"], lay["slab_sbo"])
    assert slab <= slot.numel()
    return torch.cat([slot[hw * (nw // 8) * lay["slab_sbo"] // 2 + idx]
                      for hw in range(2)])


def _emulate_kernel(ew, z, xyz, cluster=2):
    """What csrc/fused_eval.cu computes, from the bytes it copies and reads
    (pack_weights' slab stream, the layer table) and the wrapper's
    per-launch rows (hoisted_rows), in fp32 on the CPU. For every k16 step
    the B operand is the ring slot read back through its descriptor, the A
    operand the activation or xyz tile read through its descriptor; the
    zero slabs that pad an xyz slab to a whole ring stage read the xyz
    tile again. The last hidden layer's h, which the kernel keeps in
    registers for the final dot product, is read back from the tile."""
    w, meta = pack_weights(ew)
    w = w.float()
    rows = hoisted_rows(ew, meta, z)
    lay = EVAL_LAYOUT
    n_pts = xyz.shape[0]
    tiles = -(-n_pts // 64)
    m = torch.arange(64)[:, None]
    xt = _xyz_tiles(xyz, tiles)
    act = torch.zeros(tiles, 64 * 512)
    a_idx = _core_offsets(64, 16, lay["tile_lbo"], lay["tile_sbo"])
    g = lay["stage_slabs"]
    for i, (k, n, kx, w_off, row_off) in enumerate(meta.tolist()):
        if i == len(meta) - 1:
            h = act[:, _tile_off(m, torch.arange(k)[None, :])]
            acc = h @ w[w_off:w_off + k] + rows[row_off]
            break
        acc = torch.zeros(tiles, 64, n)
        xsteps = -(-kx // (16 * g)) * g
        for t in range(k // 16 + xsteps):
            b = _read_slab(w, w_off + t * n * 16, n, cluster)
            tx = t - k // 16
            a_buf, a_t = (act, t) if tx < 0 else (xt, tx if tx < kx // 16
                                                  else 0)
            a = a_buf[:, a_t * 2 * lay["tile_lbo"] // 2 + a_idx]
            acc = acc + a @ b.T
        h = torch.relu(acc + rows[row_off:row_off + n]).to(
            torch.bfloat16).float()
        act[:, _tile_off(m, torch.arange(n)[None, :]).reshape(-1)] = \
            h.reshape(tiles, 64 * n)
    out = acc.reshape(-1)[:n_pts]
    return torch.tanh(out) if ew.use_tanh else out


def _plan_inputs(name):
    """(ew, z, xyz) for a plan: the trained chair decoder with code 7 and
    777 points, or a plan of _setup with its latent and ragged points."""
    if name == "trained":
        sd, codes = load_stage1_pack(PACK)
        dec = SdfDecoder(tcfg.DecoderConfig())
        z = torch.from_numpy(codes[7])
        xyz = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (777, 3)).astype(np.float32))
    else:
        _, _, dec, sd, z, xyz = _setup(name)
        z, xyz = torch.from_numpy(z), torch.from_numpy(xyz)
    return precompute_eval_weights(dec, sd, torch.bfloat16), z, xyz


@pytest.mark.parametrize("name", ["small", "tanh", "trained"])
def test_packed_layout_reproduces_plain_version(name):
    """The slab stream (253 -> 256 padding, xyz slabs and their zero
    slabs), the layer table and the per-launch rows, copied in 1 or 2
    shares and read back through the kernel's descriptors, hold the same
    function as fast_apply in bf16, ragged tail included."""
    ew, z, xyz = _plan_inputs(name)
    want = fast_apply(ew, z, xyz)
    for cluster in (1, 2):
        got = _emulate_kernel(ew, z, xyz, cluster)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=5e-3, rtol=0)


def test_pack_table():
    """The layer table of the canonical plan: per layer (k, n, kx, w_off,
    row_off) with the 253-wide layer padded to 256, one xyz slab and one
    zero slab (a whole ring stage of 2) at layer 0 and the skip layer,
    every layer's slabs where the previous layer's end, 16-byte aligned,
    and its row where the previous row ends."""
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False))
    ew = precompute_eval_weights(dec, dec.state_dict(), torch.bfloat16)
    w, meta = pack_weights(ew)
    assert meta.shape == (9, 5) and meta.dtype == np.int64
    assert meta[:, 1].tolist() == [512, 512, 512, 256, 512, 512, 512, 512, 1]
    assert meta[:, 0].tolist() == [0, 512, 512, 512, 256, 512, 512, 512, 512]
    assert meta[:, 2].tolist() == [16, 0, 0, 0, 16, 0, 0, 0, 0]
    assert EVAL_LAYOUT["stage_slabs"] == 2 and EVAL_LAYOUT["xyz_cols"] == 16
    sizes = (meta[:, 0] + 2 * meta[:, 2]) * meta[:, 1]
    sizes[-1] = 512
    np.testing.assert_array_equal(meta[1:, 3], np.cumsum(sizes)[:-1])
    assert w.numel() == sizes.sum() == 1606144 and w.dtype == torch.bfloat16
    assert all(off % 8 == 0 for off in meta[:, 3])       # 16-byte aligned
    np.testing.assert_array_equal(meta[1:, 4], np.cumsum(meta[:-1, 1]))
    # layer 0: its xyz slab, then a zero slab; no hidden slab
    x0 = torch.zeros(512, 16)
    x0[:, :3] = ew.layers[0].w_x.float()
    torch.testing.assert_close(w[:512 * 16].float(), slab_order(x0))
    assert not w[512 * 16:512 * 32].any()
    # the skip layer: 16 hidden slabs of W_h (253 -> 256), then its xyz
    # slab and a zero slab
    off = meta[4, 3]
    wh = torch.zeros(512, 256)
    wh[:, :253] = ew.layers[4].w_h.float()
    torch.testing.assert_close(w[off:off + 512 * 256].float(),
                               slab_order(wh))
    x4 = torch.zeros(512, 16)
    x4[:, :3] = ew.layers[4].w_x.float()
    off += 512 * 256
    torch.testing.assert_close(w[off:off + 512 * 16].float(), slab_order(x4))
    assert not w[off + 512 * 16:meta[5, 3]].any()
    # the final layer: its weight as a plain vector
    torch.testing.assert_close(w[meta[8, 3]:].float(),
                               ew.layers[8].w_h.float().reshape(-1))


@pytest.mark.parametrize("name", ["small", "tanh"])
def test_pack_table_small_plans(name):
    """The small skip plan (widths 128, the 109-wide layer padded to 128,
    xyz slabs at layers 0 and 2) and the tanh plan (widths 32 padded to
    64, one xyz layer): slab counts in whole ring stages, offsets and
    rows back to back."""
    ew, _, _ = _plan_inputs(name)
    w, meta = pack_weights(ew)
    want = {"small": [(0, 128, 16), (128, 128, 0), (128, 128, 16),
                      (128, 1, 0)],
            "tanh": [(0, 64, 16), (64, 64, 0), (64, 1, 0)]}[name]
    assert [tuple(r) for r in meta[:, :3].tolist()] == want
    g = EVAL_LAYOUT["stage_slabs"]
    slabs = meta[:-1, 0] // 16 + np.where(meta[:-1, 2] > 0, g, 0)
    assert all(s % g == 0 for s in slabs)
    sizes = list(slabs * meta[:-1, 1] * 16) + [meta[-1, 0]]
    np.testing.assert_array_equal(meta[1:, 3], np.cumsum(sizes)[:-1])
    assert w.numel() == sum(sizes)
    np.testing.assert_array_equal(meta[1:, 4], np.cumsum(meta[:-1, 1]))


@pytest.mark.parametrize("n", [64, 128, 256, 512])
def test_xyz_slab_times_xyz_tile(n):
    """An xyz slab ([W_x | 0], n x 16) read through the slab descriptor,
    times the [64, 16] xyz tile that store_xyz writes read through the
    tile descriptor, is bf16(xyz) @ W_x^T; the zero slab after it adds
    nothing."""
    rng = np.random.default_rng(n)
    wx = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(
        torch.bfloat16)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (50, 3)).astype(np.float32))
    stream = slab_order(F.pad(wx.float(), (0, 2 * 16 - 3)))
    xt = _xyz_tiles(xyz, 1)[0]
    a_idx = _core_offsets(64, 16, EVAL_LAYOUT["tile_lbo"],
                          EVAL_LAYOUT["tile_sbo"])
    a = xt[a_idx]                                      # [64, 16]
    got = a @ _read_slab(stream, 0, n, 2).T
    want = xyz.to(torch.bfloat16).float() @ wx.float().T
    torch.testing.assert_close(got[:50], want, atol=1e-5, rtol=1e-5)
    assert not got[50:].any()                          # points past N
    assert not (a @ _read_slab(stream, n * 16, n, 2).T).any()


def test_hoisted_rows_carry_latent_products():
    """hoisted_rows: every layer's row at its table offset, padded with
    zeros to its width: b + bf16(z) @ W_z^T for layer 0 and the skip
    layer, b for the others."""
    ew, z, _ = _plan_inputs("small")
    _, meta = pack_weights(ew)
    rows = hoisted_rows(ew, meta, z)
    assert rows.dtype == torch.float32 and rows.numel() == meta[:, 1].sum()
    zb = z.to(torch.bfloat16).float()
    for lay, (_, n, _, _, ro) in zip(ew.layers, meta.tolist()):
        want = lay.b.clone()
        if lay.w_z is not None:
            want = want + lay.w_z.float() @ zb
        torch.testing.assert_close(rows[ro:ro + want.numel()], want)
        assert not rows[ro + want.numel():ro + n].any()


def test_pack_rejects_unsupported_plans():
    for kw in (dict(hidden_dim=1024), dict(latent_in=(8,))):
        dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False, **kw))
        ew = precompute_eval_weights(dec, dec.state_dict())
        with pytest.raises(ValueError, match="fused kernel"):
            pack_weights(ew)


def test_make_kernel_apply_needs_card_unless_cpu(monkeypatch):
    dec = SdfDecoder(tcfg.DecoderConfig(latent_size=8, hidden_dim=32,
                                        num_layers=2, latent_in=()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_kernel_apply(dec, dec.state_dict())
    apply = make_kernel_apply(dec, dec.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="weights on"):
        apply(torch.zeros(8, dtype=torch.float64).to("meta"),
              torch.zeros(4, 3))
