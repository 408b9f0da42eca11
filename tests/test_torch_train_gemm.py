"""Host-side logic of kernel #4's GEMM engine (csrc/fused_train.cu:
tn_gemm_kernel for the forward/dgrad roles, mn_wgrad_kernel for the wgrad
role), checked on the CPU through its Python model (ops/train_gemm.py):
the 128-byte swizzle the TMA copies write and the K-major and MN-major
wgmma descriptors read, the tensor maps' boxes, the persistent tile and
split-K unit schedules, the accumulator map with the Philox block
exchange, and the wrappers' shape checks and plain versions. The kernels
themselves are held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
from latent_diffusion_models_for_shape_sdfs_torch.ops import train_gemm as tg
from latent_diffusion_models_for_shape_sdfs_torch.ops.relu_dropout import (
    dropout_keep_mask)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

LAY = tg.TN_LAYOUT
WIDTHS = [(512, 512), (512, 256), (256, 512), (128, 128)]   # (K, N)


def test_layout_fits_the_card():
    assert LAY["stage_bytes"] == (LAY["bm"] + LAY["max_bn"]) * LAY["bk"] * 2
    assert LAY["bk"] * 2 == LAY["swizzle_bytes"]
    # the ring, the output tile, two column-partial buffers (a float2 for
    # each of 128 threads of each warpgroup and 4 sums), the ring's
    # barriers, slack to align the ring
    assert LAY["cbuf"] == (LAY["bm"] // tg.WG_ROWS) * 128 * 4 * 8
    assert LAY["smem"] == (LAY["stages"] * LAY["stage_bytes"]
                           + LAY["bm"] * LAY["max_bn"] * 2 + 2 * LAY["cbuf"]
                           + 2 * LAY["stages"] * 8 + 1024)
    assert LAY["smem"] <= 232448                # an H100 block's limit
    assert LAY["bm"] == 2 * tg.WG_ROWS and LAY["threads"] == 3 * 128


# (operand, rows, byte offset from the stage's 1024-aligned start)
OPERANDS = [("A, warpgroup 0", 64, 0), ("A, warpgroup 1", 64, 64 * 128),
            ("B, BN 128", 128, 128 * 128), ("B, BN 256", 256, 128 * 128)]


@pytest.mark.parametrize("stage", range(LAY["stages"]))
@pytest.mark.parametrize("name,rows,off", OPERANDS)
def test_descriptors_read_every_element_once_in_place(stage, name, rows,
                                                      off):
    """The wgmma descriptors of the four k16 steps of a stage read each
    element (row, k) of the operand where the TMA copy put it, and every
    2-byte slot of the operand exactly once."""
    tile = 0x400 + stage * LAY["stage_bytes"] + off      # 1024-aligned
    assert tile % 1024 == 0
    seen = []
    for kk in range(LAY["bk"] // 16):
        d = tg.sw128_desc(tile + 32 * kk)
        f = tg.desc_fields(d)
        assert (f["start"], f["lbo"], f["sbo"], f["mode"], f["base"]) == (
            tile + 32 * kk, 16, 1024, 1, 0)
        for r in range(rows):
            for k in range(16):
                a = tg.wgmma_address(d, r, k)
                assert a == tile + tg.tma_offset(r, 16 * kk + k), (r, kk, k)
                seen.append(a)
    assert sorted(seen) == list(range(tile, tile + rows * 128, 2))


def test_emulated_tile_product_through_the_layout():
    """A 128 x 128 tile's product from K = 128, with the operands placed
    byte by byte as the TMA copies place them and read back through the
    descriptors as wgmma reads them, equals A B^T."""
    rng = np.random.default_rng(0)
    m, n, k = 128, 128, 128
    a = rng.integers(-8, 8, (m, k))
    b = rng.integers(-8, 8, (n, k))
    c = np.zeros((m, n), np.int64)
    for kb in range(k // LAY["bk"]):
        smem = {}
        for r in range(m):
            for kc in range(LAY["bk"]):
                smem[tg.tma_offset(r, kc)] = a[r, kb * 64 + kc]
        b_off = LAY["bm"] * 128
        for r in range(n):
            for kc in range(LAY["bk"]):
                smem[b_off + tg.tma_offset(r, kc)] = b[r, kb * 64 + kc]
        for wg in range(2):
            for kk in range(4):
                da = tg.sw128_desc(wg * 64 * 128 + 32 * kk)
                db = tg.sw128_desc(b_off + 32 * kk)
                at = np.array([[smem[tg.wgmma_address(da, r, j)]
                                for j in range(16)] for r in range(64)])
                bt = np.array([[smem[tg.wgmma_address(db, r, j)]
                                for j in range(16)] for r in range(n)])
                c[wg * 64:(wg + 1) * 64] += at @ bt.T
    np.testing.assert_array_equal(c, a @ b.T)


@pytest.mark.parametrize("m", [1 << 20, 512 * 7])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_tensor_maps_cover_the_operands(m, k, n):
    """Each map's box tiles its operand exactly (no box reaches past the
    tensor, none is left out), within TMA's limits (16-byte strides, a
    128-byte inner box for the 128-byte swizzle, at most 256 rows); the
    boxes the schedule loads cover A and B."""
    ma, mb, bn = tg.gemm_maps(m, n, k)
    assert bn == (256 if n % 256 == 0 else 128)
    assert ma["dims"] == (k, m) and mb["dims"] == (k, n)
    for mp, rows in ((ma, m), (mb, n)):
        assert mp["strides"] == (2 * k,) and mp["strides"][0] % 16 == 0
        assert mp["box"][0] * 2 == mp["swizzle"] == 128
        assert mp["box"][1] <= 256
        assert k % mp["box"][0] == 0 and rows % mp["box"][1] == 0
    sched = tg.tile_schedule(m, n, bn, 132)
    m0s = sorted({t[0] for cta in sched for t in cta})
    n0s = sorted({t[1] for cta in sched for t in cta})
    assert m0s == list(range(0, m, ma["box"][1]))
    assert n0s == list(range(0, n, mb["box"][1]))


@pytest.mark.parametrize("m", [1 << 20, 512 * 7])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_tile_schedule_visits_every_tile_once(m, k, n):
    bn = tg.check_shape(m, n, k)
    for grid in (132, 7):
        sched = tg.tile_schedule(m, n, bn, grid)
        tiles = [t for cta in sched for t in cta]
        want = {(m0, n0) for m0 in range(0, m, 128) for n0 in range(0, n, bn)}
        assert len(tiles) == len(want) and set(tiles) == want
        sizes = [len(cta) for cta in sched]
        assert max(sizes) - min(sizes) <= 1
        # consecutive tiles of the sweep share A's rows (N fastest)
        assert sched[0][0] == (0, 0)
        if n // bn > 1 and len(sched) > 1:
            assert sched[1][0] == (0, bn)


@pytest.mark.parametrize("bn", [128, 256])
def test_accumulator_map_and_dropout_exchange(bn):
    """Every element of a warpgroup's 64 x BN tile is held by exactly one
    accumulator register, and masked with word col % 4 of the Philox block
    (row, col >> 2), drawn by exactly one lane: one draw per 4 elements."""
    row0, n0 = 4096 + 64, 256
    held, drawn = set(), []
    for warp in range(4):
        for lane in range(32):
            for j in range(bn // 8):
                words = tg.dropout_words(warp, lane, j, row0, n0)
                for e in range(4):
                    r, c = tg.acc_coords(warp, lane, 4 * j + e)
                    assert (r, c) not in held
                    held.add((r, c))
                    assert words[e] == (row0 + r, (n0 + c) >> 2, c % 4)
                odd = lane % 2
                drawn.append((row0 + 16 * warp + lane // 4 + 8 * odd,
                              (n0 + 8 * j + 2 * (lane % 4)) >> 2))
    assert held == {(r, c) for r in range(64) for c in range(bn)}
    assert len(drawn) == len(set(drawn)) == 64 * bn // 4


@pytest.mark.parametrize("bn", [128, 256])
def test_epilogue_stores_land_in_the_store_boxes(bn):
    """The epilogue's shared-memory stores put accumulator (row, col) where
    the TMA store of the output boxes reads it, cover the warpgroup's
    output tile once, and each store instruction of a warp (fixed j and
    row half, 32 lanes x 4 bytes) touches 32 distinct banks."""
    seen = set()
    for warp in range(4):
        for j in range(bn // 8):
            for e in range(4):
                words = []
                for lane in range(32):
                    r, c = tg.acc_coords(warp, lane, 4 * j + e)
                    off = tg.out_offset(warp, lane, j, e)
                    assert off == tg.box_offset(r, c), (warp, lane, j, e)
                    assert off not in seen
                    seen.add(off)
                    words.append(off // 4)
                if e % 2 == 0:
                    assert len({w % 32 for w in words}) == 32
    assert seen == set(range(0, 64 * bn * 2, 2))


@pytest.mark.parametrize("m,n,k,what", [(1000, 512, 512, "rows"),
                                        (1024, 320, 512, "width"),
                                        (1024, 512, 96, "K"),
                                        (0, 512, 512, "rows")])
def test_shape_checks_raise(m, n, k, what):
    with pytest.raises(ValueError, match=what):
        tg.check_shape(m, n, k)


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(bf)
    w = torch.from_numpy((rng.normal(size=(n, k)) / np.sqrt(k))
                         .astype(np.float32)).to(bf)
    return a, w


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("skip", [False, True])
def test_cpu_forward_role_is_its_plain_version(rate, skip):
    """On CPU tensors gemm_fwd is the plain version: relu of the product,
    the per-scene rows and the xyz term, then the mask of ops.relu_dropout
    (bitwise) with the inverted scale."""
    m, k, n, p = 512, 256, 128, 128
    h, w = _operands(m, k, n)
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.normal(size=(m // p if skip else 1, n))
                            .astype(np.float32))
    xyz = wx = None
    if skip:
        xyz = torch.from_numpy(rng.uniform(-1, 1, (m, 3)).astype(
            np.float32)).to(torch.bfloat16)
        wx = torch.from_numpy(rng.normal(size=(n, 3)).astype(
            np.float32)).to(torch.bfloat16)
    got = ft.gemm_fwd(h, w, rows, p, xyz, wx, seed=-77, rate=rate)
    pre = h.float() @ w.float().T + rows.repeat_interleave(
        m // rows.shape[0], 0)
    if skip:
        pre = pre + xyz.float() @ wx.float().T
    want = torch.relu(pre)
    if rate:
        keep = dropout_keep_mask(m, n, -77, rate)
        assert torch.equal((got != 0) & (pre > 0), keep & (got != 0))
        want = torch.where(keep, want * (1.0 / (1.0 - rate)), 0.0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("with_xyz", [False, True])
def test_cpu_dgrad_role_is_its_plain_version(with_xyz):
    """On CPU tensors gemm_dgrad masks with the keep bits of h_prev as
    where(h_prev > 0, ...) did, and returns the column partials of its
    output (xyz-weighted too when xyz is given)."""
    m, k, n = 256, 512, 256
    g, wt = _operands(m, k, n, seed=2)
    hprev, _ = _operands(m, n, 8, seed=3)
    xyz = _operands(m, 3, 8, seed=4)[0] if with_xyz else None
    got, part = ft.gemm_dgrad(g, wt, tg.pack_keep_bits(hprev > 0), 1.25, xyz)
    want = torch.where(hprev > 0, (g.float() @ wt.float().T) * 1.25, 0.0)
    assert torch.equal(got, want.to(torch.bfloat16))
    assert bool((got[hprev <= 0] == 0).all())
    assert part.shape == (m // 128, (4 if with_xyz else 1) * n)
    assert torch.equal(part, ft.column_partials_reference(got, xyz))


# ------------------------------------------------- the wgrad role (MN-major)

WL = tg.WGRAD_LAYOUT
WGRAD_WIDTHS = [(512, 512), (256, 512), (512, 256), (128, 128)]   # (out, in)


def test_wgrad_layout_fits_the_card():
    assert WL["stage_bytes"] == (WL["bm"] + WL["max_bn"]) * WL["bk"] * 2
    assert tg.BOX_BYTES == WL["lbo"] == tg.BOX * WL["bk"] * 2
    assert WL["sbo"] == 8 * WL["swizzle_bytes"] == 8 * tg.BOX * 2
    assert WL["smem"] == WL["stages"] * WL["stage_bytes"] + 2 * WL[
        "stages"] * 8 + 1024
    assert WL["smem"] <= 232448                # an H100 block's limit
    assert WL["bm"] == LAY["bm"] and WL["threads"] == LAY["threads"]


# (operand, MN extent, byte offset from the stage's 1024-aligned start)
MN_OPERANDS = [("g, warpgroup 0", 64, 0), ("g, warpgroup 1", 64, 8192),
               ("h, BN 128", 128, 16384), ("h, BN 256", 256, 16384)]


@pytest.mark.parametrize("stage", range(WL["stages"]))
@pytest.mark.parametrize("name,extent,off", MN_OPERANDS)
def test_mn_descriptors_read_every_element_once_in_place(stage, name, extent,
                                                         off):
    """The transposed (MN-major) wgmma descriptors of the four k16 steps
    of a stage read each element (mn, k) of the operand where the TMA
    boxes put point 16 kk + k, column mn, and every 2-byte slot of the
    operand's boxes exactly once (g: each warpgroup its own box; h: 2 or 4
    boxes through the LBO)."""
    tile = 0x400 + stage * WL["stage_bytes"] + off      # 1024-aligned
    assert tile % 1024 == 0
    seen = []
    for kk in range(WL["bk"] // 16):
        d = tg.mn_sw128_desc(tile + 16 * 128 * kk, WL["lbo"])
        f = tg.desc_fields(d)
        assert (f["start"], f["lbo"], f["sbo"], f["mode"], f["base"]) == (
            tile + 2048 * kk, 8192, 1024, 1, 0)
        for mn in range(extent):
            for k in range(16):
                a = tg.mn_wgmma_address(d, mn, k)
                assert a == tile + tg.mn_tma_offset(16 * kk + k, mn), (
                    mn, kk, k)
                seen.append(a)
    assert sorted(seen) == list(range(tile, tile + extent * WL["bk"] * 2, 2))


@pytest.mark.parametrize("bn", [128, 256])
def test_emulated_wgrad_tile_product_through_the_layout(bn):
    """A 128 x BN tile's wgrad from one stage of 64 points, with g [64,
    128] and h [64, BN] placed byte by byte as the TMA boxes place them and
    read back through the MN-major descriptors as wgmma reads them (each
    warpgroup its 64 out rows), equals g^T h."""
    rng = np.random.default_rng(bn)
    pts = WL["bk"]
    g = rng.integers(-8, 8, (pts, WL["bm"]))
    h = rng.integers(-8, 8, (pts, bn))
    smem = {}
    b_off = WL["bm"] * pts * 2
    for p in range(pts):
        for c in range(WL["bm"]):
            smem[tg.mn_tma_offset(p, c)] = g[p, c]
        for c in range(bn):
            smem[b_off + tg.mn_tma_offset(p, c)] = h[p, c]
    c_tile = np.zeros((WL["bm"], bn), np.int64)
    for wg in range(2):
        for kk in range(pts // 16):
            da = tg.mn_sw128_desc(wg * tg.BOX_BYTES + 2048 * kk, WL["lbo"])
            db = tg.mn_sw128_desc(b_off + 2048 * kk, WL["lbo"])
            at = np.array([[smem[tg.mn_wgmma_address(da, r, j)]
                            for j in range(16)] for r in range(64)])
            bt = np.array([[smem[tg.mn_wgmma_address(db, r, j)]
                            for j in range(16)] for r in range(bn)])
            c_tile[wg * 64:(wg + 1) * 64] += at @ bt.T
    np.testing.assert_array_equal(c_tile, g.T @ h)


@pytest.mark.parametrize("k", [1 << 20, 3 * 16384])
@pytest.mark.parametrize("m,n", WGRAD_WIDTHS)
def test_wgrad_tensor_maps_cover_the_operands(k, m, n):
    """Each map's box tiles its [points][cols] operand exactly, within
    TMA's limits (16-byte strides, a 128-byte inner box for the 128-byte
    swizzle, at most 256 rows); the boxes the schedule loads cover g's and
    h's columns and every point."""
    k_split = tg.wgrad_chunk(k)
    mg, mh, bn = tg.wgrad_maps(m, n, k, k_split)
    assert bn == (256 if n % 256 == 0 else 128)
    assert mg["dims"] == (m, k) and mh["dims"] == (n, k)
    for mp, cols in ((mg, m), (mh, n)):
        assert mp["strides"] == (2 * cols,) and mp["strides"][0] % 16 == 0
        assert mp["box"][0] * 2 == mp["swizzle"] == 128
        assert mp["box"][1] <= 256
        assert cols % mp["box"][0] == 0 and k % mp["box"][1] == 0
        assert k_split % mp["box"][1] == 0
    units = [u for cta in tg.wgrad_schedule(m, n, bn, k, k_split, 132)
             for u in cta]
    assert sorted({u[0] for u in units}) == list(range(0, m, WL["bm"]))
    assert sorted({u[1] for u in units}) == list(range(0, n, bn))
    assert sorted({u[2] for u in units}) == list(range(0, k, k_split))


@pytest.mark.parametrize("k,k_split", [(1 << 20, 16384), (3 * 16384, 3072),
                                       (2048, 256)])
@pytest.mark.parametrize("m,n", WGRAD_WIDTHS)
def test_wgrad_schedule_covers_every_unit_once(k, k_split, m, n):
    """Every (tile, chunk) unit is walked once on any grid, CTAs take
    units in turn (tile fastest, chunk slowest: the CTAs starting together
    share a chunk), and the chunks' boundaries are the same on every
    grid."""
    bn = tg.check_wgrad_shape(m, n, k, k_split)
    want = {(m0, n0, k0) for m0 in range(0, m, 128) for n0 in range(0, n, bn)
            for k0 in range(0, k, k_split)}
    chunks = None
    for grid in (132, 7, 1, 10 ** 6):
        sched = tg.wgrad_schedule(m, n, bn, k, k_split, grid)
        units = [u for cta in sched for u in cta]
        assert len(units) == len(want) and set(units) == want
        sizes = [len(cta) for cta in sched]
        assert max(sizes) - min(sizes) <= 1
        flat = [sched[b][i] for i in range(max(sizes))
                for b in range(len(sched)) if i < len(sched[b])]
        tiles = (m // 128) * (n // bn)
        assert [u[2] for u in flat] == sorted(u[2] for u in flat)
        assert flat[:tiles] == sorted(flat[:tiles], key=lambda u: (u[0], u[1]))
        assert {u[2] for u in flat[:tiles]} == {0}
        bounds = sorted({u[2] for u in units})
        assert chunks is None or bounds == chunks
        chunks = bounds


@pytest.mark.parametrize("n_points", [1 << 20, 64 * 256, 2 * 512, 3 * 16384,
                                      5 * 4096])
def test_wgrad_chunk_divides_the_points(n_points):
    """The pass's chunk divides N, is a multiple of a stage's 64 points
    (N is a multiple of 256 points) and at most 16,384 points."""
    c = tg.wgrad_chunk(n_points)
    assert n_points % c == 0 and c % WL["bk"] == 0 and c <= 16384
    assert c == 16384 or n_points % (2 * c)


@pytest.mark.parametrize("m,n,k_split", [(512, 512, 1024), (256, 512, 512),
                                         (512, 256, 2048), (128, 128, 64)])
def test_cpu_wgrad_role_is_its_plain_version(m, n, k_split):
    """On CPU tensors gemm_wgrad is gemm_wgrad_reference: the per-chunk
    f32 partials of g^T h, which sum to the whole product (exactly, for
    small-integer operands)."""
    k = 2048
    rng = np.random.default_rng(m + n + k_split)
    bf = torch.bfloat16
    g = torch.from_numpy(rng.integers(-3, 4, (k, m)).astype(np.float32)).to(bf)
    h = torch.from_numpy(rng.integers(-3, 4, (k, n)).astype(np.float32)).to(bf)
    n0 = profiling.LAUNCHES.copy()
    got = ft.gemm_wgrad(g, h, k_split)
    assert profiling.LAUNCHES == n0          # plain version on CPU
    assert got.dtype == torch.float32 and got.shape == (k // k_split, m, n)
    assert torch.equal(got, ft.gemm_wgrad_reference(g, h, k_split))
    assert torch.equal(got.sum(0), g.float().T @ h.float())
    assert torch.equal(got[-1], g[-k_split:].float().T @ h[-k_split:].float())


def _misaligned(rows, cols):
    """A contiguous bf16 [rows, cols] view 2 bytes past a 16-byte
    boundary."""
    return torch.zeros(rows * cols + 1, dtype=torch.bfloat16)[1:].view(
        rows, cols)


@pytest.mark.parametrize("what,args,match", [
    ("out width", lambda: (torch.zeros(1024, 320, dtype=torch.bfloat16),
                           torch.zeros(1024, 512, dtype=torch.bfloat16), 512),
     "out width"),
    ("in width", lambda: (torch.zeros(1024, 512, dtype=torch.bfloat16),
                          torch.zeros(1024, 192, dtype=torch.bfloat16), 512),
     "width"),
    ("chunk not a multiple of 64", lambda: (
        torch.zeros(1024, 128, dtype=torch.bfloat16),
        torch.zeros(1024, 128, dtype=torch.bfloat16), 96), "chunk"),
    ("chunk not dividing K", lambda: (
        torch.zeros(1000, 128, dtype=torch.bfloat16),
        torch.zeros(1000, 128, dtype=torch.bfloat16), 512), "chunk"),
    ("K differs", lambda: (torch.zeros(1024, 128, dtype=torch.bfloat16),
                           torch.zeros(512, 128, dtype=torch.bfloat16), 512),
     "K"),
    ("dtype", lambda: (torch.zeros(1024, 128),
                       torch.zeros(1024, 128, dtype=torch.bfloat16), 512),
     "bf16"),
    ("not contiguous", lambda: (
        torch.zeros(128, 1024, dtype=torch.bfloat16).T,
        torch.zeros(1024, 128, dtype=torch.bfloat16), 512), "contiguous"),
    ("misaligned", lambda: (_misaligned(1024, 128),
                            torch.zeros(1024, 128, dtype=torch.bfloat16), 512),
     "aligned"),
    ("not 2-D", lambda: (torch.zeros(1024, 128, 1, dtype=torch.bfloat16),
                         torch.zeros(1024, 128, dtype=torch.bfloat16), 512),
     "matrices")])
def test_wgrad_wrapper_raises_on_bad_operands(what, args, match):
    with pytest.raises(ValueError, match=match):
        ft.gemm_wgrad(*args())
