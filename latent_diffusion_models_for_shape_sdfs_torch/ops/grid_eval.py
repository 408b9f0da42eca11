"""SDF grid decoding on the device: dense, hierarchical (one, two and
three levels, single-shape and batched), and the flat batched decode of
many shapes at once.

Counterpart of the JAX package's `ops/grid_eval.py`. Query coordinates
are made on the device from flat indices (no coordinate array is
uploaded), and every level of a hierarchical decode evaluates its static,
capacity-sized rows, so a decode enqueues its work without waiting on the
device: the active counts come back as device scalars, read only when the
caller asks (`check_overflow=True`). The batched decodes
(`decode_grid_batch`, `decode_grid_hierarchical2_batch`,
`decode_grid_hierarchical3_batch`), which the JAX package vmaps over the
latents, run the single-shape program shape by shape at the batch's caps,
so each shape's grid and counts are the single-shape decode's.

Grid convention: res points per axis spanning [-1,1], spacing 2/(res-1),
flat index = (x*res + y)*res + z, matching ops/isosurface.py.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
"""(z [L], xyz [N,3]) -> sdf [N]: a *single* latent against a point set, so
implementations can hoist per-shape latent projections
(ops.fused_decoder, ops.cuda_kernels)."""


def make_grid_points(res: int, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Host-side [res^3, 3] lattice (tests / tiny grids only)."""
    axis = np.linspace(lo, hi, res, dtype=np.float32)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def _flat_to_xyz(flat: torch.Tensor, res: int) -> torch.Tensor:
    """Flat indices -> [-1,1]^3 coordinates, on the indices' device."""
    zc = flat % res
    yc = (flat // res) % res
    xc = flat // (res * res)
    ijk = torch.stack([xc, yc, zc], dim=-1).to(torch.float32)
    return ijk * (2.0 / (res - 1)) - 1.0


def decode_grid(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                chunk: int = 262_144) -> torch.Tensor:
    """Dense [res,res,res] SDF of one latent, chunk by chunk on z's device
    (the oracle the hierarchical decode is held against)."""
    total = res ** 3
    chunk = min(chunk, total)
    nchunks = math.ceil(total / chunk)
    out = torch.empty(nchunks * chunk, dtype=torch.float32, device=z.device)
    ar = torch.arange(chunk, dtype=torch.int32, device=z.device)
    for c in range(nchunks):
        flat = torch.clamp(c * chunk + ar, max=total - 1)
        out[c * chunk:(c + 1) * chunk] = apply_fn(z, _flat_to_xyz(flat, res))
    return out[:total].reshape(res, res, res)


def decode_grid_batch(apply_fn: ApplyFn, zs: torch.Tensor, res: int,
                      chunk: int = 65_536) -> torch.Tensor:
    """Dense grids for a batch of latents [S, L] -> [S, res, res, res],
    shape by shape."""
    return torch.stack([decode_grid(apply_fn, z, res, chunk=chunk)
                        for z in zs])


# ------------------------------------------------------ hierarchical decode


def _eval_block_centers(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                        block: int) -> torch.Tensor:
    """SDF at the center of every block of `block`^3 fine voxels. [nb^3]."""
    nb = res // block
    flat = torch.arange(nb ** 3, dtype=torch.int32, device=z.device)
    zc = flat % nb
    yc = (flat // nb) % nb
    xc = flat // (nb * nb)
    ijk = torch.stack([xc, yc, zc], dim=-1).to(torch.float32)
    # center of the block in fine-index space -> world coords
    center_idx = ijk * block + (block - 1) / 2.0
    xyz = center_idx * (2.0 / (res - 1)) - 1.0
    return apply_fn(z, xyz)


def _block_points(block_flat: torch.Tensor, res: int,
                  block: int) -> torch.Tensor:
    """World coords of every fine voxel in each block. [K, b^3, 3]."""
    nb = res // block
    zc = block_flat % nb
    yc = (block_flat // nb) % nb
    xc = block_flat // (nb * nb)
    base = torch.stack([xc, yc, zc], dim=-1)[:, None, :] * block  # [K,1,3]
    off = torch.arange(block ** 3, dtype=torch.int32,
                       device=block_flat.device)
    off3 = torch.stack([off // (block * block), (off // block) % block,
                        off % block], dim=-1)[None, :, :]         # [1,b^3,3]
    idx = (base + off3).to(torch.float32)
    return idx * (2.0 / (res - 1)) - 1.0


# Bound on the points of one apply_fn call inside block evaluation: keeps
# the [points, hidden] activation slab of a plain apply ~<= 2 GB at width 512.
_MAX_POINTS_PER_GROUP = 1 << 20


def _eval_blocks(apply_fn: ApplyFn, z: torch.Tensor,
                 block_flat: torch.Tensor, res: int, block: int,
                 points_per_group: int = _MAX_POINTS_PER_GROUP
                 ) -> torch.Tensor:
    """Evaluate K blocks of block^3 fine voxels. block_flat [K] -> [K, b^3].

    Groups are balanced rather than filled to points_per_group: with
    K=136448 a greedy group of 131072 would make a second group that is
    96% edge padding; ceil-dividing K over the minimal group count keeps
    every group the same size and the padding below one group's
    rounding."""
    K = block_flat.shape[0]
    b3 = block ** 3
    if K == 0:
        return torch.zeros((0, b3), dtype=torch.float32, device=z.device)
    max_group = max(1, min(K, points_per_group // b3))
    ngroups = math.ceil(K / max_group)
    group = math.ceil(K / ngroups)
    pad = ngroups * group - K
    ids = torch.cat([block_flat, block_flat[-1:].expand(pad)])
    ids = ids.reshape(ngroups, group)
    out = torch.empty((ngroups, group, b3), dtype=torch.float32,
                      device=z.device)
    for g in range(ngroups):
        xyz = _block_points(ids[g], res, block).reshape(group * b3, 3)
        out[g] = apply_fn(z, xyz).reshape(group, b3)
    return out.reshape(ngroups * group, b3)[:K]


def _compact(mask: torch.Tensor, cap: int) -> tuple:
    """Stream compaction into `cap` static slots, without a host sync.

    Returns (ids [cap] int32: positions of the first `cap` set entries,
    zero-filled; valid [cap] bool; n_active: int32 device scalar, which
    may exceed cap; slot [n] int32: each set entry's rank, `cap` where
    unset). Ranks >= cap are dropped by scattering them into one spare
    slot past the end (JAX's `mode="drop"`); cumsum keeps int32."""
    n = mask.shape[0]
    npos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = torch.where(mask & (npos < cap), npos, cap)
    ids = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    ids.scatter_(0, keep.long(),
                 torch.arange(n, dtype=torch.int32, device=mask.device))
    n_active = npos[-1] + 1
    valid = torch.arange(cap, device=mask.device) < n_active
    return ids[:cap], valid, n_active, torch.where(mask, npos, cap)


def _quantizers(out_dtype: str, tau2: float, b2: int) -> tuple:
    """(conv, conv_vals): payload conversions of the cascade values and of
    the fine rows. "int8" quantizes at tau2/127 with sign preservation
    (the reconstructed sign pattern, hence the crossing set, is exactly
    the f32 payload's); "int4" packs the fine rows to two's-complement
    nibbles at clip tau2/2 (even index low, odd high); rounding is
    half-to-even, as in JAX."""
    if out_dtype in ("int8", "int4"):
        def conv(v):
            q = torch.clamp(torch.round(v * (127.0 / tau2)), -127.0, 127.0)
            q = torch.where((q == 0.0) & (v != 0.0), torch.sign(v), q)
            return q.to(torch.int8)
    elif out_dtype in ("float32", "bfloat16"):
        dt = getattr(torch, out_dtype)

        def conv(v):
            return v.to(dt)
    else:
        raise ValueError(f"unsupported payload dtype {out_dtype!r}")
    if out_dtype != "int4":
        return conv, conv
    if (b2 ** 3) % 2:
        raise ValueError(
            f"int4 payload packs fine-row values pairwise and needs an "
            f"even row length b2**3; got b2={b2} (b2**3={b2 ** 3}). "
            f"Use an even b2 or out_dtype='int8'.")

    def conv_vals(v):
        q = torch.clamp(torch.round(v * (14.0 / tau2)), -7.0, 7.0)
        q = torch.where((q == 0.0) & (v != 0.0), torch.sign(v), q)
        q = q.to(torch.int32)
        lo = q[..., 0::2] & 0xF
        hi = q[..., 1::2] & 0xF
        return (lo | (hi << 4)).to(torch.uint8)

    return conv, conv_vals


def _assemble_blocks(fill_b: torch.Tensor, vals: torch.Tensor,
                     ids: torch.Tensor, valid: torch.Tensor, res: int,
                     block: int, layout: str) -> torch.Tensor:
    """Merge per-block fill values and fine block values into the grid.

    fill_b [n_blocks]: per-block fill; vals [cap, block^3]: fine values
    for blocks `ids` (masked by `valid`). An inverse-permutation row
    gather (vals_pad[inv]) and a select. layout="block": [n_blocks,
    block^3] (row = block id, col = within-block x-major offset;
    `unblock_grid` converts one shape's on the host); layout="xmajor"
    (one shape, n_blocks = (res/block)^3): [res,res,res]."""
    nb = res // block
    nbb = fill_b.shape[0]
    cap = vals.shape[0]
    inv = torch.full((nbb + 1,), cap, dtype=torch.int32, device=vals.device)
    inv.scatter_(0, torch.where(valid, ids, nbb).long(),
                 torch.arange(cap, dtype=torch.int32, device=vals.device))
    inv = inv[:nbb]
    vals_pad = torch.cat([vals, vals.new_zeros((1, block ** 3))])
    grid = torch.where((inv < cap)[:, None], vals_pad[inv.long()],
                       fill_b[:, None])
    if layout == "block":
        return grid
    grid = grid.reshape(nb, nb, nb, block, block, block)
    return grid.permute(0, 3, 1, 4, 2, 5).reshape(res, res, res)


def auto_layout(res: int, block: int, budget_bytes: int = 4 << 30) -> str:
    """The reference's layout policy: xmajor when its padded transpose
    temporary fits the budget, else block."""
    pad_factor = max(1, 128 // block) * max(1, 8 // block)
    return "xmajor" if res ** 3 * 4 * pad_factor <= budget_bytes else "block"


def _decode_grid_hier_device_impl(apply_fn: ApplyFn, z: torch.Tensor,
                                  res: int, block: int, capacity: int,
                                  safety: float = 1.5,
                                  layout: str = "xmajor") -> tuple:
    """One-level coarse->fine decode: block centers, then the `capacity`
    first blocks within tau of the surface evaluated densely. Returns
    (grid, n_active as a device scalar)."""
    h = 2.0 / (res - 1)
    tau = safety * (block * h * math.sqrt(3.0) / 2.0)
    centers = _eval_block_centers(apply_fn, z, res, block)      # [nb^3]
    idx, valid, n_active, _ = _compact(centers.abs() <= tau, capacity)
    vals = _eval_blocks(apply_fn, z, idx, res, block)
    grid = _assemble_blocks(centers, vals, idx, valid, res, block, layout)
    return grid, n_active


def _decode_grid_hier2_impl(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                            b1: int, b2: int, cap1: int, cap2: int,
                            safety: float = 1.5, layout: str = "xmajor",
                            points_per_group: int = _MAX_POINTS_PER_GROUP,
                            out_dtype: str = "float32") -> tuple:
    """Two-level coarse->mid->fine sparse decode: b1-block centers (L0);
    the cap1 parents nearest the surface refined to b2 sub-block centers
    (L1); the cap2 sub-blocks nearest the surface evaluated densely (L2).
    Assembled at b2 granularity: parent-center fill -> sub-center fill ->
    fine values. Returns (grid, n1, n2), counts as device scalars."""
    r = b1 // b2
    nb1 = res // b1
    nb2 = res // b2
    h = 2.0 / (res - 1)
    tau1 = safety * (b1 * h * math.sqrt(3.0) / 2.0)
    tau2 = safety * (b2 * h * math.sqrt(3.0) / 2.0)
    dev = z.device

    # ---- L0: b1-block centers
    c1 = _eval_block_centers(apply_fn, z, res, b1)             # [nb1^3]
    idx1, valid1, n1, _ = _compact(c1.abs() <= tau1, cap1)     # [cap1]

    # ---- L1: sub-block centers of the selected parents
    x1, y1, z1 = idx1 // (nb1 * nb1), (idx1 // nb1) % nb1, idx1 % nb1
    off = torch.arange(r ** 3, dtype=torch.int32, device=dev)
    ox, oy, oz = off // (r * r), (off // r) % r, off % r
    sx = x1[:, None] * r + ox[None, :]                         # [cap1, r^3]
    sy = y1[:, None] * r + oy[None, :]
    sz = z1[:, None] * r + oz[None, :]
    sub_ids = (sx * nb2 + sy) * nb2 + sz                       # b2-flat ids
    cidx = torch.stack([sx, sy, sz], -1).to(torch.float32) * b2 \
        + (b2 - 1) / 2.0
    sub_xyz = (cidx * (2.0 / (res - 1)) - 1.0).reshape(cap1 * r ** 3, 3)
    c2 = apply_fn(z, sub_xyz).reshape(cap1, r ** 3)            # [cap1, r^3]
    act2 = (c2.abs() <= tau2) & valid1[:, None]
    sel, valid2, n2, _ = _compact(act2.reshape(-1), cap2)
    ids2 = sub_ids.reshape(-1)[sel.long()]                     # [cap2]

    # ---- L2: fine voxels of the selected sub-blocks
    vals = _eval_blocks(apply_fn, z, ids2, res, b2, points_per_group)

    fill2 = _fill_cascade_gather_flat(c1, c2, idx1, valid1, 1, nb1, nb2, r,
                                      cap1)
    dt = getattr(torch, out_dtype)
    if dt != vals.dtype:
        # bf16 output grid: halves assembly and d2h traffic; near the iso
        # level the relative bf16 step costs ~1e-4 absolute on vertex
        # interpolation, below the grid-resolution error floor
        vals, fill2 = vals.to(dt), fill2.to(dt)
    grid = _assemble_blocks(fill2, vals, ids2, valid2, res, b2, layout)
    return grid, n1, n2


def _decode_grid_hier3_impl(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                            b1: int, b2: int, b3: int,
                            cap1: int, cap2: int, cap3: int,
                            safety: float = 1.5, safety3: float = 0.0,
                            layout: str = "sparse2",
                            points_per_group: int = _MAX_POINTS_PER_GROUP,
                            out_dtype: str = "float32"):
    """Three-level coarse->mid->sub->fine sparse decode, returning the
    active counts as device scalars.

    L0 evaluates every b1-block center; parents with |sdf| <= tau1 are
    compacted into cap1 rows and their b2 sub-centers evaluated (L1);
    those within tau2 are compacted into cap2 rows and their b3
    sub-centers evaluated (L2); those within tau3 are evaluated densely
    (L3). Each tau = safety * (block diagonal)/2 in world units, so for a
    <= safety-Lipschitz SDF an unrefined block holds no zero and its
    uniform fill keeps every crossing. safety3 (0 = inherit safety)
    widens only the finest selection margin.

    Returns (out, n1, n2, n3). `layout` "sparse2": out = (c1 [nb1^3],
    c2 [cap1, (b1/b2)^3], idx1 [cap1] int32, vals2 [cap2, b2^3], ids2
    [cap2] int32), the compact v2 payload; "sparse": (fill2 [nb2^3],
    vals2, ids2); "block" / "xmajor": the assembled grid."""
    r1 = b1 // b2
    r2 = b2 // b3
    nb1 = res // b1
    nb2 = res // b2
    nb3 = res // b3
    h = 2.0 / (res - 1)
    tau1 = safety * (b1 * h * math.sqrt(3.0) / 2.0)
    tau2 = safety * (b2 * h * math.sqrt(3.0) / 2.0)
    tau3 = (safety3 or safety) * (b3 * h * math.sqrt(3.0) / 2.0)
    conv, conv_vals = _quantizers(out_dtype, tau2, b2)
    dev = z.device

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    # ---- L0: b1-block centers
    c1 = _eval_block_centers(apply_fn, z, res, b1)               # [nb1^3]
    idx1, valid1, n1, _ = _compact(c1.abs() <= tau1, cap1)

    # ---- L1: b2 sub-centers of selected parents
    x1, y1, z1 = idx1 // (nb1 * nb1), (idx1 // nb1) % nb1, idx1 % nb1
    off = arange(r1 ** 3)
    ox, oy, oz = off // (r1 * r1), (off // r1) % r1, off % r1
    sx = x1[:, None] * r1 + ox[None, :]
    sy = y1[:, None] * r1 + oy[None, :]
    sz = z1[:, None] * r1 + oz[None, :]
    sub_ids = (sx * nb2 + sy) * nb2 + sz                        # [cap1,r1^3]
    cidx = torch.stack([sx, sy, sz], -1).to(torch.float32) * b2 \
        + (b2 - 1) / 2.0
    c2 = apply_fn(z, (cidx * h - 1.0).reshape(cap1 * r1 ** 3, 3)
                  ).reshape(cap1, r1 ** 3)
    act2 = (c2.abs() <= tau2) & valid1[:, None]
    sel2, valid2, n2, _ = _compact(act2.reshape(-1), cap2)
    ids2 = sub_ids.reshape(-1)[sel2.long()]                     # b2-flat

    # ---- L2: b3 sub-centers of selected b2 blocks
    x2, y2, z2 = ids2 // (nb2 * nb2), (ids2 // nb2) % nb2, ids2 % nb2
    off3 = arange(r2 ** 3)
    px, py, pz = off3 // (r2 * r2), (off3 // r2) % r2, off3 % r2
    tx = x2[:, None] * r2 + px[None, :]
    ty = y2[:, None] * r2 + py[None, :]
    tz = z2[:, None] * r2 + pz[None, :]
    sub3_ids = (tx * nb3 + ty) * nb3 + tz                       # [cap2,r2^3]
    c3idx = torch.stack([tx, ty, tz], -1).to(torch.float32) * b3 \
        + (b3 - 1) / 2.0
    c3 = apply_fn(z, (c3idx * h - 1.0).reshape(cap2 * r2 ** 3, 3)
                  ).reshape(cap2, r2 ** 3)
    act3 = (c3.abs() <= tau3) & valid2[:, None]
    sel3, valid3, n3, slot_rank = _compact(act3.reshape(-1), cap3)
    ids3 = sub3_ids.reshape(-1)[sel3.long()]                    # b3-flat

    # ---- L3: fine voxels of selected b3 blocks
    vals3 = _eval_blocks(apply_fn, z, ids3, res, b3,
                         points_per_group)                      # [cap3,b3^3]

    # ---- compose b2 rows: per (b2 block, sub-slot) the fine values if
    # the slot was refined, else the slot's sub-center fill. slot_rank
    # carries each slot's row in vals3 (>= cap3: not refined).
    inv_slot = slot_rank.reshape(cap2, r2 ** 3)
    vals3_pad = torch.cat([vals3, vals3.new_zeros((1, b3 ** 3))])
    picked = vals3_pad[torch.clamp(inv_slot, max=cap3).long()]  # [cap2,r2^3,b3^3]
    vals2 = torch.where((inv_slot < cap3)[..., None], picked,
                        c3[..., None])
    # reorder (sub-block, within-sub) -> x-major order of the b2 block
    vals2 = vals2.reshape(cap2, r2, r2, r2, b3, b3, b3)
    vals2 = vals2.permute(0, 1, 4, 2, 5, 3, 6).reshape(cap2, b2 ** 3)
    if layout == "sparse2":
        return ((conv(c1), conv(c2), idx1, conv_vals(vals2), ids2),
                n1, n2, n3)
    # ---- b2-granularity fill cascade (c1 -> c2), then row assembly
    fill2 = _fill_cascade_gather_flat(c1, c2, idx1, valid1, 1, nb1, nb2,
                                      r1, cap1)
    vals2, fill2 = conv(vals2), conv(fill2)
    if layout == "sparse":
        return (fill2, vals2, ids2), n1, n2, n3
    grid = _assemble_blocks(fill2, vals2, ids2, valid2, res, b2, layout)
    return grid, n1, n2, n3


def decode_grid_adaptive(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                         chunk: int = 262_144) -> np.ndarray:
    """Production single-shape decode to a host x-major [res,res,res]
    float32 grid: the three-level sparse decode (float32 payload, margins
    1.2 / 2.0) with capacity-escalation retries, reconstructed on the
    host (sparse2_to_grid: the values of the JAX package's block-layout
    grid); the dense decode for grids under 64 or not 16-divisible, and
    for a shape whose shell still overflows after four escalations."""
    if res < 64 or res % 16 != 0:
        return decode_grid(apply_fn, z, res, chunk=chunk).cpu().numpy()
    nb1 = res // 16
    cap1 = max(256, nb1 ** 3 // 4)
    cap2 = max(2048, res ** 2 // 4)   # ~surface-shell scale at b2=4
    cap3 = max(8192, res ** 2)        # ~surface-shell scale at b3=2
    for _ in range(4):
        arrs, st = decode_grid_hierarchical3_sparse2(
            apply_fn, z, res, 16, 4, 2, cap1, cap2, cap3, safety=1.2,
            safety3=2.0, check_overflow=True, out_dtype="float32")
        if not st["capacity_exceeded"]:
            return sparse2_to_grid(*(a.cpu().numpy() for a in arrs),
                                   st["active_l1"], st["active_l2"], res,
                                   16, 4)
        if st["active_l1"] > st["cap1"]:
            cap1 *= 2
        if st["active_l2"] > st["cap2"]:
            cap2 *= 2
        if st["active_l3"] > st["cap3"]:
            cap3 *= 2
    return decode_grid(apply_fn, z, res, chunk=chunk).cpu().numpy()


def hier3_int8_scale(res: int, b2: int = 4, safety: float = 1.2) -> float:
    """Quantization scale of the int8 sparse payload: tau2 of the decode
    program (payload value = round(sdf * 127 / scale), sign-preserved).
    Must be called with the same (res, b2, safety) as the decode."""
    h = 2.0 / (res - 1)
    return float(safety * (b2 * h * math.sqrt(3.0) / 2.0))


def _check_blocks(res: int, *blocks: int) -> None:
    """res divisible by the first block, each block by the next."""
    dims = (res,) + blocks
    if any(a % b for a, b in zip(dims, dims[1:])):
        raise ValueError(f"need res % b1 == b1 % b2 == ... == 0, got "
                         f"res={res}, blocks {blocks}")


def _counts(stats: dict, caps: dict, check_overflow: bool) -> dict:
    """Read the active counts (device scalars or [S] tensors) to the host
    and flag an overflow, when the caller asks."""
    if check_overflow:
        over = False
        for k, cap in caps.items():
            n = stats[k].cpu().numpy()
            stats[k] = int(n) if n.ndim == 0 else n
            over = over or bool((n > cap).any())
        stats["capacity_exceeded"] = over
    return stats


def _caps3(res, b1, b2, b3, cap1, cap2, cap3) -> tuple:
    cap1 = min(cap1, (res // b1) ** 3)
    cap2 = min(cap2, cap1 * (b1 // b2) ** 3)
    cap3 = min(cap3, cap2 * (b2 // b3) ** 3)
    return cap1, cap2, cap3


def decode_grid_hierarchical3_sparse2(apply_fn: ApplyFn, z: torch.Tensor,
                                      res: int, b1: int = 16, b2: int = 4,
                                      b3: int = 2, cap1: int = 3072,
                                      cap2: int = 8192, cap3: int = 24576,
                                      safety: float = 1.2,
                                      safety3: float = 0.0,
                                      check_overflow: bool = True,
                                      out_dtype: str = "int8"):
    """Three-level sparse decode, compact v2 payload for serving.

    Returns ((c1 [nb1^3], c2 [cap1, (b1/b2)^3], idx1 [cap1],
    vals2 [cap2, b2^3], ids2 [cap2]), stats), all on z's device: the
    coarse fill cascade at its native granularity plus the near-surface
    fine rows. Only the first stats['active_l1'] rows of c2/idx1 and
    'active_l2' rows of vals2/ids2 are meaningful. out_dtype "int8"
    (default) quantizes at tau2/127 with sign preservation (dequantize
    scale: hier3_int8_scale); "int4" packs the fine rows to nibbles;
    "bfloat16" and "float32" keep magnitudes. With check_overflow=False
    the active counts stay device scalars and nothing waits on the
    device. Reconstruct with sparse2_to_grid."""
    _check_blocks(res, b1, b2, b3)
    cap1, cap2, cap3 = _caps3(res, b1, b2, b3, cap1, cap2, cap3)
    arrs, n1, n2, n3 = _decode_grid_hier3_impl(
        apply_fn, z, res, b1, b2, b3, cap1, cap2, cap3, safety=safety,
        safety3=safety3, out_dtype=out_dtype)
    stats = {"layout": "sparse2", "cap1": cap1, "cap2": cap2,
             "cap3": cap3, "active_l1": n1, "active_l2": n2,
             "active_l3": n3,
             "payload_bytes": int(sum(a.nbytes for a in arrs)),
             "effective_voxels": res ** 3}
    if out_dtype in ("int8", "int4"):
        stats["quant_scale"] = hier3_int8_scale(res, b2, safety)
    return arrs, _counts(stats, {"active_l1": cap1, "active_l2": cap2,
                                 "active_l3": cap3}, check_overflow)


def decode_grid_hierarchical_device(apply_fn: ApplyFn, z: torch.Tensor,
                                    res: int, block: int = 16,
                                    capacity: int = 2048,
                                    safety: float = 1.5,
                                    layout: str = "auto"):
    """One-level coarse->fine decode, on z's device with no host wait
    until the stats are read: a fixed `capacity` of near-surface blocks
    is refined; the stats report the true active count, so a caller can
    detect an overflow and re-run with a larger capacity (the coarse fill
    keeps the signs regardless).

    Returns (grid [res]^3, or [nb^3, block^3] in the block layout, stats
    dict with host ints)."""
    _check_blocks(res, block)
    nb = res // block
    capacity = min(capacity, nb ** 3)
    if layout == "auto":
        layout = auto_layout(res, block)
    grid, n_active = _decode_grid_hier_device_impl(
        apply_fn, z, res, block, capacity, safety=safety, layout=layout)
    n_active = int(n_active)
    stats = {
        "layout": layout,
        "coarse_evals": nb ** 3,
        "fine_evals": capacity * block ** 3,
        "active_blocks": n_active,
        "capacity": capacity,
        "capacity_exceeded": n_active > capacity,
        "total_blocks": int(nb ** 3),
        "effective_voxels": res ** 3,
    }
    return grid, stats


def decode_grid_hierarchical2_device(apply_fn: ApplyFn, z: torch.Tensor,
                                     res: int, b1: int = 16, b2: int = 4,
                                     cap1: int = 3072, cap2: int = 8192,
                                     safety: float = 1.5,
                                     check_overflow: bool = True,
                                     layout: str = "auto",
                                     out_dtype: str = "float32"):
    """Two-level sparse decode (see _decode_grid_hier2_impl). With
    check_overflow=False nothing waits on the device (the stats carry
    device scalars)."""
    _check_blocks(res, b1, b2)
    cap1 = min(cap1, (res // b1) ** 3)
    cap2 = min(cap2, cap1 * (b1 // b2) ** 3)
    if layout == "auto":
        layout = auto_layout(res, b2)
    grid, n1, n2 = _decode_grid_hier2_impl(apply_fn, z, res, b1, b2, cap1,
                                           cap2, safety=safety,
                                           layout=layout,
                                           out_dtype=out_dtype)
    stats = {
        "layout": layout,
        "coarse_evals": (res // b1) ** 3,
        "mid_evals": cap1 * (b1 // b2) ** 3,
        "fine_evals": cap2 * b2 ** 3,
        "active_l1": n1, "active_l2": n2,
        "cap1": cap1, "cap2": cap2,
        "effective_voxels": res ** 3,
    }
    return grid, _counts(stats, {"active_l1": cap1, "active_l2": cap2},
                         check_overflow)


def decode_grid_hierarchical3_device(apply_fn: ApplyFn, z: torch.Tensor,
                                     res: int, b1: int = 16, b2: int = 4,
                                     b3: int = 2, cap1: int = 3072,
                                     cap2: int = 8192, cap3: int = 24576,
                                     safety: float = 1.5,
                                     safety3: float = 0.0,
                                     check_overflow: bool = True,
                                     layout: str = "auto",
                                     out_dtype: str = "float32"):
    """Three-level sparse decode (see _decode_grid_hier3_impl) to an
    assembled grid ("xmajor" or "block" layout)."""
    _check_blocks(res, b1, b2, b3)
    if out_dtype == "int8":
        raise ValueError("int8 is a sparse-payload-only dtype")
    cap1, cap2, cap3 = _caps3(res, b1, b2, b3, cap1, cap2, cap3)
    if layout == "auto":
        layout = auto_layout(res, b2)
    grid, n1, n2, n3 = _decode_grid_hier3_impl(
        apply_fn, z, res, b1, b2, b3, cap1, cap2, cap3, safety=safety,
        safety3=safety3, layout=layout, out_dtype=out_dtype)
    stats = {
        "layout": layout,
        "coarse_evals": (res // b1) ** 3,
        "mid_evals": cap1 * (b1 // b2) ** 3,
        "sub_evals": cap2 * (b2 // b3) ** 3,
        "fine_evals": cap3 * b3 ** 3,
        "active_l1": n1, "active_l2": n2, "active_l3": n3,
        "cap1": cap1, "cap2": cap2, "cap3": cap3,
        "effective_voxels": res ** 3,
    }
    return grid, _counts(stats, {"active_l1": cap1, "active_l2": cap2,
                                 "active_l3": cap3}, check_overflow)


def decode_grid_hierarchical3_sparse(apply_fn: ApplyFn, z: torch.Tensor,
                                     res: int, b1: int = 16, b2: int = 4,
                                     b3: int = 2, cap1: int = 3072,
                                     cap2: int = 8192, cap3: int = 24576,
                                     safety: float = 1.5,
                                     safety3: float = 0.0,
                                     check_overflow: bool = True,
                                     out_dtype: str = "bfloat16"):
    """Three-level sparse decode returning the compact v1 representation
    ((fill2 [nb2^3], vals2 [cap2, b2^3], ids2 [cap2]), stats): the
    expanded b2 fill cascade and the near-surface fine rows; only the
    first stats['active_l2'] rows of vals2/ids2 are meaningful.
    Reconstruct a full x-major grid with sparse_to_grid."""
    _check_blocks(res, b1, b2, b3)
    cap1, cap2, cap3 = _caps3(res, b1, b2, b3, cap1, cap2, cap3)
    (fill2, vals2, ids2), n1, n2, n3 = _decode_grid_hier3_impl(
        apply_fn, z, res, b1, b2, b3, cap1, cap2, cap3, safety=safety,
        safety3=safety3, layout="sparse", out_dtype=out_dtype)
    stats = {"layout": "sparse", "cap1": cap1, "cap2": cap2, "cap3": cap3,
             "active_l1": n1, "active_l2": n2, "active_l3": n3,
             "payload_bytes": int(fill2.nbytes + vals2.nbytes
                                  + ids2.nbytes),
             "effective_voxels": res ** 3}
    return (fill2, vals2, ids2), _counts(
        stats, {"active_l1": cap1, "active_l2": cap2, "active_l3": cap3},
        check_overflow)


def _stack_shapes(outs: list):
    """Per-shape results -> batched: a tensor, or a tuple of tensors,
    stacked along a new leading axis (what vmap returns)."""
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def decode_grid_hierarchical2_batch(apply_fn: ApplyFn, zs: torch.Tensor,
                                    res: int, b1: int = 16, b2: int = 4,
                                    cap1: int = 1024, cap2: int = 9216,
                                    safety: float = 1.2,
                                    layout: str = "block",
                                    check_overflow: bool = True):
    """Two-level sparse decode of a batch of latents zs [S, L], shape by
    shape at the batch's caps. Returns (grids [S, ...], stats); the
    active counts are [S] arrays. Default layout "block" ([S, nb2^3,
    b2^3]); unblock on the host per shape."""
    _check_blocks(res, b1, b2)
    S = int(zs.shape[0])
    cap1 = min(cap1, (res // b1) ** 3)
    cap2 = min(cap2, cap1 * (b1 // b2) ** 3)
    if layout == "auto":
        layout = auto_layout(res, b2)
    ppg = max(b2 ** 3, _MAX_POINTS_PER_GROUP // S)
    outs = [_decode_grid_hier2_impl(apply_fn, z, res, b1, b2, cap1, cap2,
                                    safety=safety, layout=layout,
                                    points_per_group=ppg) for z in zs]
    grids, n1, n2 = (_stack_shapes(list(o)) for o in zip(*outs))
    stats = {
        "layout": layout,
        "coarse_evals": S * (res // b1) ** 3,
        "mid_evals": S * cap1 * (b1 // b2) ** 3,
        "fine_evals": S * cap2 * b2 ** 3,
        "active_l1": n1, "active_l2": n2,
        "cap1": cap1, "cap2": cap2,
        "effective_voxels": S * res ** 3,
    }
    return grids, _counts(stats, {"active_l1": cap1, "active_l2": cap2},
                          check_overflow)


def decode_grid_hierarchical3_batch(apply_fn: ApplyFn, zs: torch.Tensor,
                                    res: int, b1: int = 16, b2: int = 4,
                                    b3: int = 2, cap1: int = 1024,
                                    cap2: int = 9216, cap3: int = 24576,
                                    safety: float = 1.2,
                                    safety3: float = 2.0,
                                    layout: str = "block",
                                    out_dtype: str = "float32",
                                    check_overflow: bool = True):
    """Three-level sparse decode of a batch of latents zs [S, L], shape by
    shape at the batch's caps, with points_per_group max(b3^3, 2^20 / S)
    (the reference's vmapped grouping). The finest selection level gets
    the widened safety3 margin (default 2.0), as the single-shape serving
    path does. Returns (grids [S, ...], stats); the active counts are [S]
    arrays. Default layout "block" ([S, nb2^3, b2^3])."""
    _check_blocks(res, b1, b2, b3)
    S = int(zs.shape[0])
    cap1, cap2, cap3 = _caps3(res, b1, b2, b3, cap1, cap2, cap3)
    if layout == "auto":
        layout = auto_layout(res, b2)
    ppg = max(b3 ** 3, _MAX_POINTS_PER_GROUP // S)
    outs = [_decode_grid_hier3_impl(apply_fn, z, res, b1, b2, b3, cap1,
                                    cap2, cap3, safety=safety,
                                    safety3=safety3, layout=layout,
                                    points_per_group=ppg,
                                    out_dtype=out_dtype) for z in zs]
    grids, n1, n2, n3 = (_stack_shapes(list(o)) for o in zip(*outs))
    stats = {
        "layout": layout,
        "coarse_evals": S * (res // b1) ** 3,
        "mid_evals": S * cap1 * (b1 // b2) ** 3,
        "sub_evals": S * cap2 * (b2 // b3) ** 3,
        "fine_evals": S * cap3 * b3 ** 3,
        "active_l1": n1, "active_l2": n2, "active_l3": n3,
        "cap1": cap1, "cap2": cap2, "cap3": cap3,
        "effective_voxels": S * res ** 3,
    }
    return grids, _counts(stats, {"active_l1": cap1, "active_l2": cap2,
                                  "active_l3": cap3}, check_overflow)


def probe_bench_caps(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                     safety: float = 1.1, safety3: float = 0.0,
                     headroom: float = 1.25) -> tuple:
    """Measured-active capacity policy for a shape: one generous-cap
    three-level decode measures its true active block counts at the given
    margins; caps = round_up(headroom * active, 128)."""
    nb1 = res // 16
    _, st = decode_grid_hierarchical3_device(
        apply_fn, z, res, 16, 4, 2, nb1 ** 3, res ** 2 // 2, 2 * res ** 2,
        safety=safety, safety3=safety3, layout="block", check_overflow=True)
    if st["capacity_exceeded"]:
        raise RuntimeError(f"probe caps exceeded: {st}")

    def rnd(n):
        return -(-int(headroom * n) // 128) * 128

    return (rnd(st["active_l1"]), rnd(st["active_l2"]),
            rnd(st["active_l3"]))


def decode_grid_hierarchical(apply_fn: ApplyFn, z: torch.Tensor, res: int,
                             block: int = 8, safety: float = 1.5,
                             max_blocks_per_call: int = 4096) -> tuple:
    """Coarse->fine sparse decode driven from the host. Returns (grid
    [res^3] host float32 x-major, stats).

    A block can contain the zero set only if the SDF at its center is
    within half the block diagonal (1-Lipschitz bound) times `safety`.
    Skipped blocks are filled with their center value. The active blocks
    are evaluated in calls of at most max_blocks_per_call, each padded to
    a multiple of 256 blocks (counted in fine_evals: padded evals are
    real compute)."""
    _check_blocks(res, block)
    nb = res // block
    h = 2.0 / (res - 1)
    tau = safety * (block * h * math.sqrt(3.0) / 2.0)

    centers = _eval_block_centers(apply_fn, z, res, block).cpu().numpy()
    active = np.nonzero(np.abs(centers) <= tau)[0].astype(np.int32)
    grid = np.repeat(centers.astype(np.float32), block ** 3).reshape(
        nb, nb, nb, block, block, block)
    total_fine_evals = 0
    K = len(active)
    for start in range(0, K, max_blocks_per_call):
        ids = active[start:start + max_blocks_per_call]
        pad = (-len(ids)) % 256
        ids_p = np.pad(ids, (0, pad), mode="edge") if pad else ids
        vals = _eval_blocks(apply_fn, z, torch.as_tensor(ids_p,
                                                         device=z.device),
                            res, block).cpu().numpy()
        total_fine_evals += vals.size
        vals = vals[:len(ids)]
        bx, by, bz = ids // (nb * nb), (ids // nb) % nb, ids % nb
        grid[bx, by, bz] = vals.reshape(-1, block, block, block)
    grid = grid.transpose(0, 3, 1, 4, 2, 5).reshape(res, res, res)
    stats = {
        "coarse_evals": centers.size,
        "fine_evals": total_fine_evals,
        "active_blocks": int(K),
        "total_blocks": int(nb ** 3),
        "effective_voxels": res ** 3,
    }
    return grid, stats


# ------------------------------------------------ flattened batched decode
#
# The flat decode compacts the active blocks of ALL shapes of a batch into
# one global work list per level (ids carry the shape through shape-major
# flat indexing, s * nb^3 + local id), so a heterogeneous batch does work
# ~ the sum of its actives plus one shared headroom, not S times the
# largest shape's. Its evaluator takes a latent row per point:
# ops.cuda_kernels.make_kernel_apply_pairs (or ops.fused_decoder.fast_apply
# over z rows). An evaluator with an `indexed(zs, sids, xyz)` method (the
# kernel's wrapper) reads each point's row from zs itself, so no rows are
# gathered.

PairsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
"""(z_rows [N, L], xyz [N,3]) -> sdf [N]: every point with its own latent
row."""

_PAIRS_POINTS_PER_GROUP = 1 << 19


def _eval_pairs_grouped(pairs_fn: PairsFn, zs: torch.Tensor,
                        sids: torch.Tensor, xyz: torch.Tensor,
                        points_per_group: int = _PAIRS_POINTS_PER_GROUP
                        ) -> torch.Tensor:
    """pairs_fn over (zs[sids], xyz) in bounded-memory groups.

    With `pairs_fn.indexed` each group is one indexed call on (zs, the
    group's ids, its points). Otherwise the latent rows are gathered per
    group, so the transient is group * L rows, not the whole work list's;
    zs is gathered in its own dtype (bf16 codes on the production path,
    f32 in the parity tests). Groups are balanced, the last padded with
    the edge point."""
    indexed = getattr(pairs_fn, "indexed", None)

    def run(s, x):
        if indexed is not None:
            return indexed(zs, s, x)
        return pairs_fn(zs.index_select(0, s), x)

    n = xyz.shape[0]
    if n <= points_per_group:
        return run(sids, xyz)
    ngroups = math.ceil(n / points_per_group)
    group = math.ceil(n / ngroups)
    pad = ngroups * group - n
    sids_p = torch.cat([sids, sids[-1:].expand(pad)]).reshape(ngroups, group)
    xyz_p = torch.cat([xyz, xyz[-1:].expand(pad, 3)]).reshape(
        ngroups, group, 3)
    out = torch.empty((ngroups, group), dtype=torch.float32, device=xyz.device)
    for g in range(ngroups):
        out[g] = run(sids_p[g], xyz_p[g])
    return out.reshape(ngroups * group)[:n]


def _fill_cascade_gather_flat(c1: torch.Tensor, c2: torch.Tensor,
                              idx1: torch.Tensor, valid1: torch.Tensor,
                              S: int, nb1: int, nb2: int, r1: int,
                              cap1: int) -> torch.Tensor:
    """The b2-granularity fill of every shape, [S*nb2^3]: c1 broadcast to
    its r1^3 children, replaced by the c2 row where the parent refined.
    The shape-major b1 id ((s*nb1 + x1)*nb1 + y1)*nb1 + z1 factors s into
    the leading axis of the transpose, so children stay in their shape's
    segment."""
    n1 = S * nb1 ** 3
    inv1 = torch.full((n1 + 1,), cap1, dtype=torch.int32, device=c1.device)
    inv1.scatter_(0, torch.where(valid1, idx1, n1).long(),
                  torch.arange(cap1, dtype=torch.int32, device=c1.device))
    inv1 = inv1[:n1]
    c2_pad = torch.cat([c2, c2.new_zeros((1, r1 ** 3))])
    rows = c2_pad[torch.clamp(inv1, max=cap1).long()]       # [S*nb1^3, r1^3]
    rows = torch.where((inv1 < cap1)[:, None], rows, c1[:, None])
    rows = rows.reshape(S * nb1, nb1, nb1, r1, r1, r1)
    return rows.permute(0, 3, 1, 4, 2, 5).reshape(S * nb2 ** 3)


def _repeat(t: torch.Tensor, k: int) -> torch.Tensor:
    """Each element k times in a row (jnp.repeat), without a host sync."""
    return t[:, None].expand(-1, k).reshape(-1)


def _decode_flat_impl(pairs_fn: PairsFn, zs: torch.Tensor, S: int,
                      res: int, b1: int, b2: int, b3: int, cap1: int,
                      cap2: int, cap3: int, safety: float, safety3: float,
                      out_dtype: str,
                      points_per_group: int = _PAIRS_POINTS_PER_GROUP):
    """The flat batched decode, enqueued with no host sync: the same
    levels, thresholds and fills as _decode_grid_hier3_impl, compacted
    over the whole batch. Returns (grids [S, nb2^3, b2^3] block layout,
    n1, n2, n3, per_shape_l1 [S]), counts as device scalars."""
    r1, r2 = b1 // b2, b2 // b3
    nb1, nb2, nb3 = res // b1, res // b2, res // b3
    h = 2.0 / (res - 1)
    tau1 = safety * (b1 * h * math.sqrt(3.0) / 2.0)
    tau2 = safety * (b2 * h * math.sqrt(3.0) / 2.0)
    tau3 = (safety3 or safety) * (b3 * h * math.sqrt(3.0) / 2.0)
    conv, _ = _quantizers(out_dtype, tau2, b2)
    dev = zs.device

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    # ---- L0: every shape's b1-block centers
    flat = arange(nb1 ** 3)
    ijk = torch.stack([flat // (nb1 * nb1), (flat // nb1) % nb1,
                       flat % nb1], -1).to(torch.float32)
    xyz_c = (ijk * b1 + (b1 - 1) / 2.0) * h - 1.0
    c1 = _eval_pairs_grouped(pairs_fn, zs, _repeat(arange(S), nb1 ** 3),
                             xyz_c.repeat(S, 1), points_per_group)
    mask1 = c1.abs() <= tau1                                 # [S*nb1^3]
    idx1, valid1, n1, _ = _compact(mask1, cap1)

    # ---- L1: b2 sub-centers of selected parents (global ids)
    s1, l1 = idx1 // nb1 ** 3, idx1 % nb1 ** 3
    x1, y1, z1 = l1 // (nb1 * nb1), (l1 // nb1) % nb1, l1 % nb1
    off = arange(r1 ** 3)
    ox, oy, oz = off // (r1 * r1), (off // r1) % r1, off % r1
    sx = x1[:, None] * r1 + ox[None, :]
    sy = y1[:, None] * r1 + oy[None, :]
    sz = z1[:, None] * r1 + oz[None, :]
    sub_ids = s1[:, None] * nb2 ** 3 + (sx * nb2 + sy) * nb2 + sz
    cidx = torch.stack([sx, sy, sz], -1).to(torch.float32) * b2 \
        + (b2 - 1) / 2.0
    c2 = _eval_pairs_grouped(
        pairs_fn, zs, _repeat(s1, r1 ** 3),
        (cidx * h - 1.0).reshape(cap1 * r1 ** 3, 3),
        points_per_group).reshape(cap1, r1 ** 3)
    act2 = (c2.abs() <= tau2) & valid1[:, None]
    sel2, valid2, n2, _ = _compact(act2.reshape(-1), cap2)
    ids2 = sub_ids.reshape(-1)[sel2.long()]                  # global b2 ids

    # ---- L2: b3 sub-centers of selected b2 blocks
    s2, l2 = ids2 // nb2 ** 3, ids2 % nb2 ** 3
    x2, y2, z2 = l2 // (nb2 * nb2), (l2 // nb2) % nb2, l2 % nb2
    off3 = arange(r2 ** 3)
    px, py, pz = off3 // (r2 * r2), (off3 // r2) % r2, off3 % r2
    tx = x2[:, None] * r2 + px[None, :]
    ty = y2[:, None] * r2 + py[None, :]
    tz = z2[:, None] * r2 + pz[None, :]
    sub3_ids = s2[:, None] * nb3 ** 3 + (tx * nb3 + ty) * nb3 + tz
    c3idx = torch.stack([tx, ty, tz], -1).to(torch.float32) * b3 \
        + (b3 - 1) / 2.0
    c3 = _eval_pairs_grouped(
        pairs_fn, zs, _repeat(s2, r2 ** 3),
        (c3idx * h - 1.0).reshape(cap2 * r2 ** 3, 3),
        points_per_group).reshape(cap2, r2 ** 3)
    act3 = (c3.abs() <= tau3) & valid2[:, None]
    sel3, _, n3, slot_rank = _compact(act3.reshape(-1), cap3)
    ids3 = sub3_ids.reshape(-1)[sel3.long()]                 # global b3 ids

    # ---- L3: fine voxels of selected b3 blocks
    vals3 = _eval_pairs_grouped(
        pairs_fn, zs, _repeat(ids3 // nb3 ** 3, b3 ** 3),
        _block_points(ids3 % nb3 ** 3, res, b3).reshape(cap3 * b3 ** 3, 3),
        points_per_group).reshape(cap3, b3 ** 3)

    # ---- compose b2 rows (as the single-shape decode)
    inv_slot = slot_rank.reshape(cap2, r2 ** 3)
    vals3_pad = torch.cat([vals3, vals3.new_zeros((1, b3 ** 3))])
    picked = vals3_pad[torch.clamp(inv_slot, max=cap3).long()]
    vals2 = torch.where((inv_slot < cap3)[..., None], picked, c3[..., None])
    vals2 = vals2.reshape(cap2, r2, r2, r2, b3, b3, b3)
    vals2 = vals2.permute(0, 1, 4, 2, 5, 3, 6).reshape(cap2, b2 ** 3)

    fill2 = _fill_cascade_gather_flat(c1, c2, idx1, valid1, S, nb1, nb2,
                                      r1, cap1)
    vals2, fill2 = conv(vals2), conv(fill2)
    # block-layout assembly over the S*nb2^3 global block axis
    grids = _assemble_blocks(fill2, vals2, ids2, valid2, res, b2,
                             "block").reshape(S, nb2 ** 3, b2 ** 3)
    per_shape_l1 = mask1.reshape(S, nb1 ** 3).sum(1, dtype=torch.int32)
    return grids, n1, n2, n3, per_shape_l1


def decode_grid_hierarchical3_batch_flat(
        pairs_fn: PairsFn, zs: torch.Tensor, res: int, b1: int = 16,
        b2: int = 4, b3: int = 2, cap1: int = 16384, cap2: int = 147456,
        cap3: int = 393216, safety: float = 1.2, safety3: float = 2.0,
        out_dtype: str = "float32", check_overflow: bool = True,
        points_per_group: int = _PAIRS_POINTS_PER_GROUP):
    """Flattened three-level batched decode of zs [S, L]: work ~ the sum of
    the shapes' actives.

    caps are global totals across the batch (probe_flat_caps). Returns
    (grids [S, (res/b2)^3, b2^3] in block layout on zs's device, stats).
    Thresholds, fills and sign-exactness are those of the single-shape
    decode. `out_dtype` "float32", "bfloat16" or "int8" (sign-preserving
    at tau2/127, as hier3_int8_scale). With check_overflow=False nothing
    waits on the device: the active counts stay device scalars."""
    if out_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unsupported payload dtype {out_dtype!r} for the "
                         "flat decode (float32, bfloat16, int8)")
    _check_blocks(res, b1, b2, b3)
    S = int(zs.shape[0])
    r1, r2 = b1 // b2, b2 // b3
    nb1 = res // b1
    cap1 = min(cap1, S * nb1 ** 3)
    cap2 = min(cap2, cap1 * r1 ** 3)
    cap3 = min(cap3, cap2 * r2 ** 3)
    grids, n1, n2, n3, per_shape_l1 = _decode_flat_impl(
        pairs_fn, zs, S, res, b1, b2, b3, cap1, cap2, cap3, float(safety),
        float(safety3), out_dtype, points_per_group)
    stats = {
        "layout": "block",
        "coarse_evals": S * nb1 ** 3,
        "mid_evals": cap1 * r1 ** 3,
        "sub_evals": cap2 * r2 ** 3,
        "fine_evals": cap3 * b3 ** 3,
        "active_l1": n1, "active_l2": n2, "active_l3": n3,
        "cap1": cap1, "cap2": cap2, "cap3": cap3,
        "effective_voxels": S * res ** 3,
    }
    if check_overflow:
        stats["active_l1"] = int(n1)
        stats["active_l2"] = int(n2)
        stats["active_l3"] = int(n3)
        stats["per_shape_l1"] = per_shape_l1.cpu().numpy()
        stats["capacity_exceeded"] = (stats["active_l1"] > cap1
                                      or stats["active_l2"] > cap2
                                      or stats["active_l3"] > cap3)
    return grids, stats


def probe_flat_caps(pairs_fn: PairsFn, zs: torch.Tensor, res: int,
                    safety: float = 1.2, safety3: float = 2.0,
                    headroom: float = 1.25, chunk: int = 16) -> tuple:
    """Measured-active + headroom global caps for the flat decode: generous
    cap decodes of `chunk` shapes at a time measure each level's total
    actives (a shape's actives do not depend on its batch-mates, so the
    chunks' counts add up); caps = round_up(headroom * total, 512)."""
    S = int(zs.shape[0])
    nb1 = res // 16
    tot1 = tot2 = tot3 = 0
    for s0 in range(0, S, chunk):
        zc = zs[s0:s0 + chunk]
        Sc = int(zc.shape[0])
        # bf16 grids: only the counts matter here
        _, st = decode_grid_hierarchical3_batch_flat(
            pairs_fn, zc, res, 16, 4, 2, Sc * nb1 ** 3, Sc * res ** 2 // 2,
            Sc * 2 * res ** 2, safety=safety, safety3=safety3,
            out_dtype="bfloat16", check_overflow=True)
        if st["capacity_exceeded"]:
            raise RuntimeError(f"probe caps exceeded: {st}")
        tot1 += st["active_l1"]
        tot2 += st["active_l2"]
        tot3 += st["active_l3"]

    def rnd(n):
        return -(-int(headroom * n) // 512) * 512

    return (rnd(tot1), rnd(tot2), rnd(tot3))


def unblock_grid(block_grid: np.ndarray, res: int, block: int) -> np.ndarray:
    """Host-side block layout -> x-major [res,res,res] (numpy view ops)."""
    nb = res // block
    g = np.asarray(block_grid).reshape(nb, nb, nb, block, block, block)
    return np.ascontiguousarray(
        g.transpose(0, 3, 1, 4, 2, 5)).reshape(res, res, res)


# ------------------------------------------- host-side payload (numpy)


def _sparse2_dequant(a, dequant_scale):
    a = np.asarray(a)
    if a.dtype == np.int8:
        if dequant_scale is None:
            raise ValueError(
                "int8 payload needs dequant_scale (hier3_int8_scale)")
        return a.astype(np.float32) * (dequant_scale / 127.0)
    if a.dtype == np.uint8:
        # packed int4 fine rows: two's-complement nibbles, even index
        # low, odd index high; clip scale tau2/2
        if dequant_scale is None:
            raise ValueError(
                "int4 payload needs dequant_scale (hier3_int8_scale)")
        lo = (a & 0xF).astype(np.int8)
        hi = ((a >> 4) & 0xF).astype(np.int8)
        lo = np.where(lo > 7, lo - 16, lo)
        hi = np.where(hi > 7, hi - 16, hi)
        out = np.empty(a.shape[:-1] + (a.shape[-1] * 2,), np.float32)
        out[..., 0::2] = lo
        out[..., 1::2] = hi
        return out * (dequant_scale / 14.0)
    return a


def sparse2_fill2(c1, c2, idx1, n1: int, res: int, b1: int, b2: int,
                  dequant_scale: float = None,
                  dtype=np.float32) -> np.ndarray:
    """Rebuild the b2-granularity fill cascade [nb2^3] of the v2 payload:
    c1 broadcast to b2 blocks, active-parent c2 rows scattered over their
    sub-block ids (the host mirror of the decode's cascade). This array
    plus the fine rows is everything the payload-direct mesher needs."""
    r1 = b1 // b2
    nb1, nb2 = res // b1, res // b2
    bx = np.arange(nb2, dtype=np.int64) // r1
    parent = (bx[:, None, None] * nb1 + bx[None, :, None]) * nb1 \
        + bx[None, None, :]
    fill2 = np.asarray(_sparse2_dequant(c1, dequant_scale),
                       dtype)[parent.reshape(-1)].copy()
    i1 = np.asarray(idx1[:n1]).astype(np.int64)
    x1, y1, z1 = i1 // (nb1 * nb1), (i1 // nb1) % nb1, i1 % nb1
    off = np.arange(r1 ** 3, dtype=np.int64)
    ox, oy, oz = off // (r1 * r1), (off // r1) % r1, off % r1
    sub = ((x1[:, None] * r1 + ox[None, :]) * nb2
           + (y1[:, None] * r1 + oy[None, :])) * nb2 \
        + (z1[:, None] * r1 + oz[None, :])
    fill2[sub.reshape(-1)] = np.asarray(
        _sparse2_dequant(c2[:n1], dequant_scale), dtype).reshape(-1)
    return fill2


def sparse2_to_grid(c1, c2, idx1, vals2, ids2, n1: int, n2: int,
                    res: int, b1: int, b2: int,
                    dequant_scale: float = None,
                    dtype=np.float32) -> np.ndarray:
    """Host-side reconstruction of the compact v2 payload (numpy arrays):
    sparse2_fill2 cascade + sparse_to_grid. int8/int4 payloads require
    `dequant_scale` (= hier3_int8_scale of the decode's (res, b2,
    safety))."""
    fill2 = sparse2_fill2(c1, c2, idx1, n1, res, b1, b2,
                          dequant_scale, dtype)
    return sparse_to_grid(fill2, _sparse2_dequant(vals2, dequant_scale),
                          ids2, n2, res, b2, dtype)


def sparse_to_grid(fill2: np.ndarray, vals2: np.ndarray, ids2: np.ndarray,
                   n_active: int, res: int, b2: int,
                   dtype=np.float32) -> np.ndarray:
    """Host-side reconstruction of a sparse decode into an x-major grid,
    built directly through a [nb,b2,nb,b2,nb,b2] view: every block starts
    from its fill value and the n_active fine rows land via one mixed
    fancy/slice assignment."""
    nb = res // b2
    g = np.empty((res, res, res), dtype)
    gv = g.reshape(nb, b2, nb, b2, nb, b2)            # contiguous view
    gv[:] = np.asarray(fill2, dtype).reshape(nb, nb, nb)[
        :, None, :, None, :, None]
    ids = np.asarray(ids2[:n_active], np.int64)
    xs, ys, zs = ids // (nb * nb), (ids // nb) % nb, ids % nb
    # advanced indices first, sliced dims after: target [n_active,b2^3]
    gv[xs, :, ys, :, zs, :] = np.asarray(
        vals2[:n_active], dtype).reshape(-1, b2, b2, b2)
    return g
