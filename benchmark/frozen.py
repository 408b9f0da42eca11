"""Frozen copies of what the references need from the port's semantics.

The references decide `correct`, so nothing here imports the port: each
function is a copy taken at the commit that introduced the benchmark, and
later changes to the port do not move it. Known answers hold each copy in
benchmark/tests/test_bench_frozen.py.

- `dropout_keep_mask`: the port's dropout mask stream, copied from
  `ops/relu_dropout.py` (`layer_seed`, `keep_threshold`, `_mulhilo`,
  `philox4x32_10`, `dropout_keep_bits`, `dropout_keep_mask`): element
  (r, c) of a layer's [rows, H] activation is kept iff word c % 4 of
  Philox4x32-10 at counter (c // 4, r mod 2^32, r >> 32, 0) and key
  (seed mod 2^32, 0) is >= min(rate * 2^32, 2^32 - 1).
- `chair_sdf`: the exact SDF of a chair (two boxes and four capsules),
  copied from `data/analytic_device.chair_sdf`.
- `make_chairs`: the chair family's parameter ranges, from
  `data/analytic.make_chair`, drawn here in bulk from the benchmark's own
  seed (not the port's stream), with the trees the port's bank builder
  reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def layer_seed(seed: int, layer: int) -> int:
    """seed + 7919 * layer, wrapped to int32."""
    return (int(seed) + 7919 * int(layer) + (1 << 31)) % (1 << 32) - (1 << 31)


def keep_threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mulhilo(a: int, b: torch.Tensor) -> tuple:
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c: list, key: tuple) -> list:
    c0, c1, c2, c3 = c
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return [c0, c1, c2, c3]


def dropout_keep_bits(n_rows: int, n_cols: int, seed: int, row0: int = 0,
                      device="cpu") -> torch.Tensor:
    groups = (n_cols + 3) // 4
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)[:, None].expand(n_rows, groups)
    grp = torch.arange(groups, dtype=torch.int64,
                       device=device)[None, :].expand(n_rows, groups)
    words = philox4x32_10([grp, rows & _MASK32, rows >> 32,
                           torch.zeros_like(rows)], (int(seed), 0))
    return torch.stack(words, dim=-1).reshape(n_rows, 4 * groups)[:, :n_cols]


def dropout_keep_mask(n_rows: int, n_cols: int, seed: int, rate: float,
                      row0: int = 0, device="cpu",
                      chunk: int = 1 << 16) -> torch.Tensor:
    """bool [n_rows, n_cols] for rows row0 .. row0 + n_rows."""
    thr = keep_threshold(rate)
    out = torch.empty(n_rows, n_cols, dtype=torch.bool, device=device)
    for r in range(0, n_rows, chunk):
        n = min(chunk, n_rows - r)
        out[r:r + n] = dropout_keep_bits(n, n_cols, seed, row0 + r,
                                         device) >= thr
    return out


class Chairs(NamedTuple):
    box_b: torch.Tensor   # [S, 2, 3] half-extents (seat, backrest)
    box_c: torch.Tensor   # [S, 2, 3] centers
    cap_a: torch.Tensor   # [S, 4, 3] leg tops
    cap_b: torch.Tensor   # [S, 4, 3] leg bottoms
    cap_r: torch.Tensor   # [S, 4]    leg radii

    def take(self, idx: torch.Tensor) -> "Chairs":
        return Chairs(*(a[idx] for a in self))


# make_chair's ranges, in its order of draws
_CHAIR_RANGES = (("seat_w", 0.35, 0.55), ("seat_d", 0.3, 0.5),
                 ("seat_t", 0.03, 0.07), ("seat_h", -0.1, 0.1),
                 ("leg_r", 0.02, 0.05), ("leg_h", 0.3, 0.5),
                 ("back_h", 0.3, 0.55), ("back_t", 0.03, 0.06),
                 ("lean", 0.0, 0.08))


def make_chairs(n: int, seed: int) -> tuple:
    """n chairs from `seed`: (trees in make_chair's form, Chairs float32
    on the CPU). The same seed gives the same chairs."""
    rng = np.random.default_rng([int(seed), 0xC4A1])
    p = {k: rng.uniform(lo, hi, n) for k, lo, hi in _CHAIR_RANGES}
    bb = np.zeros((n, 2, 3))
    bc = np.zeros((n, 2, 3))
    ca = np.zeros((n, 4, 3))
    cb = np.zeros((n, 4, 3))
    bb[:, 0] = np.stack([p["seat_w"], p["seat_t"], p["seat_d"]], -1)
    bc[:, 0, 1] = p["seat_h"]
    bb[:, 1] = np.stack([p["seat_w"], p["back_h"] / 2, p["back_t"]], -1)
    bc[:, 1, 1] = p["seat_h"] + p["back_h"] / 2
    bc[:, 1, 2] = -p["seat_d"] + p["back_t"] - p["lean"]
    j = 0
    for sx in (-1, 1):
        for sz in (-1, 1):
            x = sx * (p["seat_w"] - p["leg_r"])
            z = sz * (p["seat_d"] - p["leg_r"])
            ca[:, j] = np.stack([x, p["seat_h"], z], -1)
            cb[:, j] = np.stack([x, p["seat_h"] - p["leg_h"], z], -1)
            j += 1
    cr = np.repeat(p["leg_r"][:, None], 4, 1)
    trees = []
    for i in range(n):
        parts = [{"type": "box", "b": bb[i, k].tolist(),
                  "c": bc[i, k].tolist()} for k in range(2)]
        parts += [{"type": "capsule", "a": ca[i, k].tolist(),
                   "b": cb[i, k].tolist(), "r": float(cr[i, k])}
                  for k in range(4)]
        trees.append({"type": "union", "children": parts, "class_id": 0})
    chairs = Chairs(*(torch.from_numpy(a.astype(np.float32))
                      for a in (bb, bc, ca, cb, cr)))
    return trees, chairs


def chair_sdf(params: Chairs, p: torch.Tensor) -> torch.Tensor:
    """SDF of S chairs at points p [S, n, 3] -> [S, n] in p's dtype."""
    params = Chairs(*(a.to(p.device, p.dtype) for a in params))
    q = (torch.abs(p[:, :, None, :] - params.box_c[:, None])
         - params.box_b[:, None])
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, -1)
                         + 1e-30)
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    d_box = torch.amin(outside + inside, dim=-1)

    ab = params.cap_b - params.cap_a
    pa = p[:, :, None, :] - params.cap_a[:, None]
    t = torch.clamp(torch.sum(pa * ab[:, None], -1)
                    / torch.sum(ab * ab, -1)[:, None], 0.0, 1.0)
    closest = pa - t[..., None] * ab[:, None]
    d_cap = torch.amin(torch.sqrt(torch.sum(closest ** 2, -1) + 1e-30)
                       - params.cap_r[:, None], dim=-1)
    return torch.minimum(d_box, d_cap)
