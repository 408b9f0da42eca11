"""Analytic SDFs sampled on the device, batched over shapes, and the
sample banks built from them.

Counterpart of the JAX package's `data/analytic_jax.py`. Every chair from
`analytic.make_chair` shares one CSG structure (2 boxes + 4 capsules),
and every classes13 shape is one op (union or difference) over at most
six primitives, so a split packs into fixed-shape parameter tensors
(`ChairParams`, `CsgParams`) and the preprocessor's sampling design
(Newton-projected surface points, two Gaussian shells, a uniform filler,
exact analytic labels; `analytic.sample_sdf_points`) runs on the card for
a block of shapes at once. `bank_from_chairs` / `bank_from_csg` build a
whole split's `DeviceSampleBank` that way, chunk by chunk, each chunk's
draws from a generator keyed by (seed, chunk start). The random streams
are torch's; parity with the reference is statistical, the labels exact.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
    DeviceSampleBank)
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)


class ChairParams(NamedTuple):
    """Packed parameters of S chairs (analytic.make_chair structure)."""

    box_b: torch.Tensor   # [S, 2, 3] half-extents (seat, backrest)
    box_c: torch.Tensor   # [S, 2, 3] centers
    cap_a: torch.Tensor   # [S, 4, 3] leg segment tops
    cap_b: torch.Tensor   # [S, 4, 3] leg segment bottoms
    cap_r: torch.Tensor   # [S, 4]    leg radii

    @property
    def num_shapes(self) -> int:
        return self.box_b.shape[0]

    def slice(self, start: int, size: int) -> "ChairParams":
        return ChairParams(*(a[start:start + size] for a in self))


def pack_chairs(shapes: list, device="cpu") -> ChairParams:
    """Pack `analytic.make_chair` trees into ChairParams on `device`."""
    S = len(shapes)
    bb = np.zeros((S, 2, 3), np.float32)
    bc = np.zeros((S, 2, 3), np.float32)
    ca = np.zeros((S, 4, 3), np.float32)
    cb = np.zeros((S, 4, 3), np.float32)
    cr = np.zeros((S, 4), np.float32)
    for i, s in enumerate(shapes):
        if s["type"] != "union":
            raise ValueError(f"not a make_chair tree: {s['type']}")
        boxes = [c for c in s["children"] if c["type"] == "box"]
        caps = [c for c in s["children"] if c["type"] == "capsule"]
        if len(boxes) != 2 or len(caps) != 4:
            raise ValueError("not a make_chair tree")
        for j, b in enumerate(boxes):
            bb[i, j] = b["b"]
            bc[i, j] = b.get("c", (0.0, 0.0, 0.0))
        for j, c in enumerate(caps):
            ca[i, j] = c["a"]
            cb[i, j] = c["b"]
            cr[i, j] = c["r"]
    return ChairParams(*(torch.from_numpy(a).to(device)
                         for a in (bb, bc, ca, cb, cr)))


def chair_sdf(params: ChairParams, p: torch.Tensor) -> torch.Tensor:
    """SDF of S chairs at points p [S, n, 3] -> [S, n]: the union (min) of
    the exact box and capsule SDFs, as analytic.sdf on a make_chair tree."""
    q = (torch.abs(p[:, :, None, :] - params.box_c[:, None])
         - params.box_b[:, None])                                # [S,n,2,3]
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, -1)
                         + 1e-30)
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    d_box = torch.amin(outside + inside, dim=-1)                 # [S, n]

    ab = params.cap_b - params.cap_a                             # [S, 4, 3]
    pa = p[:, :, None, :] - params.cap_a[:, None]                # [S,n,4,3]
    t = torch.clamp(torch.sum(pa * ab[:, None], -1)
                    / torch.sum(ab * ab, -1)[:, None], 0.0, 1.0)
    closest = pa - t[..., None] * ab[:, None]
    d_cap = torch.amin(torch.sqrt(torch.sum(closest ** 2, -1) + 1e-30)
                       - params.cap_r[:, None], dim=-1)
    return torch.minimum(d_box, d_cap)


def _surface_points_any(sdf_fn: Callable, generator: torch.Generator,
                        num_shapes: int, m: int, device,
                        iters: int = 12) -> torch.Tensor:
    """Newton-project m uniform points per shape onto sdf_fn's zero set:
    x <- clip(x - d * g/|g|, -1.1, 1.1), `iters` times, with autograd's
    gradient. `sdf_fn` maps [S, m, 3] -> [S, m]. Returns [S, m, 3]."""
    x = torch.rand((num_shapes, m, 3), generator=generator,
                   device=device) * 2.0 - 1.0
    with torch.enable_grad():
        for _ in range(iters):
            x = x.detach().requires_grad_(True)
            d = sdf_fn(x)
            g, = torch.autograd.grad(d.sum(), x)
            gn = torch.clamp(torch.sqrt(torch.sum(g * g, -1, keepdim=True)),
                             min=1e-8)
            x = torch.clamp(x - d.detach()[..., None] * g / gn, -1.1, 1.1)
    return x.detach()


def _surface_points(params: ChairParams, generator: torch.Generator, m: int,
                    iters: int = 12) -> torch.Tensor:
    """_surface_points_any on chair_sdf: [S, m, 3]."""
    return _surface_points_any(lambda x: chair_sdf(params, x), generator,
                               params.num_shapes, m, params.box_b.device,
                               iters)


def sample_sdf_points_device_any(sdf_fn: Callable,
                                 generator: torch.Generator, n: int,
                                 num_shapes: int, device,
                                 surface_frac: float = 0.95,
                                 noise_stds=(0.05, 0.0158)) -> tuple:
    """Preprocessor-contract sampling of S shapes on `device`:
    (xyz [S, n, 3], sdf [S, n]). Parts, in order: n_surf // 2 points of
    the std-0.05 shell and the rest of n_surf of the std-0.0158 shell
    around Newton-projected surface points (drawn with replacement), then
    n - n_surf uniform points in [-1, 1]^3; n_surf = int(n *
    surface_frac). Labels are sdf_fn of the points."""
    S = num_shapes
    n_surf = int(n * surface_frac)
    n_unif = n - n_surf
    half = n_surf // 2
    m = max(half, n_surf - half)
    base = _surface_points_any(sdf_fn, generator, S, m, device)
    parts = []
    for std, k in zip(noise_stds, (half, n_surf - half)):
        idx = torch.randint(0, m, (S, k), generator=generator, device=device)
        pts = torch.gather(base, 1, idx[..., None].expand(S, k, 3))
        parts.append(pts + std * torch.randn((S, k, 3), generator=generator,
                                             device=device))
    parts.append(torch.rand((S, n_unif, 3), generator=generator,
                            device=device) * 2.0 - 1.0)
    xyz = torch.cat(parts, dim=1)
    return xyz, sdf_fn(xyz)


def sample_sdf_points_device(params: ChairParams,
                             generator: torch.Generator, n: int,
                             surface_frac: float = 0.95,
                             noise_stds=(0.05, 0.0158)) -> tuple:
    """sample_sdf_points_device_any on chair_sdf: (xyz [S, n, 3],
    sdf [S, n])."""
    return sample_sdf_points_device_any(
        lambda x: chair_sdf(params, x), generator, n, params.num_shapes,
        params.box_b.device, surface_frac, noise_stds)


# ------------------------------------------------------------------ banks

def _sign_split(rows: torch.Tensor, d: torch.Tensor) -> tuple:
    """Rows [C, n, 4] with labels d [C, n] -> (pos [C, n, 4], neg
    [C, n, 4], pos_count [C], neg_count [C]): each array holds all n rows,
    stably sorted so its side comes first (the slots the bank's draw
    reads, i < count). A side with no rows gets count n: the draw then
    reads the whole set, as SdfDataset.sample_scene's top-up does."""
    n = rows.shape[1]
    neg_flag = d < 0.0
    order_pos = torch.sort(neg_flag.to(torch.uint8), dim=1,
                           stable=True).indices
    order_neg = torch.sort((~neg_flag).to(torch.uint8), dim=1,
                           stable=True).indices
    pos = torch.gather(rows, 1, order_pos[..., None].expand_as(rows))
    neg = torch.gather(rows, 1, order_neg[..., None].expand_as(rows))
    nneg = neg_flag.sum(1, dtype=torch.int32)
    npos = torch.where(nneg == n, n, n - nneg).int()
    nneg = torch.where(nneg == 0, n, nneg).int()
    return pos, neg, npos, nneg


def _chunk_generator(seed: int, start: int, device) -> torch.Generator:
    """A generator on `device` keyed by (seed, start)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), int(start)])
                        .generate_state(1, np.uint64)[0]))
    return gen


def _bank_chunk(params: ChairParams, generator: torch.Generator,
                n: int) -> tuple:
    """Sign-split sample rows of a chunk of chairs: (pos, neg, pos_count,
    neg_count) as _sign_split returns them."""
    xyz, d = sample_sdf_points_device(params, generator, n)
    return _sign_split(torch.cat([xyz, d[..., None]], dim=-1), d)


def _bank(params, chunk_fn: Callable, seed: int, n: int, chunk: int,
          device) -> DeviceSampleBank:
    """The bank of a packed split at n samples a shape, built chunk by
    chunk (chunk_fn(params of the chunk, generator, n), the generator
    keyed by (seed, chunk start)) into preallocated [S, n, 4] rows."""
    S = params.num_shapes
    pos = torch.empty((S, n, 4), dtype=torch.float32, device=device)
    neg = torch.empty_like(pos)
    pc = torch.empty((S,), dtype=torch.int32, device=device)
    nc = torch.empty_like(pc)
    for start in range(0, S, chunk):
        size = min(chunk, S - start)
        sl = slice(start, start + size)
        pos[sl], neg[sl], pc[sl], nc[sl] = chunk_fn(
            params.slice(start, size), _chunk_generator(seed, start, device),
            n)
    return DeviceSampleBank(pos, neg, pc, nc)


def bank_from_chairs(shapes: list, seed: int, samples_per_shape: int,
                     chunk: int = 512, device="cuda") -> DeviceSampleBank:
    """A DeviceSampleBank of a chair split built on `device`: the host
    packs only the parameters; sampling, labels and the sign split run
    on the device."""
    dev = resolve_device(device)
    return _bank(pack_chairs(shapes, device=dev), _bank_chunk, seed,
                 samples_per_shape, chunk, dev)


# -------------------------------------------------------- generic CSG pack
# A classes13 shape (analytic.FAMILIES_13) is `op(children=primitives)`,
# op in {union, difference}, with at most six primitive children (a chair
# is a union of 2 boxes + 4 capsules, a single primitive a 1-child union),
# so a whole split packs into fixed-shape tensors.

MAX_PRIMS = 6
_PRM_W = 10  # parameter slab per primitive (superset layout below)


class CsgParams(NamedTuple):
    """Packed op-of-primitives for S shapes.

    ptype [S, K] int32: 0 sphere, 1 box, 2 torus, 3 capsule, -1 inactive
    prm   [S, K, 10] f32:
        sphere:  [c0 c1 c2 r  . . . . . .]
        box:     [b0 b1 b2 c0 c1 c2 . . . .]
        torus:   [R r c0 c1 c2 . . . . .]
        capsule: [a0 a1 a2 b0 b1 b2 r . . .]
    op    [S] int32: 0 union (min), 1 difference (max(d0, -d_rest))
    """

    ptype: torch.Tensor
    prm: torch.Tensor
    op: torch.Tensor

    @property
    def num_shapes(self) -> int:
        return self.ptype.shape[0]

    def slice(self, start: int, size: int) -> "CsgParams":
        return CsgParams(*(a[start:start + size] for a in self))

    def flat(self) -> torch.Tensor:
        """[S, K*11 + 1] f32 (ptype and op cast to f32): a shape as the
        `z` of grid_eval's ApplyFn (csg_apply_flat)."""
        S = self.num_shapes
        return torch.cat([self.ptype.float().reshape(S, -1),
                          self.prm.reshape(S, -1),
                          self.op.float().reshape(S, 1)], dim=-1)


def _pack_prim(s: dict) -> tuple:
    t = s["type"]
    row = np.zeros((_PRM_W,), np.float32)
    if t == "sphere":
        row[0:3] = np.asarray(s.get("c", (0, 0, 0)), np.float32)
        row[3] = s["r"]
        return 0, row
    if t == "box":
        row[0:3] = np.asarray(s["b"], np.float32)
        row[3:6] = np.asarray(s.get("c", (0, 0, 0)), np.float32)
        return 1, row
    if t == "torus":
        row[0] = s["R"]
        row[1] = s["r"]
        row[2:5] = np.asarray(s.get("c", (0, 0, 0)), np.float32)
        return 2, row
    if t == "capsule":
        row[0:3] = np.asarray(s["a"], np.float32)
        row[3:6] = np.asarray(s["b"], np.float32)
        row[6] = s["r"]
        return 3, row
    raise ValueError(f"not a primitive: {t!r}")


def pack_csg(shapes: list, device="cpu") -> CsgParams:
    """Pack `analytic.make_shape` trees (any classes13 family; depth-1
    trees, all that make_shape makes) into CsgParams on `device`."""
    S = len(shapes)
    ptype = np.full((S, MAX_PRIMS), -1, np.int32)
    prm = np.zeros((S, MAX_PRIMS, _PRM_W), np.float32)
    op = np.zeros((S,), np.int32)
    for i, s in enumerate(shapes):
        t = s["type"]
        if t in ("union", "difference"):
            ch = s["children"]
            if len(ch) > MAX_PRIMS:
                raise ValueError(f"{len(ch)} children > MAX_PRIMS")
            op[i] = 0 if t == "union" else 1
            for j, c in enumerate(ch):
                ptype[i, j], prm[i, j] = _pack_prim(c)
        else:
            ptype[i, 0], prm[i, 0] = _pack_prim(s)
    return CsgParams(*(torch.from_numpy(a).to(device)
                       for a in (ptype, prm, op)))


def csg_sdf(params: CsgParams, p: torch.Tensor) -> torch.Tensor:
    """SDF of S packed shapes at points p [S, n, 3] -> [S, n].

    Every slot evaluates all four primitive formulas and keeps the one
    its type code names (branch-free); the +1e-30 under each sqrt keeps
    the gradient finite at r = 0."""
    prm = params.prm[:, None]                         # [S, 1, K, 10]
    pc = p[:, :, None, :]                             # [S, n, 1, 3]
    d_sph = (torch.sqrt(torch.sum((pc - prm[..., 0:3]) ** 2, -1) + 1e-30)
             - prm[..., 3])
    q = torch.abs(pc - prm[..., 3:6]) - prm[..., 0:3]
    d_box = (torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, -1) + 1e-30)
             + torch.clamp(torch.amax(q, dim=-1), max=0.0))
    qt = pc - prm[..., 2:5]
    xz = torch.sqrt(qt[..., 0] ** 2 + qt[..., 2] ** 2 + 1e-30) - prm[..., 0]
    d_tor = torch.sqrt(xz ** 2 + qt[..., 1] ** 2 + 1e-30) - prm[..., 1]
    a = prm[..., 0:3]
    ab = prm[..., 3:6] - a
    pa = pc - a
    t = torch.clamp(torch.sum(pa * ab, -1)
                    / torch.clamp(torch.sum(ab * ab, -1), min=1e-12),
                    0.0, 1.0)
    d_cap = (torch.sqrt(torch.sum((pa - t[..., None] * ab) ** 2, -1)
                        + 1e-30) - prm[..., 6])
    tt = params.ptype[:, None]                        # [S, 1, K]
    d_all = torch.where(tt == 0, d_sph,
                        torch.where(tt == 1, d_box,
                                    torch.where(tt == 2, d_tor, d_cap)))
    act = tt >= 0
    du = torch.amin(torch.where(act, d_all, torch.inf), dim=-1)
    # difference: slot 0 is always active; the rest subtract
    rest = torch.where(act[..., 1:], -d_all[..., 1:], -torch.inf)
    dd = torch.maximum(d_all[..., 0], torch.amax(rest, dim=-1))
    return torch.where(params.op[:, None] == 0, du, dd)


def csg_apply_flat(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """grid_eval ApplyFn over one CsgParams.flat() row z [K*11 + 1] and
    points p [N, 3] -> [N]: decodes a classes13 shape's analytic SDF
    through the same decodes as the learned decoder."""
    K = MAX_PRIMS
    params = CsgParams(ptype=z[None, :K].int(),
                       prm=z[K:K + K * _PRM_W].reshape(1, K, _PRM_W),
                       op=z[-1:].int())
    return csg_sdf(params, p[None])[0]


def _bank_chunk_csg(params: CsgParams, generator: torch.Generator,
                    n: int) -> tuple:
    """_bank_chunk for a chunk of packed CSG shapes."""
    xyz, d = sample_sdf_points_device_any(
        lambda x: csg_sdf(params, x), generator, n, params.num_shapes,
        params.prm.device)
    return _sign_split(torch.cat([xyz, d[..., None]], dim=-1), d)


def bank_from_csg(shapes: list, seed: int, samples_per_shape: int,
                  chunk: int = 512, device="cuda") -> DeviceSampleBank:
    """A DeviceSampleBank of any classes13 split built on `device`: the
    multi-category twin of bank_from_chairs."""
    dev = resolve_device(device)
    return _bank(pack_csg(shapes, device=dev), _bank_chunk_csg, seed,
                 samples_per_shape, chunk, dev)
