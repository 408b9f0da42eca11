"""Analytic chair SDFs sampled on the device, batched over chairs.

Counterpart of the chair part of the JAX package's `data/analytic_jax.py`
(`ChairParams`, `pack_chairs`, `chair_sdf`, `_surface_points`,
`sample_sdf_points_device`). Every chair from `analytic.make_chair`
shares one CSG structure (2 boxes + 4 capsules), so a split packs into
fixed-shape parameter tensors and the preprocessor's sampling design
(Newton-projected surface points, two Gaussian shells, a uniform filler,
exact analytic labels; `analytic.sample_sdf_points`) runs on the card for
a block of chairs at once. The random streams are torch's, drawn from a
`torch.Generator`; parity with the reference is statistical, the labels
exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def _surface_points(params: ChairParams, generator: torch.Generator, m: int,
                    iters: int = 12) -> torch.Tensor:
    """Newton-project m uniform points per chair onto its zero set:
    x <- clip(x - d * g/|g|, -1.1, 1.1), `iters` times, with autograd's
    gradient of chair_sdf. Returns [S, m, 3]."""
    dev = params.box_b.device
    x = torch.rand((params.num_shapes, m, 3), generator=generator,
                   device=dev) * 2.0 - 1.0
    with torch.enable_grad():
        for _ in range(iters):
            x = x.detach().requires_grad_(True)
            d = chair_sdf(params, x)
            g, = torch.autograd.grad(d.sum(), x)
            gn = torch.clamp(torch.sqrt(torch.sum(g * g, -1, keepdim=True)),
                             min=1e-8)
            x = torch.clamp(x - d.detach()[..., None] * g / gn, -1.1, 1.1)
    return x.detach()


def sample_sdf_points_device(params: ChairParams,
                             generator: torch.Generator, n: int,
                             surface_frac: float = 0.95,
                             noise_stds=(0.05, 0.0158)) -> tuple:
    """Per-chair preprocessor-contract sampling on the chairs' device:
    (xyz [S, n, 3], sdf [S, n]). Parts, in order: n_surf // 2 points of
    the std-0.05 shell and the rest of n_surf of the std-0.0158 shell
    around Newton-projected surface points (drawn with replacement), then
    n - n_surf uniform points in [-1, 1]^3; n_surf = int(n *
    surface_frac). Labels are chair_sdf of the points."""
    S = params.num_shapes
    dev = params.box_b.device
    n_surf = int(n * surface_frac)
    n_unif = n - n_surf
    half = n_surf // 2
    m = max(half, n_surf - half)
    base = _surface_points(params, generator, m)
    parts = []
    for std, k in zip(noise_stds, (half, n_surf - half)):
        idx = torch.randint(0, m, (S, k), generator=generator, device=dev)
        pts = torch.gather(base, 1, idx[..., None].expand(S, k, 3))
        parts.append(pts + std * torch.randn((S, k, 3), generator=generator,
                                             device=dev))
    parts.append(torch.rand((S, n_unif, 3), generator=generator,
                            device=dev) * 2.0 - 1.0)
    xyz = torch.cat(parts, dim=1)
    return xyz, chair_sdf(params, xyz)
