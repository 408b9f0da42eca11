"""Area-weighted surface sampling of triangle meshes (host NumPy)."""

from __future__ import annotations

import numpy as np


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0) -> np.ndarray:
    """n points uniformly (by area) on the mesh surface. [n, 3] f32. The
    same (seed, n) draws the same points as the JAX package's sampler."""
    pts, _ = sample_mesh_surface_with_normals(verts, faces, n, seed=seed)
    return pts


def sample_mesh_surface_with_normals(
        verts: np.ndarray, faces: np.ndarray, n: int,
        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Like sample_mesh_surface, but also returns the (unit) face normal
    each point was sampled from: ([n,3] f32, [n,3] f32). Face normals
    follow the triangle winding; evaluation.normal_consistency uses |cos|,
    so the winding convention does not matter."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        raise ValueError("empty mesh")
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    cross = np.cross(b - a, c - a)
    areas = 0.5 * np.linalg.norm(cross, axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh (zero area)")
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(faces), size=n, p=areas / total)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1.0
    u[flip] = 1.0 - u[flip]
    v[flip] = 1.0 - v[flip]
    pts = a[tri] + u[:, None] * (b[tri] - a[tri]) + v[:, None] * (c[tri] - a[tri])
    nrm = cross[tri]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                           1e-20)
    return pts.astype(np.float32), nrm.astype(np.float32)
