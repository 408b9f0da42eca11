"""Analytic signed-distance fields: exact ground truth + offline data source.

The port's NumPy copy of the JAX package's `data/analytic.py` (that
package's `__init__` imports JAX). Same code, so the same seed gives
bit-identical shapes and samples in both packages.

ShapeNet does not ship with the repository, so the framework ships
closed-form SDF families that (a) stand in for the lineage's
preprocessed ShapeNet sample sets (same output contract as the native
preprocessor: surface-biased (xyz, sdf) samples) and (b) provide exact
oracles for every geometry test (decoder overfit error, isosurface vertex
radius, Chamfer bounds). See SURVEY.md section 2.2 `data/analytic`.

All functions are host-side NumPy (the data layer feeds fixed-shape device
batches; nothing here is traced). Shapes are JSON-able parameter trees:

    {"type": "sphere", "r": 0.5, "c": [0,0,0]}
    {"type": "box", "b": [0.4,0.3,0.2], "c": [0,0,0]}
    {"type": "torus", "R": 0.5, "r": 0.15, "c": [...]}
    {"type": "capsule", "a": [..], "b": [..], "r": 0.1}
    {"type": "union"|"intersection"|"difference", "children": [shape, ...]}

CSG min/max SDFs are exact outside and a lower bound inside — the standard
convention the lineage's mesh-derived SDFs approximate anyway.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- primitives


def sdf_sphere(p: np.ndarray, r: float, c=(0, 0, 0)) -> np.ndarray:
    return np.linalg.norm(p - np.asarray(c, np.float32), axis=-1) - r


def sdf_box(p: np.ndarray, b, c=(0, 0, 0)) -> np.ndarray:
    q = np.abs(p - np.asarray(c, np.float32)) - np.asarray(b, np.float32)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def sdf_torus(p: np.ndarray, R: float, r: float, c=(0, 0, 0)) -> np.ndarray:
    q = p - np.asarray(c, np.float32)
    xz = np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - R
    return np.sqrt(xz ** 2 + q[..., 1] ** 2) - r


def sdf_capsule(p: np.ndarray, a, b, r: float) -> np.ndarray:
    a = np.asarray(a, np.float32)
    ab = np.asarray(b, np.float32) - a
    pa = p - a
    t = np.clip((pa @ ab) / (ab @ ab), 0.0, 1.0)
    return np.linalg.norm(pa - t[..., None] * ab, axis=-1) - r


def sdf(shape: dict, p: np.ndarray) -> np.ndarray:
    """Evaluate a shape tree at points p[..., 3] -> sdf[...]. Exact fp32."""
    t = shape["type"]
    if t == "sphere":
        return sdf_sphere(p, shape["r"], shape.get("c", (0, 0, 0)))
    if t == "box":
        return sdf_box(p, shape["b"], shape.get("c", (0, 0, 0)))
    if t == "torus":
        return sdf_torus(p, shape["R"], shape["r"], shape.get("c", (0, 0, 0)))
    if t == "capsule":
        return sdf_capsule(p, shape["a"], shape["b"], shape["r"])
    if t == "union":
        return np.minimum.reduce([sdf(s, p) for s in shape["children"]])
    if t == "intersection":
        return np.maximum.reduce([sdf(s, p) for s in shape["children"]])
    if t == "difference":
        ch = shape["children"]
        d = sdf(ch[0], p)
        for s in ch[1:]:
            d = np.maximum(d, -sdf(s, p))
        return d
    raise ValueError(f"unknown shape type {t!r}")


def sdf_grad(shape: dict, p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Central-difference gradient (unit-ish normal away from edges)."""
    g = np.empty_like(p, dtype=np.float32)
    for i in range(3):
        d = np.zeros((3,), np.float32)
        d[i] = eps
        g[..., i] = (sdf(shape, p + d) - sdf(shape, p - d)) / (2 * eps)
    return g

# ----------------------------------------------------------------- sampling


def sample_surface(shape: dict, n: int, rng: np.random.Generator,
                   iters: int = 12) -> np.ndarray:
    """Sample ~n points on the zero set by sphere-tracing random rays inward
    and Newton-projecting: x <- x - sdf(x) * grad(x). Exact for spheres,
    sub-1e-3 accurate for smooth CSG away from edges."""
    # Over-sample, keep the best-converged points.
    m = int(n * 1.6) + 64
    x = rng.uniform(-1.0, 1.0, size=(m, 3)).astype(np.float32)
    for _ in range(iters):
        d = sdf(shape, x)
        g = sdf_grad(shape, x)
        gn = np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-8)
        x = x - (d[..., None]) * g / gn
        x = np.clip(x, -1.1, 1.1)
    err = np.abs(sdf(shape, x))
    order = np.argsort(err)
    return x[order[:n]].astype(np.float32)


def sample_sdf_points(shape: dict, n: int, rng: np.random.Generator,
                      surface_frac: float = 0.95,
                      noise_stds=(0.05, 0.0158)) -> tuple:
    """Preprocessor-contract sampling: surface-biased two-variance Gaussian
    shells + uniform-in-cube filler, with exact analytic SDF labels.

    noise stds are sqrt of the lineage's variances (0.0025, 0.00025): the
    shells reach ~+-0.1, matching the clamp_dist=0.1 training design — a
    tighter spread lets a wide decoder collapse to the constant 0.

    Returns (xyz[n,3] fp32, sdf[n] fp32) — the same contract as the native
    preprocess tool's output (SURVEY.md section 3.1).
    """
    n_surf = int(n * surface_frac)
    n_unif = n - n_surf
    half = n_surf // 2
    base = sample_surface(shape, max(half, n_surf - half), rng)
    pts = []
    for std, k in zip(noise_stds, (half, n_surf - half)):
        idx = rng.integers(0, len(base), size=k)
        pts.append(base[idx] + rng.normal(0, std, size=(k, 3)).astype(np.float32))
    pts.append(rng.uniform(-1.0, 1.0, size=(n_unif, 3)).astype(np.float32))
    xyz = np.concatenate(pts, axis=0).astype(np.float32)
    return xyz, sdf(shape, xyz).astype(np.float32)

# ------------------------------------------------------- synthetic families


def make_chair(rng: np.random.Generator) -> dict:
    """Random parametric 'chair' (ShapeNet-chairs stand-in): seat slab +
    backrest + 4 legs, CSG union, sized to fit the unit sphere."""
    seat_w = rng.uniform(0.35, 0.55)
    seat_d = rng.uniform(0.3, 0.5)
    seat_t = rng.uniform(0.03, 0.07)
    seat_h = rng.uniform(-0.1, 0.1)
    leg_r = rng.uniform(0.02, 0.05)
    leg_h = rng.uniform(0.3, 0.5)
    back_h = rng.uniform(0.3, 0.55)
    back_t = rng.uniform(0.03, 0.06)
    lean = rng.uniform(0.0, 0.08)
    parts = [
        {"type": "box", "b": [seat_w, seat_t, seat_d], "c": [0.0, seat_h, 0.0]},
        {"type": "box", "b": [seat_w, back_h / 2, back_t],
         "c": [0.0, seat_h + back_h / 2, -seat_d + back_t - lean]},
    ]
    for sx in (-1, 1):
        for sz in (-1, 1):
            a = [sx * (seat_w - leg_r), seat_h, sz * (seat_d - leg_r)]
            b = [sx * (seat_w - leg_r), seat_h - leg_h, sz * (seat_d - leg_r)]
            parts.append({"type": "capsule", "a": a, "b": b, "r": leg_r})
    return {"type": "union", "children": parts}


def make_shape(family: str, rng: np.random.Generator) -> dict:
    """One random shape from a named family."""
    if family == "sphere":
        return {"type": "sphere", "r": float(rng.uniform(0.3, 0.7)),
                "c": list(rng.uniform(-0.15, 0.15, 3).astype(float))}
    if family == "box":
        return {"type": "box", "b": list(rng.uniform(0.2, 0.6, 3).astype(float)),
                "c": list(rng.uniform(-0.1, 0.1, 3).astype(float))}
    if family == "torus":
        return {"type": "torus", "R": float(rng.uniform(0.35, 0.6)),
                "r": float(rng.uniform(0.08, 0.2))}
    if family == "capsule":
        a = rng.uniform(-0.5, 0.5, 3).astype(float)
        b = rng.uniform(-0.5, 0.5, 3).astype(float)
        return {"type": "capsule", "a": list(a), "b": list(b),
                "r": float(rng.uniform(0.1, 0.3))}
    if family == "chair":
        return make_chair(rng)
    if family == "csg":
        kinds = ["sphere", "box", "torus", "capsule"]
        k = int(rng.integers(2, 4))
        children = [make_shape(kinds[int(rng.integers(0, len(kinds)))], rng)
                    for _ in range(k)]
        op = ["union", "union", "difference"][int(rng.integers(0, 3))]
        return {"type": op, "children": children}
    if family == "mixed":
        fams = ["sphere", "box", "torus", "capsule", "chair", "csg"]
        return make_shape(fams[int(rng.integers(0, len(fams)))], rng)
    raise ValueError(f"unknown family {family!r}")


# 13-class stand-in for multi-category ShapeNet (BASELINE.json:11).
FAMILIES_13 = ["sphere", "box", "torus", "capsule", "chair", "csg", "mixed",
               "sphere", "box", "torus", "capsule", "chair", "csg"]


def make_synthetic_split(family: str, num_shapes: int, seed: int = 0) -> list:
    """Deterministic list of shape trees for a synthetic split.

    `family="classes13"` cycles the 13-class stand-in and tags each shape
    with its class id (for class-conditional training, BASELINE.json:10-11).
    """
    rng = np.random.default_rng(seed)
    shapes = []
    for i in range(num_shapes):
        if family == "classes13":
            cls = i % 13
            s = make_shape(FAMILIES_13[cls], rng)
            s = dict(s, class_id=cls)
        else:
            s = dict(make_shape(family, rng), class_id=0)
        shapes.append(s)
    return shapes
