"""Isosurface extraction: SDF grid or sparse payload -> triangle mesh (host).

Counterpart of the JAX package's `ops/isosurface.py`, without JAX. The
mesher is **marching tetrahedra**: each grid cell is split into 6
tetrahedra around the main diagonal and each tetrahedron is polygonised
exactly (1 or 2 triangles per crossing tet); vertices sit on linearly
interpolated zero crossings. The shared C++ library
(`native/build/libmarching_cubes_c.so`, built from
`native/marching_cubes/clib.cpp`) implements the same algorithm and is
loaded through ctypes with the same ABI as the JAX package's loader;
`extract_mesh` dispatches to it when built, else to the NumPy version
below.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
from typing import Optional

import numpy as np

# Cube corner offsets, canonical binary order: bit0=x, bit1=y, bit2=z.
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
], np.int64)

# 6-tetrahedron decomposition of the cube sharing the main diagonal 0-7.
# Every pair of face-adjacent cubes induces the same diagonal on the shared
# face, so the extracted surface is crack-free.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int64)

_ORIGIN = np.full(3, -1.0, np.float32)   # corner of the [-1,1]^3 cube

_OTHERS = [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]]
_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _interp(p_a, p_b, v_a, v_b, iso):
    """Linear zero-crossing between two corner point sets [N,3]."""
    denom = v_b - v_a
    t = np.where(np.abs(denom) > 1e-12, (iso - v_a) / denom, 0.5)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p_a + t * (p_b - p_a)


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0) -> tuple:
    """grid[R,R,R] (x,y,z-indexed) -> (verts[N,3] f32, faces[M,3] i64).

    Coordinates: point (i,j,k) sits at -1 + (i,j,k) * 2/(R-1), the
    lineage's [-1,1]^3 decode cube.
    """
    grid = np.asarray(grid, np.float32)
    R = grid.shape[0]
    assert grid.shape == (R, R, R), "expect a cubic grid"
    spacing = 2.0 / (R - 1)
    origin = _ORIGIN

    n = R - 1
    # Corner values [8, n, n, n], flat cell bases, global corner point ids.
    vals = np.empty((8, n, n, n), np.float32)
    for c, (dx, dy, dz) in enumerate(_CORNERS):
        vals[c] = grid[dx:dx + n, dy:dy + n, dz:dz + n]
    vals = vals.reshape(8, -1)

    ii, jj, kk = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")
    base = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    # gid of cube corner c for each cell: flat index into the R^3 lattice.
    gids = np.empty((8, base.shape[0]), np.int64)
    for c, off in enumerate(_CORNERS):
        idx = base + off
        gids[c] = (idx[:, 0] * R + idx[:, 1]) * R + idx[:, 2]
    basef = base.astype(np.float32)

    tri_pts = []   # [*, 3(tri verts), 3(xyz)]
    tri_keys = []  # [*, 3] — vertex = unique global lattice edge id

    def corner_pts(c, sel):
        return (basef[sel] + _CORNERS[c].astype(np.float32)) * spacing \
            + origin

    R3 = R * R * R

    for tet in _TETS:
        tv = vals[tet]                      # [4, Ncells]
        inside = tv < iso
        count = inside.sum(axis=0)

        def edge_pt(a, b, sel):
            """(position, global edge key) of the crossing on tet edge a-b.
            The key is orientation-independent, so the same lattice edge
            always welds to one vertex across tets and cells."""
            p = _interp(corner_pts(tet[a], sel), corner_pts(tet[b], sel),
                        tv[a][sel], tv[b][sel], iso)
            ga, gb = gids[tet[a]][sel], gids[tet[b]][sel]
            key = np.minimum(ga, gb) * R3 + np.maximum(ga, gb)
            return p, key

        def emit(triple, sel):
            ps, ks = zip(*(edge_pt(a, b, sel) for a, b in triple))
            tri_pts.append(np.stack(ps, axis=1))
            tri_keys.append(np.stack(ks, axis=1))

        # one inside (or one outside): single triangle on 3 incident edges
        for lone in range(4):
            o = _OTHERS[lone]
            for polarity in (1, 3):
                sel = (count == polarity) & (
                    inside[lone] if polarity == 1 else ~inside[lone])
                sel = np.nonzero(sel)[0]
                if sel.size:
                    emit([(lone, o[0]), (lone, o[1]), (lone, o[2])], sel)
        # two inside: quad on the 4 cross edges -> 2 triangles
        for a, b in _PAIRS:
            cd = [x for x in range(4) if x not in (a, b)]
            sel = np.nonzero((count == 2) & inside[a] & inside[b])[0]
            if sel.size:
                emit([(a, cd[0]), (a, cd[1]), (b, cd[1])], sel)
                emit([(a, cd[0]), (b, cd[1]), (b, cd[0])], sel)

    if not tri_pts:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    soup = np.concatenate(tri_pts, axis=0)   # [M, 3, 3]
    keys = np.concatenate(tri_keys, axis=0)  # [M, 3]
    uniq, first, inv = np.unique(keys.reshape(-1), return_index=True,
                                 return_inverse=True)
    verts = soup.reshape(-1, 3)[first].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int64)
    # Drop triangles degenerate in topology (repeated welded vertex) — they
    # arise when a crossing lands exactly on a lattice point.
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


_MC_LIB = "unset"  # lazily resolved ctypes handle (None = unavailable)


def _native_mc_lib():
    """ctypes handle to libmarching_cubes_c (`$LDM_SDF_NATIVE_MC_LIB`, else
    native/build/ of this checkout), or None when it is not built. The
    library holds no global state, so calls from serve_meshes' mesh-worker
    threads are safe (and release the GIL)."""
    global _MC_LIB
    if _MC_LIB != "unset":
        return _MC_LIB
    env = os.environ.get("LDM_SDF_NATIVE_MC_LIB")
    here = pathlib.Path(__file__).resolve().parents[2]
    cand = env or str(here / "native" / "build" / "libmarching_cubes_c.so")
    if not pathlib.Path(cand).exists():
        _MC_LIB = None
        return None
    lib = ctypes.CDLL(cand)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mc_run.restype = ctypes.c_void_p
    lib.mc_run.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, f32p,
                           ctypes.c_float, i64p, i64p]
    lib.mc_run_payload.restype = ctypes.c_void_p
    lib.mc_run_payload.argtypes = [
        f32p, f32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        f32p, ctypes.c_float, i32p, ctypes.c_int64, i64p, i64p]
    lib.simp_run.restype = ctypes.c_void_p
    lib.simp_run.argtypes = [f32p, ctypes.c_int64, i64p, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_double, i64p, i64p]
    lib.mc_copy.restype = None
    lib.mc_copy.argtypes = [ctypes.c_void_p, f32p, i64p]
    lib.mc_free.restype = None
    lib.mc_free.argtypes = [ctypes.c_void_p]
    _MC_LIB = lib
    return lib


def _take_mesh(lib, h, nv, nf) -> tuple:
    """Copy a native MeshOut handle into numpy arrays and free it."""
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    try:
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int64)
        lib.mc_copy(h, verts.ctypes.data_as(f32p),
                    faces.ctypes.data_as(i64p))
    finally:
        lib.mc_free(h)
    return verts, faces


def _extract_mesh_clib(lib, grid: np.ndarray, iso: float) -> tuple:
    f32p = ctypes.POINTER(ctypes.c_float)
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    h = lib.mc_run(grid.ctypes.data_as(f32p), grid.shape[0],
                   ctypes.c_float(iso), _ORIGIN.ctypes.data_as(f32p),
                   ctypes.c_float(2.0 / (grid.shape[0] - 1)), ctypes.byref(nv),
                   ctypes.byref(nf))
    return _take_mesh(lib, h, nv, nf)


def extract_mesh_payload(fill2: np.ndarray, vals2: np.ndarray,
                         ids2: np.ndarray, n_active: int, res: int,
                         b2: int) -> Optional[tuple]:
    """Mesh a sparse serving payload directly, with no dense grid on the
    host. `fill2` [nb^3] f32 is the b2-granularity fill cascade
    (ops.grid_eval.sparse2_fill2, dequantized), `vals2` [>=n_active, b2^3]
    f32 the fine rows, `ids2` their b2-flat block ids. The native mesher
    scans only cells touching active blocks (+1-cell halo); the mesh is
    bit-identical to extract_mesh on the reconstructed grid at iso 0, the
    only level the decode's tau-selection makes sound. Returns None when
    the native library is unavailable (the caller reconstructs the grid
    and uses extract_mesh)."""
    lib = _native_mc_lib()
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nb = res // b2
    fill2 = np.ascontiguousarray(fill2, np.float32)
    if fill2.size != nb ** 3:
        raise ValueError(f"fill2 has {fill2.size} values, expected "
                         f"{nb ** 3}")
    vals = np.ascontiguousarray(np.asarray(vals2)[:n_active], np.float32)
    ids = np.ascontiguousarray(np.asarray(ids2)[:n_active], np.int32)
    rank = np.full((nb ** 3,), -1, np.int32)
    rank[ids.astype(np.int64)] = np.arange(n_active, dtype=np.int32)
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    h = lib.mc_run_payload(
        fill2.ctypes.data_as(f32p), vals.ctypes.data_as(f32p),
        rank.ctypes.data_as(i32p), res, b2, ctypes.c_float(0.0),
        _ORIGIN.ctypes.data_as(f32p), ctypes.c_float(2.0 / (res - 1)),
        ids.ctypes.data_as(i32p), int(n_active), ctypes.byref(nv),
        ctypes.byref(nf))
    return _take_mesh(lib, h, nv, nf)


def mesher_impl() -> str:
    """Which implementation `extract_mesh` would dispatch to right now:
    "native-lib" | "numpy". Timed paths record it, so a silent fallback
    to the ~100x slower NumPy mesher shows in every capture."""
    return "numpy" if _native_mc_lib() is None else "native-lib"


def reset_native_cache() -> None:
    """Drop the lazy ctypes handle so a freshly built native/build is
    picked up in-process."""
    global _MC_LIB
    _MC_LIB = "unset"


def extract_mesh(grid: np.ndarray, iso: float = 0.0) -> tuple:
    """Dispatch: in-process native lib > NumPy marching tetrahedra (the
    same algorithm, the same mesh), over the [-1,1]^3 cube."""
    grid = np.ascontiguousarray(grid, np.float32)
    lib = _native_mc_lib()
    if lib is not None:
        return _extract_mesh_clib(lib, grid, iso)
    return marching_tetrahedra(grid, iso)


def simplify_mesh(verts: np.ndarray, faces: np.ndarray,
                  target_faces: Optional[int] = None,
                  ratio: Optional[float] = None) -> tuple:
    """Quadric edge-collapse decimation (native/simplify/qem_core.hpp).

    Give a face budget via `target_faces` or `ratio` (fraction of the
    input count). Preserves closed-manifold topology and open rims; the
    budget is best-effort. Native-only:
    raises RuntimeError when libmarching_cubes_c.so is not built."""
    lib = _native_mc_lib()
    if lib is None:
        raise RuntimeError(
            "mesh simplification needs the native library: "
            "cmake -S native -B native/build && "
            "cmake --build native/build")
    if (target_faces is None) == (ratio is None):
        raise ValueError("give target_faces OR ratio")
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int64)
    if ratio is not None:
        target_faces = int(len(faces) * ratio)
    if len(faces) == 0 or len(faces) <= target_faces:
        return verts.copy(), faces.copy()
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    h = lib.simp_run(
        verts.ctypes.data_as(f32p), len(verts),
        faces.ctypes.data_as(i64p), len(faces),
        int(target_faces),
        ctypes.c_double(-1.0),            # no error ceiling
        ctypes.byref(nv), ctypes.byref(nf))
    return _take_mesh(lib, h, nv, nf)
