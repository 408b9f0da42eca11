"""Minimal OBJ / PLY triangle-mesh IO and vertex normals (host NumPy).

The port's copy of the JAX package's `utils/meshio.py` (no JAX in it, so
both packages write the same bytes and read the same meshes). Writers
emit OBJ plus ascii and binary_little_endian PLY (the DeepSDF lineage's
mesh outputs and ShapeNet's on-disk PLYs are binary little-endian); the
reader handles the common subsets needed to round-trip our own output and
ingest external meshes for the native preprocess path (float/double
vertex properties located by name, uchar/uint-counted face index lists).
`vertex_normals` gives angle-weighted unit normals after
`harmonize_winding` makes the winding consistent and outward.
"""

from __future__ import annotations

import pathlib

import numpy as np


def harmonize_winding(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Flip faces so each connected component is consistently wound,
    then orient every component outward by its signed volume.

    The marching-tetrahedra extractors emit per-tet windings that are
    NOT globally consistent (the lone-corner cases share one vertex
    order across both polarities) — harmless for distance metrics and
    for welding, but normals need orientation. BFS over the shared-edge
    graph: two faces are consistently oriented iff their shared edge
    runs in OPPOSITE directions. Non-manifold edges (>2 faces) are not
    traversed. The signed-volume sign fix is exact for closed
    components and a centroid-flux heuristic for open ones."""
    f = np.asarray(faces, np.int64).copy()
    if not len(f):
        return f
    v = np.asarray(verts, np.float64)
    # shared-edge adjacency: edge key -> up to 2 (face, direction)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    owner = np.tile(np.arange(len(f)), 3)
    direction = (edges[:, 0] < edges[:, 1])  # True = forward wrt sorted
    key = (np.minimum(edges[:, 0], edges[:, 1]) * (v.shape[0] + 1)
           + np.maximum(edges[:, 0], edges[:, 1]))
    order = np.argsort(key, kind="stable")
    key_s, owner_s, dir_s = key[order], owner[order], direction[order]
    starts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    counts = np.diff(np.r_[starts, len(key_s)])
    adj = [[] for _ in range(len(f))]  # face -> (other, same_dir)
    for s, c in zip(starts, counts):
        if c == 2:  # manifold interior edge
            fa, fb = owner_s[s], owner_s[s + 1]
            same = dir_s[s] == dir_s[s + 1]
            adj[fa].append((fb, same))
            adj[fb].append((fa, same))
    flip = np.zeros(len(f), bool)
    seen = np.zeros(len(f), bool)
    comp = np.full(len(f), -1, np.int64)
    n_comp = 0
    for root in range(len(f)):
        if seen[root]:
            continue
        stack = [root]
        seen[root] = True
        comp[root] = n_comp
        while stack:
            cur = stack.pop()
            for nb, same in adj[cur]:
                if seen[nb]:
                    continue
                # consistent orientation = shared edge in opposite
                # directions; equal directions means one must flip
                flip[nb] = flip[cur] ^ same
                seen[nb] = True
                comp[nb] = n_comp
                stack.append(nb)
        n_comp += 1
    f[flip] = f[flip][:, ::-1]
    # outward sign per component via signed volume (divergence theorem);
    # one bincount pass — a per-component boolean scan is O(F*n_comp)
    # and degenerates on many-component noise meshes
    tri = v[f]
    svol = np.einsum("ij,ij->i", tri[:, 0],
                     np.cross(tri[:, 1], tri[:, 2])) / 6.0
    totals = np.bincount(comp, weights=svol, minlength=n_comp)
    neg = np.flatnonzero(totals < 0)
    if len(neg):
        sel = np.isin(comp, neg)
        f[sel] = f[sel][:, ::-1]
    return f


def vertex_normals(verts: np.ndarray, faces: np.ndarray,
                   harmonize: bool = True) -> np.ndarray:
    """Angle-weighted per-vertex unit normals [N,3] f32.

    Angle weighting (the incident face's corner angle at the vertex) is
    the standard tessellation-independent choice: splitting a face in
    two leaves the weights unchanged, unlike area or uniform weighting.
    `harmonize` (default) first makes the winding globally consistent +
    outward (harmonize_winding) — required for meshes from the
    marching-tetrahedra extractors, whose raw winding is mixed.
    Host cost ~7.5 us/face (3 s for a 400k-face serving mesh on the
    1-core host, BFS-dominated) — fine for the opt-in --normals export
    path it serves."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    if harmonize:
        f = harmonize_winding(v, f)
    n = np.zeros_like(v)
    if len(f):
        tri = v[f]  # [F, 3, 3]
        for k in range(3):
            a, b, c = tri[:, k], tri[:, (k + 1) % 3], tri[:, (k + 2) % 3]
            e1, e2 = b - a, c - a
            fn = np.cross(e1, e2)
            fl = np.linalg.norm(fn, axis=1)
            l1 = np.linalg.norm(e1, axis=1)
            l2 = np.linalg.norm(e2, axis=1)
            cos = np.einsum("ij,ij->i", e1, e2) / np.maximum(l1 * l2,
                                                             1e-300)
            ang = np.arccos(np.clip(cos, -1.0, 1.0))
            unit = fn / np.maximum(fl, 1e-300)[:, None]
            np.add.at(n, f[:, k], unit * ang[:, None])
        # vertices incident only to zero-area slivers (crossings landing
        # exactly on lattice points) accumulate a zero sum — borrow the
        # average of their edge-neighbours' normals instead
        norm = np.linalg.norm(n, axis=1)
        dead = np.flatnonzero((norm < 1e-12)
                              & np.isin(np.arange(len(v)), f))
        if len(dead):
            dead_set = set(dead.tolist())
            nbr = {d: [] for d in dead_set}
            for face in f:
                for k in range(3):
                    if face[k] in dead_set:
                        nbr[face[k]].extend(
                            (face[(k + 1) % 3], face[(k + 2) % 3]))
            for d, ns in nbr.items():
                if ns:
                    n[d] = n[list(ns)].sum(axis=0)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                           1e-300)).astype(np.float32)


def write_obj(path: str | pathlib.Path, verts: np.ndarray,
              faces: np.ndarray, normals: np.ndarray = None) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        for v in np.asarray(verts, np.float64):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if normals is not None:
            for nv in np.asarray(normals, np.float64):
                f.write(f"vn {nv[0]:.6f} {nv[1]:.6f} {nv[2]:.6f}\n")
            for face in np.asarray(faces, np.int64) + 1:
                f.write(f"f {face[0]}//{face[0]} {face[1]}//{face[1]} "
                        f"{face[2]}//{face[2]}\n")
            return
        for face in np.asarray(faces, np.int64) + 1:  # OBJ is 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def write_ply(path: str | pathlib.Path, verts: np.ndarray,
              faces: np.ndarray, binary: bool = False,
              normals: np.ndarray = None) -> None:
    """Triangle mesh -> PLY. binary=True writes binary_little_endian 1.0
    (float32 xyz + `list uchar int` faces — the canonical DeepSDF output
    layout); binary=False writes ascii 1.0. `normals` [N,3] adds
    nx/ny/nz float vertex properties. Either variant round-trips
    through read_ply and the native preprocess loader losslessly
    (f32 verts)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    nprops = ("property float nx\nproperty float ny\nproperty float nz\n"
              if normals is not None else "")
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              + nprops +
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    vdata = verts if normals is None else np.concatenate(
        [verts, np.asarray(normals, np.float32)], axis=1)
    if binary:
        face_rec = np.empty(
            len(faces), np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
        face_rec["n"] = 3
        face_rec["idx"] = faces
        with p.open("wb") as f:
            f.write(header.encode("ascii"))
            f.write(np.ascontiguousarray(vdata, "<f4").tobytes())
            f.write(face_rec.tobytes())
        return
    with p.open("w") as f:
        f.write(header)
        for v in vdata:
            f.write(" ".join(f"{x:.6f}" for x in v) + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_mesh(path: str | pathlib.Path, verts: np.ndarray,
               faces: np.ndarray, normals: np.ndarray = None) -> None:
    """Extension-dispatched writer: .obj -> OBJ, .ply -> binary PLY.
    `normals` [N,3] adds vn lines / nx,ny,nz properties."""
    ext = pathlib.Path(path).suffix.lower()
    if ext == ".obj":
        write_obj(path, verts, faces, normals=normals)
    elif ext == ".ply":
        write_ply(path, verts, faces, binary=True, normals=normals)
    else:
        raise ValueError(f"unsupported mesh format: {path}")


def read_obj(path: str | pathlib.Path) -> tuple:
    """Reads v/f lines; polygonal faces are fan-triangulated."""
    verts, faces = [], []
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(tok.split("/")[0]) - 1 for tok in parts[1:]]
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int64).reshape(-1, 3))


# PLY scalar type name -> numpy little-endian dtype
_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
}


def _parse_ply_header(raw: bytes) -> tuple:
    """-> (fmt, elements [(name, count, props)], body offset). props is
    [(name, dtype_str)] for scalars, ('list', count_dt, idx_dt, name)
    for list properties."""
    end = raw.find(b"end_header\n")
    if not raw.startswith(b"ply") or end < 0:
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    for line in raw[:end].decode("ascii").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(
                    ("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]],
                     parts[4]))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, elements, end + len(b"end_header\n")


def _fan(idx_rows) -> np.ndarray:
    faces = []
    for idx in idx_rows:
        for k in range(1, len(idx) - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(faces, np.int64).reshape(-1, 3)


def read_ply(path: str | pathlib.Path, with_normals: bool = False) -> tuple:
    """ascii or binary_little_endian PLY -> (verts f32 [N,3], faces i64
    [M,3]); polygons are fan-triangulated. Vertex x/y/z are located by
    property NAME (extra per-vertex floats — colors — are skipped);
    faces must lead with their index list property. with_normals=True
    appends a third element: nx/ny/nz as [N,3] f32, or None when the
    file carries no normals."""
    raw = pathlib.Path(path).read_bytes()
    fmt, elements, off = _parse_ply_header(raw)
    verts = np.zeros((0, 3), np.float32)
    faces = np.zeros((0, 3), np.int64)
    nrm = None
    if fmt == "ascii":
        lines = raw[off:].decode("ascii").splitlines()
        row = 0
        for name, count, props in elements:
            if name == "vertex":
                # by NAME and in (x, y, z) order — the PLY spec puts no
                # constraint on property declaration order
                by = {pr[0]: i for i, pr in enumerate(props)}
                assert all(k in by for k in "xyz"), \
                    "vertex needs x/y/z properties"
                cols = [by[k] for k in ("x", "y", "z")]
                verts = np.asarray(
                    [[float(lines[row + j].split()[c]) for c in cols]
                     for j in range(count)], np.float32)
                if all(k in by for k in ("nx", "ny", "nz")):
                    ncols = [by[k] for k in ("nx", "ny", "nz")]
                    nrm = np.asarray(
                        [[float(lines[row + j].split()[c]) for c in ncols]
                         for j in range(count)], np.float32)
            elif name == "face":
                assert props and props[0][0] == "list"
                idx_rows = []
                for j in range(count):
                    toks = lines[row + j].split()
                    idx_rows.append([int(x)
                                     for x in toks[1:1 + int(toks[0])]])
                faces = _fan(idx_rows)
            row += count
        return (verts, faces, nrm) if with_normals else (verts, faces)
    # binary_little_endian
    buf = memoryview(raw)[off:]
    pos = 0
    for name, count, props in elements:
        if name == "vertex":
            if any(pr[0] == "list" for pr in props):
                raise ValueError("list property on vertex unsupported")
            rec = np.dtype([(f"p{i}", dt) for i, (_n, dt)
                            in enumerate(props)])
            arr = np.frombuffer(buf, rec, count, pos)
            by = {pr[0]: f"p{i}" for i, pr in enumerate(props)}
            assert all(k in by for k in "xyz"), \
                "vertex needs x/y/z properties"
            verts = np.stack([arr[by[k]].astype(np.float32)
                              for k in ("x", "y", "z")], axis=-1)
            if all(k in by for k in ("nx", "ny", "nz")):
                nrm = np.stack([arr[by[k]].astype(np.float32)
                                for k in ("nx", "ny", "nz")], axis=-1)
            pos += rec.itemsize * count
        elif name == "face":
            assert props and props[0][0] == "list", \
                "face element must lead with its index list"
            assert len(props) == 1, "extra face properties unsupported"
            _tag, cdt, idt, _nm = props[0]
            csz = np.dtype(cdt).itemsize
            isz = np.dtype(idt).itemsize
            if count:
                k0 = int(np.frombuffer(buf, cdt, 1, pos)[0])
                uniform = np.dtype([("n", cdt), ("idx", idt, (k0,))])
                if pos + uniform.itemsize * count <= len(buf):
                    recs = np.frombuffer(buf, uniform, count, pos)
                    if (recs["n"] == k0).all():
                        faces = _fan(recs["idx"]) if k0 != 3 else \
                            recs["idx"].astype(np.int64)
                        pos += uniform.itemsize * count
                        continue
                idx_rows = []          # ragged polygon sizes: walk records
                for _ in range(count):
                    k = int(np.frombuffer(buf, cdt, 1, pos)[0])
                    idx_rows.append(np.frombuffer(buf, idt, k, pos + csz)
                                    .astype(np.int64))
                    pos += csz + isz * k
                faces = _fan(idx_rows)
        else:  # skip unknown scalar-only elements
            if any(pr[0] == "list" for pr in props):
                raise ValueError(
                    f"binary PLY element {name!r} has a list property — "
                    "variable stride, cannot skip")
            rec = np.dtype([(f"p{i}", dt) for i, (_n, dt)
                            in enumerate(props)])
            pos += rec.itemsize * count
    return (verts, faces, nrm) if with_normals else (verts, faces)


def read_ply_ascii(path: str | pathlib.Path) -> tuple:
    """Back-compat alias (read_ply handles ascii AND binary)."""
    return read_ply(path)
