"""Minimal OBJ / PLY triangle-mesh writers (host NumPy).

The port's copy of the writers of the JAX package's `utils/meshio.py`:
OBJ, and binary_little_endian PLY (float32 xyz + `list uchar int` faces,
the DeepSDF output layout).
"""

from __future__ import annotations

import pathlib

import numpy as np


def write_obj(path: str | pathlib.Path, verts: np.ndarray,
              faces: np.ndarray) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        for v in np.asarray(verts, np.float64):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces, np.int64) + 1:  # OBJ is 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def write_ply(path: str | pathlib.Path, verts: np.ndarray,
              faces: np.ndarray) -> None:
    """Triangle mesh -> binary_little_endian 1.0 PLY (float32 xyz +
    `list uchar int` faces, byte for byte what the JAX package's
    `write_ply(..., binary=True)` writes)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    face_rec = np.empty(
        len(faces), np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with p.open("wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(face_rec.tobytes())


def write_mesh(path: str | pathlib.Path, verts: np.ndarray,
               faces: np.ndarray) -> None:
    """Extension-dispatched writer: .obj -> OBJ, .ply -> binary PLY."""
    ext = pathlib.Path(path).suffix.lower()
    if ext == ".obj":
        write_obj(path, verts, faces)
    elif ext == ".ply":
        write_ply(path, verts, faces)
    else:
        raise ValueError(f"unsupported mesh format: {path}")
