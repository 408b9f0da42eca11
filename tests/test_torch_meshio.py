"""PyTorch port vs the JAX package: mesh IO and normals (utils.meshio).

The port keeps its own NumPy copy of the JAX package's module, so on the
same seeded meshes the two must agree exactly: winding and normals bit
for bit, every writer's bytes equal, and every reader returning equal
arrays on files written by either package (OBJ, ascii and binary PLY,
with and without normals, polygons fan-triangulated)."""

import numpy as np
import pytest

from latent_diffusion_models_for_shape_sdfs_tpu.utils import meshio as jm
from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
    extract_mesh)
from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
    make_grid_points)
from latent_diffusion_models_for_shape_sdfs_torch.utils import meshio as tm


def _mesh(seed: int, scramble: bool = True):
    """A marching-tetrahedra mesh of two blobs (two components), windings
    flipped at random per face when `scramble`."""
    rng = np.random.default_rng(seed)
    p = make_grid_points(20)
    c = rng.uniform(-0.3, 0.3, (2, 3))
    d = np.minimum(np.linalg.norm(p - c[0], axis=1) - 0.3,
                   np.linalg.norm(p - c[1] * [-1, 1, 1], axis=1) - 0.25)
    v, f = extract_mesh(d.reshape(20, 20, 20).astype(np.float32))
    if scramble:
        flip = rng.random(len(f)) < 0.5
        f = f.copy()
        f[flip] = f[flip][:, ::-1]
    return v, f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_winding_and_normals_bitwise(seed):
    v, f = _mesh(seed)
    np.testing.assert_array_equal(tm.harmonize_winding(v, f),
                                  jm.harmonize_winding(v, f))
    for harmonize in (True, False):
        got = tm.vertex_normals(v, f, harmonize=harmonize)
        assert got.dtype == np.float32 and got.shape == v.shape
        np.testing.assert_array_equal(
            got, jm.vertex_normals(v, f, harmonize=harmonize))
    n = tm.vertex_normals(v, f)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
    # outward: the normals point away from the nearest blob centre on
    # average (positive mean radial component)
    assert float(np.mean(np.sum(n * (v - v.mean(0)), axis=1))) > 0


def test_degenerate_and_empty_meshes():
    """Zero-area slivers borrow their neighbours' normals; no faces -> no
    normals (zeros) in both packages."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.5, 0, 0],
                  [0, 0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 4], [0, 4, 1]], np.int64)
    np.testing.assert_array_equal(tm.vertex_normals(v, f),
                                  jm.vertex_normals(v, f))
    e = np.zeros((0, 3), np.int64)
    np.testing.assert_array_equal(tm.harmonize_winding(v, e),
                                  jm.harmonize_winding(v, e))
    np.testing.assert_array_equal(tm.vertex_normals(v, e),
                                  jm.vertex_normals(v, e))


WRITERS = [("obj", dict()), ("ply", dict(binary=False)),
           ("ply", dict(binary=True))]


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("fmt, kw", WRITERS)
def test_written_bytes_equal(tmp_path, fmt, kw, normals):
    v, f = _mesh(3)
    nrm = tm.vertex_normals(v, f) if normals else None
    pt, pj = tmp_path / f"t.{fmt}", tmp_path / f"j.{fmt}"
    if fmt == "obj":
        tm.write_obj(pt, v, f, normals=nrm)
        jm.write_obj(pj, v, f, normals=nrm)
    else:
        tm.write_ply(pt, v, f, normals=nrm, **kw)
        jm.write_ply(pj, v, f, normals=nrm, **kw)
    assert pt.read_bytes() == pj.read_bytes()
    # write_mesh: by extension (.ply binary)
    tm.write_mesh(tmp_path / f"tm.{fmt}", v, f, normals=nrm)
    jm.write_mesh(tmp_path / f"jm.{fmt}", v, f, normals=nrm)
    assert (tmp_path / f"tm.{fmt}").read_bytes() == \
        (tmp_path / f"jm.{fmt}").read_bytes()
    with pytest.raises(ValueError, match="unsupported"):
        tm.write_mesh(tmp_path / "x.stl", v, f)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fmt, kw", WRITERS)
def test_readers_round_trip(tmp_path, writer, fmt, kw):
    """Files written by either package read back to equal arrays through
    both readers: f32 vertices exactly (ascii/OBJ: to the 6 written
    decimals), faces exactly, normals when written."""
    v, f = _mesh(4)
    nrm = tm.vertex_normals(v, f)
    mod = tm if writer == "port" else jm
    p = tmp_path / f"m.{fmt}"
    if fmt == "obj":
        mod.write_obj(p, v, f, normals=nrm)
        got, want = tm.read_obj(p), jm.read_obj(p)
    else:
        mod.write_ply(p, v, f, normals=nrm, **kw)
        got = tm.read_ply(p, with_normals=True)
        want = jm.read_ply(p, with_normals=True)
        for a, b in zip(tm.read_ply_ascii(p), jm.read_ply_ascii(p)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[2], nrm, atol=1e-6 if kw[
            "binary"] is False else 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], f)
    np.testing.assert_allclose(got[0], v, atol=5e-7 if fmt == "obj" or not
                               kw.get("binary") else 0)


def test_polygons_are_fan_triangulated(tmp_path):
    """Quads and a pentagon in OBJ (with v/vt/vn tokens), ascii PLY and
    ragged binary PLY (an extra scalar vertex element skipped by name;
    no normals -> None)."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 1.5, 0],
                  [0, 0, 1]], np.float32)
    polys = [[0, 1, 2, 3], [3, 2, 4], [0, 1, 2, 4, 3], [0, 5, 1]]
    obj = "".join(f"v {x} {y} {z}\n" for x, y, z in v) + "".join(
        "f " + " ".join(f"{i + 1}/{i + 1}/1" for i in p) + "\n"
        for p in polys)
    (tmp_path / "p.obj").write_text(obj)
    for a, b in zip(tm.read_obj(tmp_path / "p.obj"),
                    jm.read_obj(tmp_path / "p.obj")):
        np.testing.assert_array_equal(a, b)
    head = ("ply\nformat {} 1.0\nelement vertex 6\nproperty float y\n"
            "property float x\nproperty float z\nproperty uchar red\n"
            "element face 4\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    asc = head.format("ascii") + "".join(
        f"{y} {x} {z} 7\n" for x, y, z in v) + "".join(
        f"{len(p)} " + " ".join(map(str, p)) + "\n" for p in polys)
    (tmp_path / "a.ply").write_text(asc)
    rec = np.zeros(6, [("y", "<f4"), ("x", "<f4"), ("z", "<f4"),
                       ("r", "u1")])
    rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
    body = rec.tobytes() + b"".join(
        np.uint8(len(p)).tobytes() + np.asarray(p, "<i4").tobytes()
        for p in polys)
    (tmp_path / "b.ply").write_bytes(
        head.format("binary_little_endian").encode() + body)
    for name in ("a.ply", "b.ply"):
        got = tm.read_ply(tmp_path / name, with_normals=True)
        want = jm.read_ply(tmp_path / name, with_normals=True)
        assert got[2] is None and want[2] is None
        np.testing.assert_array_equal(got[0], v)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert len(got[1]) == 2 + 1 + 3 + 1
    (tmp_path / "bad.ply").write_bytes(b"not a ply")
    with pytest.raises(ValueError, match="PLY"):
        tm.read_ply(tmp_path / "bad.ply")


def _read_with_normals(path):
    """(verts, faces, normals) of a written mesh through the port's
    readers; OBJ normals from its `vn` lines."""
    if path.suffix == ".ply":
        return tm.read_ply(path, with_normals=True)
    v, f = tm.read_obj(path)
    n = np.asarray([[float(x) for x in ln.split()[1:4]]
                    for ln in path.read_text().splitlines()
                    if ln.startswith("vn ")], np.float32)
    return v, f, n


@pytest.mark.parametrize("fmt", ["ply", "obj"])
def test_cli_decode_writes_normals(tmp_path, monkeypatch, fmt):
    """`decode --normals` through both packages on the same weights: each
    written file's normals are unit and equal to vertex_normals of the
    mesh read back: exactly for binary PLY; for OBJ, whose coordinates
    are written to 6 decimals, to 1e-3 on 99% of the vertices and 5e-2 on
    all (slivers turn most). The port's vertex_normals of JAX's file
    agrees with the normals JAX wrote in it the same way."""
    from latent_diffusion_models_for_shape_sdfs_tpu import cli as jcli
    from latent_diffusion_models_for_shape_sdfs_torch import cli
    from tests.test_torch_render import _experiments
    texp, jexp, _ = _experiments(tmp_path, monkeypatch)
    args = ["--scene", "0", "2", "--res", "32", "--format", fmt,
            "--normals"]
    cli.main(["--device", "cpu", "decode", str(texp), *args])
    jcli.main(["decode", str(jexp), *args])

    def agree(n, v, f):
        err = np.abs(n - tm.vertex_normals(v, f)).max(1)
        if fmt == "ply":
            assert err.max() == 0
        else:
            assert np.quantile(err, 0.99) < 1e-3 and err.max() < 5e-2

    for name in ("scene_000", "scene_002"):
        v, f, n = _read_with_normals(texp / "decoded" / f"{name}.{fmt}")
        vj, fj, nj = _read_with_normals(jexp / "decoded" / f"{name}.{fmt}")
        assert len(f) > 20 and abs(len(v) - len(vj)) <= 0.02 * len(vj)
        assert n.shape == v.shape
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0,
                                   atol=1e-5)
        agree(n, v, f)
        agree(nj, vj, fj)
