"""PyTorch port vs the JAX package: the serving path (serve.serve_meshes,
serve.watch_and_serve), end to end on the CPU. Both packages mesh
through the same mesher: the native library where native/build holds it,
else each package's NumPy marching tetrahedra."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import serve as jserve
from latent_diffusion_models_for_shape_sdfs_tpu.config import (
    DecoderConfig as JaxDecoderConfig)
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_decoder import (
    make_fast_apply as jax_make_fast_apply)
from latent_diffusion_models_for_shape_sdfs_torch import serve as tserve
from latent_diffusion_models_for_shape_sdfs_torch.config import DecoderConfig
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    chamfer_l2, sample_mesh_surface)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    make_fast_apply)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_tree_npz, params_from_jax)

torch.set_num_threads(2)

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "scale_chairs6k" / "stage1_pack.npz")


def torch_sphere(z, xyz):
    """Analytic ApplyFn: latent sets the radius (z[0] in [0,1] -> r)."""
    r = 0.35 + 0.1 * z[0]
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1)) - r


# Chebyshev cube on a 1/256 lattice: both frameworks evaluate it exactly
# (tests/test_torch_grid_eval.py says why the sphere cannot be bitwise).
def jax_cube(z, xyz):
    q = jnp.abs(jnp.round(xyz * 256.0))
    return jnp.max(q, axis=-1) / 256.0 - (0.35 + 0.1 * z[0])


def torch_cube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


def _serve(fn, lat, **kw):
    return list(tserve.serve_meshes(fn, lat, device="cpu", **kw))


def test_serve_meshes_fp32_matches_jax_on_trained_decoder():
    """The fp32 lineage-parity mode (fp32 fast_apply, float32 payload) on
    the committed 8x512 chair decoder at res 64. The decoded crossing set
    (the sign pattern of the reconstructed grid) matches JAX's outside the
    |sdf| < 3e-4 near-zero band, where the reference's own decode programs
    flip signs (ROADMAP.md, queue 3); the served meshes agree vertex for
    vertex up to fp32 interpolation noise."""
    from scipy.spatial import cKDTree

    from latent_diffusion_models_for_shape_sdfs_tpu.ops import (
        grid_eval as jge)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        grid_eval as tge)
    tree = load_tree_npz(PACK)
    params, codes = tree["params"], tree["codes"]
    lat = [codes[0], codes[3000]]
    res, h = 64, 2.0 / 63
    japply = jax_make_fast_apply(
        JaxDecoder(JaxDecoderConfig(use_dropout=False)), params, jnp.float32)
    tapply = make_fast_apply(SdfDecoder(DecoderConfig(use_dropout=False)),
                             params_from_jax(params), torch.float32)

    kw = dict(safety=1.2, safety3=2.0, out_dtype="float32")
    caps = tserve._default_caps(res)
    ja, jst = jge.decode_grid_hierarchical3_sparse2(
        japply, jnp.asarray(lat[0]), res, 16, 4, 2, *caps, **kw)
    ta, tst = tge.decode_grid_hierarchical3_sparse2(
        tapply, torch.from_numpy(lat[0]), res, 16, 4, 2, *caps, **kw)
    n = ("active_l1", "active_l2", "active_l3")
    assert [tst[k] for k in n] == [jst[k] for k in n]
    gj = jge.sparse2_to_grid(*(np.asarray(a) for a in ja), jst["active_l1"],
                             jst["active_l2"], res, 16, 4)
    gt = tge.sparse2_to_grid(*(a.numpy() for a in ta), tst["active_l1"],
                             tst["active_l2"], res, 16, 4)
    outside = np.minimum(np.abs(gj), np.abs(gt)) >= 3e-4
    assert np.array_equal(np.signbit(gt[outside]), np.signbit(gj[outside]))
    assert np.abs(gt - gj).max() < 1e-4

    want = list(jserve.serve_meshes(japply, lat, res=res,
                                    out_dtype="float32"))
    got = _serve(tapply, lat, res=res, out_dtype="float32")
    for (vt, ft, st), (vj, fj, sj) in zip(got, want):
        assert st["mesher"] == sj["mesher"]
        assert len(ft) > 1000 and not st["capacity_exceeded"]
        assert abs(len(vt) - len(vj)) <= 0.01 * len(vj)
        d, _ = cKDTree(vj).query(vt, k=1)
        assert np.mean(d < 1e-3 * h) >= 0.97
        pt = sample_mesh_surface(vt, ft, 20_000, seed=0)
        pj = sample_mesh_surface(vj, fj, 20_000, seed=0)
        assert chamfer_l2(pt, pj) < (h / 4) ** 2


@pytest.mark.parametrize("out_dtype", ["int8", "float32"])
def test_serve_meshes_match_jax_bitwise_on_exact_sdf(out_dtype):
    """Same SDF values in, same payload, same mesher: the port's meshes
    equal JAX's bit for bit, including under capacity escalation."""
    lat = [np.asarray([0.5, 0.0], np.float32),
           np.asarray([1.0, 0.0], np.float32)]
    kw = dict(res=64, out_dtype=out_dtype, caps=(8, 64, 256))
    want = list(jserve.serve_meshes(jax_cube, lat, **kw))
    got = _serve(torch_cube, lat, **kw)
    for (vt, ft, st), (vj, fj, sj) in zip(got, want):
        assert len(ft) > 100
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        for k in ("active_l1", "active_l2", "active_l3", "escalations",
                  "cap1", "cap2", "cap3", "capacity_exceeded",
                  "payload_bytes", "mesher"):
            assert st[k] == sj[k], k
        assert st["escalations"] >= 1


def test_serve_meshes_geometry_and_threading():
    lat = [np.asarray([0.2 * i, 0.0], np.float32) for i in range(4)]
    serial = _serve(torch_sphere, lat, res=64, mesh_workers=1)
    pooled = _serve(torch_sphere, lat, res=64, mesh_workers=4)
    assert len(serial) == len(pooled) == 4
    for i, ((v1, f1, s1), (v2, f2, s2)) in enumerate(zip(serial, pooled)):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(f1, f2)
        assert s1["escalations"] == 0 and s1["active_l2"] == s2["active_l2"]
        rad = np.linalg.norm(v1, axis=1)
        assert abs(np.median(rad) - (0.35 + 0.02 * i)) < 0.02


def test_serve_meshes_truncation_is_flagged():
    lat = [np.asarray([1.0, 0.0], np.float32)]
    (_v, _f, st), = _serve(torch_sphere, lat, res=64, caps=(8, 64, 256),
                           max_escalations=0)
    assert st["capacity_exceeded"]
    assert (st["cap1"], st["cap2"], st["cap3"]) == (8, 64, 256)


def test_serve_meshes_iso_rules():
    z = np.asarray([0.5, 0.0], np.float32)            # r = 0.4
    with pytest.raises(ValueError, match="magnitude-preserving"):
        _serve(torch_sphere, [z], res=64, iso=0.05)
    (v, f, _st), = _serve(torch_sphere, [z], res=64, iso=0.05,
                          out_dtype="float32")
    assert len(f) > 100
    assert abs(np.median(np.linalg.norm(v, axis=1)) - 0.45) < 0.02


def test_serve_meshes_bfloat16_payload():
    (v, f, st), = _serve(torch_sphere, [np.asarray([0.5, 0.0], np.float32)],
                         res=64, out_dtype="bfloat16")
    assert len(f) > 100
    assert abs(np.median(np.linalg.norm(v, axis=1)) - 0.4) < 0.02


def test_serve_meshes_simplify_needs_native_mesher():
    from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
        mesher_impl)
    lat = [np.asarray([0.5, 0.0], np.float32)]
    if mesher_impl() == "numpy":
        with pytest.raises(RuntimeError, match="native library"):
            _serve(torch_sphere, lat, res=64, simplify_ratio=0.25)
        return
    (v, f, st), = _serve(torch_sphere, lat, res=64, simplify_ratio=0.25)
    assert 0 < len(f) <= 0.26 * st["faces_before"]
    assert abs(np.median(np.linalg.norm(v, axis=1)) - 0.4) < 0.02


def test_entry_points_need_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.asarray([0.5, 0.0], np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(tserve.serve_meshes(torch_sphere, [z], res=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.watch_and_serve(torch_sphere, tmp_path, tmp_path / "o",
                               res=64, max_idle=0.0)


def test_watch_and_serve_daemon_and_quarantine(tmp_path):
    """Requests in, meshes + stats out, .done markers; malformed requests
    (not an npy, wrong rank, observations without a reconstruct_fn) are
    quarantined with an error sidecar and the daemon keeps serving."""
    q = tmp_path / "q"
    out = tmp_path / "out"
    q.mkdir()
    (q / "junk.npy").write_bytes(b"not an npy at all")
    np.save(q / "bad_shape.npy", np.zeros((2, 2, 2), np.float32))
    np.savez(q / "obs.npz", obs_xyz=np.zeros((10, 3), np.float32),
             obs_sdf=np.zeros(10, np.float32))
    np.save(q / "a.npy", np.asarray([0.5, 0.0], np.float32))
    np.savez(q / "b.npz", z=np.asarray([[0.2, 0.0], [0.8, 0.0]], np.float32))
    served = tserve.watch_and_serve(torch_sphere, q, out, res=64, poll=0.05,
                                    max_idle=0.5, device="cpu")
    assert served == 2
    for name in ("junk.npy", "bad_shape.npy", "obs.npz"):
        assert (q / f"{name}.failed").exists()
    err = json.loads((out / "obs.error.json").read_text())
    assert "reconstruct_fn" in err["error"]
    assert (q / "a.npy.done").exists() and (q / "b.npz.done").exists()
    stats = json.loads((out / "b.stats.json").read_text())
    assert len(stats) == 2
    for i in range(2):
        ply = (out / f"b_{i:03d}.ply").read_bytes()
        header = ply[:ply.index(b"end_header")].decode()
        assert f"element vertex {stats[i]['verts']}" in header
        assert stats[i]["verts"] > 100
    (q / "STOP").touch()
    assert tserve.watch_and_serve(torch_sphere, q, out, res=64, poll=0.05,
                                  device="cpu") == 0
    assert not (q / "STOP").exists()
