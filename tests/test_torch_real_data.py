"""PyTorch port vs the JAX package: real-mesh data (the `sdf:<dir>` source).

SdfDataset.from_dir on .npz stores written by numpy (the preprocess tool's
layout: pos / neg [N,4], center [3], scale [1], surface [M,3]) must hold
the JAX package's arrays and transforms and draw the same batches bit for
bit; pipeline.build_dataset must build it from `sdf:<dir>`. run_eval on
an `sdf:` experiment is held against the JAX package's run_eval on the
same small seeded decoder, carried across as numpy parameters: the same
first `num_points` rows of each store's surface as ground truth, the
scenes clamped to the trained codes, no normal consistency; the meshes
differ only where bf16 sums in another order move a crossing, so the
Chamfer-L2 of each scene agrees to 2% and the F-score to 0.02. The chain
OBJ -> `preprocess` (native) -> `train-ad` -> `eval` runs through the
port's CLI when the native tools are built, as tests/test_real_mesh_chain.py
runs it through the JAX package's."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import pipeline as jpipe
from latent_diffusion_models_for_shape_sdfs_tpu.data.sdf_dataset import (
    SdfDataset as JaxDataset)
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.train.auto_decoder import (
    AdTrainState as JaxAdState)
from latent_diffusion_models_for_shape_sdfs_torch import cli
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import pipeline as tpipe
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    chamfer_l2, sample_mesh_surface)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
    decode_grid)
from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
    extract_mesh)
from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
    init_ad_state)
from latent_diffusion_models_for_shape_sdfs_torch.utils import meshio
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    StageCheckpointer, ad_state_tree, params_from_jax)
from tests.test_native import _icosphere, needs_native

torch.set_num_threads(2)


def _write_stores(root, n, seed, surface=True, transform=True):
    """n sphere scenes (radius 0.3-0.5) as preprocess-style .npz files,
    named so that sorted order differs from creation order."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        r = 0.3 + 0.2 * i / max(n - 1, 1)
        xyz = rng.uniform(-1, 1, (700 + 37 * i, 3)).astype(np.float32)
        d = (np.linalg.norm(xyz, axis=1) - r).astype(np.float32)
        rows = np.concatenate([xyz, d[:, None]], 1)
        arrs = {"pos": rows[d >= 0], "neg": rows[d < 0]}
        if transform:
            arrs["center"] = rng.normal(size=3).astype(np.float32)
            arrs["scale"] = np.asarray([1.0 + i], np.float32)
        if surface:
            s = rng.normal(size=(3000, 3))
            arrs["surface"] = (r * s / np.linalg.norm(s, axis=1,
                                                      keepdims=True)
                               ).astype(np.float32)
        np.savez(root / f"scene_{(n - i) * 7:03d}.npz", **arrs)
    return root


@pytest.mark.parametrize("transform", [True, False])
def test_from_dir_matches_jax(tmp_path, transform):
    d = _write_stores(tmp_path / "sdf", 5, 0, transform=transform)
    got, want = SdfDataset.from_dir(d), JaxDataset.from_dir(d)
    assert len(got) == len(want) == 5
    for a, b in zip(got.pos + got.neg, want.pos + want.neg):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.class_ids, want.class_ids)
    assert got.shapes is None
    if transform:
        for (c, s), (cj, sj) in zip(got.transforms, want.transforms):
            np.testing.assert_array_equal(c, cj)
            assert s == sj and isinstance(s, float)
    else:
        assert got.transforms == want.transforms == [None] * 5
    for seed in (0, 1):
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        for bt, bj in zip(got.epoch_batches(rt, 2, 64),
                          want.epoch_batches(rj, 2, 64)):
            np.testing.assert_array_equal(bt.scene_ids, bj.scene_ids)
            np.testing.assert_array_equal(bt.xyz, bj.xyz)
            np.testing.assert_array_equal(bt.sdf, bj.sdf)


def test_from_dir_needs_files(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="npz"):
        SdfDataset.from_dir(tmp_path / "empty")


def test_build_dataset_sdf_source(tmp_path):
    d = _write_stores(tmp_path / "sdf", 3, 1)
    kw = dict(data_source=f"sdf:{d}")
    got = tpipe.build_dataset(tcfg.ExperimentConfig(**kw))
    want = jpipe.build_dataset(jcfg.ExperimentConfig(**kw))
    for a, b in zip(got.pos + got.neg, want.pos + want.neg):
        np.testing.assert_array_equal(a, b)
    assert [t[1] for t in got.transforms] == [t[1] for t in
                                              want.transforms]
    with pytest.raises(ValueError, match="unknown data source"):
        tpipe.build_dataset(tcfg.ExperimentConfig(data_source="mesh:x"))


def _decoder(n_codes):
    """A small seeded decoder (JAX init) whose zero sets cross the grid."""
    import jax
    jc = jcfg.DecoderConfig(latent_size=8, hidden_dim=32, num_layers=3,
                            latent_in=(2,), use_dropout=False)
    dec = JaxDecoder(jc)
    params = jax.tree.map(np.asarray, dec.init_params(jax.random.PRNGKey(4)))
    codes = (0.3 * np.random.default_rng(5).normal(size=(n_codes, 8))
             ).astype(np.float32)
    last = params["lin2"]
    last["g"] = (8.0 * last["g"]).astype(np.float32)
    from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_decoder import (
        make_fast_apply)
    pts = np.random.default_rng(0).uniform(-0.6, 0.6, (4096, 3))
    med = float(np.median(np.asarray(make_fast_apply(dec, params)(
        jnp.asarray(codes[0]), jnp.asarray(pts, jnp.float32)))))
    last["b"] = (last["b"] - med).astype(np.float32)
    return dec, params, codes


def _experiments(tmp_path, monkeypatch, data, n_codes):
    dec, params, codes = _decoder(n_codes)
    kw = {"ad.decoder.latent_size": 8, "ad.decoder.hidden_dim": 32,
          "ad.decoder.num_layers": 3, "ad.decoder.latent_in": [2],
          "ad.decoder.use_dropout": False, "ad.num_scenes": n_codes,
          "sample.grid_res": 32}
    texp, jexp = tmp_path / "t", tmp_path / "j"
    tc = tcfg.override(tcfg.ExperimentConfig(data_source=f"sdf:{data}"),
                       **kw)
    tc.save(texp)
    jcfg.override(jcfg.ExperimentConfig(data_source=f"sdf:{data}"),
                  **kw).save(jexp)
    state = init_ad_state(tc.ad, SdfDecoder(tc.ad.decoder),
                          params=params_from_jax(params), codes=codes,
                          device="cpu")
    StageCheckpointer(texp, "auto_decoder").save(0, ad_state_tree(state, 0))
    monkeypatch.setattr(jpipe, "load_ad_state", lambda exp_dir: (
        dec, JaxAdState(params, jnp.asarray(codes), None, None)))
    return texp, jexp


@pytest.mark.parametrize("n_files, n_codes", [(3, 3), (4, 2)])
def test_run_eval_sdf_matches_jax(tmp_path, monkeypatch, n_files, n_codes):
    """A data dir with more files than trained codes evaluates only the
    scenes that have one."""
    data = _write_stores(tmp_path / "sdf", n_files, 2)
    texp, jexp = _experiments(tmp_path, monkeypatch, data, n_codes)
    got = tpipe.run_eval(str(texp), num_points=1500, device="cpu")
    want = jpipe.run_eval(str(jexp), num_points=1500)
    assert set(got) == set(want)
    assert "normal_consistency" not in got
    assert sorted(got["chamfer_l2"]) == sorted(want["chamfer_l2"]) == [
        str(i) for i in range(n_codes)]
    assert got["num_failed"] == want["num_failed"] == 0
    for k, v in want["chamfer_l2"].items():
        np.testing.assert_allclose(got["chamfer_l2"][k], v, rtol=0.02)
        assert abs(got["fscore"][k] - want["fscore"][k]) <= 0.02
    assert json.loads((texp / "evals" / "chamfer.json").read_text()) == got


def test_run_eval_uses_the_stored_surface(tmp_path, monkeypatch):
    """The ground truth is the first num_points rows of `surface`, in the
    store's order: the port's Chamfer equals one recomputed from them."""
    data = _write_stores(tmp_path / "sdf", 2, 3)
    texp, _ = _experiments(tmp_path, monkeypatch, data, 2)
    out = tpipe.run_eval(str(texp), num_points=800, device="cpu")
    _, state = tpipe.load_ad_state(str(texp), device="cpu")
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply)
    apply_fn = make_kernel_apply(state.decoder, tpipe.decoder_params(state),
                                 device="cpu")
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        sample_mesh_surface_with_normals)
    for i, f in enumerate(sorted(data.glob("*.npz"))):
        v, fc = extract_mesh(decode_grid(apply_fn, state.codes.detach()[i],
                                         32).numpy())
        pred, _ = sample_mesh_surface_with_normals(v, fc, 800, seed=i)
        with np.load(f) as z:
            gt = z["surface"][:800]
        assert out["chamfer_l2"][str(i)] == chamfer_l2(pred, gt)
    for f in data.glob("*.npz"):          # a store without `surface`
        with np.load(f) as z:
            arrs = {k: z[k] for k in z.files if k != "surface"}
        np.savez(f, **arrs)
    with pytest.raises(ValueError, match="surface"):
        tpipe.run_eval(str(texp), num_points=800, device="cpu")


def test_cli_preprocess_refuses_without_the_native_tool(tmp_path,
                                                        monkeypatch):
    """No fallback: without native/build/preprocess_mesh the verb exits
    with the reference's message."""
    import pathlib
    real_exists = pathlib.Path.exists
    monkeypatch.setattr(pathlib.Path, "exists", lambda p: False if p.name
                        == "preprocess_mesh" else real_exists(p))
    with pytest.raises(SystemExit, match="native preprocess tool not built"):
        cli.main(["--device", "cpu", "preprocess", str(tmp_path),
                  str(tmp_path / "out")])


@needs_native
def test_obj_to_trained_mesh_chain(tmp_path):
    """tests/test_real_mesh_chain.py through the port's CLI: an OBJ and a
    binary PLY -> preprocess -> train-ad from `sdf:` -> eval against the
    stored surfaces; the decoded mesh mapped back through center / scale
    matches the source icosphere."""
    v, f = _icosphere(subdiv=3)
    mesh_dir = tmp_path / "meshes"
    meshio.write_obj(mesh_dir / "shape0.obj", v, f)
    meshio.write_ply(mesh_dir / "shape1.ply", 0.8 * v, f, binary=True)
    sdf_dir = tmp_path / "sdf"
    cli.main(["--device", "cpu", "preprocess", str(mesh_dir), str(sdf_dir),
              "--samples", "60000"])
    files = sorted(sdf_dir.glob("*.npz"))
    assert [p.name for p in files] == ["shape0.npz", "shape1.npz"]
    ds = SdfDataset.from_dir(sdf_dir)
    center, scale = ds.transforms[0]
    assert np.abs(center).max() < 1e-3
    assert abs(scale - 1.0 / (0.5 * 1.03)) < 1e-3
    exp = tmp_path / "exp"
    cli.main(["--device", "cpu", "init-experiment", str(exp), "--data",
              f"sdf:{sdf_dir}", "--scenes", "2",
              "--set", "ad.decoder.latent_size=16",
              "--set", "ad.decoder.hidden_dim=64",
              "--set", "ad.decoder.num_layers=4",
              "--set", "ad.decoder.latent_in=[2]",
              "--set", "ad.decoder.use_dropout=false",
              "--set", "ad.scenes_per_batch=2",
              "--set", "ad.samples_per_scene=4096",
              "--set", "ad.num_epochs=250", "--set", "ad.clamp_dist=0.5",
              "--set", "ad.lr_decoder=0.001", "--set", "ad.lr_latent=0.002",
              "--set", "ad.lr_decay_interval=125",
              "--set", "ad.snapshot_every=0", "--set", "sample.grid_res=48"])
    cli.main(["--device", "cpu", "train-ad", str(exp)])
    _, state = tpipe.load_ad_state(str(exp), device="cpu")
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply)
    apply_fn = make_kernel_apply(state.decoder, tpipe.decoder_params(state),
                                 device="cpu")
    pv, pf = extract_mesh(decode_grid(apply_fn, state.codes.detach()[0],
                                      48).numpy())
    assert len(pf) > 100
    pred = sample_mesh_surface(pv / scale + center, pf, 10_000, seed=0)
    gt = sample_mesh_surface(v, f, 10_000, seed=1)
    assert chamfer_l2(pred, gt) < 2e-3
    cli.main(["--device", "cpu", "eval", str(exp), "--points", "10000"])
    ev = json.loads((exp / "evals" / "chamfer.json").read_text())
    assert ev["num_failed"] == 0 and len(ev["chamfer_l2"]) == 2
    assert ev["mean"] < 2e-3 * scale ** 2, ev
    shutil.rmtree(exp / "checkpoints")
