"""PyTorch port vs the JAX package: the checkpoint helpers of
utils/checkpoint.py (restore_tree_npz, restore_stage1, save_array_dict,
load_array_dict) and evaluation's chamfer_l2_directed, on the CPU. Files
written by either package are read by the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.evaluation import (
    chamfer_l2_directed as jax_directed)
from latent_diffusion_models_for_shape_sdfs_tpu.utils import checkpoint as jck
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    chamfer_l2, chamfer_l2_directed)
from latent_diffusion_models_for_shape_sdfs_torch.utils import checkpoint as tck


@pytest.mark.parametrize("n_src,n_dst", [(500, 800), (1000, 300)])
def test_chamfer_directed_matches_jax(n_src, n_dst):
    rng = np.random.default_rng(n_src)
    a = rng.normal(size=(n_src, 3)).astype(np.float32)
    b = rng.normal(size=(n_dst, 3)).astype(np.float32) + 0.1
    for src, dst in ((a, b), (b, a)):
        assert abs(chamfer_l2_directed(src, dst)
                   - jax_directed(src, dst)) <= 1e-12
    assert abs(chamfer_l2_directed(a, b) + chamfer_l2_directed(b, a)
               - chamfer_l2(a, b)) <= 1e-12


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"lin0": {"v": rng.normal(size=(11, 32)).astype(
                           np.float32),
                                "b": rng.normal(size=(32,)).astype(
                           np.float32)}},
            "codes": rng.normal(size=(5, 8)).astype(np.float32),
            "step": np.asarray(7, np.int32)}


def test_array_dicts_cross_read(tmp_path):
    d = {"z": np.arange(12, dtype=np.float32).reshape(3, 4),
         "ids": np.asarray([3, 1], np.int32)}
    jck.save_array_dict(tmp_path / "jax.npz", d)
    tck.save_array_dict(tmp_path / "port.npz",
                        {"z": torch.from_numpy(d["z"]), "ids": d["ids"]})
    for name in ("jax.npz", "port.npz"):
        for load in (jck.load_array_dict, tck.load_array_dict):
            got = load(tmp_path / name)
            assert got.keys() == d.keys()
            for k in d:
                assert got[k].dtype == d[k].dtype
                np.testing.assert_array_equal(got[k], d[k])


def test_restore_tree_npz_matches_jax(tmp_path):
    """A pack written by either package restores against a template in
    both, with the saved dtype, and both raise KeyError for a missing
    leaf and ValueError for another shape."""
    tree = _tree()
    jck.pack_tree_npz(tmp_path / "jax.npz", jax.tree.map(jnp.asarray, tree))
    tck.pack_tree_npz(tmp_path / "port.npz", tree)
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, np.float64), tree)
    for name in ("jax.npz", "port.npz"):
        got = tck.restore_tree_npz(tmp_path / name, tmpl)
        ref = jck.restore_tree_npz(tmp_path / name, tmpl)
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(ref),
                           jax.tree.leaves(tree)):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    sub = {"codes": torch.zeros(5, 8)}                 # a subset, as tensors
    np.testing.assert_array_equal(
        tck.restore_tree_npz(tmp_path / "port.npz", sub)["codes"],
        tree["codes"])
    missing = dict(tmpl, extra=np.zeros(3))
    wrong = dict(tmpl, codes=np.zeros((5, 9)))
    for restore in (tck.restore_tree_npz, jck.restore_tree_npz):
        with pytest.raises(KeyError, match="extra"):
            restore(tmp_path / "port.npz", missing)
        with pytest.raises(ValueError, match="codes"):
            restore(tmp_path / "port.npz", wrong)


def test_restore_stage1_prefers_the_checkpoint(tmp_path):
    tree = _tree()
    tmpl = {"params": tree["params"], "codes": tree["codes"]}
    with pytest.raises(FileNotFoundError):
        tck.restore_stage1(tmp_path, tmpl)
    tck.pack_tree_npz(tmp_path / "stage1_pack.npz", tree)
    got = tck.restore_stage1(tmp_path, tmpl)
    np.testing.assert_array_equal(got["codes"], tree["codes"])
    np.testing.assert_array_equal(got["params"]["lin0"]["v"],
                                  tree["params"]["lin0"]["v"])
    newer = _tree(seed=1)
    tck.StageCheckpointer(tmp_path, "ad").save(3, {
        "params": {"lin0": {k: torch.from_numpy(v) for k, v in
                            newer["params"]["lin0"].items()}},
        "codes": torch.from_numpy(newer["codes"])})
    got = tck.restore_stage1(tmp_path, tmpl)
    assert torch.equal(got["codes"], torch.from_numpy(newer["codes"]))
    assert torch.equal(got["params"]["lin0"]["b"],
                       torch.from_numpy(newer["params"]["lin0"]["b"]))
    with pytest.raises(ValueError, match="codes"):
        tck.restore_stage1(tmp_path, dict(tmpl, codes=np.zeros((4, 8))))
