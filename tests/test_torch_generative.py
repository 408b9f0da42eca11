"""PyTorch port vs the JAX package: generative-set metrics.

evaluation.generative (host NumPy/scipy, a copy of the reference's) must
return exactly the JAX package's values on the same seeded clouds.
evaluation.device_metrics runs here with device="cpu" against the JAX
package's device metrics on the CPU: Chamfer matrices to 1e-6 relative,
Sinkhorn-EMD matrices to 1e-5 relative, MMD / COV / 1-NNA to the same;
and against the host oracles as the JAX package's own tests hold its
device path (tests/test_device_metrics.py): Chamfer to 2e-4 of the
KD-tree value, Sinkhorn-EMD within the entropic envelope of the exact
assignment."""

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.evaluation import (
    device_metrics as jdm)
from latent_diffusion_models_for_shape_sdfs_tpu.evaluation import (
    generative as jgen)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    device_metrics as tdm)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    generative as tgen)

torch.set_num_threads(2)


def _clouds(k, n, seed, spread=1.0):
    """tests/test_device_metrics.py's clouds: Gaussian blobs of std 0.2
    at random centres."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        c = rng.uniform(-0.5, 0.5, 3) * spread
        out.append((c + 0.2 * rng.normal(size=(n, 3))).astype(np.float32))
    return out


# ----------------------------------------------------------------- host


def test_host_metrics_equal():
    gen, ref = _clouds(5, 80, 0), _clouds(4, 80, 1)
    np.testing.assert_array_equal(tgen.pairwise_chamfer(gen, ref),
                                  jgen.pairwise_chamfer(gen, ref))
    assert tgen.mmd_coverage(gen, ref) == jgen.mmd_coverage(gen, ref)
    assert tgen.one_nna(gen, ref) == jgen.one_nna(gen, ref)
    assert tgen.evaluate_generated(gen, ref) == jgen.evaluate_generated(
        gen, ref)


def test_host_emd_equal():
    gen, ref = _clouds(3, 96, 2), _clouds(3, 96, 3)
    assert tgen.emd_exact(gen[0], ref[1]) == jgen.emd_exact(gen[0], ref[1])
    for points in (64, 200):
        assert tgen.evaluate_generated_emd_host(
            gen, ref, points=points, seed=4) == \
            jgen.evaluate_generated_emd_host(gen, ref, points=points, seed=4)


# --------------------------------------------------------------- device


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_device_chamfer_matches_jax(chunk):
    a, b = _clouds(5, 128, 0), _clouds(4, 100, 1)
    got = tdm.pairwise_metric(a, b, "chamfer", chunk=chunk, device="cpu")
    want = jdm.pairwise_metric(a, b, "chamfer", chunk=chunk)
    assert got.shape == (5, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, tgen.pairwise_chamfer(a, b), rtol=2e-4,
                               atol=1e-6)
    got_t = tdm.pairwise_metric(torch.from_numpy(np.stack(a)),
                                torch.from_numpy(np.stack(b)), "chamfer",
                                chunk=chunk, device="cpu")
    np.testing.assert_array_equal(got_t, got)


@pytest.mark.parametrize("eps, iters", [(0.005, 500), (0.01, 200)])
def test_device_sinkhorn_matches_jax(eps, iters):
    a, b = _clouds(3, 64, 2), _clouds(3, 64, 3)
    got = tdm.pairwise_metric(a, b, "emd", chunk=2, eps=eps, iters=iters,
                              device="cpu")
    want = jdm.pairwise_metric(a, b, "emd", chunk=2, eps=eps, iters=iters)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if eps == 0.005:            # tests/test_device_metrics.py's envelope
        for i in range(3):
            for j in range(3):
                exact = tgen.emd_exact(a[i], b[j])
                assert got[i, j] >= exact - 1e-4
                assert got[i, j] - exact < 0.05 * exact + 0.01


@pytest.mark.parametrize("metric", ["chamfer", "emd"])
def test_device_self_matrix_matches_jax(metric):
    x = _clouds(5, 48, 9)
    got = tdm.pairwise_metric_self(x, metric, chunk=3, device="cpu")
    want = jdm.pairwise_metric_self(x, metric, chunk=3)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5 if metric == "emd"
                               else 1e-6, atol=0)
    np.testing.assert_array_equal(got, got.T)
    assert (np.diag(got) == 0).all()
    one = tdm.pairwise_metric_self(x[:1], metric, device="cpu")
    assert one.shape == (1, 1) and one[0, 0] == 0.0


@pytest.mark.parametrize("metrics", [("chamfer",), ("chamfer", "emd")])
def test_evaluate_generated_device_matches_jax(metrics):
    gen, ref = _clouds(6, 96, 5), _clouds(6, 96, 6)
    got = tdm.evaluate_generated_device(gen, ref, metrics=metrics, chunk=4,
                                        device="cpu")
    want = jdm.evaluate_generated_device(gen, ref, metrics=metrics, chunk=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
    host = tgen.evaluate_generated(gen, ref)
    assert abs(host["mmd_chamfer"] - got["mmd_chamfer"]) < 2e-4
    assert host["coverage"] == got["coverage"]
    assert host["one_nna"] == got["one_nna"]


def test_device_metrics_check_their_inputs(monkeypatch):
    a = _clouds(2, 32, 7)
    with pytest.raises(ValueError, match="metric"):
        tdm.pairwise_metric(a, a, "hausdorff", device="cpu")
    with pytest.raises(ValueError, match="equal-size"):
        tdm.pairwise_metric(a, _clouds(2, 16, 8), "emd", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.pairwise_metric(a, a)             # the default device is cuda
