"""Tests of the port that need a CUDA card (marker `gpu`; they skip
without one). They import neither JAX nor the JAX package, so they run on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

(`--noconftest`: tests/conftest.py sets up JAX for the reference tests.)
"""

import pathlib

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_torch.config import DecoderConfig
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import chamfer_l2
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply)
from latent_diffusion_models_for_shape_sdfs_torch.serve import serve_meshes
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack)

pytestmark = pytest.mark.gpu

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "scale_chairs6k" / "stage1_pack.npz")

# the plans of tests/test_pallas_kernels.py, with torch-initialised weights
PLANS = {
    "small": dict(latent_size=16, hidden_dim=128, num_layers=3,
                  latent_in=(2,), use_dropout=False),
    "tanh": dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
                 use_tanh=True, use_dropout=False),
    "canonical": dict(use_dropout=False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _decoder(name):
    if name == "trained":
        sd, codes = load_stage1_pack(PACK)
        return SdfDecoder(DecoderConfig()), sd, codes[11]
    torch.manual_seed(0)
    dec = SdfDecoder(DecoderConfig(**PLANS[name]))
    L = dec.cfg.latent_size
    z = np.random.default_rng(0).normal(size=L) / np.sqrt(L)
    return dec, dec.state_dict(), z.astype(np.float32)


@pytest.mark.parametrize("name", sorted(PLANS) + ["trained"])
@pytest.mark.parametrize("n", [1, 63, 64, 700, (1 << 16) + 131])
def test_kernel_matches_plain_version(name, n, cuda):
    """Kernel vs bf16 fast_apply, ragged tails included (tolerance of
    tests/test_pallas_kernels.py)."""
    dec, sd, z = _decoder(name)
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    xyz = torch.from_numpy(np.random.default_rng(n).uniform(
        -1, 1, (n, 3)).astype(np.float32)).to(cuda)
    got = apply(zt, xyz)
    torch.cuda.synchronize()
    assert apply.launches == 1 and got.shape == (n,)
    torch.testing.assert_close(got, fast_apply(apply.ew, zt, xyz),
                               atol=5e-3, rtol=0)


def test_kernel_wrapper_checks_inputs(cuda):
    dec, sd, z = _decoder("tanh")
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    with pytest.raises(ValueError, match="weights on"):
        apply(zt.cpu(), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="xyz must be"):
        apply.launch(torch.zeros(4, 4, device=cuda),
                     torch.zeros(1, device=cuda))
    assert apply(zt, torch.zeros(0, 3, device=cuda)).shape == (0,)


def snapped_cube(z, xyz):
    """An SDF whose float32 evaluation is exact on any device."""
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


def test_serve_on_card_matches_cpu(cuda):
    """Same SDF values on both devices: the card's serve (async copies to
    pinned buffers on a second stream, event waits, escalation) yields the
    CPU serve's meshes and stats bit for bit."""
    lat = [np.asarray([0.1 * i, 0.0], np.float32) for i in range(6)]
    kw = dict(res=64, caps=(8, 64, 256), mesh_workers=3)
    on_card = list(serve_meshes(snapped_cube, lat, device=cuda, **kw))
    on_cpu = list(serve_meshes(snapped_cube, lat, device="cpu", **kw))
    for (v1, f1, s1), (v2, f2, s2) in zip(on_card, on_cpu):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(f1, f2)
        for k in ("active_l1", "active_l2", "active_l3", "escalations",
                  "payload_bytes", "mesher"):
            assert s1[k] == s2[k], k


def test_serve_through_kernel_matches_plain_version(cuda):
    """Trained chairs at 128^3 through the kernel vs through the plain
    version: the same crossings up to bf16 noise (vertex Chamfer-L2 far
    below a quarter voxel squared), 4 launches per shape."""
    dec, sd, _ = _decoder("trained")
    codes = load_stage1_pack(PACK)[1]
    lat = list(codes[[5, 3333]])
    apply = make_kernel_apply(dec, sd, device=cuda)
    got = list(serve_meshes(apply, lat, res=128, device=cuda))
    assert apply.launches >= 4 * len(lat)

    def plain(z, xyz):
        return fast_apply(apply.ew, z, xyz)

    want = list(serve_meshes(plain, lat, res=128, device=cuda))
    h = 2.0 / 127
    for (v1, f1, _), (v2, _f2, _) in zip(got, want):
        assert len(f1) > 1000
        assert chamfer_l2(v1, v2) < (h / 4) ** 2
