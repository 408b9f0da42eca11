"""PyTorch port vs the JAX package: config, stage-1 pack reader, decoder
forward and the folded eval path (ops.fused_decoder), on the committed
trained 8x512 decoder. Same numpy inputs through both; JAX on the CPU."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_decoder import (
    make_fast_apply as jax_make_fast_apply)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    make_fast_apply, make_reference_apply)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack, load_tree_npz, params_from_jax, params_to_jax)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
PACK = REPO / "runs" / "scale_chairs6k" / "stage1_pack.npz"


@pytest.fixture(scope="module")
def pack():
    tree = load_tree_npz(PACK)
    return tree["params"], tree["codes"]


def _inputs(codes, n, seed=0):
    rng = np.random.default_rng(seed)
    z = codes[int(rng.integers(len(codes)))].astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return z, xyz


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "configs").iterdir()
    if (p / "specs.json").exists()))
def test_config_loads_specs_like_jax(name):
    a = tcfg.ExperimentConfig.load(REPO / "configs" / name)
    b = jcfg.ExperimentConfig.load(REPO / "configs" / name)
    assert a.to_json() == b.to_json()
    assert tcfg.ExperimentConfig.from_json(a.to_json()).to_json() \
        == a.to_json()


def test_pack_reader_and_param_round_trip(pack):
    params, codes = pack
    assert codes.shape == (6144, 256)
    sd = params_from_jax(params)
    assert sd["lin0.v"].shape == (512, 259)          # torch [out, in]
    back = params_to_jax(sd)
    assert back.keys() == params.keys()
    for name, layer in params.items():
        assert back[name].keys() == layer.keys()
        for k, a in layer.items():
            assert back[name][k].dtype == a.dtype
            np.testing.assert_array_equal(back[name][k], a)
    sd2, codes2 = load_stage1_pack(PACK)
    np.testing.assert_array_equal(codes2, codes)
    for k in sd:
        assert torch.equal(sd2[k], sd[k])


@pytest.mark.parametrize("key", ["['a'][0]['b']", "['a'].b", "a"])
def test_pack_key_parser(key, tmp_path):
    f = tmp_path / "p.npz"
    np.savez(f, **{key: np.zeros(2)})
    if key == "['a'][0]['b']":
        assert load_tree_npz(f)["a"][0]["b"].shape == (2,)
    else:
        with pytest.raises(ValueError, match="unsupported pack key"):
            load_tree_npz(f)


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 5e-3)])
def test_decoder_forward_matches_jax(pack, dtype, atol):
    params, codes = pack
    cfg = jcfg.DecoderConfig(use_dropout=False, compute_dtype=dtype)
    z, xyz = _inputs(codes, 3000)
    zz = np.broadcast_to(z, (len(xyz), len(z)))
    want = np.asarray(JaxDecoder(cfg).apply(
        {"params": params}, jnp.asarray(zz), jnp.asarray(xyz), train=False))
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False,
                                        compute_dtype=dtype)).eval()
    dec.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = dec(torch.from_numpy(np.ascontiguousarray(zz)),
                  torch.from_numpy(xyz)).numpy()
        ref = make_reference_apply(dec)(torch.from_numpy(z),
                                        torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_array_equal(ref, got)


def test_decoder_refuses_training_dropout():
    dec = SdfDecoder(tcfg.DecoderConfig(latent_size=8, hidden_dim=32,
                                        num_layers=2, latent_in=()))
    """Training-mode dropout runs only with an explicit seed."""
    with pytest.raises(ValueError, match="seed"):
        dec(torch.zeros(4, 8), torch.zeros(4, 3))
    assert dec(torch.zeros(4, 8), torch.zeros(4, 3), seed=1).shape == (4,)
    assert dec.eval()(torch.zeros(4, 8), torch.zeros(4, 3)).shape == (4,)


def test_decoder_init_matches_torch_weight_norm_contract():
    """g starts at ||v[o, :]||, so the initial effective weight is v."""
    torch.manual_seed(0)
    lin = SdfDecoder(tcfg.DecoderConfig(latent_size=8, hidden_dim=32,
                                        num_layers=2, latent_in=())).lin1
    torch.testing.assert_close(lin.weight(), lin.v, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 5e-3)])
def test_fast_apply_matches_jax(pack, dtype, atol):
    params, codes = pack
    cfg = jcfg.DecoderConfig(use_dropout=False)
    z, xyz = _inputs(codes, 2048 + 131, seed=1)
    want = np.asarray(jax_make_fast_apply(
        JaxDecoder(cfg), params, getattr(jnp, dtype))(
            jnp.asarray(z), jnp.asarray(xyz)))
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False))
    got = make_fast_apply(dec, params_from_jax(params),
                          getattr(torch, dtype))(
        torch.from_numpy(z), torch.from_numpy(xyz)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)


def test_fast_apply_tanh_small_plan_matches_jax():
    cfg = jcfg.DecoderConfig(latent_size=8, hidden_dim=32, num_layers=2,
                             latent_in=(), use_tanh=True, use_dropout=False)
    jdec = JaxDecoder(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    z = (rng.normal(size=8) / np.sqrt(8)).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    want = np.asarray(jax_make_fast_apply(jdec, params, jnp.float32)(
        jnp.asarray(z), jnp.asarray(xyz)))
    dec = SdfDecoder(tcfg.DecoderConfig(
        latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
        use_tanh=True, use_dropout=False))
    got = make_fast_apply(dec, params_from_jax(params), torch.float32)(
        torch.from_numpy(z), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
