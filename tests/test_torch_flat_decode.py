"""PyTorch port vs the JAX package: the flat batched decode
(ops.grid_eval.decode_grid_hierarchical3_batch_flat, probe_flat_caps,
unblock_grid).

A per-row form of the snapped Chebyshev cube of
tests/test_torch_grid_eval.py, an SDF both frameworks evaluate exactly:
each latent row sets its own half-width (column 0) and centre (columns
1-3, on the 1/256 lattice), so the shapes of a batch have different
actives. Through both packages its grids and stats must be equal bit for
bit. A small random decoder, through both packages' bf16 fast_apply over z
rows, must give grids that agree to 5e-3 outside the near-zero band."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops import (
    fused_decoder as jfd)
from latent_diffusion_models_for_shape_sdfs_tpu.ops import grid_eval as jge
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply_pairs)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    params_from_jax)

torch.set_num_threads(2)


def jax_cube_rows(zr, xyz):
    q = jnp.abs(jnp.round(xyz * 256.0) - zr[:, 1:4] * 256.0)
    return jnp.max(q, axis=-1) / 256.0 - zr[:, 0]


def torch_cube_rows(zr, xyz):
    q = torch.abs(torch.round(xyz * 256.0) - zr[:, 1:4] * 256.0)
    return torch.amax(q, dim=-1) / 256.0 - zr[:, 0]


def _cube_zs(S, seed):
    """Half-widths 0.2-0.5, centres within +-0.16 on the 1/256 lattice."""
    rng = np.random.default_rng(seed)
    hw = 0.2 + 0.3 * np.arange(S) / S
    c = rng.integers(-40, 41, size=(S, 3)) / 256.0
    return np.concatenate([hw[:, None], c], 1).astype(np.float32)


def _host(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jax_host(a):
    a = np.asarray(a)
    return a if a.dtype in (np.int8, np.float32) else a.astype(np.float32)


STAT_KEYS = ("layout", "coarse_evals", "mid_evals", "sub_evals",
             "fine_evals", "active_l1", "active_l2", "active_l3", "cap1",
             "cap2", "cap3", "effective_voxels", "capacity_exceeded")


def _decode_both(jfn, tfn, zs, res, caps, **kw):
    jg, jst = jge.decode_grid_hierarchical3_batch_flat(
        jfn, jnp.asarray(zs), res, 16, 4, 2, *caps, **kw)
    tg, tst = tge.decode_grid_hierarchical3_batch_flat(
        tfn, torch.from_numpy(zs), res, 16, 4, 2, *caps, **kw)
    assert set(tst) == set(jst)
    for k in STAT_KEYS:
        assert tst[k] == jst[k], k
    np.testing.assert_array_equal(tst["per_shape_l1"], jst["per_shape_l1"])
    return _host(tg), _jax_host(jg), tst


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("res, S", [(64, 4), (32, 3)])
def test_flat_decode_matches_jax_bitwise(out_dtype, res, S):
    """Equal caps from probe_flat_caps, equal stats (actives, caps,
    per-shape L1 actives) and bitwise-equal grids."""
    zs = _cube_zs(S, seed=res)
    caps = tge.probe_flat_caps(torch_cube_rows, torch.from_numpy(zs), res)
    assert caps == jge.probe_flat_caps(jax_cube_rows, jnp.asarray(zs), res)
    got, want, st = _decode_both(jax_cube_rows, torch_cube_rows, zs, res,
                                 caps, safety=1.2, safety3=2.0,
                                 out_dtype=out_dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not st["capacity_exceeded"]
    if res == 64:      # at res 32 every shape refines all 8 of its blocks
        assert len(set(st["per_shape_l1"].tolist())) > 1  # heterogeneous
    assert int(st["per_shape_l1"].sum()) == st["active_l1"]


def test_flat_decode_overflow_detected_like_jax():
    """tests/test_grid_eval.py:201's caps: the shells overflow, the flag
    says so, and the truncated grids still equal JAX's."""
    zs = _cube_zs(3, seed=2)
    got, want, st = _decode_both(jax_cube_rows, torch_cube_rows, zs, 32,
                                 (4, 16, 32), safety=1.2, safety3=2.0)
    assert st["capacity_exceeded"]
    np.testing.assert_array_equal(got, want)


def test_flat_decode_unblocked_matches_dense_decode():
    """Each shape of the flat decode, unblocked to x-major, keeps the dense
    decode's sign everywhere and its value wherever the fine level ran."""
    res, zs = 32, _cube_zs(3, seed=5)
    caps = tge.probe_flat_caps(torch_cube_rows, torch.from_numpy(zs), res)
    grids, _ = tge.decode_grid_hierarchical3_batch_flat(
        torch_cube_rows, torch.from_numpy(zs), res, 16, 4, 2, *caps)
    for s in range(3):
        z = torch.from_numpy(zs[s])
        dense = tge.decode_grid(
            lambda zz, xyz: torch_cube_rows(zz.expand(len(xyz), -1), xyz),
            z, res).numpy()
        got = tge.unblock_grid(grids[s].numpy(), res, 4)
        np.testing.assert_array_equal(
            got, jge.unblock_grid(grids[s].numpy(), res, 4))
        assert np.array_equal(np.signbit(got), np.signbit(dense))
        near = np.abs(dense) < 2.0 / (res - 1)
        np.testing.assert_array_equal(got[near], dense[near])


def test_eval_pairs_grouped_balanced_groups_match_jax():
    """Groups of at most points_per_group, balanced and padded with the
    edge point, each gathering its own latent rows."""
    rng = np.random.default_rng(0)
    zs = _cube_zs(5, seed=1)
    sids = rng.integers(0, 5, 301).astype(np.int32)
    xyz = rng.uniform(-1, 1, (301, 3)).astype(np.float32)
    want = np.asarray(jge._eval_pairs_grouped(
        jax_cube_rows, jnp.asarray(zs), jnp.asarray(sids), jnp.asarray(xyz),
        64))
    got = tge._eval_pairs_grouped(torch_cube_rows, torch.from_numpy(zs),
                                  torch.from_numpy(sids),
                                  torch.from_numpy(xyz), 64).numpy()
    np.testing.assert_array_equal(got, want)


def test_flat_decode_random_decoder_matches_jax():
    """A small random decoder (L 16, 3 layers of 128, skip at 2) carried
    across by params_from_jax, through JAX's fast_apply over z rows and
    the port's kernel wrapper (its plain version on the CPU), both bf16:
    equal actives, grids within 5e-3 outside the near-zero band
    (ROADMAP.md, queue 3)."""
    kw = dict(latent_size=16, hidden_dim=128, num_layers=3, latent_in=(2,),
              use_dropout=False)
    jdec = JaxDecoder(jcfg.DecoderConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(4)))
    # a steeper field with a zero set: the init's output lies in 0.0-0.2,
    # inside every level's margin, so nothing would stay unrefined
    params["lin3"]["g"] = params["lin3"]["g"] * 10.0
    params["lin3"]["b"] = params["lin3"]["b"] - 0.3
    jew = jfd.precompute_eval_weights(jdec, params, jnp.bfloat16)

    def jfn(zr, xyz):
        return jfd.fast_apply(jew, zr, xyz)

    tfn = make_kernel_apply_pairs(SdfDecoder(tcfg.DecoderConfig(**kw)),
                                  params_from_jax(params), device="cpu")
    zs = (np.random.default_rng(4).normal(size=(3, 16)) * 0.5).astype(
        np.float32)
    res = 64
    caps = (3 * 4 ** 3, 3 * 16 ** 3, 3 * 32 ** 3)     # every block fits
    got, want, st = _decode_both(jfn, tfn, zs, res, caps, safety=1.2,
                                 safety3=2.0)
    assert not st["capacity_exceeded"]
    assert 0 < st["active_l3"] < st["sub_evals"] // 2
    outside = np.minimum(np.abs(got), np.abs(want)) >= 3e-4
    assert np.abs(got - want)[outside].max() <= 5e-3
    assert np.array_equal(np.signbit(got[outside]), np.signbit(want[outside]))
    # and the wrapper's plain version is fast_apply over the rows
    ew = precompute_eval_weights(SdfDecoder(tcfg.DecoderConfig(**kw)),
                                 params_from_jax(params), torch.bfloat16)
    zr = torch.from_numpy(zs[[0, 2, 1]])
    xyz = torch.zeros(3, 3)
    torch.testing.assert_close(tfn(zr, xyz), fast_apply(ew, zr, xyz))


def test_flat_decode_rejects_bad_arguments():
    zs = torch.from_numpy(_cube_zs(2, seed=0))
    with pytest.raises(ValueError, match="res % b1"):
        tge.decode_grid_hierarchical3_batch_flat(torch_cube_rows, zs, 60)
    with pytest.raises(ValueError, match="unsupported payload dtype"):
        tge.decode_grid_hierarchical3_batch_flat(torch_cube_rows, zs, 32,
                                                 out_dtype="int4")
