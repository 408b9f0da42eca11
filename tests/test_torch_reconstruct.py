"""PyTorch port vs the JAX package: test-time latent optimisation
(reconstruct.py), MAP with restarts, the lr drop, the warm start, the
score-distillation prior and the batched form.

A small decoder (4 layers x 64, L 16, latent_in (2,)) carries the
reference's random init into the port (utils.checkpoint.params_from_jax);
the port is fed the reference's own z0 and prior draws, recomputed from
its keys. Tolerances: z to 1e-5 of max|z| and the loss values to 1e-6
relative after 20 steps (fp32 sums in another order; Adam divides by the
root of the second moment, so rounding of a small gradient moves its
update more than the gradient's own error)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import reconstruct as jrec
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule)
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import reconstruct as trec
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    params_from_jax)

torch.set_num_threads(2)

DEC = dict(latent_size=16, hidden_dim=64, num_layers=4, latent_in=(2,),
           use_dropout=False)
L, N, T = 16, 256, 100
# clamp 1.0 keeps the random decoder's data gradient alive; sigma 1 makes
# the prior term count
REC = dict(num_steps=20, lr_decay_at=10, clamp_dist=1.0, code_reg_sigma=1.0,
           seed=3)


@pytest.fixture(scope="module")
def decoders():
    jdec = JaxDecoder(jcfg.DecoderConfig(**DEC))
    params = jax.tree.map(np.asarray, jdec.init_params(
        jax.random.PRNGKey(0)))
    tdec = SdfDecoder(tcfg.DecoderConfig(**DEC))
    tdec.load_state_dict(params_from_jax(params))
    return jdec, params, tdec


def _obs(seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (N,) if batch is None else (batch, N)
    xyz = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    c = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    sdf = (np.linalg.norm(xyz - c, axis=-1) - 0.5).astype(np.float32)
    return xyz, sdf


def _cfgs(**kw):
    kw = dict(REC, **kw)
    return jcfg.ReconstructConfig(**kw), tcfg.ReconstructConfig(**kw)


def _z0(jc, k):
    return jc.init_std * jax.random.normal(jax.random.PRNGKey(jc.seed),
                                           (k, L), jnp.float32)


def _sds_draws(jc, k, anneal, t_lo=0.02, t_hi=0.98):
    """The reference's per-step prior draws, recomputed from its keys."""
    sds_key = jax.random.fold_in(jax.random.PRNGKey(jc.seed), 0x5D5)
    eps, ts = [], []
    for step in range(jc.num_steps):
        ks = jax.random.fold_in(sds_key, step)
        tf = jax.random.uniform(jax.random.fold_in(ks, 1), minval=t_lo,
                                maxval=t_hi)
        ts.append(int(jnp.clip((tf * T).astype(jnp.int32), 0, T - 1)))
        eps.append(np.asarray(jax.random.normal(jax.random.fold_in(ks, 2),
                                                (k, L), jnp.float32)))
    out = {"eps": torch.from_numpy(np.stack(eps))}
    if not anneal:
        out["t"] = torch.tensor(ts)
    return out


def _check(z, info, jz, jinfo):
    jz = np.asarray(jz)
    np.testing.assert_allclose(z.numpy(), jz, rtol=0,
                               atol=1e-5 * np.abs(jz).max())
    for key in ("loss_first", "loss_last", "l1_last"):
        np.testing.assert_allclose(info[key], jinfo[key], rtol=1e-6)
    assert info["steps"] == jinfo["steps"]
    assert info["num_inits"] == jinfo["num_inits"]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("decay_at", [10, 400])
def test_map_matches_jax(decoders, k, decay_at):
    """20 MAP steps with k restarts, with and without the lr drop: the
    same z (the same restart chosen) and loss values."""
    jdec, params, tdec = decoders
    jc, tc = _cfgs(num_inits=k, lr_decay_at=decay_at)
    xyz, sdf = _obs()
    jz, jinfo = jrec.reconstruct_latent(jdec, params, jnp.asarray(xyz),
                                        jnp.asarray(sdf), jc)
    z, info = trec.reconstruct_latent(
        tdec, xyz, sdf, tc, draws={"z0": torch.from_numpy(
            np.array(_z0(jc, k)))})
    _check(z, info, jz, jinfo)
    assert info["loss_hist"][0] == info["loss_first"]
    assert info["l1_hist"][-1] == info["l1_last"]


def test_lr_drops_tenfold_at_lr_decay_at(decoders):
    _, _, tdec = decoders
    _, tc = _cfgs(lr=4e-3, lr_decay_at=7)
    opt = trec.LatentOpt(tdec, tc, 1, N)
    lr = opt.lr.numpy()
    assert (lr[:7] == np.float32(4e-3)).all()
    assert (lr[7:] == np.float32(4e-4)).all() and len(lr) == 20
    with pytest.raises(RuntimeError, match="load"):
        opt.eager()            # a run needs its draws loaded first


def test_warm_start_matches_jax(decoders):
    """z_init: restart 0 starts exactly there, the others jittered."""
    jdec, params, tdec = decoders
    jc, tc = _cfgs(num_inits=3)
    xyz, sdf = _obs(1)
    z_init = np.random.default_rng(5).normal(size=L).astype(np.float32) * .3
    jz, jinfo = jrec.reconstruct_latent(jdec, params, jnp.asarray(xyz),
                                        jnp.asarray(sdf), jc,
                                        z_init=jnp.asarray(z_init))
    draws = {"z0": torch.from_numpy(np.array(_z0(jc, 3)))}
    z, info = trec.reconstruct_latent(tdec, xyz, sdf, tc, draws=draws,
                                      z_init=torch.from_numpy(z_init))
    _check(z, info, jz, jinfo)
    opt = trec.LatentOpt(tdec, dataclasses.replace(tc, num_steps=0), 3, N)
    opt.load(xyz, sdf, draws, z_init=torch.from_numpy(z_init))
    assert torch.equal(opt.z[0], torch.from_numpy(z_init))
    assert torch.equal(opt.z[1], torch.from_numpy(z_init) + draws["z0"][1])


def _gauss(alpha_bars, s2, xp):
    """The exact eps-predictor of N(0, s2) codes: sqrt(1-ab) z_t /
    (ab s2 + 1 - ab)."""
    def fn(z_t, t):
        ab = alpha_bars[t][:, None]
        return xp.sqrt(1.0 - ab) * z_t / (ab * s2 + 1.0 - ab)
    return fn


@pytest.mark.parametrize("anneal", [True, False])
def test_diffusion_prior_matches_jax(decoders, anneal):
    """SDS with a fixed Gaussian denoiser at weight 0.05, k = 2."""
    jdec, params, tdec = decoders
    jc, tc = _cfgs(num_inits=2)
    xyz, sdf = _obs(2)
    rng = np.random.default_rng(9)
    mu = (0.1 * rng.normal(size=L)).astype(np.float32)
    sigma = rng.uniform(0.05, 0.2, L).astype(np.float32)
    jsched = JaxSchedule.create(T)
    tsched = DiffusionSchedule.create(T, device="cpu")
    jz, jinfo = jrec.reconstruct_latent_diffusion_prior(
        jdec, params, jnp.asarray(xyz), jnp.asarray(sdf),
        _gauss(jsched.alpha_bars, 0.5, jnp), jsched, jnp.asarray(mu),
        jnp.asarray(sigma), jc, sds_weight=0.05, anneal=anneal)
    draws = {"z0": torch.from_numpy(np.array(_z0(jc, 2))),
             **_sds_draws(jc, 2, anneal)}
    z, info = trec.reconstruct_latent_diffusion_prior(
        tdec, xyz, sdf, _gauss(tsched.alpha_bars, 0.5, torch), tsched,
        torch.from_numpy(mu), torch.from_numpy(sigma), tc, sds_weight=0.05,
        anneal=anneal, draws=draws)
    _check(z, info, jz, jinfo)
    assert info["sds_weight"] == jinfo["sds_weight"] == 0.05


def test_annealed_timesteps_match_jax():
    """The annealed prior's t per step: the reference's float32 sweep."""
    S = 800
    frac = jnp.arange(S).astype(jnp.float32) / max(S - 1, 1)
    tf = 0.98 + (0.02 - 0.98) * frac
    want = np.asarray(jnp.clip((tf * 1000).astype(jnp.int32), 0, 999))
    np.testing.assert_array_equal(trec.sds_timesteps(S, 1000, 0.02, 0.98),
                                  want)


def test_diffusion_prior_at_weight_zero_is_map(decoders):
    """sds_weight 0 gives the MAP run bit for bit (same z0 stream)."""
    _, _, tdec = decoders
    _, tc = _cfgs(num_inits=2)
    xyz, sdf = _obs(3)
    sched = DiffusionSchedule.create(T, device="cpu")
    z0, i0 = trec.reconstruct_latent_diffusion_prior(
        tdec, xyz, sdf, _gauss(sched.alpha_bars, 0.5, torch), sched,
        torch.zeros(L), torch.ones(L), tc, sds_weight=0.0)
    z1, i1 = trec.reconstruct_latent(tdec, xyz, sdf, tc)
    assert torch.equal(z0, z1)
    np.testing.assert_array_equal(i0["loss_hist"], i1["loss_hist"])
    np.testing.assert_array_equal(i0["l1_hist"], i1["l1_hist"])


def test_batch_matches_jax(decoders):
    jdec, params, tdec = decoders
    jc, tc = _cfgs()
    xyz, sdf = _obs(4, batch=3)
    jz = jrec.reconstruct_latent_batch(jdec, params, jnp.asarray(xyz),
                                       jnp.asarray(sdf), jc)
    z = trec.reconstruct_latent_batch(
        tdec, xyz, sdf, tc,
        draws={"z0": torch.from_numpy(np.array(_z0(jc, 3)))})
    jz = np.asarray(jz)
    assert z.shape == (3, L)
    np.testing.assert_allclose(z.numpy(), jz, rtol=0,
                               atol=1e-5 * np.abs(jz).max())


def test_cache_reuses_the_step(decoders):
    """With a cache, runs of the same (k, n, cfg) and prior dict share one
    LatentOpt and give what a fresh one gives."""
    _, _, tdec = decoders
    _, tc = _cfgs(num_steps=5)
    cache: dict = {}
    xyz, sdf = _obs(5)
    a, _ = trec.reconstruct_latent(tdec, xyz, sdf, tc, cache=cache)
    b, _ = trec.reconstruct_latent(tdec, xyz, sdf, tc, cache=cache)
    c, _ = trec.reconstruct_latent(tdec, xyz[:100], sdf[:100], tc,
                                   cache=cache)
    assert len(cache) == 2 and torch.equal(a, b)
    assert torch.equal(c, trec.reconstruct_latent(tdec, xyz[:100],
                                                  sdf[:100], tc)[0])
    # the decoder is frozen only while a step runs: its flags and mode are
    # as they were, and no weight gradient was built
    assert all(p.requires_grad and p.grad is None
               for p in tdec.parameters())
    assert tdec.training
    sched = DiffusionSchedule.create(T, device="cpu")
    sp = {"denoise_fn": _gauss(sched.alpha_bars, 0.5, torch),
          "sched": sched, "mu": torch.zeros(L), "sigma": torch.ones(L),
          "weight": 0.05, "t_lo": 0.02, "t_hi": 0.98, "anneal": True}
    d, _ = trec.reconstruct_latent(tdec, xyz, sdf, tc, sds_prior=sp,
                                   cache=cache)
    e, _ = trec.reconstruct_latent(tdec, xyz, sdf, tc, sds_prior=sp,
                                   cache=cache)
    assert len(cache) == 3 and torch.equal(d, e) and not torch.equal(a, d)
    trec.reconstruct_latent(tdec, xyz, sdf, tc, sds_prior=dict(sp),
                            cache=cache)
    assert len(cache) == 4                        # another prior dict


def test_cache_keeps_the_latest_sizes(decoders):
    """The cache holds CACHE_SIZE steps: a new size evicts the least
    recently used one, and a hit makes its entry the latest."""
    _, _, tdec = decoders
    _, tc = _cfgs(num_steps=2)
    xyz, sdf = _obs(6)
    cache: dict = {}
    sizes = [100 + 10 * i for i in range(trec.CACHE_SIZE)]
    for n in sizes:
        trec.reconstruct_latent(tdec, xyz[:n], sdf[:n], tc, cache=cache)
    first = cache[(1, sizes[0], tc, None)]
    trec.reconstruct_latent(tdec, xyz[:sizes[0]], sdf[:sizes[0]], tc,
                            cache=cache)
    assert [key[1] for key in cache] == sizes[1:] + sizes[:1]
    trec.reconstruct_latent(tdec, xyz[:50], sdf[:50], tc, cache=cache)
    assert len(cache) == trec.CACHE_SIZE
    assert [key[1] for key in cache] == sizes[2:] + sizes[:1] + [50]
    assert cache[(1, sizes[0], tc, None)] is first
