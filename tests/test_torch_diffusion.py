"""PyTorch port vs the JAX package: stage-2 sampling (diffusion.schedule,
diffusion.sampler, models.denoiser, train.diffusion's code normalization,
utils.checkpoint's denoiser converters, serve.generate_meshes).

The denoiser's weights are flax's init, perturbed by seeded noise (flax
starts `out_proj` at zero, which would make every comparison 0), carried
to the port by denoiser_params_from_jax. Tolerances: 1e-5 absolute for
the denoiser (flax's LayerNorm takes the variance as E[x^2] - E[x]^2,
torch's in two passes), 1e-4 for latents after 50 DDIM and 10 DPM steps
from the same z_T."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion import (
    sampler as jsampler)
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule)
from latent_diffusion_models_for_shape_sdfs_tpu.models import (
    denoiser as jden)
from latent_diffusion_models_for_shape_sdfs_tpu.train import (
    diffusion as jtrain)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import serve as tserve
from latent_diffusion_models_for_shape_sdfs_torch.diffusion import sampler
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models import denoiser
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply)
from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
    normalize_codes, unnormalize_codes)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    denoiser_params_from_jax, denoiser_params_to_jax, load_stage1_pack)

torch.set_num_threads(2)

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "multicat6k" / "stage1_pack.npz")

# config 4's denoiser at test width: every conditioning path on
DEN = dict(arch="mlp", latent_size=16, hidden_dim=64, num_blocks=2,
           time_embed_dim=32, num_classes=5, partial_sdf_cond=True,
           partial_points=24)


def _models(seed=0, **over):
    """(flax model, its params with seeded noise on every leaf, the port's
    CondDenoiser carrying the same weights)."""
    kw = dict(DEN, **over)
    jm = jden.CondDenoiser(jcfg.DenoiserConfig(**kw))
    B, L = 2, kw["latent_size"]
    params = jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((B, L)), jnp.zeros((B,), jnp.int32),
        class_id=jnp.zeros((B,), jnp.int32),
        obs_xyz=jnp.zeros((B, kw["partial_points"], 3)),
        obs_sdf=jnp.zeros((B, kw["partial_points"])))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), params)
    tm = denoiser.CondDenoiser(tcfg.DenoiserConfig(**kw))
    tm.load_state_dict(denoiser_params_from_jax(params))
    return jm, params, tm


def _inputs(B=6, L=16, P=24, seed=1):
    rng = np.random.default_rng(seed)
    return dict(z=rng.normal(size=(B, L)).astype(np.float32),
                t=rng.integers(0, 1000, B).astype(np.int32),
                cid=rng.integers(0, 5, B).astype(np.int32),
                xyz=rng.uniform(-1, 1, (B, P, 3)).astype(np.float32),
                sdf=(0.1 * rng.normal(size=(B, P))).astype(np.float32),
                mask=rng.random((B, P)) < 0.7,
                drop=np.asarray([True, False] * (B // 2)))


@pytest.mark.parametrize("T, lo, hi", [(1000, 1e-4, 0.02), (100, 1e-4, 0.02),
                                       (1000, 1e-4, 0.03), (7, 1e-3, 0.2)])
def test_schedule_matches_jax(T, lo, hi):
    j = JaxSchedule.create(T, lo, hi)
    t = DiffusionSchedule.create(T, lo, hi, device="cpu")
    assert t.timesteps == T
    for k in j._fields:
        got = getattr(t, k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
    rng = np.random.default_rng(T)
    z0 = rng.normal(size=(5, 4)).astype(np.float32)
    eps = rng.normal(size=(5, 4)).astype(np.float32)
    ts = rng.integers(0, T, 5).astype(np.int32)
    zt = t.q_sample(torch.from_numpy(z0), torch.from_numpy(ts).long(),
                    torch.from_numpy(eps))
    np.testing.assert_allclose(zt.numpy(), np.asarray(j.q_sample(
        jnp.asarray(z0), jnp.asarray(ts), jnp.asarray(eps))), rtol=1e-5,
        atol=1e-6)
    back = t.predict_z0(zt, torch.from_numpy(ts).long(), torch.from_numpy(eps))
    np.testing.assert_allclose(back.numpy(), z0, atol=2e-4)


def test_schedule_needs_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionSchedule.create(10)


@pytest.mark.parametrize("dim", [32, 128, 33])
def test_sinusoidal_time_embed_matches_jax(dim):
    """To 1e-5, plus what one float32 ulp of a frequency (XLA's exp and
    torch's round differently) moves an argument t * freq by: up to 1.2e-4
    rad at t = 999."""
    t = np.asarray([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jden.sinusoidal_time_embed(jnp.asarray(t), dim))
    got = denoiser.sinusoidal_time_embed(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (5, dim)
    assert (np.abs(got - want) <= 1e-5 + t[:, None] * 2 ** -23).all()


@pytest.mark.parametrize("masked", [False, True])
def test_partial_sdf_encoder_matches_jax(masked):
    """Max over the points (masked points excluded; a row with no point
    left gives 0, through the -inf mask and the finite-or-0 step)."""
    jm, params, tm = _models()
    x = _inputs()
    mask = x["mask"].copy()
    mask[1] = False                                    # an empty set
    pe = params["partial_enc"]
    want = np.asarray(jden.PartialSdfEncoder().apply(
        {"params": pe}, jnp.asarray(x["xyz"]), jnp.asarray(x["sdf"]),
        jnp.asarray(mask) if masked else None))
    got = tm.partial_enc(torch.from_numpy(x["xyz"]),
                         torch.from_numpy(x["sdf"]),
                         torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    if masked:
        assert not got[1].any()


CASES = {
    "class": dict(class_id=True),
    "null class": dict(),
    "class + obs": dict(class_id=True, obs=True),
    "class + masked obs + cond_drop": dict(class_id=True, obs=True,
                                           mask=True, drop=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cond_denoiser_matches_jax(case):
    c = CASES[case]
    jm, params, tm = _models()
    x = _inputs()
    jkw, tkw = {}, {}
    if c.get("class_id"):
        jkw["class_id"], tkw["class_id"] = jnp.asarray(x["cid"]), \
            torch.from_numpy(x["cid"])
    if c.get("obs"):
        jkw.update(obs_xyz=jnp.asarray(x["xyz"]), obs_sdf=jnp.asarray(x["sdf"]))
        tkw.update(obs_xyz=torch.from_numpy(x["xyz"]),
                   obs_sdf=torch.from_numpy(x["sdf"]))
    if c.get("mask"):
        jkw["obs_mask"], tkw["obs_mask"] = jnp.asarray(x["mask"]), \
            torch.from_numpy(x["mask"])
    if c.get("drop"):
        jkw["cond_drop"], tkw["cond_drop"] = jnp.asarray(x["drop"]), \
            torch.from_numpy(x["drop"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x["z"]),
                               jnp.asarray(x["t"]), **jkw))
    with torch.no_grad():
        got = tm(torch.from_numpy(x["z"]), torch.from_numpy(x["t"]),
                 **tkw).numpy()
    assert np.abs(want).max() > 0.1              # out_proj is not zero
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_denoiser_params_round_trip_and_init():
    jm, params, tm = _models()
    back = denoiser_params_to_jax(tm.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    fresh = denoiser.CondDenoiser(tcfg.DenoiserConfig(**DEN))
    assert not fresh.body.out_proj.weight.any()         # flax's zero init
    assert fresh.body.block0.ln.eps == 1e-6
    unet = denoiser.CondDenoiser(tcfg.DenoiserConfig(arch="unet"))
    assert isinstance(unet.body, denoiser.LatentDenoiserUNet)
    assert not unet.body.head.weight.any() and not unet.body.head.bias.any()
    assert isinstance(denoiser.make_denoiser(tcfg.DenoiserConfig()),
                      denoiser.LatentDenoiserMLP)


def test_normalize_codes_matches_jax():
    codes = np.random.default_rng(3).normal(0.2, 0.7, (300, 16)).astype(
        np.float32)
    codes[:, 5] = 1.0                                  # sigma floored at eps
    jn, jmu, jsig = jtrain.normalize_codes(jnp.asarray(codes))
    tn, tmu, tsig = normalize_codes(torch.from_numpy(codes))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-7)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(unnormalize_codes(tn, tmu, tsig).numpy(),
                               codes, atol=1e-5)


def _guided(jm, params, tm, x, scale):
    """The CFG-guided denoise functions of both packages (class and
    observations), the unconditional branch dropping only the class."""
    jfn = jsampler.guided_denoise_fn(
        jm.apply, params, scale, class_id=jnp.asarray(x["cid"]),
        obs_xyz=jnp.asarray(x["xyz"]), obs_sdf=jnp.asarray(x["sdf"]))
    tfn = sampler.guided_denoise_fn(
        tm, scale, class_id=torch.from_numpy(x["cid"]),
        obs_xyz=torch.from_numpy(x["xyz"]), obs_sdf=torch.from_numpy(x["sdf"]),
        obs_mask=None)
    return jfn, tfn


def test_guided_denoise_fn_matches_jax():
    jm, params, tm = _models()
    x = _inputs()
    zt, t = jnp.asarray(x["z"]), jnp.asarray(x["t"])
    for scale in (0.0, 2.0):
        jfn, tfn = _guided(jm, params, tm, x, scale)
        with torch.no_grad():
            got = tfn(torch.from_numpy(x["z"]), torch.from_numpy(x["t"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(zt, t)),
                                   atol=3e-5, rtol=0)
    # CFG: (1+s) eps_c - s eps_u, eps_u with the null class, same obs
    with torch.no_grad():
        zz, tt = torch.from_numpy(x["z"]), torch.from_numpy(x["t"])
        kw = dict(obs_xyz=torch.from_numpy(x["xyz"]),
                  obs_sdf=torch.from_numpy(x["sdf"]))
        e_c = tm(zz, tt, class_id=torch.from_numpy(x["cid"]), **kw)
        e_u = tm(zz, tt, class_id=None, **kw)
        torch.testing.assert_close(_guided(jm, params, tm, x, 2.0)[1](zz, tt),
                                   3.0 * e_c - 2.0 * e_u)


@pytest.mark.parametrize("name, steps", [("ddim", 50), ("dpm", 10)])
def test_samplers_match_jax_from_same_z_init(name, steps):
    """Config 4's sampling (CFG 2.0 over class + observations) from the
    same z_T: latents equal JAX's to 1e-4. The guided random network rides
    on the exact denoiser of N(0, I) data, so the latents stay O(1) (the
    network alone drives them to O(100), where 1e-4 is under an ulp)."""
    jm, params, tm = _models()
    x = _inputs(B=6)
    jg, tg = _guided(jm, params, tm, x, 2.0)
    ja = JaxSchedule.create(1000).alpha_bars
    ta = DiffusionSchedule.create(1000, device="cpu").alpha_bars

    def jfn(z, t):
        a = ja[t][:, None]
        return jnp.sqrt(1 - a) * z + 0.2 * jg(z, t)

    def tfn(z, t):
        a = ta[t.long()][:, None]
        return torch.sqrt(1 - a) * z + 0.2 * tg(z, t)
    z_init = np.random.default_rng(9).normal(size=(6, 16)).astype(np.float32)
    jsched = JaxSchedule.create(1000)
    tsched = DiffusionSchedule.create(1000, device="cpu")
    jf = {"ddim": jsampler.ddim_sample, "dpm": jsampler.dpm_solver_sample}[name]
    tf = {"ddim": sampler.ddim_sample, "dpm": sampler.dpm_solver_sample}[name]
    want = np.asarray(jf(jfn, jsched, jax.random.PRNGKey(0), 6, 16,
                         steps=steps, z_init=jnp.asarray(z_init)))
    got = tf(tfn, tsched, torch.Generator().manual_seed(0), 6, 16,
             steps=steps, z_init=torch.from_numpy(z_init)).numpy()
    assert np.isfinite(want).all() and 0.5 < np.abs(want).max() < 10
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_ddim_timesteps_match_jax():
    for T, steps in ((1000, 50), (1000, 10), (100, 7)):
        np.testing.assert_array_equal(
            sampler.ddim_timesteps(T, steps).numpy(),
            np.asarray(jsampler.ddim_timesteps(T, steps)))


def _gaussian_eps(schedule, s2):
    """Exact eps-predictor for data ~ N(0, s2 I) (tests/test_dpm_solver.py):
    sqrt(1-abar) z / (abar s2 + 1 - abar)."""
    abar = schedule.alpha_bars

    def fn(z, t):
        a = abar[t.long()][:, None]
        return torch.sqrt(1 - a) * z / (a * s2 + 1 - a)

    return fn


def _run_sampler(name, fn, sched, rng, num, L):
    """One of the four samplers; `rng` a torch.Generator or a JAX key."""
    mod = sampler if isinstance(rng, torch.Generator) else jsampler
    if name == "ddpm":
        return mod.ddpm_sample(fn, sched, rng, num, L)
    if name == "dpm":
        return mod.dpm_solver_sample(fn, sched, rng, num, L, steps=10)
    return mod.ddim_sample(fn, sched, rng, num, L, steps=50,
                           eta=1.0 if name == "ddim_eta1" else 0.0)


@pytest.mark.parametrize("name", ["ddpm", "ddim_eta1", "ddim", "dpm"])
def test_samplers_deterministic_per_generator_seed(name):
    s = DiffusionSchedule.create(100, device="cpu")
    fn = _gaussian_eps(s, 0.25)
    a, b, c = (_run_sampler(name, fn, s, torch.Generator().manual_seed(k),
                            64, 4) for k in (5, 5, 6))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == (64, 4) and torch.isfinite(a).all()


@pytest.mark.parametrize("name", ["ddpm", "ddim_eta1"])
def test_random_samplers_distributed_like_jax(name):
    """The noise streams differ (torch.Generator vs JAX key), so the
    random samplers are held to JAX in distribution: with the exact
    denoiser of N(0, 0.25 I) data, 4,096 latents of each package have the
    same per-dimension mean and std within 0.03 (about 4 standard errors
    of the difference; DDIM with eta 1 at 50 steps lands near 0.445, not
    0.5, in both: its discretization)."""
    T, s2, num = 1000, 0.25, 4096
    ts = DiffusionSchedule.create(T, device="cpu")
    js = JaxSchedule.create(T)
    got = _run_sampler(name, _gaussian_eps(ts, s2), ts,
                       torch.Generator().manual_seed(1), num, 4).numpy()
    ja = js.alpha_bars

    def jfn(z, t):
        a = ja[t][:, None]
        return jnp.sqrt(1 - a) * z / (a * s2 + 1 - a)

    want = np.asarray(_run_sampler(name, jfn, js, jax.random.PRNGKey(1),
                                   num, 4))
    assert np.abs(got.mean(0) - want.mean(0)).max() < 0.03
    assert np.abs(got.std(0) - want.std(0)).max() < 0.03
    if name == "ddpm":
        assert np.abs(got.std(0) - 0.5).max() < 0.03


def test_generate_meshes_through_serving_path_on_cpu():
    """Sample, un-normalize with the multicat codes' moments, serve: two
    meshes through serve_meshes (the decoder-eval wrapper's plain path on
    the CPU), deterministic per generator seed."""
    sd, codes = load_stage1_pack(PACK)
    apply = make_kernel_apply(SdfDecoder(tcfg.DecoderConfig()), sd,
                              device="cpu")
    _, mu, sigma = normalize_codes(torch.from_numpy(codes))
    sched = DiffusionSchedule.create(1000, device="cpu")
    fn = _gaussian_eps(sched, 1.0)

    def gen(seed):
        return list(tserve.generate_meshes(
            apply, fn, sched, torch.Generator().manual_seed(seed), 2, 256,
            mu=mu, sigma=sigma, steps=10, res=32, sampler="dpm",
            mesh_workers=1))

    out, again = gen(3), gen(3)
    assert len(out) == 2
    for (v, f, st), (v2, f2, _) in zip(out, again):
        assert len(f) > 0 and np.isfinite(v).all()
        np.testing.assert_array_equal(v, v2)
        assert not st["capacity_exceeded"]
