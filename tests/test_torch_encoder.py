"""PyTorch port vs the JAX package: the amortized latent encoder
(models/encoder.py), its trainer (train/encoder.py) with its checkpoints,
the device chair sampler that builds its bank (data/analytic_device.py)
and the pipeline's bank (`_enc_bank`).

Weights go across by utils.checkpoint.encoder_params_from_jax. Tolerances:
the forward to 1e-5 absolute; three training steps on the reference's own
ids/pidx draws to 1e-6 relative in the loss and 2e-5 absolute in the
params (tests/test_torch_train_diff.py's); the schedule to 2e-6 relative
or 4 float32 ulps of the peak rate;
the chair SDF to 1e-6 of JAX's and 1e-5 of the host oracle's; the
sampler, whose streams differ, by exact labels and by each part's size,
and its mean and std against JAX's within 6 standard errors."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import pipeline as jpipe
from latent_diffusion_models_for_shape_sdfs_tpu.data import (
    analytic_jax as jaj)
from latent_diffusion_models_for_shape_sdfs_tpu.data.sdf_dataset import (
    SdfDataset as JaxDataset)
from latent_diffusion_models_for_shape_sdfs_tpu.models import (
    encoder as jenc)
from latent_diffusion_models_for_shape_sdfs_tpu.train import (
    encoder as jtenc)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import pipeline as tpipe
from latent_diffusion_models_for_shape_sdfs_torch.data import (
    analytic, analytic_device as ad)
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.models import (
    encoder as tenc)
from latent_diffusion_models_for_shape_sdfs_torch.train import (
    encoder as ttenc)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    StageCheckpointer, enc_state_tree, encoder_params_from_jax,
    encoder_params_to_jax, restore_enc_state)

torch.set_num_threads(2)

ENC = dict(latent_size=8, point_widths=(16, 32), head_widths=(32,))
S, P, L = 6, 40, 8


def _models(seed=0):
    jm = jenc.LatentEncoder(jcfg.EncoderConfig(**ENC))
    rng = np.random.default_rng(seed)
    # seeded noise on every leaf: flax starts `out` at zero
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(
        size=a.shape)).astype(np.float32), jm.init_params(
            jax.random.PRNGKey(seed)))
    tm = tenc.LatentEncoder(tcfg.EncoderConfig(**ENC))
    tm.load_state_dict(encoder_params_from_jax(params))
    return jm, params, tm


def _obs(B, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            (0.2 * rng.normal(size=(B, N))).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_forward_matches_flax(masked):
    jm, params, tm = _models()
    xyz, sdf = _obs(4, 50)
    mask = None
    if masked:
        mask = np.random.default_rng(1).uniform(size=(4, 50)) < 0.6
        mask[2] = False                           # a fully masked row
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(xyz),
                               jnp.asarray(sdf), None if mask is None
                               else jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(xyz), torch.from_numpy(sdf),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    back = encoder_params_to_jax(tm.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert not tenc.LatentEncoder(tcfg.EncoderConfig(**ENC)).out.weight.any()


def test_encode_latent_matches_jax():
    jm, params, tm = _models(2)
    xyz, sdf = _obs(1, 30, 3)
    mu = np.linspace(-1, 1, L).astype(np.float32)
    sigma = np.linspace(0.5, 2, L).astype(np.float32)
    want = np.asarray(jenc.encode_latent(jm, params, jnp.asarray(xyz[0]),
                                         jnp.asarray(sdf[0]), mu, sigma))
    got = tenc.encode_latent(tm, torch.from_numpy(xyz[0]),
                             torch.from_numpy(sdf[0]), torch.from_numpy(mu),
                             torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("schedule,warmup", [("cosine", 500), ("cosine", 0),
                                             ("constant", 0)])
def test_enc_schedule_matches_optax(schedule, warmup):
    kw = dict(lr=3e-4, lr_schedule=schedule, warmup_steps=warmup,
              num_steps=20000)
    lr = ttenc.make_enc_tx(tcfg.EncConfig(**kw))
    if schedule == "cosine":
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup else 3e-4, peak_value=3e-4,
            warmup_steps=max(warmup, 1), decay_steps=20000,
            end_value=0.05 * 3e-4)
    else:
        want = optax.constant_schedule(3e-4)
    # optax ramps as (init - peak) * (1 - count / steps) + peak in float32,
    # so its early values carry the peak's rounding: 4 float32 ulps of it
    ulp = float(np.finfo(np.float32).eps) * 3e-4
    for step in (0, 1, 250, 499, 500, 501, 7000, 19999, 20000, 25000):
        np.testing.assert_allclose(lr(step), float(want(step)), rtol=2e-6,
                                   atol=4 * ulp, err_msg=str(step))


def _cfgs(**kw):
    base = dict(n_obs=12, batch_scenes=4, num_steps=3, scan_chunk=3,
                lr=1e-3, lr_schedule="cosine", warmup_steps=1, seed=5,
                snapshot_every=2)
    base.update(kw)
    return (jcfg.EncConfig(encoder=jcfg.EncoderConfig(**ENC), **base),
            tcfg.EncConfig(encoder=tcfg.EncoderConfig(**ENC), **base))


def _bank(seed=0):
    xyz, sdf = _obs(S, P, seed)
    codes = np.random.default_rng(seed + 1).normal(
        size=(S, L)).astype(np.float32)
    return codes, xyz, sdf


def test_three_steps_match_jax():
    """train_encoder's scan (cosine warmup: the first update at lr 0) vs
    the port's eager steps on the reference's draws."""
    jc, tc = _cfgs()
    jm, params, _ = _models(4)
    codes, xyz, sdf = _bank()
    tx = jtenc.make_enc_tx(jc)
    st0 = jtenc.EncTrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    _, st1, (jmu, jsig), jloss = jtenc.train_encoder(
        jc, jnp.asarray(codes), xyz, sdf, state=st0)
    key = jax.random.PRNGKey(jc.seed)
    ids, pidx = [], []
    for i in range(3):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        ids.append(np.asarray(jax.random.randint(k1, (4,), 0, S)))
        pidx.append(np.asarray(jax.random.randint(k2, (4, 12), 0, P)))
    draws = {"ids": torch.from_numpy(np.stack(ids)).long(),
             "pidx": torch.from_numpy(np.stack(pidx)).long()}
    state = ttenc.init_enc_state(tc, device="cpu")
    state.model.load_state_dict(encoder_params_from_jax(params))
    codes_n, mu, sigma = ttenc.normalize_codes(torch.from_numpy(codes))
    step = ttenc.EncStep(tc, state, ttenc.make_bank(xyz, sdf, "cpu"),
                         codes_n)
    loss = step.eager(draws)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsig), rtol=1e-6)
    want = encoder_params_from_jax(jax.tree.map(np.asarray, st1.params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg=name)
    assert state.step == int(st1.step) == 3


def test_encoder_resume_is_exact(tmp_path):
    """A run snapshotted at step 6 (snapshots fire on crossing
    snapshot_every 4 with chunks of 3: at 6, 9 and 12), restored into a
    fresh state and trained on to 12 equals the straight run, bit for
    bit, params and Adam's state."""
    _, tc = _cfgs(num_steps=12, scan_chunk=3, snapshot_every=4)
    codes, xyz, sdf = _bank(1)
    ckpt = StageCheckpointer(tmp_path, "encoder")
    straight = ttenc.train_encoder(
        tc, codes, xyz, sdf, device="cpu",
        checkpoint_fn=lambda s, st, mu, sig: ckpt.save(
            s, enc_state_tree(st, mu, sig)))[1]
    assert ckpt.steps() == [6, 9, 12]
    b = ttenc.init_enc_state(tc, seed=9, device="cpu")
    lr = b.optimizer.param_groups[0]["lr"]
    mu, _ = restore_enc_state(b, ckpt.restore(6))
    assert b.step == 6 and b.optimizer.param_groups[0]["lr"] is lr
    assert torch.equal(mu, ttenc.normalize_codes(torch.from_numpy(codes))[1])
    b = ttenc.train_encoder(tc, codes, xyz, sdf, state=b, device="cpu")[1]
    assert b.step == straight.step == 12
    for p, q in zip(straight.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
        sa, sb = straight.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def chairs():
    shapes = analytic.make_synthetic_split("chair", 8, seed=2)
    return shapes, ad.pack_chairs(shapes), jaj.pack_chairs(shapes)


def test_chair_sdf_matches_jax_and_host(chairs):
    shapes, tp, jp = chairs
    pts = np.random.default_rng(0).uniform(-1.1, 1.1, (8, 10_000, 3)) \
        .astype(np.float32)
    got = ad.chair_sdf(tp, torch.from_numpy(pts)).numpy()
    want = np.stack([np.asarray(jaj.chair_sdf(
        jax.tree.map(lambda a: a[i], jp), jnp.asarray(pts[i])))
        for i in range(8)])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    host = np.stack([analytic.sdf(shapes[i], pts[i].astype(np.float64))
                     for i in range(8)])
    np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)


def test_device_sampler_matches_jax_statistics(chairs):
    _, tp, jp = chairs
    n = 4096
    gen = torch.Generator().manual_seed(0)
    xyz, d = ad.sample_sdf_points_device(tp, gen, n)
    assert xyz.shape == (8, n, 3) and d.shape == (8, n)
    assert torch.equal(d, ad.chair_sdf(tp, xyz))            # exact labels
    base = ad._surface_points(tp, torch.Generator().manual_seed(1), 2000)
    assert float(ad.chair_sdf(tp, base).abs().median()) < 1e-4
    jx, _ = jax.vmap(lambda p, k: jaj.sample_sdf_points_device(p, k, n))(
        jp, jax.random.split(jax.random.PRNGKey(0), 8))
    jx = np.asarray(jx)
    n_surf = int(n * 0.95)
    half = n_surf // 2
    parts = [(0, half), (half, n_surf), (n_surf, n)]  # the reference's sizes
    assert [b - a for a, b in parts] == [1945, 1946, 205]
    x = xyz.numpy()
    for a, b in parts:
        for stat in (np.mean, np.std):
            g, w = stat(x[:, a:b], axis=1), stat(jx[:, a:b], axis=1)
            se = np.std(jx[:, a:b], axis=1) / np.sqrt(b - a)
            assert (np.abs(g - w) < 6 * np.sqrt(2) * se).all(), (a, stat)


def test_enc_bank_shapes_on_both_paths():
    kw = {"encoder.n_obs": 16, "ad.num_scenes": 3, "encoder.seed": 4}
    cfg = tcfg.override(tcfg.ExperimentConfig(data_source="analytic:chair"),
                        **kw)
    x, d = tpipe._enc_bank(cfg, None, device="cpu")
    assert isinstance(x, torch.Tensor) and x.shape == (3, 64, 3)
    assert d.shape == (3, 64)
    shapes = analytic.make_synthetic_split("chair", 3, seed=cfg.ad.seed)
    assert torch.equal(d, ad.chair_sdf(ad.pack_chairs(shapes), x))
    x2, _ = tpipe._enc_bank(cfg, None, device="cpu")
    assert torch.equal(x, x2)                    # keyed by (seed, tag, start)
    cfg = tcfg.override(cfg, data_source="analytic:sphere",
                        **{"encoder.obs_bank_points": 40})
    jc = jcfg.override(jcfg.ExperimentConfig(data_source="analytic:sphere"),
                       **kw, **{"encoder.obs_bank_points": 40})
    shapes = analytic.make_synthetic_split("sphere", 3)
    x, d = tpipe._enc_bank(cfg, SdfDataset.from_analytic(shapes, 500,
                                                         workers=1))
    jx, jd = jpipe._enc_bank(jc, JaxDataset.from_analytic(shapes, 500,
                                                          workers=1))
    assert isinstance(x, np.ndarray) and x.shape == (3, 40, 3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(d, jd)
