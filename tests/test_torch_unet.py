"""PyTorch port vs the JAX package: the 1-D conv UNet denoiser
(models.denoiser.ConvBlock1D / LatentDenoiserUNet, config 2-unet's
`arch="unet"`), its flax init, its parameter mapping, its stage-2 steps
and its stage-2 pack.

Weights go across by utils.checkpoint.denoiser_params_from_jax (a flax
Conv kernel [k, in, out] is a torch weight [out, in, k]). Tolerances: the
forward to 1e-5 absolute; the nearest upsampling bitwise; three stage-2
steps on the reference's own draws to 1e-6 relative in the loss and 2e-5
absolute in params and EMA (tests/test_torch_train_diff.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule)
from latent_diffusion_models_for_shape_sdfs_tpu.models import (
    denoiser as jden)
from latent_diffusion_models_for_shape_sdfs_tpu.train import (
    diffusion as jtd)
from latent_diffusion_models_for_shape_sdfs_tpu.utils.checkpoint import (
    restore_tree_npz)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models import (
    denoiser as tden)
from latent_diffusion_models_for_shape_sdfs_torch.train import (
    diffusion as ttd)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    denoiser_params_from_jax, denoiser_params_to_jax, load_stage2_pack,
    save_stage2_pack)

torch.set_num_threads(2)

# latent 64 = 32 tokens x 2 channels; base max(32, 64 // 8) = 32, so the
# blocks run 32 / 64 / 128 channels and the up blocks take 192 and 96
DEN = dict(arch="unet", latent_size=64, hidden_dim=64, time_embed_dim=32)
N_CODES = 10


def _noisy(params, seed):
    """Seeded noise on every leaf (flax starts the head at zero, which
    would zero the output and every other gradient)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), params)


def _models(classes=0, seed=0):
    den = dict(DEN, num_classes=classes)
    jm = jden.CondDenoiser(jcfg.DenoiserConfig(**den))
    z = jnp.zeros((2, DEN["latent_size"]))
    t = jnp.zeros((2,), jnp.int32)
    params = _noisy(jm.init(jax.random.PRNGKey(seed), z, t)["params"], seed)
    tm = tden.CondDenoiser(tcfg.DenoiserConfig(**den))
    tm.load_state_dict(denoiser_params_from_jax(params))
    return jm, params, tm


def test_nearest_upsampling_is_jax_resize_bitwise():
    x = np.random.default_rng(0).normal(size=(3, 5, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 10, 8),
                                       "nearest"))             # [B, T, C]
    got = tden.upsample_nearest2(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)
    assert torch.equal(got, torch.from_numpy(x).transpose(1, 2)
                       .repeat_interleave(2, dim=-1))


@pytest.mark.parametrize("in_ch,ch", [(32, 32), (96, 64)])
def test_conv_block_matches_flax(in_ch, ch):
    """One block, with and without the 1x1 skip conv `cs`."""
    rng = np.random.default_rng(in_ch)
    x = rng.normal(size=(4, 16, in_ch)).astype(np.float32)      # [B, T, C]
    cond = rng.normal(size=(4, 48)).astype(np.float32)
    jb = jden.ConvBlock1D(ch)
    params = _noisy(jb.init(jax.random.PRNGKey(1), jnp.asarray(x),
                            jnp.asarray(cond))["params"], 1)
    assert ("cs" in params) == (in_ch != ch)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(cond)))
    tb = tden.ConvBlock1D(in_ch, ch, 48)
    tb.load_state_dict(denoiser_params_from_jax(params))
    with torch.no_grad():
        got = tb(torch.from_numpy(x).transpose(1, 2),
                 torch.from_numpy(cond)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("classes", [0, 5])
def test_unet_forward_matches_flax(classes):
    jm, params, tm = _models(classes)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(6, DEN["latent_size"])).astype(np.float32)
    t = rng.integers(0, 1000, 6).astype(np.int32)
    kw, tkw = {}, {}
    if classes:
        cid = rng.integers(0, classes, 6).astype(np.int32)
        drop = np.array([True, False] * 3)
        kw = {"class_id": jnp.asarray(cid), "cond_drop": jnp.asarray(drop)}
        tkw = {"class_id": torch.from_numpy(cid).long(),
               "cond_drop": torch.from_numpy(drop)}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                               jnp.asarray(t), **kw))
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(t).long(),
                 **tkw).numpy()
    assert isinstance(tm.body, tden.LatentDenoiserUNet)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unet_params_round_trip():
    _, params, tm = _models(5)
    back = denoiser_params_to_jax(tm.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert tm.state_dict()["body.up2.c1.weight"].shape == (64, 192, 3)
    assert tm.state_dict()["body.up2.cs.weight"].shape == (64, 192, 1)
    assert "body.down1.cs.weight" not in tm.state_dict()


def test_unet_flax_init_statistics():
    """flax's init through init_diff_state: Conv kernels lecun-normal over
    fan_in = k x in_channels (truncated at 2 std), zero biases, GroupNorm
    1 / 0, a zero head; each conv kernel's std within 5% of the flax
    init's (both about sqrt(1/fan_in))."""
    cfg = tcfg.DiffConfig(denoiser=tcfg.DenoiserConfig(**DEN))
    st = ttd.init_diff_state(cfg, seed=0, device="cpu")
    jm = jden.CondDenoiser(jcfg.DenoiserConfig(**DEN))
    jp = denoiser_params_from_jax(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64)),
        jnp.zeros((2,), jnp.int32))["params"]))
    sd = st.model.state_dict()
    assert set(sd) == set(jp)
    n_conv = 0
    for m_name, m in st.model.named_modules():
        if isinstance(m, torch.nn.Conv1d) and m_name != "body.head":
            fan_in = m.weight.shape[1] * m.weight.shape[2]
            w = m.weight.detach()
            want = jp[m_name + ".weight"]
            assert abs(float(w.std()) - float(want.std())) < 0.05 * float(
                want.std()) or w.numel() < 2000
            assert float(w.abs().max()) <= 2 * np.sqrt(1 / fan_in) / 0.8796
            assert not m.bias.any()
            n_conv += 1
        elif isinstance(m, torch.nn.GroupNorm):
            assert (m.weight == 1).all() and not m.bias.any()
            assert m.eps == 1e-6
    assert n_conv == 15          # stem, 2 in each of 5 blocks, 4 skips
    assert not st.model.body.head.weight.any()
    assert not st.model.body.head.bias.any()


def _jax_draws(key, n, B, L, T):
    """make_diff_scan's per-step draws (no conditioning), recomputed from
    its keys."""
    out = {"idx": [], "t": [], "eps": []}
    for k in jax.random.split(key, n):
        ki, kt, ke, _, _ = jax.random.split(k, 5)
        out["idx"].append(jax.random.randint(ki, (B,), 0, N_CODES))
        out["t"].append(jax.random.randint(kt, (B,), 0, T))
        out["eps"].append(jax.random.normal(ke, (B, L), jnp.float32))
    out = {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
           for k, v in out.items()}
    out["idx"], out["t"] = out["idx"].long(), out["t"].long()
    return out


def test_three_unet_steps_match_jax_scan():
    """At config 2-unet's lr 1e-4: at 1e-3, Adam's first steps amplify the
    fp32 rounding of the conv kernels' cancelling gradient elements (a few
    1e-8, near Adam's eps) into a 3.7e-6 relative drift of the third
    step's loss, while the forward and each gradient agree to 4e-7 of
    their max. Adam's moments are held to 1e-5 of each tensor's max."""
    kw = dict(timesteps=100, batch_size=8, lr=1e-4, ema_decay=0.9,
              scan_chunk=3)
    jc = jcfg.DiffConfig(denoiser=jcfg.DenoiserConfig(**DEN), **kw)
    tc = tcfg.DiffConfig(denoiser=tcfg.DenoiserConfig(**DEN), **kw)
    jm, params, _ = _models()
    st0 = jtd.DiffTrainState(params, jax.tree.map(jnp.copy, params),
                             optax.adam(jc.lr).init(params),
                             jnp.zeros((), jnp.int32))
    codes = np.random.default_rng(0).normal(
        size=(N_CODES, 64)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    run = jtd.make_diff_scan(jc, jm, JaxSchedule.create(jc.timesteps),
                             N_CODES, jit=False)
    st1, mean_loss = run(st0, jnp.asarray(codes), jnp.zeros(N_CODES, int),
                         jnp.zeros((N_CODES, 1, 3)), jnp.zeros((N_CODES, 1)),
                         key)
    state = ttd.init_diff_state(tc, device="cpu",
                                params=denoiser_params_from_jax(params))
    step = ttd.DiffStep(tc, state, DiffusionSchedule.create(
        tc.timesteps, device="cpu"), torch.from_numpy(codes),
        torch.zeros(N_CODES, dtype=torch.long), torch.zeros(N_CODES, 1, 3),
        torch.zeros(N_CODES, 1))
    loss = step.eager(_jax_draws(key, 3, 8, 64, 100))
    np.testing.assert_allclose(float(loss), float(mean_loss), rtol=1e-6)
    want_p = denoiser_params_from_jax(jax.tree.map(np.asarray, st1.params))
    want_e = denoiser_params_from_jax(jax.tree.map(np.asarray,
                                                   st1.ema_params))
    adam = st1.opt_state[0]
    for tag, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = denoiser_params_from_jax(jax.tree.map(np.asarray, tree))
        for name, p in state.model.named_parameters():
            got = state.optimizer.state[p][tag]
            np.testing.assert_allclose(
                got.numpy(), want[name].numpy(), rtol=0,
                atol=1e-5 * float(want[name].abs().max()), err_msg=name)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(),
                                   want_e[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
    assert state.step == 3


def test_unet_stage2_pack_reads_in_jax(tmp_path):
    """A port-written UNet stage-2 pack restores into the flax template
    through the reference's restore_tree_npz, leaf for leaf."""
    cfg = tcfg.DiffConfig(denoiser=tcfg.DenoiserConfig(**DEN))
    st = ttd.init_diff_state(cfg, seed=1, device="cpu")
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(0.01)
    mu, sigma = torch.randn(64), torch.rand(64) + 0.5
    path = tmp_path / "stage2_pack.npz"
    save_stage2_pack(path, st, mu, sigma)
    jm = jden.CondDenoiser(jcfg.DenoiserConfig(**DEN))
    tmpl_p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)),
                     jnp.zeros((1,), jnp.int32))["params"]
    tree = restore_tree_npz(path, {"params": tmpl_p, "ema_params": tmpl_p,
                                   "mu": jnp.zeros(64),
                                   "sigma": jnp.zeros(64)})
    sd = denoiser_params_from_jax(jax.tree.map(np.asarray, tree["params"]))
    for k, v in st.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    np.testing.assert_array_equal(np.asarray(tree["sigma"]), sigma.numpy())
    p2, e2, _, _ = load_stage2_pack(path)
    assert all(torch.equal(p2[k], v) for k, v in
               st.model.state_dict().items())
