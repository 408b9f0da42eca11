"""PyTorch port vs the JAX package: stage-2 training (train.diffusion),
full-state checkpoints with resume (utils.checkpoint.StageCheckpointer)
and the stage-2 pack.

The step is held against the reference's `make_diff_scan(..., jit=False)`
on JAX's own per-step draws, recomputed from its keys and injected into
the port, for a config with classes, partial-SDF conditioning and a bank
wider than partial_points. Tolerances: the mean loss to 1e-6 relative;
Adam's moments to 1e-5 of each tensor's largest magnitude; params and EMA
to 2e-5 absolute, 2% of one Adam step at lr 1e-3 (Adam divides by the
root of the second moment, so fp32 rounding of a small gradient moves its
update more than the gradient's own error)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule)
from latent_diffusion_models_for_shape_sdfs_tpu.models.denoiser import (
    CondDenoiser as JaxDenoiser)
from latent_diffusion_models_for_shape_sdfs_tpu.train import (
    diffusion as jtd)
from latent_diffusion_models_for_shape_sdfs_tpu.utils.checkpoint import (
    restore_tree_npz)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.train import (
    auto_decoder as tad)
from latent_diffusion_models_for_shape_sdfs_torch.train import (
    diffusion as ttd)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    StageCheckpointer, ad_state_tree, denoiser_params_from_jax,
    diff_state_tree, load_stage2_pack, restore_ad_state, restore_diff_state,
    save_stage2_pack)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger)

torch.set_num_threads(2)

DEN = dict(latent_size=16, hidden_dim=64, num_blocks=2, time_embed_dim=32,
           num_classes=5, partial_sdf_cond=True, partial_points=24,
           cond_drop_prob=0.3)
DIFF = dict(timesteps=100, batch_size=8, lr=1e-3, ema_decay=0.9,
            scan_chunk=3)
N_CODES, BANK = 10, 64


def _cfgs(den=None, **kw):
    den = dict(DEN, **(den or {}))
    diff = dict(DIFF, **kw)
    return (jcfg.DiffConfig(denoiser=jcfg.DenoiserConfig(**den), **diff),
            tcfg.DiffConfig(denoiser=tcfg.DenoiserConfig(**den), **diff))


def _banks(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_CODES, 16)).astype(np.float32),
            rng.integers(0, 5, N_CODES).astype(np.int32),
            rng.uniform(-1, 1, (N_CODES, BANK, 3)).astype(np.float32),
            (0.1 * rng.normal(size=(N_CODES, BANK))).astype(np.float32))


def _jax_state(jc, seed=0):
    """The reference's init, with seeded noise on every leaf (flax starts
    out_proj at zero, which would zero every other gradient)."""
    model = JaxDenoiser(jc.denoiser)
    st = jtd.init_diff_state(jc, model, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), st.params)
    return model, jtd.DiffTrainState(
        params, jax.tree.map(jnp.copy, params),
        optax.adam(jc.lr).init(params), jnp.zeros((), jnp.int32))


def _jax_draws(key, n, B, L, T, p, P):
    """make_diff_scan's per-step draws, recomputed from its keys."""
    out = {k: [] for k in ("idx", "t", "eps", "drop", "cols")}
    for k in jax.random.split(key, n):
        ki, kt, ke, kd, ko = jax.random.split(k, 5)
        out["idx"].append(jax.random.randint(ki, (B,), 0, N_CODES))
        out["t"].append(jax.random.randint(kt, (B,), 0, T))
        out["eps"].append(jax.random.normal(ke, (B, L), jnp.float32))
        out["drop"].append(jax.random.bernoulli(kd, p, (B,)))
        out["cols"].append(jax.random.randint(ko, (B, P), 0, BANK))
    out = {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
           for k, v in out.items()}
    for k in ("idx", "t", "cols"):
        out[k] = out[k].long()
    return out


def _port_step(tc, state, banks):
    codes, cids, oxyz, osdf = banks
    return ttd.DiffStep(tc, state, DiffusionSchedule.create(
        tc.timesteps, tc.beta_start, tc.beta_end, device="cpu"),
        torch.from_numpy(codes), torch.from_numpy(cids).long(),
        torch.from_numpy(oxyz), torch.from_numpy(osdf))


def _sd(tree):
    return denoiser_params_from_jax(jax.tree.map(np.asarray, tree))


def test_three_steps_match_jax_scan():
    jc, tc = _cfgs()
    model, st0 = _jax_state(jc)
    banks = _banks()
    key = jax.random.PRNGKey(7)
    run = jtd.make_diff_scan(jc, model, JaxSchedule.create(jc.timesteps),
                             N_CODES, jit=False)
    st1, mean_loss = run(st0, *(jnp.asarray(b) for b in banks), key)
    draws = _jax_draws(key, 3, jc.batch_size, 16, jc.timesteps,
                       DEN["cond_drop_prob"], DEN["partial_points"])
    state = ttd.init_diff_state(tc, device="cpu", params=_sd(st0.params))
    loss = _port_step(tc, state, banks).eager(draws)
    assert state.step == 3 and int(st1.step) == 3
    np.testing.assert_allclose(float(loss), float(mean_loss), rtol=1e-6)
    adam = st1.opt_state[0]
    want = {"p": _sd(st1.params), "ema": _sd(st1.ema_params),
            "mu": _sd(adam.mu), "nu": _sd(adam.nu)}
    for name, p in state.model.named_parameters():
        s = state.optimizer.state[p]
        assert int(s["step"]) == int(adam.count) == 3
        for tag, got in [("p", p.detach()), ("ema", state.ema[name]),
                         ("mu", s["exp_avg"]), ("nu", s["exp_avg_sq"])]:
            w = want[tag][name]
            tol = (2e-5 if tag in ("p", "ema")
                   else 1e-5 * float(w.abs().max()))
            torch.testing.assert_close(got, w, atol=tol, rtol=0,
                                       msg=f"{tag} {name}")


def test_step_without_conditioning_matches_jax():
    """The unconditional body (no drop, class or observation draws)."""
    jc, tc = _cfgs(den=dict(num_classes=0, partial_sdf_cond=False))
    model, st0 = _jax_state(jc, seed=3)
    banks = _banks(1)
    key = jax.random.PRNGKey(2)
    run = jtd.make_diff_scan(jc, model, JaxSchedule.create(jc.timesteps),
                             N_CODES, jit=False)
    st1, mean_loss = run(st0, *(jnp.asarray(b) for b in banks), key)
    draws = _jax_draws(key, 3, jc.batch_size, 16, jc.timesteps, 0.0, 1)
    draws = {k: draws[k] for k in ("idx", "t", "eps")}
    state = ttd.init_diff_state(tc, device="cpu", params=_sd(st0.params))
    loss = _port_step(tc, state, banks).eager(draws)
    np.testing.assert_allclose(float(loss), float(mean_loss), rtol=1e-6)
    want = _sd(st1.params)
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=2e-5,
                                   rtol=0, msg=name)


@pytest.mark.parametrize("warmup, steps", [(10, 100), (0, 50)])
def test_make_diff_tx_matches_optax(warmup, steps):
    jc, tc = _cfgs(lr=2e-4, lr_schedule="cosine", warmup_steps=warmup,
                   num_steps=steps)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup else jc.lr, peak_value=jc.lr,
        warmup_steps=max(warmup, 1), decay_steps=steps, end_value=0.05 * jc.lr)
    lr = ttd.make_diff_tx(tc)
    for s in [0, 1, 5, 9, 10, 11, 37, steps - 1, steps, 3 * steps]:
        np.testing.assert_allclose(lr(s), float(sched(s)), rtol=2e-6,
                                   err_msg=str(s))
    assert ttd.make_diff_tx(dataclasses.replace(tc, lr_schedule="constant"))(
        123) == tc.lr


def test_flax_init_statistics():
    """Every leaf of the port's from-scratch init against the same leaf of
    flax's `model.init`: equal shapes; biases, LayerNorm and out_proj
    exactly equal (0 or 1); kernels and the class table with the same
    std (each within 4 sigma of its sampling error of the expected std)
    and kernels cut at 2 std."""
    den = dict(DEN, latent_size=64, hidden_dim=256, num_classes=13,
               partial_points=32)
    jc, tc = _cfgs(den=den)
    model = JaxDenoiser(jc.denoiser)
    B = 2
    jp = model.init(jax.random.PRNGKey(0), jnp.zeros((B, 64)),
                    jnp.zeros((B,), jnp.int32),
                    class_id=jnp.zeros((B,), jnp.int32),
                    obs_xyz=jnp.zeros((B, 32, 3)),
                    obs_sdf=jnp.zeros((B, 32)))["params"]
    want = _sd(jp)
    got = ttd.init_diff_state(tc, seed=0, device="cpu").model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name.endswith("bias") or g.ndim == 1 or "out_proj" in name:
            assert torch.equal(g, w), name
            continue
        # Dense [out, in]: sqrt(1 / fan_in); Embed [rows, features]:
        # 1 / sqrt(features); both 1 / sqrt(shape[1])
        std = 1.0 / np.sqrt(w.shape[1])
        sig = 4.0 * std / np.sqrt(2.0 * w.numel())
        for t in (g, w):
            assert abs(float(t.std()) - std) < sig, name
        if not name.endswith("cls.weight"):
            assert float(g.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
    # the EMA starts as a distinct copy of the params
    st = ttd.init_diff_state(tc, seed=0, device="cpu")
    for k, p in st.model.named_parameters():
        assert torch.equal(st.ema[k], p) and st.ema[k].data_ptr() != \
            p.data_ptr()


def test_draw_chunk_is_keyed_by_seed_and_start():
    _, tc = _cfgs(scan_chunk=400)
    a = ttd.draw_chunk(tc, N_CODES, BANK, 0, "cpu")
    b = ttd.draw_chunk(tc, N_CODES, BANK, 0, "cpu")
    c = ttd.draw_chunk(tc, N_CODES, BANK, 400, "cpu")
    assert set(a) == {"idx", "t", "eps", "drop", "cols"}
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]), k
    assert a["idx"].shape == (400, 8) and int(a["idx"].max()) < N_CODES
    assert a["t"].min() >= 0 and int(a["t"].max()) < tc.timesteps
    assert a["cols"].shape == (400, 8, 24) and int(a["cols"].max()) < BANK
    assert abs(float(a["drop"].float().mean()) - 0.3) < 0.03
    narrow = ttd.draw_chunk(tc, N_CODES, 24, 0, "cpu")    # bank == P
    assert "cols" not in narrow


def _loop_cfg(**kw):
    _, tc = _cfgs(**dict(dict(scan_chunk=5, num_steps=20, snapshot_every=10),
                         **kw))
    return tc


def test_train_diffusion_loop_logs_checkpoints_and_learns(tmp_path):
    tc = _loop_cfg(num_steps=60, lr_schedule="cosine", lr=3e-3)
    codes, cids, oxyz, osdf = _banks()
    saved = []
    log = tmp_path / "diff.jsonl"
    model, state, (mu, sigma), last = ttd.train_diffusion(
        tc, codes, class_ids=cids, obs_xyz=oxyz, obs_sdf=osdf,
        logger=MetricLogger(log), device="cpu",
        checkpoint_fn=lambda d, st, m, s: saved.append(d))
    assert saved == [10, 20, 30, 40, 50, 60] and state.step == 60
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert recs[0]["event"] == "lr_schedule" and recs[0]["used"] == "constant"
    chunks = [r for r in recs if r["event"] == "diff_chunk"]
    assert [r["step"] for r in chunks] == list(range(5, 65, 5))
    assert chunks[-1]["loss"] == last and np.isfinite(last)
    assert np.mean([r["loss"] for r in chunks[-3:]]) < np.mean(
        [r["loss"] for r in chunks[:3]])
    torch.testing.assert_close(mu, torch.from_numpy(codes.mean(0)))
    assert model is state.model


def test_stage1_resume_is_exact(tmp_path):
    """k steps + save + restore into a fresh state + k steps == 2k steps,
    bit for bit: decoder, codes, both Adam groups."""
    cfg = tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        latent_size=8, hidden_dim=16, num_layers=3, latent_in=(2,),
        compute_dtype="bfloat16", dropout_impl="pallas"),
        num_scenes=3, scenes_per_batch=2, samples_per_scene=64)
    rng = np.random.default_rng(4)
    ids = torch.tensor([0, 2])
    xyz = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    sdf = torch.from_numpy((0.05 * rng.normal(size=(2, 64))).astype(
        np.float32))

    def fresh(seed=0):
        st = tad.init_ad_state(cfg, SdfDecoder(cfg.decoder), seed=seed,
                               device="cpu")
        return st, tad.make_ad_train_step(st.decoder, cfg)

    def run(st, step, lo, hi):
        for i in range(lo, hi):
            step(st, ids, xyz, sdf, float(i), 100 + i)

    straight, step = fresh()
    run(straight, step, 0, 10)
    a, step_a = fresh()
    run(a, step_a, 0, 5)
    ckpt = StageCheckpointer(tmp_path, "auto_decoder", max_to_keep=2)
    for e in (3, 4):
        ckpt.save(e, ad_state_tree(a, e))
    b, step_b = fresh(seed=9)
    assert restore_ad_state(b, ckpt.restore()) == 4
    run(b, step_b, 5, 10)
    sa, sb = straight.decoder.state_dict(), b.decoder.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(straight.codes, b.codes)
    oa, ob = straight.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    ckpt.save(5, ad_state_tree(b, 5))
    assert ckpt.steps() == [4, 5]
    assert not list(ckpt.root.glob("*.tmp"))


def test_stage2_resume_is_exact(tmp_path):
    """train_diffusion to step 10, save, restore into a state drawn from
    another seed, train on to 20 == 20 straight steps, bit for bit:
    params, EMA, Adam moments and counts (chunks are keyed by step)."""
    banks = _banks()
    codes, cids, oxyz, osdf = banks
    kw = dict(class_ids=cids, obs_xyz=oxyz, obs_sdf=osdf, device="cpu")
    straight = ttd.train_diffusion(_loop_cfg(), codes, **kw)[1]
    half = ttd.train_diffusion(_loop_cfg(num_steps=10), codes, **kw)
    _, a, (mu, sigma), _ = half
    ckpt = StageCheckpointer(tmp_path, "diffusion")
    ckpt.save(a.step, diff_state_tree(a, mu, sigma))
    b = ttd.init_diff_state(_loop_cfg(), seed=5, device="cpu")
    mu2, sigma2 = restore_diff_state(b, ckpt.restore())
    assert b.step == 10 and torch.equal(mu2, mu) and torch.equal(sigma2,
                                                                 sigma)
    b = ttd.train_diffusion(_loop_cfg(), codes, state=b, **kw)[1]
    assert b.step == straight.step == 20
    for (k, p), q in zip(straight.model.named_parameters(),
                         b.model.parameters()):
        assert torch.equal(p, q), k
        assert torch.equal(straight.ema[k], b.ema[k]), k
        sa, sb = straight.optimizer.state[p], b.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (k, key)


def test_stage2_pack_reads_in_jax(tmp_path):
    """A pack the port writes restores in JAX's restore_tree_npz into a
    flax template; flax's eps_hat from it equals the port's to 1e-5, for
    params and EMA; the port reads it back bit for bit."""
    jc, tc = _cfgs()
    model, st0 = _jax_state(jc, seed=1)
    banks = _banks(2)
    state = ttd.init_diff_state(tc, device="cpu", params=_sd(st0.params))
    draws = _jax_draws(jax.random.PRNGKey(1), 3, 8, 16, 100, 0.3, 24)
    _port_step(tc, state, banks).eager(draws)          # EMA != params
    mu = torch.arange(16, dtype=torch.float32)
    sigma = torch.full((16,), 0.5)
    save_stage2_pack(tmp_path / "s2.npz", state, mu, sigma)
    tmpl = {"params": st0.params, "ema_params": st0.params,
            "mu": jnp.zeros(16), "sigma": jnp.zeros(16)}
    back = restore_tree_npz(tmp_path / "s2.npz", tmpl)
    np.testing.assert_array_equal(back["mu"], mu.numpy())
    rng = np.random.default_rng(5)
    z = rng.normal(size=(6, 16)).astype(np.float32)
    t = rng.integers(0, 100, 6).astype(np.int32)
    cid = rng.integers(0, 5, 6).astype(np.int32)
    ox = rng.uniform(-1, 1, (6, 24, 3)).astype(np.float32)
    od = (0.1 * rng.normal(size=(6, 24))).astype(np.float32)
    p_sd, ema_sd, mu2, sigma2 = load_stage2_pack(tmp_path / "s2.npz")
    assert torch.equal(mu2, mu) and torch.equal(sigma2, sigma)
    for key, sd in (("params", state.model.state_dict()),
                    ("ema_params", state.ema)):
        want = np.asarray(model.apply({"params": back[key]}, jnp.asarray(z),
                                      jnp.asarray(t),
                                      class_id=jnp.asarray(cid),
                                      obs_xyz=jnp.asarray(ox),
                                      obs_sdf=jnp.asarray(od)))
        state.model.load_state_dict(sd)
        with torch.no_grad():
            got = state.model(torch.from_numpy(z), torch.from_numpy(t),
                              class_id=torch.from_numpy(cid),
                              obs_xyz=torch.from_numpy(ox),
                              obs_sdf=torch.from_numpy(od)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=key)
        read = p_sd if key == "params" else ema_sd
        for k, v in sd.items():
            assert torch.equal(read[k], v), (key, k)


def test_graphed_chunk_needs_a_card():
    _, tc = _cfgs()
    state = ttd.init_diff_state(tc, device="cpu")
    step = _port_step(tc, state, _banks())
    with pytest.raises(RuntimeError, match="CUDA"):
        step.graphed(ttd.draw_chunk(tc, N_CODES, BANK, 0, "cpu"))
