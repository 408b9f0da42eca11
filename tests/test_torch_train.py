"""PyTorch port vs the JAX package: stage-1 training on the CPU.

Losses, latent table, the analytic data source and sample store (bit for
bit), the decoder's training forward, the autograd train step's
trajectory, the training loop, and the stage-1 pack writer. Same numpy
inputs through both packages; JAX on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import losses as jlosses
from latent_diffusion_models_for_shape_sdfs_tpu.data import analytic as janalytic
from latent_diffusion_models_for_shape_sdfs_tpu.data.sdf_dataset import (
    SdfDataset as JaxDataset)
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.models.latent_table import (
    LatentTable, gather_codes as jax_gather_codes)
from latent_diffusion_models_for_shape_sdfs_tpu.train import auto_decoder as jad
from latent_diffusion_models_for_shape_sdfs_tpu.utils.checkpoint import (
    pack_tree_npz as jax_pack_tree_npz, restore_tree_npz)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import losses
from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.models.latent_table import (
    gather_codes, init_latent_table)
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack, params_from_jax, params_to_jax, save_stage1_pack)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger, Timer, rate)

torch.set_num_threads(2)


def _cfgs(decoder: dict, **kw):
    """The same AdConfig in both packages."""
    return (jcfg.AdConfig(decoder=jcfg.DecoderConfig(**decoder), **kw),
            tcfg.AdConfig(decoder=tcfg.DecoderConfig(**decoder), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- (a) losses

@pytest.mark.parametrize("delta", [0.1, 0.05, 1.0])
def test_clamped_l1_matches_jax(delta):
    """tests/test_loss_oracle.py's random cases, within 1e-6."""
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 0.3, size=4096).astype(np.float32)
    gt = rng.normal(0, 0.3, size=4096).astype(np.float32)
    for n in (pred.size, 3 * pred.size):
        ours = float(losses.clamped_l1(_t(pred), _t(gt), delta, n))
        ref = float(jlosses.clamped_l1(jnp.asarray(pred), jnp.asarray(gt),
                                       delta, n))
        assert abs(ours - ref) < 1e-6 * max(1.0, abs(ref))
    # clamp before subtract; sum / n, not mean
    assert abs(float(losses.clamped_l1(_t([0.3]), _t([-0.3]), 0.1, 1))
               - 0.2) < 1e-7
    assert abs(float(losses.clamped_l1(_t([0.05, 0.05]), _t([0.0, 0.0]),
                                       0.1, 4)) - 0.025) < 1e-7


@pytest.mark.parametrize("squared", [False, True])
def test_code_reg_matches_jax(squared):
    z = np.random.default_rng(1).normal(size=(64, 256)).astype(np.float32)
    lam, warmup, n = 1e-4, 100, 64 * 16384
    for epoch in (0, 1, 10, 50, 100, 200, 5000):
        ours = float(losses.code_reg(_t(z), epoch, lam, warmup, n, squared))
        ref = float(jlosses.code_reg(jnp.asarray(z), epoch, lam, warmup, n,
                                     squared))
        assert abs(ours - ref) < 1e-9 + 1e-6 * abs(ref)
    e = np.random.default_rng(2).normal(size=(8, 16)).astype(np.float32)
    assert float(losses.eps_mse(_t(e), _t(e * 0.5))) == pytest.approx(
        float(jlosses.eps_mse(jnp.asarray(e), jnp.asarray(e * 0.5))),
        rel=1e-6)


@pytest.mark.parametrize("bound", [0.0, 0.5])
def test_gather_codes_matches_jax(bound):
    codes = np.random.default_rng(3).normal(size=(10, 16)).astype(
        np.float32)
    codes[4] = 0.0                                   # zero-norm row
    ids = np.asarray([4, 1, 1, 9, 0], np.int64)
    ours = gather_codes(_t(codes), _t(ids), bound).numpy()
    ref = np.asarray(jax_gather_codes(LatentTable(jnp.asarray(codes)),
                                      jnp.asarray(ids), bound))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    if bound:
        assert np.linalg.norm(ours, axis=1).max() <= bound * (1 + 1e-6)


def test_latent_table_init_statistics():
    gen = torch.Generator().manual_seed(0)
    codes = init_latent_table(gen, 4096, 64, code_init_std=2.0)
    assert codes.dtype == torch.float32 and codes.shape == (4096, 64)
    assert abs(codes.std().item() - 2.0 / 8.0) < 0.01
    gen.manual_seed(0)
    assert torch.equal(codes, init_latent_table(gen, 4096, 64, 2.0))


# --------------------------------------------------------- (b) data, bitwise

@pytest.mark.parametrize("family,seed", [("chair", 11), ("classes13", 0),
                                         ("mixed", 5), ("csg", 2)])
def test_synthetic_split_and_samples_bitwise(family, seed):
    ours = analytic.make_synthetic_split(family, 13, seed=seed)
    ref = janalytic.make_synthetic_split(family, 13, seed=seed)
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True)
    for i in (0, 7):
        a = analytic.sample_sdf_points(ours[i], 777, np.random.default_rng(i))
        b = janalytic.sample_sdf_points(ref[i], 777, np.random.default_rng(i))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_dataset_batches_bitwise(monkeypatch):
    """from_analytic (serial here, a process pool in the port: `spawn`, as
    in a process whose CUDA is initialised, since this one runs JAX's
    threads) and epoch_batches give the JAX package's arrays for the same
    seeds."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    shapes = analytic.make_synthetic_split("chair", 10, seed=11)
    ours = SdfDataset.from_analytic(shapes, 600, seed=3, workers=2)
    ref = JaxDataset.from_analytic(
        janalytic.make_synthetic_split("chair", 10, seed=11), 600, seed=3,
        workers=1)
    for a, b in zip(ours.pos + ours.neg, ref.pos + ref.neg):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.class_ids, ref.class_ids)
    ba = list(ours.epoch_batches(np.random.default_rng(7), 4, 64))
    bb = list(ref.epoch_batches(np.random.default_rng(7), 4, 64))
    assert len(ba) == len(bb) == 3
    for x, y in zip(ba, bb):
        for k in ("scene_ids", "xyz", "sdf"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))


# --------------------------------------------- (d) decoder training forward

def _jax_params(cfg, key=0):
    dec = JaxDecoder(cfg)
    return dec, jax.tree.map(np.asarray, dec.init_params(
        jax.random.PRNGKey(key)))


@pytest.mark.parametrize("plan", [
    dict(latent_size=16, hidden_dim=64, num_layers=3, latent_in=(2,)),
    dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
         use_tanh=True),
])
def test_train_forward_without_dropout_matches_jax(plan):
    """fp32, dropout off: the training forward equals JAX apply(train=True)
    to atol 1e-5."""
    jc = jcfg.DecoderConfig(use_dropout=False, **plan)
    jdec, params = _jax_params(jc)
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False, **plan))
    dec.load_state_dict(params_from_jax(params))
    dec.train()
    rng = np.random.default_rng(0)
    z = rng.normal(size=(300, plan["latent_size"])).astype(np.float32)
    xyz = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    ours = dec(_t(z), _t(xyz), seed=5).detach().numpy()
    ref = np.asarray(jdec.apply({"params": params}, jnp.asarray(z),
                                jnp.asarray(xyz), train=True,
                                rngs={"dropout": jax.random.PRNGKey(1)}))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_train_forward_dropout_is_seeded(impl):
    """With dropout on: deterministic per seed, different across seeds,
    eval mode drops nothing; the pallas route draws relu_dropout's mask
    for seed + 7919 * layer."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.relu_dropout import (
        dropout_keep_mask, layer_seed)
    cfg = tcfg.DecoderConfig(latent_size=8, hidden_dim=64, num_layers=2,
                             latent_in=(), dropout_prob=0.3,
                             dropout_impl=impl)
    torch.manual_seed(0)
    dec = SdfDecoder(cfg).train()
    z, xyz = torch.randn(200, 8), torch.rand(200, 3) * 2 - 1
    a, b, c = dec(z, xyz, seed=1), dec(z, xyz, seed=1), dec(z, xyz, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    ref = dec.eval()(z, xyz)
    assert not torch.equal(a, ref)
    if impl == "pallas":
        h = torch.relu(dec.lin0(torch.cat([z, xyz], -1)))
        keep = dropout_keep_mask(200, 64, layer_seed(1, 0), 0.3)
        h = torch.where(keep, h / 0.7, 0.0)
        h = torch.relu(dec.lin1(h))
        keep = dropout_keep_mask(200, 64, layer_seed(1, 1), 0.3)
        h = torch.where(keep, h * torch.tensor(1 / 0.7), 0.0)
        torch.testing.assert_close(dec.lin2(h)[:, 0], a, rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------ (e) train-step trajectory vs JAX

def test_autograd_steps_track_jax():
    """3 steps of the autograd route (fp32, dropout off, L=16, H=64, three
    hidden layers, skip (2,), S=2, P=256) from JAX's initial state: loss
    within 1e-5 relative each step; params and codes within 1e-6 absolute
    after (0.2% of one Adam step at lr 5e-4; the gradients differ only by
    fp32 summation order)."""
    plan = dict(latent_size=16, hidden_dim=64, num_layers=3, latent_in=(2,),
                use_dropout=False)
    jc, tc = _cfgs(plan, num_scenes=3, scenes_per_batch=2,
                   samples_per_scene=256, clamp_dist=0.2)
    jdec = JaxDecoder(jc.decoder)
    jst = jad.init_ad_state(jc, jdec, jax.random.PRNGKey(0))
    st = tad.init_ad_state(tc, device="cpu",
                           params=params_from_jax(jax.tree.map(
                               np.asarray, jst.params)),
                           codes=np.array(jst.codes))
    jstep = jad.make_ad_train_step(jdec, jc)
    step = tad.make_ad_train_step(st.decoder, tc)
    rng = np.random.default_rng(0)
    for i in range(3):
        ids = rng.permutation(3)[:2]
        xyz = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
        sdf = (0.15 * rng.normal(size=(2, 256))).astype(np.float32)
        epoch = float(150 * i)
        jst, jm = jstep(jst, jnp.asarray(ids, jnp.int32), jnp.asarray(xyz),
                        jnp.asarray(sdf), jnp.asarray(epoch),
                        jax.random.PRNGKey(i))
        m = step(st, _t(ids), _t(xyz), _t(sdf), epoch, i)
        for k in ("loss", "loss_l1", "loss_reg"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                abs=1e-12), k
        assert m["lr_dec"] == pytest.approx(float(jm["lr_dec"]), rel=1e-7)
    ours = params_to_jax(st.decoder.state_dict())
    for name, layer in ours.items():
        for k, a in layer.items():
            np.testing.assert_allclose(a, np.asarray(jst.params[name][k]),
                                       atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.codes.detach().numpy(),
                               np.asarray(jst.codes), atol=1e-6, rtol=0)
    # the untouched-in-step-3 rows still moved (dense Adam over the table)
    assert not np.array_equal(st.codes.detach().numpy(),
                              np.asarray(jad.init_ad_state(
                                  jc, jdec, jax.random.PRNGKey(0)).codes))


@pytest.mark.parametrize("epoch", [0, 499, 500, 1200])
def test_step_lr_matches_jax(epoch):
    assert tad.step_lr(5e-4, epoch, 0.5, 500) == pytest.approx(
        float(jad.step_lr(5e-4, epoch, 0.5, 500)), rel=1e-7)


# ------------------------------------------------------------ the loop

def _loop_cfg(**kw):
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        latent_size=16, hidden_dim=64, num_layers=3, latent_in=(2,),
        compute_dtype="bfloat16", dropout_impl="pallas"),
        num_scenes=3, scenes_per_batch=2, samples_per_scene=256,
        clamp_dist=0.2, **kw)


def test_train_loop_logs_checkpoints_and_learns(tmp_path):
    cfg = _loop_cfg(num_epochs=12, snapshot_every=5)
    ds = SdfDataset.from_analytic(analytic.make_synthetic_split(
        "sphere", 3, seed=0), 2000, workers=1)
    saved, steps = [], []
    log = tmp_path / "ad.jsonl"
    _, state, m = tad.train_auto_decoder(
        cfg, ds, logger=MetricLogger(log), device="cpu",
        checkpoint_fn=lambda e, s: saved.append(e),
        on_step=lambda i, e, mm: steps.append((i, e, float(mm["loss_l1"]))))
    assert saved == [4, 9, 11]
    assert [s[:2] for s in steps] == [(i, i // 2) for i in range(24)]
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 10, 11]
    assert recs[-1]["steps"] == 24 and np.isfinite(recs[-1]["loss"])
    assert np.mean([s[2] for s in steps[-4:]]) < np.mean(
        [s[2] for s in steps[:4]])
    assert float(m["loss_l1"]) == steps[-1][2]
    with pytest.raises(ValueError, match="scenes"):
        tad.train_auto_decoder(_loop_cfg(num_epochs=1), SdfDataset.from_analytic(
            analytic.make_synthetic_split("sphere", 2), 100, workers=1),
            device="cpu")


@pytest.mark.parametrize("opt", ["data_parallel"])
def test_unported_options_raise(opt, monkeypatch):
    """data_parallel without an initialised torch.distributed group takes
    the single-device step, as the JAX package does on one device: the
    same trajectory bit for bit as data_parallel=False, also with more
    than one CUDA device visible (the data-parallel step runs over a
    group: tests/test_torch_dp.py). device_data no longer raises: its
    route is held in tests/test_torch_device_bank.py."""
    ds = SdfDataset.from_analytic(analytic.make_synthetic_split(
        "sphere", 3, seed=0), 2000, workers=1)
    runs = []
    for dp in (False, True):
        losses = []
        _, state, _ = tad.train_auto_decoder(
            _loop_cfg(num_epochs=2, data_parallel=dp), ds, device="cpu",
            on_step=lambda i, e, m: losses.append(
                (float(m["loss_l1"]), float(m["loss"]))))
        runs.append((losses, state))
    (l0, s0), (l1, s1) = runs
    assert len(l0) == 4 and l0 == l1
    assert torch.equal(s0.codes, s1.codes)
    sd1 = s1.decoder.state_dict()
    for k, v in s0.decoder.state_dict().items():
        assert torch.equal(v, sd1[k]), k
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tad._dp_mesh(_loop_cfg(data_parallel=True)) is None


def test_unported_fused_options_raise(tmp_path):
    """code_bound under the fused route still raises; MetricLogger's
    TensorBoard mirror, once refused, writes an event file."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_train import (
        make_fused_ad_loss_grads)
    cfg = _loop_cfg(use_pallas=True, code_bound=1.0)
    with pytest.raises(NotImplementedError, match="code_bound"):
        make_fused_ad_loss_grads(SdfDecoder(cfg.decoder), cfg)
    log = MetricLogger(tensorboard=tmp_path / "tb")
    log.log("ad_epoch", epoch=0, loss_l1=0.5)
    log.close()
    ev, = (tmp_path / "tb").glob("events.out.tfevents.*")
    assert ev.stat().st_size > 0
    t = Timer().start()
    assert t.stop(torch.zeros(1)) >= 0 and rate(4, 2.0) == 2.0


# ---------------------------------------------------------- (h) stage-1 pack

def test_pack_round_trips_with_jax(tmp_path):
    """A pack the port writes restores bit for bit in JAX's
    restore_tree_npz, and a JAX-written pack loads bit for bit in the
    port."""
    jc = jcfg.DecoderConfig(latent_size=16, hidden_dim=64, num_layers=3,
                            latent_in=(2,))
    jdec, params = _jax_params(jc, key=4)
    codes = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    sd = params_from_jax(params)
    save_stage1_pack(tmp_path / "port.npz", sd, torch.from_numpy(codes))
    tmpl = {"params": jax.tree.map(jnp.zeros_like, params),
            "codes": jnp.zeros((5, 16), jnp.float32)}
    back = restore_tree_npz(tmp_path / "port.npz", tmpl)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": params, "codes": codes})):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jax_pack_tree_npz(tmp_path / "jax.npz", {"params": params,
                                             "codes": codes})
    sd2, codes2 = load_stage1_pack(tmp_path / "jax.npz")
    np.testing.assert_array_equal(codes2, codes)
    for k, v in sd.items():
        assert torch.equal(sd2[k], v), k
