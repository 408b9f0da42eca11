"""PyTorch port vs the JAX package: the on-device sample bank
(data/device_bank.py) and stage-1 training from it (AdConfig.device_data).

`from_dataset` and the draw on JAX's own uniforms bit for bit; the draw
from a torch.Generator (determinism, balance, rows from the store); a
3-step bank trajectory against the reference's bank step
(`make_ad_train_step(jit=False)` + `sample_batch`) on both routes, fed
JAX's uniforms; the loop's scene-id stream; `dataset=None` with a bank;
and `train-ad` with `ad.device_data` through the CLI. JAX on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.data.device_bank import (
    DeviceSampleBank as JaxBank)
from latent_diffusion_models_for_shape_sdfs_tpu.data.sdf_dataset import (
    SdfDataset as JaxDataset)
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.train import auto_decoder as jad
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
    DeviceSampleBank)
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    params_from_jax, params_to_jax)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger)

torch.set_num_threads(2)


def _store(seed=0, sizes=((40, 25), (0, 30), (17, 0), (33, 9))):
    """Per-scene (pos, neg) rows, with an empty side in scenes 1 and 2."""
    rng = np.random.default_rng(seed)
    pos, neg = [], []
    for n_p, n_n in sizes:
        p = rng.uniform(-1, 1, (n_p, 4)).astype(np.float32)
        n = rng.uniform(-1, 1, (n_n, 4)).astype(np.float32)
        p[:, 3] = np.abs(p[:, 3])
        n[:, 3] = -np.abs(n[:, 3]) - 1e-3
        pos.append(p)
        neg.append(n)
    return pos, neg


def test_from_dataset_matches_jax_bitwise():
    """Rows, padding and counts equal JAX's bit for bit, including the
    scenes with an empty side (filled from the other side before the
    buffers are sized)."""
    pos, neg = _store()
    ours = DeviceSampleBank.from_dataset(SdfDataset(pos, neg), device="cpu")
    ref = JaxBank.from_dataset(JaxDataset(pos, neg))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.pos.shape == (4, 40, 4) and ours.neg.shape == (4, 30, 4)
    assert ours.pos_count.tolist() == [40, 30, 17, 33]
    assert ours.neg_count.tolist() == [25, 30, 17, 9]
    assert ours.nbytes == 4 * 40 * 16 + 4 * 30 * 16 + 2 * 4 * 4


@pytest.mark.parametrize("P", [64, 33])
def test_draw_on_jax_uniforms_is_bitwise(P):
    """gather() on JAX's own uniforms (split(key) -> uniform(k1, (B,
    half)), uniform(k2, (B, rest))) returns JAX's sample_batch bit for
    bit, repeated scenes and an odd P included."""
    pos, neg = _store(1)
    ours = DeviceSampleBank.from_dataset(SdfDataset(pos, neg), device="cpu")
    ref = JaxBank.from_dataset(JaxDataset(pos, neg))
    ids = np.array([2, 0, 1, 3, 1], np.int32)
    key = jax.random.PRNGKey(7)
    xyz_j, sdf_j = ref.sample_batch(key, jnp.asarray(ids), P)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (len(ids), P // 2))
    u2 = jax.random.uniform(k2, (len(ids), P - P // 2))
    xyz, sdf = ours.gather(torch.from_numpy(ids.astype(np.int64)),
                           torch.from_numpy(np.asarray(u1)),
                           torch.from_numpy(np.asarray(u2)))
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(xyz_j))
    np.testing.assert_array_equal(sdf.numpy(), np.asarray(sdf_j))


def test_sample_batch_from_a_generator():
    """The generator's draw: the same seed gives the same batch, another
    seed another; the first half positive, the rest negative; every row
    comes from its scene's store."""
    ds = SdfDataset.from_analytic(analytic.make_synthetic_split(
        "sphere", 3, seed=0), 4000, workers=1)
    bank = DeviceSampleBank.from_dataset(ds, device="cpu")
    ids = torch.tensor([2, 0])
    draw = [bank.sample_batch(torch.Generator().manual_seed(s), ids, 512)
            for s in (0, 0, 1)]
    assert torch.equal(draw[0][0], draw[1][0])
    assert not torch.equal(draw[0][0], draw[2][0])
    xyz, sdf = draw[0]
    assert xyz.shape == (2, 512, 3) and sdf.dtype == torch.float32
    assert bool((sdf[:, :256] >= 0).all()) and bool((sdf[:, 256:] < 0).all())
    for b, scene in enumerate((2, 0)):
        store = np.concatenate([ds.pos[scene], ds.neg[scene]])
        rows = torch.cat([xyz[b], sdf[b, :, None]], -1).numpy()
        hits = (rows[:, None, :] == store[None]).all(-1).any(1)
        assert hits.all()


# ------------------------------------------- the bank step's trajectory

class _GivenUniforms(DeviceSampleBank):
    """A bank whose draw takes queued uniforms (JAX's) in place of the
    generator's."""

    queue: list = []

    def uniforms(self, generator, batch, samples_per_scene):
        return self.queue.pop(0)


PLANS = {
    # test_torch_train.py's trajectory plan (fp32, dropout off)
    "autograd": (dict(latent_size=16, hidden_dim=64, num_layers=3,
                      latent_in=(2,), use_dropout=False),
                 dict(samples_per_scene=256)),
    # test_torch_fused_train.py's plan (bf16 kernel route, rate 0)
    "fused": (dict(latent_size=16, hidden_dim=128, num_layers=3,
                   latent_in=(2,), use_dropout=False),
              dict(samples_per_scene=512, use_pallas=True)),
}


@pytest.mark.parametrize("route", ["autograd", "fused"])
def test_bank_steps_track_jax(route):
    """3 steps of make_bank_step against the reference's bank step (its
    sample_batch, then make_ad_train_step(jit=False)) from JAX's initial
    state, the port fed JAX's uniforms of each step's data key. Autograd
    route at test_torch_train.py's trajectory tolerances: loss 1e-5
    relative, params and codes 1e-6 absolute. Fused route at
    test_torch_fused_train.py's: loss 1e-4 relative; params and codes
    within 1e-2 of their largest entry (both sides round to bf16 at the
    same points, and sum in another order). The data are
    test_torch_train.py's: on analytic sphere samples the two packages'
    gradients agree to 1e-9 at equal states, but the 6e-8 state noise of
    two steps flips a hidden relu and moves step 3's gradient by 1e-6."""
    dec, extra = PLANS[route]
    kw = dict(num_scenes=4, scenes_per_batch=2, clamp_dist=0.2,
              device_data=True, **extra)
    jc = jcfg.AdConfig(decoder=jcfg.DecoderConfig(**dec), **kw)
    tc = tcfg.AdConfig(decoder=tcfg.DecoderConfig(**dec), **kw)
    # test_torch_train.py's trajectory data (xyz uniform, sdf 0.15 N),
    # split by sign into each scene's store
    rng = np.random.default_rng(0)
    rows = [np.concatenate([rng.uniform(-1, 1, (600, 3)),
                            0.15 * rng.normal(size=(600, 1))], 1)
            .astype(np.float32) for _ in range(4)]
    ds = SdfDataset([r[r[:, 3] >= 0] for r in rows],
                    [r[r[:, 3] < 0] for r in rows])
    jbank = JaxBank.from_dataset(JaxDataset(ds.pos, ds.neg))
    bank = _GivenUniforms(*DeviceSampleBank.from_dataset(ds, device="cpu"))
    jdec = JaxDecoder(jc.decoder)
    jst = jad.init_ad_state(jc, jdec, jax.random.PRNGKey(0))
    st = tad.init_ad_state(tc, device="cpu",
                           params=params_from_jax(jax.tree.map(
                               np.asarray, jst.params)),
                           codes=np.array(jst.codes))
    raw = jad.make_ad_train_step(jdec, jc, jit=False)
    P = jc.samples_per_scene

    @jax.jit
    def jstep(state, ids, epoch, key):
        k_data, k_step = jax.random.split(key)
        xyz, sdf = jbank.sample_batch(k_data, ids, P)
        return raw(state, ids, xyz, sdf, epoch, k_step)

    step = tad.make_bank_step(st.decoder, tc, bank, torch.Generator())
    rtol, atol = (1e-5, 1e-6) if route == "autograd" else (1e-4, None)
    for i in range(3):
        ids = rng.permutation(4)[:2]
        key = jax.random.PRNGKey(10 + i)
        k1, k2 = jax.random.split(jax.random.split(key)[0])
        bank.queue.append(tuple(torch.from_numpy(np.asarray(
            jax.random.uniform(k, (2, n)))) for k, n in
            ((k1, P // 2), (k2, P - P // 2))))
        epoch = float(150 * i)
        jst, jm = jstep(jst, jnp.asarray(ids, jnp.int32), jnp.asarray(epoch),
                        key)
        m = step(st, torch.from_numpy(ids.astype(np.int64)), epoch, i)
        for k in ("loss", "loss_l1", "loss_reg"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=rtol,
                                                abs=1e-12), k
    assert not bank.queue
    pairs = [(st.codes.detach().numpy(), np.asarray(jst.codes), "codes")]
    ours = params_to_jax(st.decoder.state_dict())
    pairs += [(a, np.asarray(jst.params[n][k]), f"{n}.{k}")
              for n, layer in ours.items() for k, a in layer.items()]
    for a, b, name in pairs:
        tol = atol if atol is not None else 1e-2 * np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


# ------------------------------------------------------------ the loop

def _loop_cfg(**kw):
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(
        latent_size=16, hidden_dim=64, num_layers=3, latent_in=(2,),
        compute_dtype="bfloat16", dropout_impl="pallas"),
        num_scenes=5, scenes_per_batch=2, samples_per_scene=256,
        clamp_dist=0.2, device_data=True, **kw)


class _Recording(DeviceSampleBank):
    """A bank that records the scene ids of each draw."""

    seen: list = []

    def gather(self, scene_ids, u_pos, u_neg):
        self.seen.append(scene_ids.tolist())
        return super().gather(scene_ids, u_pos, u_neg)


def test_loop_sends_the_reference_scene_ids():
    """The producer's id stream is the reference's: per epoch
    rng.permutation(n) in scenes_per_batch slices, the last padded from a
    fresh permutation, from default_rng(seed + 1); 3 steps an epoch."""
    ds = SdfDataset.from_analytic(analytic.make_synthetic_split(
        "sphere", 5, seed=0), 1500, workers=1)
    bank = _Recording(*DeviceSampleBank.from_dataset(ds, device="cpu"))
    bank.seen.clear()
    cfg = _loop_cfg(num_epochs=2)
    tad.train_auto_decoder(cfg, None, bank=bank, device="cpu")
    rng = np.random.default_rng(cfg.seed + 1)
    want = []
    for _ in range(2):
        order = rng.permutation(5)
        for s in range(0, 5, 2):
            ids = order[s:s + 2]
            if len(ids) < 2:
                ids = np.concatenate([ids, rng.permutation(5)[:1]])
            want.append(ids.tolist())
    assert bank.seen == want


def test_bank_only_and_dataset_routes_agree(tmp_path):
    """dataset=None with a prebuilt bank trains bit for bit as the bank
    uploaded from the dataset; both learn; the loop logs and
    checkpoints; misuse raises."""
    ds = SdfDataset.from_analytic(analytic.make_synthetic_split(
        "sphere", 5, seed=0), 2000, workers=1)
    cfg = _loop_cfg(num_epochs=8, snapshot_every=4)
    runs = []
    for with_ds in (True, False):
        l1, saved = [], []
        bank = None if with_ds else DeviceSampleBank.from_dataset(
            ds, device="cpu")
        _, st, _ = tad.train_auto_decoder(
            cfg, ds if with_ds else None, bank=bank, device="cpu",
            logger=MetricLogger(tmp_path / f"{with_ds}.jsonl"),
            checkpoint_fn=lambda e, s: saved.append(e),
            on_step=lambda i, e, m: l1.append(float(m["loss_l1"])))
        runs.append((l1, st))
        assert saved == [3, 7] and len(l1) == 24
        assert np.mean(l1[-3:]) < np.mean(l1[:3])
    (la, sa), (lb, sb) = runs
    assert la == lb and torch.equal(sa.codes, sb.codes)
    recs = [json.loads(x) for x in (tmp_path / "False.jsonl").read_text()
            .splitlines()]
    assert [r["epoch"] for r in recs] == [0, 7]
    bank = DeviceSampleBank.from_dataset(ds, device="cpu")
    with pytest.raises(ValueError, match="prebuilt bank"):
        tad.train_auto_decoder(cfg, None, device="cpu")
    with pytest.raises(ValueError, match="prebuilt bank"):
        tad.train_auto_decoder(dataclasses.replace(cfg, device_data=False),
                               None, bank=bank, device="cpu")
    with pytest.raises(ValueError, match="bank of 5 scenes"):
        tad.train_auto_decoder(dataclasses.replace(cfg, num_scenes=6), None,
                               bank=bank, device="cpu")


def test_cli_train_ad_with_device_data(tmp_path):
    """`init-experiment --set ad.device_data=true` then `train-ad` with
    --device cpu: the bank route through the CLI writes its checkpoint
    and log, and trains as train_auto_decoder from the same store."""
    from latent_diffusion_models_for_shape_sdfs_torch import cli
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        build_dataset)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        StageCheckpointer)
    exp = str(tmp_path / "exp")
    sets = {"ad.num_scenes": 3, "ad.num_epochs": 3, "ad.scenes_per_batch": 2,
            "ad.samples_per_scene": 256, "ad.snapshot_every": 0,
            "ad.clamp_dist": 0.2, "ad.decoder.latent_size": 16,
            "ad.decoder.hidden_dim": 64, "ad.decoder.num_layers": 3,
            "ad.decoder.latent_in": [2], "ad.device_data": True}
    argv = ["--device", "cpu", "init-experiment", exp, "--data",
            "analytic:sphere"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    cli.main(argv)
    cli.main(["--device", "cpu", "train-ad", exp])
    cfg = ExperimentConfig.load(exp)
    assert cfg.ad.device_data
    tree = StageCheckpointer(exp, "auto_decoder").restore()
    _, st, _ = tad.train_auto_decoder(cfg.ad, build_dataset(cfg),
                                      device="cpu")
    np.testing.assert_array_equal(np.asarray(tree["codes"]),
                                  st.codes.detach().numpy())
    recs = [json.loads(x) for x in (tmp_path / "exp" / "logs" /
                                    "train_ad.jsonl").read_text().splitlines()]
    assert recs[-1]["event"] == "ad_epoch" and recs[-1]["epoch"] == 2
