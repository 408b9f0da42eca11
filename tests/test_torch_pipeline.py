"""PyTorch port vs the JAX package: the main-path workflow (pipeline,
cli) and what it needs (config.override / experiment_layout,
ops.grid_eval.decode_grid_adaptive, evaluation.fscore,
evaluation.mesh_sample.sample_mesh_surface_with_normals).

Bitwise where both packages compute the same values the same way (the
conditioning banks, the adaptive decode on the exactly evaluable cube of
tests/test_torch_grid_eval.py, the surface sampler); the metrics to 1e-12
(float64 NumPy in both); a decoder's meshes through both packages'
`_decode_latents_to_meshes` by their crossings (bf16 sums in another
order flip signs only within |sdf| < 3e-4). The CLI runs end to end on
a tiny sphere experiment with `--device cpu`: the main path, the encoder
and reconstruction in every mode, the daemon's observation requests, and
config 2-unet's denoiser."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import pipeline as jpipe
from latent_diffusion_models_for_shape_sdfs_tpu.data import analytic as jan
from latent_diffusion_models_for_shape_sdfs_tpu.data.sdf_dataset import (
    SdfDataset as JaxDataset)
from latent_diffusion_models_for_shape_sdfs_tpu.evaluation import (
    fscore as j_fscore, normal_consistency as j_nc, sdf_normals as j_normals)
from latent_diffusion_models_for_shape_sdfs_tpu.evaluation import (
    mesh_sample as jms)
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops import grid_eval as jge
from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_decoder import (
    make_fast_apply as jax_fast_apply)
from latent_diffusion_models_for_shape_sdfs_tpu.utils.checkpoint import (
    pack_tree_npz as jax_pack_tree_npz)
from latent_diffusion_models_for_shape_sdfs_torch import cli
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import pipeline as tpipe
from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    chamfer_l2, fscore, normal_consistency, sdf_normals)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    mesh_sample as tms)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply)
from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
    extract_mesh)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack)

torch.set_num_threads(2)


def test_config_override_and_layout_match_jax(tmp_path):
    kw = {"ad.num_scenes": 7, "diff.denoiser.hidden_dim": 96,
          "sample.grid_res": 40, "name": "x"}
    t = tcfg.override(tcfg.ExperimentConfig(), **kw)
    j = jcfg.override(jcfg.ExperimentConfig(), **kw)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert tcfg.experiment_layout(tmp_path) == jcfg.experiment_layout(
        tmp_path)


@pytest.mark.parametrize("obs_bank, classes", [(0, 13), (300, 0)])
def test_cond_banks_bitwise(obs_bank, classes):
    shapes = analytic.make_synthetic_split("classes13", 6, seed=5)
    kw = {"diff.denoiser.num_classes": classes,
          "diff.denoiser.partial_sdf_cond": True,
          "diff.denoiser.partial_points": 32,
          "diff.denoiser.obs_bank_points": obs_bank, "diff.seed": 3}
    got = tpipe._cond_banks(tcfg.override(tcfg.ExperimentConfig(), **kw),
                            SdfDataset.from_analytic(shapes, 2000,
                                                     workers=1))
    want = jpipe._cond_banks(jcfg.override(jcfg.ExperimentConfig(), **kw),
                             JaxDataset.from_analytic(
                                 jan.make_synthetic_split("classes13", 6,
                                                          seed=5),
                                 2000, workers=1))
    assert (got[0] is None) == (want[0] is None) == (classes == 0)
    for a, b in zip(got, want):
        if b is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[1].shape == (6, obs_bank or 128, 3)


def jax_snapped_cube(z, xyz):
    q = jnp.abs(jnp.round(xyz * 256.0))
    return jnp.max(q, axis=-1) / 256.0 - (0.35 + 0.1 * z[0])


def torch_snapped_cube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


@pytest.mark.parametrize("res, zv", [(64, 0.5), (48, 0.5), (33, 0.5),
                                     (64, 5.5)])
def test_decode_grid_adaptive_bitwise(res, zv):
    """The hierarchical route (64), the dense route below 64 or off the
    16-grid (48, 33), and a shell so large that it escalates the caps
    (z 5.5: a cube of half-width 0.9)."""
    z = np.asarray([zv, 0.0], np.float32)
    want = np.asarray(jge.decode_grid_adaptive(jax_snapped_cube,
                                               jnp.asarray(z), res))
    got = tge.decode_grid_adaptive(torch_snapped_cube, torch.from_numpy(z),
                                   res)
    assert got.dtype == np.float32 and got.shape == (res, res, res)
    np.testing.assert_array_equal(got, want)


def _mesh():
    shape = analytic.make_shape("chair", np.random.default_rng(3))
    grid = analytic.sdf(shape, tge.make_grid_points(40)).reshape(40, 40, 40)
    return shape, extract_mesh(grid.astype(np.float32))


def test_mesh_sampler_and_metrics_match_jax():
    shape, (v, f) = _mesh()
    got = tms.sample_mesh_surface_with_normals(v, f, 3000, seed=4)
    want = jms.sample_mesh_surface_with_normals(v, f, 3000, seed=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tms.sample_mesh_surface(v, f, 500, 1),
                                  jms.sample_mesh_surface(v, f, 500, 1))
    gt = analytic.sample_surface(shape, 2000, np.random.default_rng(0))
    nf = sdf_normals(lambda p: analytic.sdf(shape, p), gt)
    np.testing.assert_array_equal(nf, j_normals(
        lambda p: analytic.sdf(shape, p), gt))
    pts, nrm = got
    for tau in (0.005, 0.02):
        assert fscore(pts, gt, tau) == j_fscore(pts, gt, tau)
    np.testing.assert_allclose(
        normal_consistency(pts, nrm, gt, nf),
        j_nc(pts, nrm, gt, nf), rtol=1e-12)
    with pytest.raises(ValueError, match="empty"):
        tms.sample_mesh_surface_with_normals(v, f[:0], 10)


def _jax_stage1(tmp_path):
    """A JAX-written stage-1 pack of a small random decoder whose zero
    set crosses the grid for code 0."""
    jc = jcfg.DecoderConfig(latent_size=16, hidden_dim=64, num_layers=4,
                            latent_in=(2,), use_dropout=False)
    dec = JaxDecoder(jc)
    params = jax.tree.map(np.asarray, dec.init_params(jax.random.PRNGKey(2)))
    codes = (0.3 * np.random.default_rng(1).normal(size=(3, 16))).astype(
        np.float32)
    # a final layer 20x steeper (the slope of an SDF), shifted so that
    # half of code 0's grid lies inside
    last = params[f"lin{jc.num_layers - 1}"]
    last["g"] = (20.0 * last["g"]).astype(np.float32)
    pts = jnp.asarray(tge.make_grid_points(32))
    med = float(np.median(np.asarray(jax_fast_apply(dec, params)(
        jnp.asarray(codes[0]), pts))))
    last["b"] = (last["b"] - med).astype(np.float32)
    jax_pack_tree_npz(tmp_path / "stage1_pack.npz",
                      {"params": params, "codes": codes})
    return dec, params, codes


@pytest.mark.parametrize("res, hierarchical", [(64, True), (40, True),
                                               (32, False)])
def test_jax_pack_decodes_to_the_same_mesh(tmp_path, res, hierarchical):
    """Through both packages' _decode_latents_to_meshes: the serving path
    at 64 (float32 payload, as compute_dtype float32 asks), the adaptive
    decode at 40, the dense decode at 32. The two meshes' vertex sets
    agree to (h/8)^2 in Chamfer-L2 and in count to 2%: bf16 sums in
    another order move crossings only where |sdf| < 3e-4."""
    dec, params, codes = _jax_stage1(tmp_path)
    sd, codes_t = load_stage1_pack(tmp_path / "stage1_pack.npz")
    np.testing.assert_array_equal(codes_t, codes)
    cfg_kw = {"sample.hierarchical": hierarchical}
    jc = jcfg.override(jcfg.ExperimentConfig(), **cfg_kw)
    tc = tcfg.override(tcfg.ExperimentConfig(), **cfg_kw)
    want = jpipe._decode_latents_to_meshes(
        jax_fast_apply(dec, params), jnp.asarray(codes[:1]), res, jc)
    tdec = SdfDecoder(tcfg.DecoderConfig(
        latent_size=16, hidden_dim=64, num_layers=4, latent_in=(2,),
        use_dropout=False))
    got = tpipe._decode_latents_to_meshes(
        make_kernel_apply(tdec, sd, device="cpu"), torch.from_numpy(codes_t[:1]),
        res, tc, out_dir=tmp_path / "m", device="cpu")
    assert len(list((tmp_path / "m").glob("sample_*.obj"))) == 1
    h = 2.0 / (res - 1)
    for (v, f), (vj, fj) in zip(got, want):
        vj = np.asarray(vj)
        assert len(f) > 100 and len(fj) > 100
        assert abs(len(v) - len(vj)) <= 0.02 * len(vj)
        assert chamfer_l2(v, vj) < (h / 8) ** 2


TINY = [
    "--set", "ad.decoder.latent_size=8", "--set", "ad.decoder.hidden_dim=32",
    "--set", "ad.decoder.num_layers=3", "--set", "ad.decoder.latent_in=[2]",
    "--set", "ad.decoder.use_dropout=false",
    "--set", "ad.scenes_per_batch=2", "--set", "ad.samples_per_scene=512",
    "--set", "ad.num_epochs=40", "--set", "ad.clamp_dist=0.5",
    "--set", "ad.lr_decoder=0.002", "--set", "ad.lr_latent=0.004",
    "--set", "ad.snapshot_every=20",
    "--set", "diff.denoiser.latent_size=8",
    "--set", "diff.denoiser.hidden_dim=32",
    "--set", "diff.denoiser.num_blocks=1",
    "--set", "diff.denoiser.time_embed_dim=16",
    "--set", "diff.timesteps=50", "--set", "diff.batch_size=8",
    "--set", "diff.num_steps=100", "--set", "diff.scan_chunk=50",
    "--set", "diff.snapshot_every=50",
    "--set", "sample.grid_res=24", "--set", "sample.ddim_steps=10",
    "--set", "encoder.encoder.latent_size=8",
    "--set", "encoder.encoder.point_widths=[16,32]",
    "--set", "encoder.encoder.head_widths=[32]",
    "--set", "encoder.n_obs=64", "--set", "encoder.batch_scenes=2",
    "--set", "encoder.num_steps=40", "--set", "encoder.scan_chunk=20",
    "--set", "encoder.warmup_steps=5", "--set", "encoder.lr=0.003",
    "--set", "encoder.snapshot_every=20",
    "--set", "reconstruct.num_steps=60", "--set", "reconstruct.lr_decay_at=40",
    "--set", "reconstruct.lr=0.02",
]


def _cli(*args):
    cli.main(["--device", "cpu", *map(str, args)])


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    d = tmp_path_factory.mktemp("exp")
    _cli("init-experiment", d, "--data", "analytic:sphere", "--scenes", 2,
         *TINY)
    _cli("train-ad", d)
    _cli("train-diff", d)
    return d


def test_cli_trains_samples_and_evaluates(exp):
    specs = json.loads((exp / "specs.json").read_text())
    assert specs["ad"]["num_scenes"] == 2 and specs["diff"][
        "denoiser"]["hidden_dim"] == 32
    assert [p.name for p in sorted((exp / "checkpoints" / "auto_decoder")
                                   .glob("*.pt"))] == ["19.pt", "39.pt"]
    assert sorted(p.name for p in (exp / "checkpoints" / "diffusion")
                  .glob("*.pt")) == ["100.pt", "50.pt"]
    recs = [json.loads(x) for x in (exp / "logs" / "train_diff.jsonl")
            .read_text().splitlines()]
    assert [r["step"] for r in recs if r["event"] == "diff_chunk"] == [50, 100]
    _cli("sample", exp, "--num", 2, "--res", 24)
    _cli("sample", exp, "--num", 1, "--res", 64, "--format", "ply",
         "--seed", 3)
    assert len(list((exp / "samples").glob("*.obj"))) == 2
    assert (exp / "samples" / "sample_000.ply").exists()
    _cli("eval", exp, "--points", 2000)
    out = json.loads((exp / "evals" / "chamfer.json").read_text())
    assert out["num_failed"] == 0 and out["mean"] < 0.05
    assert 0.5 < out["normal_consistency_mean"] <= 1.0
    _cli("decode", exp, "--scene", 0, 1, "--res", 24)
    assert len(list((exp / "decoded").glob("scene_*.obj"))) == 2


def test_cli_train_diff_resumes(exp):
    """--resume on a longer schedule continues from the last checkpoint
    (step 100) to 150, and matches a run that trains 150 straight."""
    specs = json.loads((exp / "specs.json").read_text())
    specs["diff"]["num_steps"] = 150
    (exp / "specs.json").write_text(json.dumps(specs))
    try:
        _cli("train-diff", exp, "--resume")
        _, resumed, _ = tpipe.load_diff_state(exp, device="cpu")
    finally:
        specs["diff"]["num_steps"] = 100
        (exp / "specs.json").write_text(json.dumps(specs))
    recs = [json.loads(x) for x in (exp / "logs" / "train_diff.jsonl")
            .read_text().splitlines()]
    assert [r["step"] for r in recs if r["event"] == "resume"] == [100]
    assert resumed.step == 150
    from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
        train_diffusion)
    cfg = tcfg.override(tcfg.ExperimentConfig.load(exp),
                        **{"diff.num_steps": 150})
    _, ad = tpipe.load_ad_state(exp, device="cpu")
    ref = train_diffusion(cfg.diff, ad.codes.detach(), device="cpu")[1]
    for (k, p), q in zip(ref.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), k


def test_cli_fault_injection_and_resume(tmp_path):
    d = tmp_path / "f"
    _cli("init-experiment", d, "--data", "analytic:sphere", "--scenes", 2,
         *TINY, "--set", "ad.num_epochs=30", "--set", "ad.snapshot_every=10")
    with pytest.raises(SystemExit) as e:
        _cli("train-ad", d, "--fault-inject", 9)
    assert e.value.code == 42
    assert [p.name for p in (d / "checkpoints" / "auto_decoder").glob(
        "*.pt")] == ["9.pt"]
    _cli("train-ad", d, "--resume")
    assert sorted(int(p.stem) for p in (d / "checkpoints" / "auto_decoder")
                  .glob("*.pt")) == [9, 19, 29]
    recs = [json.loads(x) for x in (d / "logs" / "train_ad.jsonl")
            .read_text().splitlines()]
    assert {"fault_injected", "resume"} <= {r["event"] for r in recs}
    assert [r["epoch"] for r in recs if r["event"] == "resume"] == [10]


def test_cli_refuses_what_is_not_ported(exp, tmp_path, monkeypatch):
    """--tensorboard, once refused, now mirrors the stage's log into an
    event file under logs/tb (tests/test_torch_tensorboard.py decodes
    them); the default device is still the card."""
    import shutil
    d = tmp_path / "exp"
    shutil.copytree(exp, d)
    _cli("train-diff", d, "--tensorboard")
    ev = list((d / "logs" / "tb" / "diff").glob("events.out.tfevents.*"))
    assert len(ev) == 1 and ev[0].stat().st_size > 100
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eval", str(exp)])          # the default device is cuda


def _faces(path):
    return sum(1 for ln in path.open() if ln.startswith("f "))


def test_cli_trains_the_encoder_and_reconstructs(exp):
    """train-encoder, then reconstruct in its four modes: MAP, the
    diffusion prior, the encoder's one-shot and the encoder refined."""
    _cli("train-encoder", exp)
    recs = [json.loads(x) for x in (exp / "logs" / "train_enc.jsonl")
            .read_text().splitlines()]
    enc = [r for r in recs if r["event"] == "enc_train"]
    assert [r["step"] for r in enc] == [20, 40]
    assert all(np.isfinite(r["loss"]) for r in enc)
    assert sorted(int(p.stem) for p in (exp / "checkpoints" / "encoder")
                  .glob("*.pt")) == [20, 40]
    common = ["--analytic", "sphere", "--points", 600, "--res", 24]
    modes = {"map": [], "prior": ["--diffusion-prior", "--sds-weight", 0.01],
             "oneshot": ["--encoder", "--refine-steps", 0],
             "refined": ["--encoder"]}
    for name, flags in modes.items():
        _cli("reconstruct", exp, *common, "--name", name, *flags)
    out = exp / "reconstructions"
    assert _faces(out / "map.obj") > 0 and _faces(out / "prior.obj") > 0
    assert _faces(out / "refined.obj") > 0
    assert (out / "oneshot.obj").exists()
    with pytest.raises(ValueError, match="exclusive"):
        _cli("reconstruct", exp, "--encoder", "--diffusion-prior")


@pytest.mark.parametrize("mode", ["latent-opt", "encoder"])
def test_cli_serve_daemon_reconstructs_observations(exp, tmp_path, mode):
    if mode == "encoder" and not (exp / "checkpoints" / "encoder").exists():
        _cli("train-encoder", exp)
    q, out = tmp_path / "q", tmp_path / "out"
    q.mkdir()
    xyz, d = analytic.sample_sdf_points(
        analytic.make_shape("sphere", np.random.default_rng(0)), 500,
        np.random.default_rng(1))
    np.savez(q / "obs.npz", obs_xyz=xyz, obs_sdf=d)
    _cli("serve-daemon", exp, "--in", q, "--out", out, "--res", 64,
         "--poll", 0.05, "--max-idle", 0.3, "--reconstruct", mode,
         "--refine-steps", 10)
    assert not (out / "obs.error.json").exists()
    stats = json.loads((out / "obs.stats.json").read_text())
    assert stats[0]["faces"] > 0 and (q / "obs.npz.done").exists()


def test_cli_unet_config_trains_and_samples(tmp_path):
    """Config 2-unet's denoiser (arch unet, asking for a cosine lr) through
    train-diff -> sample on a tiny experiment: the trainer keeps the
    reference's constant lr and logs it."""
    d = tmp_path / "u"
    _cli("init-experiment", d, "--data", "analytic:sphere", "--scenes", 2,
         *TINY, "--set", "ad.decoder.latent_size=32",
         "--set", "ad.decoder.hidden_dim=64",
         "--set", "diff.denoiser.latent_size=32",
         "--set", "diff.denoiser.arch=unet",
         "--set", "diff.lr_schedule=cosine", "--set", "diff.warmup_steps=20")
    _cli("train-ad", d)
    _cli("train-diff", d)
    recs = [json.loads(x) for x in (d / "logs" / "train_diff.jsonl")
            .read_text().splitlines()]
    assert [r["used"] for r in recs if r["event"] == "lr_schedule"] == [
        "constant"]
    _, state, _ = tpipe.load_diff_state(d, device="cpu")
    assert state.step == 100 and state.model.body.head.weight.any()
    _cli("sample", d, "--num", 2, "--res", 24)
    assert len(list((d / "samples").glob("sample_*.obj"))) == 2


def test_cli_serve_daemon(exp, tmp_path):
    q, out = tmp_path / "q", tmp_path / "out"
    q.mkdir()
    _, ad = tpipe.load_ad_state(exp, device="cpu")
    np.save(q / "a.npy", ad.codes.detach().numpy()[0])
    _cli("serve-daemon", exp, "--in", q, "--out", out, "--res", 64,
         "--poll", 0.05, "--max-idle", 0.3)
    stats = json.loads((out / "a.stats.json").read_text())
    assert stats[0]["faces"] > 0 and (out / "a_000.ply").exists()


@pytest.mark.parametrize("n", [50, 10])
def test_obs_cond_batch_matches_jax(n):
    """One observation set to the conditioning batch: a subset without
    replacement (N >= npts) or with it (N < npts), as the reference
    draws it."""
    rng = np.random.default_rng(n)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    sdf = rng.normal(size=n).astype(np.float32)
    got = tpipe._obs_cond_batch(xyz, sdf, 16, 3, seed=7)
    want = jpipe._obs_cond_batch(xyz, sdf, 16, 3, seed=7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].shape == (3, 16, 3)


def test_sample_refuses_observations_without_partial_conditioning(exp):
    with pytest.raises(ValueError, match="partial_sdf_cond"):
        tpipe.run_sample(exp, num=1, obs_xyz=np.zeros((4, 3)),
                         obs_sdf=np.zeros(4), device="cpu")
