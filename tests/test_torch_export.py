"""PyTorch port vs the JAX package: the serving artifacts
(export_artifact: the decode and sampler programs, their loaders, the
`export-decoder` / `export-sampler` CLI verbs) and the custom op
`sdfldm::fused_eval` on the CPU.

The decode artifact is held bit for bit against JAX's artifact of the
snapped Chebyshev cube of tests/test_torch_serve.py (an SDF both
frameworks evaluate exactly): payload, grid and mesh, meta.json, the
overflow and its truncated grid. Through make_kernel_apply on the CPU
(bf16 fast_apply of a 4x64 decoder through params_from_jax) the artifact
equals the port's live decode bit for bit. The sampler artifact equals
the port's live sampler bit for bit, and JAX's sampler artifact within
tests/test_torch_diffusion.py's 1e-4 from the same z_T."""

import io
import json
import pathlib
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import export_artifact as jea
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule)
from latent_diffusion_models_for_shape_sdfs_tpu.diffusion import (
    sampler as jsampler)
from latent_diffusion_models_for_shape_sdfs_tpu.models import denoiser as jden
from latent_diffusion_models_for_shape_sdfs_torch import cli
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import export_artifact as ea
from latent_diffusion_models_for_shape_sdfs_torch import pipeline as tpipe
from latent_diffusion_models_for_shape_sdfs_torch.diffusion import sampler
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models import denoiser
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import cuda_kernels as ck
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply)
from latent_diffusion_models_for_shape_sdfs_torch.serve import serve_meshes
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    denoiser_params_from_jax, denoiser_params_to_jax, params_from_jax,
    params_to_jax)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CAPS = (64, 1024, 4096)
Z = np.asarray([0.7, 0.0], np.float32)
BIG = np.asarray([1.0, 0.0], np.float32)      # overflows (8, 64, 256)
SMALL_CAPS = (8, 64, 256)


def jax_cube(z, xyz):
    q = jnp.abs(jnp.round(xyz * 256.0))
    return jnp.max(q, axis=-1) / 256.0 - (0.35 + 0.1 * z[0])


def torch_cube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


def torch_sphere(z, xyz):
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1)) - (0.3 + 0.1 * z[0])


def _export(fn, caps=CAPS, **kw):
    return ea.export_decode_program(fn, 2, 64, caps, device="cpu", **kw)


@pytest.fixture(scope="module")
def cube_artifacts(tmp_path_factory):
    """(the port's artifact, JAX's, the port's zip on disk and its bytes)."""
    path = tmp_path_factory.mktemp("dec") / "dec.zip"
    blob = _export(torch_cube, path=path)
    return (ea.load_decode_program(path),
            jea.load_decode_program(jea.export_decode_program(
                jax_cube, 2, 64, CAPS)), path, blob)


def test_decode_artifact_matches_jax_and_live(cube_artifacts):
    """Payload, grid and mesh bit for bit: the port's artifact, JAX's
    artifact, and the port's live decode and serve_meshes; meta.json
    keys and values equal JAX's."""
    art, jart, path, blob = cube_artifacts
    got = [t.numpy() for t in art.payload(Z)]
    want = [np.asarray(a) for a in jart.payload(jnp.asarray(Z))]
    live, st = tge.decode_grid_hierarchical3_sparse2(
        torch_cube, torch.from_numpy(Z), 64, 16, 4, 2, *CAPS, safety=1.2,
        safety3=2.0, out_dtype="int8")
    for a, b, c in zip(got, want, [t.numpy() for t in live]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert [int(x) for x in got[5:]] == [
        st["active_l1"], st["active_l2"], st["active_l3"]]
    np.testing.assert_array_equal(art.grid(Z), jart.grid(Z))
    v, f = art.mesh(Z)
    vj, fj = jart.mesh(Z)
    (vl, fl, _), = list(serve_meshes(torch_cube, [Z], res=64, caps=CAPS,
                                     device="cpu"))
    assert len(f) > 1000
    for a, b, c in ((v, vj, vl), (f, fj, fl)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert art.meta == jart.meta
    assert art.meta["platforms"] == ["cpu"]
    assert path.read_bytes() == blob
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "program.bin"]
        assert json.loads(zf.read("meta.json")) == jart.meta


def test_decode_artifact_overflow_raises_or_truncates():
    art = ea.load_decode_program(_export(torch_cube, caps=SMALL_CAPS))
    jart = jea.load_decode_program(jea.export_decode_program(
        jax_cube, 2, 64, SMALL_CAPS))
    with pytest.raises(ea.CapacityExceeded, match="overflows"):
        art.grid(BIG)
    with pytest.raises(ea.CapacityExceeded):
        art.mesh(BIG)
    g = art.grid(BIG, check_capacity=False)
    assert g.shape == (64, 64, 64)
    np.testing.assert_array_equal(g, jart.grid(BIG, check_capacity=False))


def test_int4_artifact_roundtrip():
    """The bandwidth-mode payload (tests/test_export_artifact.py's
    test_int4_artifact_roundtrip): meta carries the quant scale, the mesh
    dequantizes the packed nibbles."""
    art = ea.load_decode_program(_export(torch_sphere, out_dtype="int4"))
    assert art.meta["quant_scale"] is not None
    v, f = art.mesh(Z)
    r = np.linalg.norm(v, axis=1)
    assert len(f) > 500 and np.abs(r - 0.37).max() < 0.05


def test_platforms_other_than_the_trace_device_raise():
    with pytest.raises(ValueError, match="'tpu'"):
        _export(torch_cube, platforms=("tpu",))


def _kernel_apply():
    """make_kernel_apply on the CPU for a 4x64 decoder whose weights come
    through params_from_jax from a tree in JAX's layout."""
    cfg = tcfg.DecoderConfig(latent_size=16, hidden_dim=64, num_layers=4,
                             latent_in=(2,), use_dropout=False)
    torch.manual_seed(3)
    tree = params_to_jax(SdfDecoder(cfg).state_dict())
    return ck.make_kernel_apply(SdfDecoder(cfg), params_from_jax(tree),
                                device="cpu")


def test_decode_artifact_through_kernel_apply_equals_live():
    """A decoder's artifact (make_kernel_apply on the CPU: weights folded
    into the program's constants) equals the live decode bit for bit."""
    apply = _kernel_apply()
    z = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, 16).astype(np.float32))
    art = ea.load_decode_program(ea.export_decode_program(
        apply, 16, 32, CAPS, device="cpu"))
    live, *counts = tge._decode_grid_hier3_impl(
        apply, z, 32, 16, 4, 2, *CAPS, safety=1.2, safety3=2.0,
        out_dtype="int8")
    got = art.payload(z)
    for a, b in zip(got, [*live, *counts]):
        assert torch.equal(a, b)
    assert int(got[6]) > 0


_LOADER = """
import sys
import numpy as np
from latent_diffusion_models_for_shape_sdfs_torch.export_artifact import (
    load_decode_program)
art = load_decode_program(sys.argv[1])
v, f = art.mesh(np.asarray([0.7, 0.0], np.float32))
np.savez(sys.argv[2], v=v, f=f)
bad = [m for m in sys.modules if m.startswith("jax")
       or m.startswith("latent_diffusion_models_for_shape_sdfs_tpu")
       or ".models" in m]
assert not bad, bad
"""


def test_decode_artifact_loads_without_model_code(cube_artifacts, tmp_path):
    """A fresh process that imports only export_artifact loads and meshes
    the artifact: no module of models/, no JAX."""
    art, _, path, _ = cube_artifacts
    subprocess.run([sys.executable, "-c", _LOADER, str(path),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO,
                   env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    out = np.load(tmp_path / "out.npz")
    v, f = art.mesh(Z)
    np.testing.assert_array_equal(out["v"], v)
    np.testing.assert_array_equal(out["f"], f)


def test_fused_eval_op_on_the_cpu_is_the_plain_version():
    """sdfldm::fused_eval on CPU tensors: the plain version on the packed
    operands (the slab stream read back), equal to fast_apply."""
    apply = _kernel_apply()
    w, meta = ck.pack_weights(apply.ew)
    z = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.1, 16).astype(np.float32))
    xyz = torch.rand(777, 3) * 2 - 1
    rows = ck.hoisted_rows(apply.ew, meta, z)
    got = torch.ops.sdfldm.fused_eval(xyz, w, rows, torch.from_numpy(meta),
                                      False)
    torch.testing.assert_close(got, fast_apply(apply.ew, z, xyz),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="rows must be"):
        torch.ops.sdfldm.fused_eval(xyz, w, rows[:-1],
                                    torch.from_numpy(meta), False)


# ------------------------------------------------------------- the sampler

DEN = dict(arch="mlp", latent_size=16, hidden_dim=32, num_blocks=1,
           time_embed_dim=16, num_classes=5)
B, L, T = 4, 16, 50


@pytest.fixture(scope="module")
def guided():
    """A class-conditioned guided denoiser in both packages (CFG 2.0,
    torch's init with seeded noise, carried to flax's tree), on the exact
    denoiser of N(0, I) data as tests/test_torch_diffusion.py rides it, so
    latents stay O(1)."""
    jm = jden.CondDenoiser(jcfg.DenoiserConfig(**DEN))
    torch.manual_seed(0)
    tm = denoiser.CondDenoiser(tcfg.DenoiserConfig(**DEN)).eval()
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), denoiser_params_to_jax(tm.state_dict()))
    tm.load_state_dict(denoiser_params_from_jax(params))
    cid = rng.integers(0, 5, B).astype(np.int32)
    jg = jsampler.guided_denoise_fn(jm.apply, params, 2.0,
                                    class_id=jnp.asarray(cid))
    tg = sampler.guided_denoise_fn(tm, 2.0, class_id=torch.from_numpy(cid))
    js, ts = JaxSchedule.create(T), DiffusionSchedule.create(T, device="cpu")

    def jfn(z, t):
        return jnp.sqrt(1 - js.alpha_bars[t])[:, None] * z + 0.2 * jg(z, t)

    def tfn(z, t):
        a = ts.alpha_bars[t.long()][:, None]
        return torch.sqrt(1 - a) * z + 0.2 * tg(z, t)

    return jfn, js, tfn, ts


MU = np.full((L,), 0.5, np.float32)
SIGMA = np.full((L,), 2.0, np.float32)


@pytest.mark.parametrize("name, steps", [("ddim", 10), ("dpm", 6)])
def test_sampler_artifact_matches_live_and_jax(guided, name, steps,
                                               tmp_path):
    jfn, js, tfn, ts = guided
    path = tmp_path / f"{name}.zip"
    blob = ea.export_sampler_program(tfn, ts, B, L, steps=steps,
                                     sampler=name, mu=MU, sigma=SIGMA,
                                     path=path)
    art = ea.load_sampler_program(path)
    jart = jea.load_sampler_program(jea.export_sampler_program(
        jfn, js, B, L, steps=steps, sampler=name, mu=MU, sigma=SIGMA))
    assert path.read_bytes() == blob
    assert art.meta == jart.meta
    z_T = np.random.default_rng(3).standard_normal((B, L)).astype(
        np.float32)
    out = art.sample(z_T)
    live_fn = {"ddim": sampler.ddim_sample,
               "dpm": sampler.dpm_solver_sample}[name]
    live = live_fn(tfn, ts, None, B, L, steps=steps,
                   z_init=torch.from_numpy(z_T))
    np.testing.assert_array_equal(
        out, (live * torch.from_numpy(SIGMA) + torch.from_numpy(MU)).numpy())
    want = jart.sample(z_T)
    assert 0.5 < np.abs((want - MU) / SIGMA).max() < 10
    np.testing.assert_allclose(out, want, atol=1e-4 * SIGMA[0], rtol=0)
    # the host draw is JAX's: sample_seed(7) == sample of that z_T
    z7 = np.random.default_rng(7).standard_normal((B, L)).astype(np.float32)
    np.testing.assert_array_equal(art.sample_seed(7), art.sample(z7))
    np.testing.assert_allclose(art.sample_seed(7), jart.sample_seed(7),
                               atol=1e-4 * SIGMA[0], rtol=0)
    with pytest.raises(ValueError, match="z_T shape"):
        art.sample(np.zeros((2, L), np.float32))


def test_sampler_traces_without_reading_the_device():
    """The timesteps are host integers: ddim/dpm export with no
    data-dependent read (no aten._local_scalar_dense in the graph), the
    denoiser sees ddim_timesteps in order, and the program equals the
    eager sampler bit for bit."""
    sched = DiffusionSchedule.create(T, device="cpu")
    w = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, (L, L)).astype(np.float32))
    for fn_, steps in ((sampler.ddim_sample, 10),
                       (sampler.dpm_solver_sample, 6)):
        seen = []

        def denoise(z, t):
            seen.append(t)
            return z @ w + 0.01 * t[:, None].float()

        z_T = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, L)).astype(np.float32))
        eager = fn_(denoise, sched, None, B, L, steps=steps, z_init=z_T)
        assert [int(t[0]) for t in seen] == \
            sampler.ddim_timesteps(T, steps).tolist()[::-1]
        ep = torch.export.export(ea._Program(
            lambda z: fn_(denoise, sched, None, B, L, steps=steps,
                          z_init=z)), (z_T,), strict=False)
        ops = {str(n.target) for n in ep.graph.nodes}
        assert not any("local_scalar_dense" in o or "aten.item" in o
                       for o in ops), ops
        assert torch.equal(ep.module()(z_T), eager)


# ------------------------------------------------------------------ the CLI

TINY = [
    "--set", "ad.decoder.latent_size=8", "--set", "ad.decoder.hidden_dim=32",
    "--set", "ad.decoder.num_layers=3", "--set", "ad.decoder.latent_in=[2]",
    "--set", "ad.decoder.use_dropout=false",
    "--set", "ad.scenes_per_batch=2", "--set", "ad.samples_per_scene=512",
    "--set", "ad.num_epochs=20", "--set", "ad.clamp_dist=0.5",
    "--set", "ad.snapshot_every=20",
    "--set", "diff.denoiser.latent_size=8",
    "--set", "diff.denoiser.hidden_dim=32",
    "--set", "diff.denoiser.num_blocks=1",
    "--set", "diff.denoiser.time_embed_dim=16",
    "--set", "diff.denoiser.num_classes=2",
    "--set", "diff.timesteps=50", "--set", "diff.batch_size=8",
    "--set", "diff.num_steps=50", "--set", "diff.scan_chunk=50",
    "--set", "diff.snapshot_every=50",
]


def _cli(*args):
    cli.main(["--device", "cpu", *map(str, args)])


def test_cli_export_verbs_end_to_end(tmp_path):
    """init -> train-ad -> train-diff, then export-decoder and
    export-sampler write zips of meta.json + program.bin that reload
    without model code and equal the live decode and sampler."""
    d = tmp_path / "exp"
    _cli("init-experiment", d, "--data", "analytic:sphere", "--scenes", 2,
         *TINY)
    _cli("train-ad", d)
    _cli("train-diff", d)
    _cli("export-decoder", d, "--res", 32)
    _cli("export-sampler", d, "--num", 4, "--steps", 6, "--sampler", "dpm",
         "--class-id", 1, "--out", d / "s.zip")
    with pytest.raises(ValueError, match="'tpu'"):
        _cli("export-decoder", d, "--res", 32, "--platforms", "tpu")
    for name in ("decoder_32.zip", "s.zip"):
        with zipfile.ZipFile(d / name) as zf:
            assert sorted(zf.namelist()) == ["meta.json", "program.bin"]

    dec = ea.load_decode_program(d / "decoder_32.zip")
    assert dec.meta["res"] == 32 and dec.meta["platforms"] == ["cpu"]
    decoder, ad = tpipe.load_ad_state(d, device="cpu")
    apply = ck.make_kernel_apply(decoder, tpipe.decoder_params(ad),
                                 device="cpu")
    z = ad.codes[0].detach()
    live, *counts = tge._decode_grid_hier3_impl(
        apply, z, 32, 16, 4, 2,
        *(dec.meta[k] for k in ("cap1", "cap2", "cap3")), safety=1.2,
        safety3=2.0, out_dtype="int8")
    for a, b in zip(dec.payload(z), [*live, *counts]):
        assert torch.equal(a, b)

    smp = ea.load_sampler_program(d / "s.zip")
    assert smp.meta["sampler"] == "dpm" and smp.meta["num"] == 4
    assert smp.meta["unnormalized"]
    model, ds, (mu, sigma) = tpipe.load_diff_state(d, device="cpu")
    model.load_state_dict(ds.ema)
    model.eval()
    cfg = tcfg.ExperimentConfig.load(d)
    fn = sampler.guided_denoise_fn(model, cfg.sample.guidance_scale,
                                   class_id=torch.full((4,), 1))
    sched = DiffusionSchedule.create(cfg.diff.timesteps, cfg.diff.beta_start,
                                     cfg.diff.beta_end, device="cpu")
    z_T = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    live_z = sampler.dpm_solver_sample(fn, sched, None, 4, 8, steps=6,
                                       z_init=torch.from_numpy(z_T))
    np.testing.assert_array_equal(smp.sample(z_T),
                                  (live_z * sigma + mu).numpy())
