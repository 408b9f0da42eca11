"""PyTorch port vs the JAX package: sphere-traced rendering (ops.render),
PNG IO (utils.image), latent interpolation and the `render` /
`interpolate` verbs (pipeline.run_render, run_interpolate, cli).

Rays and their sphere entries agree to float32 rounding. Renders are held
against JAX's on the same analytic SDF and on the same small random
decoder (both packages' bf16 plain evaluation), at 64^2: XLA and torch sum
in another order, so a ray that grazes the surface may hit in one and
miss in the other. Hit masks must be equal outside the band of rays whose
hit flips when the SDF is offset by +-1e-3 (a band kept under 15% of the
image), and rgb within one level wherever both hit outside it; on the
decoder, whose field is not metric, a ray may stop on another part of
the surface, so 0.5% of the image may differ more. PNG bytes
are equal. The pipeline and CLI run on a port experiment holding the
decoder's weights, JAX's on the same weights."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import cli as jcli
from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu import pipeline as jpipe
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops import render as jr
from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_decoder import (
    make_fast_apply as jax_fast_apply)
from latent_diffusion_models_for_shape_sdfs_tpu.train.auto_decoder import (
    AdTrainState as JaxAdState)
from latent_diffusion_models_for_shape_sdfs_tpu.utils import image as jimg
from latent_diffusion_models_for_shape_sdfs_torch import cli
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import pipeline as tpipe
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    chamfer_l2)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import render as tr
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply)
from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
    init_ad_state)
from latent_diffusion_models_for_shape_sdfs_torch.utils import image as timg
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    StageCheckpointer, ad_state_tree, params_from_jax)

torch.set_num_threads(2)

OFFSET = 1e-3       # SDF offset that marks the band of grazing rays


def jsphere(r=0.4, c=(0.0, 0.0, 0.0)):
    cj = jnp.asarray(c, jnp.float32)
    return lambda z, x: jnp.linalg.norm(x - cj, axis=-1) - r


def tsphere(r=0.4, c=(0.0, 0.0, 0.0)):
    ct = torch.tensor(c, dtype=torch.float32)
    return lambda z, x: torch.linalg.vector_norm(x - ct, dim=-1) - r


VIEWS = [dict(width=64, height=48, eye=(1.6, 1.2, 1.6), target=(0, 0, 0),
              fov_deg=40.0),
         dict(width=33, height=33, eye=(0.0, 2.0, 0.0), target=(0, 0, 0),
              fov_deg=55.0),                     # looking down the up axis
         dict(width=40, height=24, eye=(-2.3, 0.6, 0.1),
              target=(0.1, -0.1, 0.0), fov_deg=30.0)]


@pytest.mark.parametrize("view", VIEWS)
def test_camera_rays_and_sphere_entry(view):
    args = (view["width"], view["height"], view["eye"], view["target"],
            view["fov_deg"])
    jo, jd = jr.camera_rays(*args)
    to, td = tr.camera_rays(*args)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-6)
    for radius in (1.05, 0.5):
        jt = np.asarray(jr._ray_sphere_entry(jo, jd, radius))
        tt = tr._ray_sphere_entry(to, td, radius).numpy()
        np.testing.assert_array_equal(np.isinf(tt), np.isinf(jt))
        fin = np.isfinite(jt)
        np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=3e-5)


def _band(fn, z, view):
    """Rays whose hit flips when the SDF is offset by -OFFSET and by
    +OFFSET (the port's render of each): the band where the two packages'
    renders, whose SDF values differ by ~1e-6, may differ in their hits."""
    lo = tr.render_sdf(lambda zz, p: fn(zz, p) - OFFSET, z, **view)[1]
    hi = tr.render_sdf(lambda zz, p: fn(zz, p) + OFFSET, z, **view)[1]
    return lo != hi


def _assert_renders_agree(got, want, band, stray=0.0):
    """Hits equal outside the band; rgb within one level where both hit
    outside it, but for a `stray` share of the image (rays of a non-metric
    field that stop on another part of the surface); background within
    one level."""
    (rgb_t, hit_t), (rgb_j, hit_j) = got, want
    assert rgb_t.dtype == np.uint8 and rgb_t.shape == rgb_j.shape
    assert band.mean() < 0.15, band.mean()
    np.testing.assert_array_equal(hit_t[~band], hit_j[~band])
    both = hit_t & hit_j & ~band
    assert both.sum() > 50
    diff = np.abs(rgb_t.astype(int) - rgb_j.astype(int)).max(-1)
    assert (diff[both] > 1).sum() <= stray * diff.size
    assert diff[~hit_t & ~hit_j].max() <= 1          # background


@pytest.mark.parametrize("r, c", [(0.4, (0.0, 0.0, 0.0)),
                                  (0.3, (0.35, 0.1, 0.0))])
def test_render_sphere_matches_jax(r, c):
    view = dict(width=64, height=64, eye=(0.0, 0.0, 2.0))
    got = tr.render_sdf(tsphere(r, c), torch.zeros(4), **view)
    want = jr.render_sdf(jsphere(r, c), jnp.zeros(4), **view)
    _assert_renders_agree(got, want, _band(tsphere(r, c), torch.zeros(4),
                                           view))


def _stage1(scale=5.0):
    """A small random decoder (JAX init, carried across as numpy
    parameters) whose last layer is `scale`x steeper and shifted so that
    code 0's zero set crosses the unit ball."""
    jc = jcfg.DecoderConfig(latent_size=8, hidden_dim=32, num_layers=3,
                            latent_in=(2,), use_dropout=False)
    dec = JaxDecoder(jc)
    import jax
    params = jax.tree.map(np.asarray, dec.init_params(jax.random.PRNGKey(3)))
    codes = (0.3 * np.random.default_rng(2).normal(size=(3, 8))).astype(
        np.float32)
    last = params[f"lin{jc.num_layers - 1}"]
    last["g"] = (scale * last["g"]).astype(np.float32)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4096, 3)).astype(np.float32)
    pts *= 0.5 / np.linalg.norm(pts, axis=1, keepdims=True)
    med = float(np.median(np.asarray(jax_fast_apply(dec, params)(
        jnp.asarray(codes[0]), jnp.asarray(pts)))))
    last["b"] = (last["b"] - med).astype(np.float32)
    tdec = SdfDecoder(tcfg.DecoderConfig(
        latent_size=8, hidden_dim=32, num_layers=3, latent_in=(2,),
        use_dropout=False))
    return dec, params, codes, tdec, params_from_jax(params)


def test_render_decoder_matches_jax():
    dec, params, codes, tdec, sd = _stage1()
    apply_t = make_kernel_apply(tdec, sd, device="cpu")
    view = dict(width=64, height=64, eye=(1.5, 1.05, 1.5))
    got = tr.render_sdf(apply_t, torch.from_numpy(codes[0]), **view)
    want = jr.render_sdf(jax_fast_apply(dec, params), jnp.asarray(codes[0]),
                         **view)
    _assert_renders_agree(got, want, _band(
        apply_t, torch.from_numpy(codes[0]), view), stray=0.005)
    assert 0.05 < got[1].mean() < 0.95


def test_turntable_matches_jax():
    fn_t, fn_j = tsphere(0.35, (0.2, 0.0, 0.0)), jsphere(0.35, (0.2, 0.0, 0.0))
    got = tr.render_turntable(fn_t, torch.zeros(4), frames=3, width=32,
                              height=32)
    want = jr.render_turntable(fn_j, jnp.zeros(4), frames=3, width=32,
                               height=32)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        a = 2.0 * np.pi * i / 3
        view = dict(width=32, height=32,
                    eye=(2.3 * np.cos(a), 0.6, 2.3 * np.sin(a)))
        _assert_renders_agree(g, w, _band(fn_t, torch.zeros(4), view))
    assert not np.array_equal(got[0][1], got[1][1])


def test_render_runs_the_bound_evaluator():
    """With a wrapper that has `bind` (kernel #1's), every evaluation goes
    through the bound function: steps + 6 calls, no per-call latent."""
    dec, params, codes, tdec, sd = _stage1()
    apply_t = make_kernel_apply(tdec, sd, device="cpu")
    calls = []

    class Counting:
        device = torch.device("cpu")

        def bind(self, z):
            f = apply_t.bind(z)
            return lambda p: calls.append(len(p)) or f(p)

        def __call__(self, z, p):
            raise AssertionError("the march must use the bound evaluator")

    rgb, hit = tr.render_sdf(Counting(), codes[0], width=16, height=8,
                             steps=10)
    assert calls == [16 * 8] * 16
    rgb2, hit2 = tr.render_sdf(apply_t, torch.from_numpy(codes[0]),
                               width=16, height=8, steps=10)
    np.testing.assert_array_equal(rgb, rgb2)


@pytest.mark.parametrize("shape", [(7, 5, 3), (6, 9), (1, 1, 3)])
def test_png_bytes_equal_and_round_trip(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(
        0, 256, shape).astype(np.uint8)
    assert timg.png_bytes(img) == jimg.png_bytes(img)
    timg.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(timg.read_png(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(jimg.read_png(tmp_path / "a.png"), img)
    with pytest.raises(ValueError):
        timg.png_bytes(img.astype(np.float32))


# ---------------------------------------------------- pipeline and CLI


def _experiments(tmp_path, monkeypatch, **overrides):
    """A port experiment whose stage-1 checkpoint holds _stage1's weights,
    and a JAX experiment whose load_ad_state returns the same weights."""
    dec, params, codes, tdec, sd = _stage1()
    kw = {"ad.decoder.latent_size": 8, "ad.decoder.hidden_dim": 32,
          "ad.decoder.num_layers": 3, "ad.decoder.latent_in": [2],
          "ad.decoder.use_dropout": False, "ad.num_scenes": len(codes),
          **overrides}
    texp, jexp = tmp_path / "t", tmp_path / "j"
    tc = tcfg.override(tcfg.ExperimentConfig(), **kw)
    tc.save(texp)
    jcfg.override(jcfg.ExperimentConfig(), **kw).save(jexp)
    state = init_ad_state(tc.ad, SdfDecoder(tc.ad.decoder), params=sd,
                          codes=codes, device="cpu")
    StageCheckpointer(texp, "auto_decoder").save(0, ad_state_tree(state, 0))
    monkeypatch.setattr(jpipe, "load_ad_state", lambda exp_dir: (
        dec, JaxAdState(params, jnp.asarray(codes), None, None)))
    return texp, jexp, codes


def test_run_render_matches_jax(tmp_path, monkeypatch):
    texp, jexp, codes = _experiments(tmp_path, monkeypatch)
    for frames in (1, 2):
        tp = tpipe.run_render(str(texp), scene=0, size=48, frames=frames,
                              device="cpu")
        jp = jpipe.run_render(str(jexp), scene=0, size=48, frames=frames)
        assert [p.name for p in tp] == [p.name for p in jp]
        assert len(tp) == frames
        for a, b in zip(tp, jp):
            ta, ja = timg.read_png(a), timg.read_png(b)
            assert ta.shape == ja.shape == (48, 48, 3)
            # same decoder, same march: pixels differ only at grazing rays
            assert (np.abs(ta.astype(int) - ja.astype(int)).max(-1)
                    > 1).mean() < 0.02
    np.save(tmp_path / "z.npy", codes[1:3])
    tp = tpipe.run_render(str(texp), latent_file=str(tmp_path / "z.npy"),
                          name="lat", size=16, device="cpu")
    assert tp[0].name == "lat.png"
    with pytest.raises(ValueError, match="out of range"):
        tpipe.run_render(str(texp), scene=3, device="cpu")


@pytest.mark.parametrize("mode", ["lerp", "slerp"])
def test_run_interpolate_matches_jax(tmp_path, monkeypatch, mode):
    """Meshes at the same latents through both packages' decode (dense at
    32): vertex sets to (h/8)^2 in Chamfer-L2 and counts to 2%."""
    texp, jexp, codes = _experiments(tmp_path, monkeypatch,
                                     **{"sample.grid_res": 32})
    got = tpipe.run_interpolate(str(texp), 0, 1, steps=3, mode=mode,
                                device="cpu")
    want = jpipe.run_interpolate(str(jexp), 0, 1, steps=3, mode=mode)
    assert len(got) == len(want) == 3
    assert len(list((texp / "interpolations").glob("interp_*.obj"))) == 3
    h = 2.0 / 31
    for (v, f), (vj, fj) in zip(got, want):
        vj = np.asarray(vj)
        assert len(f) > 20 and abs(len(v) - len(vj)) <= 0.02 * len(vj)
        assert chamfer_l2(v, vj) < (h / 8) ** 2
    with pytest.raises(ValueError, match="mode"):
        tpipe.run_interpolate(str(texp), 0, 1, mode="cubic", device="cpu")


def test_slerp_degenerate_arc_falls_back_to_lerp(tmp_path, monkeypatch):
    """Parallel codes: slerp takes the lerp path, as the reference does."""
    texp, jexp, codes = _experiments(tmp_path, monkeypatch,
                                     **{"sample.grid_res": 24})
    tree = StageCheckpointer(texp, "auto_decoder").restore()
    tree["codes"][1] = 2.0 * tree["codes"][0]
    StageCheckpointer(texp, "auto_decoder").save(1, tree)
    seen = {}
    real = tpipe._decode_latents_to_meshes

    def spy(apply_fn, zs, *a, **k):
        seen.setdefault("zs", []).append(zs.clone())
        return real(apply_fn, zs, *a, **k)

    monkeypatch.setattr(tpipe, "_decode_latents_to_meshes", spy)
    for mode in ("slerp", "lerp"):
        tpipe.run_interpolate(str(texp), 0, 1, steps=4, mode=mode,
                              device="cpu")
    torch.testing.assert_close(seen["zs"][0], seen["zs"][1], rtol=0,
                               atol=0)


def test_cli_render_and_interpolate(tmp_path, monkeypatch):
    texp, jexp, codes = _experiments(tmp_path, monkeypatch,
                                     **{"sample.grid_res": 24})
    run = ["render", "--size", "24", "--frames", "2", "--march-steps", "40",
           "--name", "tt"]
    cli.main(["--device", "cpu", run[0], str(texp), *run[1:]])
    jcli.main([run[0], str(jexp), *run[1:]])
    for i in range(2):
        a = timg.read_png(texp / "renders" / f"tt_{i:03d}.png")
        b = timg.read_png(jexp / "renders" / f"tt_{i:03d}.png")
        assert (np.abs(a.astype(int) - b.astype(int)).max(-1)
                > 1).mean() < 0.02
    run = ["interpolate", "0", "2", "--steps", "3", "--mode", "slerp",
           "--format", "ply", "--name", "m"]
    cli.main(["--device", "cpu", run[0], str(texp), *run[1:]])
    jcli.main([run[0], str(jexp), *run[1:]])
    tfiles = sorted((texp / "interpolations").glob("m_*.ply"))
    assert [p.name for p in tfiles] == [p.name for p in sorted(
        (jexp / "interpolations").glob("m_*.ply"))]
    assert len(tfiles) == 3
    specs = json.loads((texp / "specs.json").read_text())
    assert specs["ad"]["num_scenes"] == 3
