"""PyTorch port vs the JAX package: the fused train kernel's plain version
(ops/fused_train.fused_train_reference) against the Pallas kernel run in
interpret mode, the loss/gradient function built on it against
`make_pallas_ad_loss_grads`, and the fused training route against the
autograd route. JAX on the CPU; the CUDA kernels run in
tests/test_torch_gpu.py on a card.

Sizes are tests/test_fused_train.py's (S=2, P=512, L=16, H=128, three
hidden layers, skip (2,)); rate 0, since the Pallas kernel cannot drop out
in interpret mode. Tolerances: loss within 1e-4 relative, every gradient
within 1e-2 of its largest entry (both sides round activations and
gradients to bf16 at the same points; the sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.fused_train import (
    fused_train_loss_grads as jax_fused, make_pallas_ad_loss_grads)
from latent_diffusion_models_for_shape_sdfs_tpu.train import auto_decoder as jad
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    params_from_jax, params_to_jax)

torch.set_num_threads(2)


def _setup(S=2, P=512, L=16, H=128, layers=3, skip=(2,), seed=0, **dec):
    """tests/test_fused_train.py's set-up, in both packages."""
    kw = dict(num_scenes=S + 1, scenes_per_batch=S, samples_per_scene=P,
              clamp_dist=0.2, use_pallas=True)
    dkw = {**dict(latent_size=L, hidden_dim=H, num_layers=layers,
                  latent_in=skip, use_dropout=False), **dec}
    jc = jcfg.AdConfig(decoder=jcfg.DecoderConfig(**dkw), **kw)
    tc = tcfg.AdConfig(decoder=tcfg.DecoderConfig(**dkw), **kw)
    jdec = JaxDecoder(jc.decoder)
    jst = jad.init_ad_state(jc, jdec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    ids = rng.permutation(S + 1)[:S].astype(np.int32)
    xyz = rng.uniform(-1, 1, (S, P, 3)).astype(np.float32)
    sdf = (0.15 * rng.normal(size=(S, P))).astype(np.float32)
    return jc, tc, jdec, jst, ids, xyz, sdf


def _close(ours, ref, name):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    err = np.abs(ours - ref).max()
    assert err <= 1e-2 * np.abs(ref).max() + 1e-12, (name, err)


def test_reference_matches_pallas_interpret():
    jc, tc, jdec, jst, ids, xyz, sdf = _setup()
    params = jax.tree.map(np.asarray, jst.params)
    z = np.asarray(jst.codes)[ids]
    N = xyz.shape[0] * xyz.shape[1]
    l_j, dz_j, g_j = jax_fused(jdec, params, jnp.asarray(z),
                               jnp.asarray(xyz), jnp.asarray(sdf), N,
                               jc.clamp_dist, 0.0, jnp.asarray(0, jnp.int32))
    dec = SdfDecoder(tc.decoder)
    ew = precompute_eval_weights(dec, params_from_jax(params),
                                 torch.bfloat16)
    n0 = profiling.LAUNCHES.copy()
    loss, dz, grads = ft.fused_train_loss_grads(
        ew, torch.from_numpy(z), torch.from_numpy(xyz),
        torch.from_numpy(sdf), N, tc.clamp_dist, 0.0, 0)
    assert profiling.LAUNCHES == n0        # plain version on CPU
    assert abs(float(loss) - float(l_j)) <= 1e-4 * abs(float(l_j))
    _close(dz.numpy(), dz_j, "dz")
    for i, gr in enumerate(grads):
        gj = g_j[f"lin{i}"]
        assert set(gr) == set(gj), i
        _close(gr["b"].numpy(), gj["b"][0], f"lin{i}.b")
        if "w_h" in gr:
            _close(gr["w_h"].numpy(), np.asarray(gj["w_h"]).T, f"lin{i}.w_h")
        if "w_z" in gr:
            _close(gr["w_z"].numpy(), np.asarray(gj["w_z"]).T, f"lin{i}.w_z")
            _close(gr["w_x"].numpy(), np.asarray(gj["w_x"])[:3].T,
                   f"lin{i}.w_x")


def test_macs_per_point_of_the_canonical_decoder():
    """4,717,056 multiply-adds per point for the 8x512 decoder: forward
    1,573,376, dgrad 1,570,304 (hidden inputs only), wgrad 1,573,376."""
    ew = precompute_eval_weights(SdfDecoder(tcfg.DecoderConfig()),
                                 SdfDecoder(tcfg.DecoderConfig())
                                 .state_dict(), torch.bfloat16)
    assert ft.macs_per_point(ew) == 2 * 1_573_376 + 1_570_304


@pytest.mark.parametrize("epoch", [0.0, 50.0])
def test_loss_grads_match_make_pallas_ad_loss_grads(epoch):
    """Parameter gradients (v, g, b, through the weight-norm fold) and the
    dense code gradient (dz rows scattered, code_reg added) against JAX;
    untouched rows exactly 0."""
    jc, tc, jdec, jst, ids, xyz, sdf = _setup()
    (loss_j, aux_j), (gp_j, gc_j) = make_pallas_ad_loss_grads(jdec, jc)(
        jst.params, jst.codes, jnp.asarray(ids), jnp.asarray(xyz),
        jnp.asarray(sdf), jnp.asarray(epoch), jax.random.PRNGKey(3))
    st = tad.init_ad_state(tc, device="cpu",
                           params=params_from_jax(jax.tree.map(
                               np.asarray, jst.params)),
                           codes=np.array(jst.codes))
    vng = ft.make_fused_ad_loss_grads(st.decoder, tc)
    loss, aux = vng(st.codes, torch.from_numpy(ids.astype(np.int64)),
                    torch.from_numpy(xyz), torch.from_numpy(sdf), epoch, 3)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-4)
    assert float(aux["loss_reg"]) == pytest.approx(float(aux_j["loss_reg"]),
                                                   rel=1e-5, abs=1e-12)
    grads = params_to_jax({k: p.grad for k, p in
                           st.decoder.named_parameters()})
    for name, layer in grads.items():
        for k, a in layer.items():
            _close(a, gp_j[name][k], f"{name}.{k}")
    gc = st.codes.grad.numpy()
    _close(gc, gc_j, "codes")
    untouched = sorted(set(range(tc.num_scenes)) - set(ids.tolist()))
    assert untouched and np.all(gc[untouched] == 0.0)
    assert np.all(np.asarray(gc_j)[untouched] == 0.0)


def test_repeated_scene_ids_accumulate():
    """A padded batch repeats a scene: its dz rows add up (index_add_)."""
    jc, tc, jdec, jst, _, xyz, sdf = _setup()
    st = tad.init_ad_state(tc, device="cpu",
                           params=params_from_jax(jax.tree.map(
                               np.asarray, jst.params)),
                           codes=np.array(jst.codes))
    vng = ft.make_fused_ad_loss_grads(st.decoder, tc)
    vng(st.codes, torch.tensor([1, 1]), torch.from_numpy(xyz),
        torch.from_numpy(sdf), 0.0, 0)
    ew = precompute_eval_weights(st.decoder, dict(
        st.decoder.named_parameters()), torch.bfloat16)
    _, dz, _ = ft.fused_train_reference(
        ew, st.codes.detach()[[1, 1]], torch.from_numpy(xyz),
        torch.from_numpy(sdf), xyz.shape[0] * xyz.shape[1], tc.clamp_dist,
        0.0, 0)
    torch.testing.assert_close(st.codes.grad[1], dz.sum(0))
    assert torch.all(st.codes.grad[[0, 2]] == 0)


@pytest.mark.parametrize("dropout", [False, True])
def test_fused_route_tracks_autograd_route(dropout):
    """5 steps: the fused route against the autograd route
    (tests/test_fused_train.py:135-152's check, corrcoef of the codes >
    0.99). With dropout on, both draw the same Philox mask (the autograd
    route through the relu+dropout kernel's plain version), so the losses
    agree to bf16 noise too."""
    extra = (dict(use_dropout=True, dropout_prob=0.2, dropout_impl="pallas",
                  compute_dtype="bfloat16") if dropout else {})
    jc, tc, jdec, jst, ids, xyz, sdf = _setup(**extra)
    tc_auto = tcfg.AdConfig(**{**tc.__dict__, "use_pallas": False})
    states = [tad.init_ad_state(c, device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jst.params)), codes=np.array(jst.codes))
        for c in (tc, tc_auto)]
    steps = [tad.make_ad_train_step(s.decoder, c)
             for s, c in zip(states, (tc, tc_auto))]
    t_ids = torch.from_numpy(ids.astype(np.int64))
    for i in range(5):
        m = [step(s, t_ids, torch.from_numpy(xyz), torch.from_numpy(sdf),
                  float(i), 1000 + i) for step, s in zip(steps, states)]
        assert abs(float(m[0]["loss"]) - float(m[1]["loss"])) < 5e-3
    a, b = (s.codes.detach().numpy().ravel() for s in states)
    assert np.corrcoef(a, b)[0, 1] > 0.99
