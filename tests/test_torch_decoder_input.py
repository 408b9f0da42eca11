"""ops.decoder_input: the bf16 decoder's input and skip operands written
from per-scene codes z [S, L] and points xyz [S, P, 3], and the decoder's
per-scene form that takes them.

(a) The decoder given z [S, L] and xyz [S, P, 3] equals the decoder given
the flat inputs (z expanded over each scene's points), bit for bit in the
forward and every gradient, on every route the CPU runs: there it expands
z itself, the padded layout asked for on the CPU too, and launches
nothing. (b) The functions refuse what the kernels cannot take, the CPU
among it. (c) `make_ad_train_step` steps per scene equal the flat entry
they replaced. The kernels, the card's route through them and a bank
step against the flat entry are held in tests/test_torch_gpu.py. No
JAX."""

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import losses
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.models.latent_table import (
    gather_codes)
from latent_diffusion_models_for_shape_sdfs_torch.ops import bf16_linear as bl
from latent_diffusion_models_for_shape_sdfs_torch.ops import (
    decoder_input as di)
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

torch.set_num_threads(2)

BF = torch.bfloat16

# decoder plans (latent 13 + xyz 3 = 16 inputs; hidden 40, skip at 2)
ROUTES = {
    "bf16_kernel_dropout": dict(compute_dtype="bfloat16",
                                dropout_impl="pallas"),
    "bf16_eval": dict(compute_dtype="bfloat16", dropout_impl="pallas"),
    "fp32": dict(dropout_impl="pallas"),
    "xla_dropout": dict(compute_dtype="bfloat16", dropout_impl="xla"),
    "latent_dropout": dict(compute_dtype="bfloat16", dropout_impl="pallas",
                           latent_dropout=True),
    "xyz_in_all": dict(compute_dtype="bfloat16", dropout_impl="pallas",
                       latent_in=(), xyz_in_all=True),
}


def _decoder(**kw) -> SdfDecoder:
    cfg = dict(latent_size=13, hidden_dim=40, num_layers=4, latent_in=(2,),
               dropout_prob=0.2)
    torch.manual_seed(3)
    return SdfDecoder(tcfg.DecoderConfig(**{**cfg, **kw}))


def _inputs(S, P, L, seed=0):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy((0.3 * rng.normal(size=(S, L))).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(S, P)).astype(np.float32))
    return z, xyz, g


def _run(dec, z0, xyz, g, seed, flat: bool):
    """pred and every gradient (the decoder's parameters, and z's) of
    sum(pred g), z per scene or expanded to the flat form."""
    dec.zero_grad(set_to_none=True)
    z = z0.clone().requires_grad_()
    S, P = xyz.shape[:2]
    if flat:
        zf = z[:, None, :].expand(S, P, z.shape[1]).reshape(S * P, -1)
        pred = dec(zf, xyz.reshape(-1, 3), seed=seed).reshape(S, P)
    else:
        pred = dec(z, xyz, seed=seed)
    (pred * g).sum().backward()
    grads = {k: p.grad for k, p in dec.named_parameters()}
    grads["z"] = z.grad
    return pred.detach(), grads


# --------------------------- (a) the per-scene form on the CPU's routes

@pytest.mark.parametrize("S,P", [(3, 37), (1, 5)])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_per_scene_decoder_is_the_flat_decoder_bit_for_bit(route, S, P):
    """z [S, L], xyz [S, P, 3] -> pred [S, P] equal to the flat form's,
    and every gradient bit for bit; the CPU launches nothing."""
    dec = _decoder(**ROUTES[route])
    dec.train(route != "bf16_eval")
    z, xyz, g = _inputs(S, P, 13)
    n0 = profiling.LAUNCHES.copy()
    p1, g1 = _run(dec, z, xyz, g, 11, flat=False)
    p2, g2 = _run(dec, z, xyz, g, 11, flat=True)
    assert p1.shape == (S, P) and torch.equal(p1, p2)
    assert g1.keys() == g2.keys()
    for k in g2:
        assert torch.equal(g1[k], g2[k]), k
    assert profiling.LAUNCHES == n0


@pytest.mark.parametrize("route", ["bf16_kernel_dropout", "bf16_eval",
                                   "xla_dropout", "latent_dropout",
                                   "xyz_in_all"])
def test_cpu_padded_layout_expands_the_codes(route, monkeypatch):
    """With the padded layout asked for on the CPU (`pads` on, as the
    layout's own tests ask for it), the per-scene form still expands z:
    bit for bit the flat padded form, and neither function is called (the
    kernels run on the card alone)."""
    dec = _decoder(**ROUTES[route]).train(route != "bf16_eval")
    z, xyz, g = _inputs(2, 21, 13, seed=7)
    monkeypatch.setattr(bl, "pads", lambda t: True)
    for name in ("decoder_input", "skip_input"):
        monkeypatch.setattr(di, name, lambda *a: pytest.fail("called"))
    p1, g1 = _run(dec, z, xyz, g, 4, flat=False)
    p2, g2 = _run(dec, z, xyz, g, 4, flat=True)
    assert torch.equal(p1, p2)
    assert all(torch.equal(g1[k], g2[k]) for k in g2)


# ---------------------------------------------- (b) the refusals

def _refusal(case):
    """(call, the error's pattern) of one refusal, on CPU tensors."""
    z, xyz, _ = _inputs(2, 5, 13)
    xg = xyz.clone().requires_grad_()
    x = torch.zeros(10, 16, dtype=BF)
    return {
        "xyz_grad": (lambda: di.decoder_input(z, xg),
                     "xyz asks for a gradient"),
        "xyz_grad_skip": (lambda: di.skip_input(x, z, xg),
                          "xyz asks for a gradient"),
        "flat_xyz": (lambda: di.decoder_input(z, xyz.reshape(10, 3)),
                     "wants"),
        "scenes_differ": (lambda: di.decoder_input(z[:1], xyz), "wants"),
        "cpu": (lambda: di.decoder_input(z, xyz), "kernels take"),
        "cpu_skip": (lambda: di.skip_input(x, z, xyz), "kernels take"),
        "fp64_codes": (lambda: di.decoder_input(z.double(), xyz),
                       "kernels take"),
    }[case]


@pytest.mark.parametrize("case", ["xyz_grad", "xyz_grad_skip", "flat_xyz",
                                  "scenes_differ", "cpu", "cpu_skip",
                                  "fp64_codes"])
def test_functions_refuse_what_they_cannot_take(case):
    """xyz asking for a gradient, shapes that are not [S, L] /
    [S, P, 3], and operands the kernels do not take (any CPU tensor,
    codes other than fp32) raise ValueError before any launch."""
    call, pattern = _refusal(case)
    n0 = profiling.LAUNCHES.copy()
    with pytest.raises(ValueError, match=pattern):
        call()
    assert profiling.LAUNCHES == n0


# ------------------------------ (c) the training step per scene

def _ad_cfg(**kw):
    dec = dict(latent_size=13, hidden_dim=40, num_layers=4, latent_in=(2,),
               compute_dtype="bfloat16", dropout_prob=0.2,
               dropout_impl="pallas")
    return tcfg.AdConfig(decoder=tcfg.DecoderConfig(**{**dec, **kw}),
                         num_scenes=5, scenes_per_batch=3,
                         samples_per_scene=48, clamp_dist=0.5)


def _flat_step(cfg, st, ids, xyz, sdf, epoch, seed):
    """The step as make_ad_train_step took it with flat inputs: z gathered,
    expanded over the points and reshaped, then the loss, autograd, the
    lr and Adam."""
    st.decoder.train()
    st.optimizer.zero_grad(set_to_none=True)
    z = gather_codes(st.codes, ids, cfg.code_bound)
    L = z.shape[-1]
    flat_z = z[:, None, :].expand(z.shape[0], xyz.shape[1], L)
    pred = st.decoder(flat_z.reshape(-1, L), xyz.reshape(-1, 3), seed=seed)
    l1 = losses.clamped_l1(pred, sdf.reshape(-1), cfg.clamp_dist,
                           sdf.numel())
    reg = losses.code_reg(z, epoch, cfg.code_reg_lambda,
                          cfg.code_reg_warmup_epochs,
                          num_sdf_samples=z.shape[0],
                          squared=cfg.code_reg_squared)
    (l1 + reg).backward()
    groups = st.optimizer.param_groups
    groups[0]["lr"] = tad.step_lr(cfg.lr_decoder, epoch, cfg.lr_decay_factor,
                                  cfg.lr_decay_interval)
    groups[1]["lr"] = tad.step_lr(cfg.lr_latent, epoch, cfg.lr_decay_factor,
                                  cfg.lr_decay_interval)
    st.optimizer.step()
    return float((l1 + reg).detach())


STEP_ROUTES = {"bf16": {}, "fp32": {"compute_dtype": "float32"},
               "xla_dropout": {"dropout_impl": "xla"},
               "latent_dropout": {"latent_dropout": True}}


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("route", sorted(STEP_ROUTES))
def test_train_step_per_scene_equals_the_flat_entry(route, padded,
                                                    monkeypatch):
    """Two make_ad_train_step steps (the decoder called per scene) against
    the same steps through the flat entry they replaced, on the CPU's
    layout and on the padded one asked for on the CPU: the losses, the
    gradients and the state after (parameters, codes) bit for bit."""
    monkeypatch.setattr(bl, "pads", lambda t: padded)
    cfg = _ad_cfg(**STEP_ROUTES[route])
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(2):
        ids = torch.from_numpy(rng.permutation(cfg.num_scenes)[:3])
        xyz = torch.from_numpy(rng.uniform(-1, 1, (3, 48, 3)).astype(
            np.float32))
        sdf = torch.from_numpy((0.3 * rng.normal(size=(3, 48))).astype(
            np.float32))
        batches.append((ids, xyz, sdf))
    out = []
    for flat in (False, True):
        st = tad.init_ad_state(cfg, seed=2, device="cpu")
        step = tad.make_ad_train_step(st.decoder, cfg)
        ls = [(_flat_step(cfg, st, *b, 1.0, 30 + i) if flat
               else float(step(st, *b, 1.0, 30 + i)["loss"]))
              for i, b in enumerate(batches)]
        grads = {k: p.grad for k, p in st.decoder.named_parameters()}
        grads["codes"] = st.codes.grad
        after = dict(st.decoder.state_dict(), codes=st.codes.detach())
        out.append((ls, grads, after))
    (l1, g1, a1), (l2, g2, a2) = out
    assert l1 == l2
    assert all(torch.equal(g1[k], g2[k]) for k in g2)
    assert all(torch.equal(a1[k], a2[k]) for k in a2)
