"""The plain references against the port on tiny cases on the CPU, where
the port runs its plain versions: the numbers a run compares come out
small, and the control's (fp8 products, TF32 on the CPU is a no-op)
larger."""

import json

import pytest
import torch

from conftest import ROOT, load_cell, shrink


def _cell(cell):
    _, _, cfg, traffic = load_cell(cell)
    shrink(cell, cfg, traffic)
    return cfg, traffic


@pytest.mark.parametrize("cell", ["c3.train.bank", "c3.train.fused"])
def test_training_step_against_reference(cell):
    """At a CPU test's size (1,024 points a step, 32 wide) the program's
    first loss is the bf16 reference's to fp32 rounding and its first
    gradient lies within a percent at its worst leaf; the fp8 control's
    lies ten times farther and is not correct."""
    from benchmark.checks import judge, load_limits
    from benchmark.drivers import ad_train
    cfg, traffic = _cell(cell)
    d = ad_train.Driver(cfg, traffic, 2 ** 31 + 12345, torch.device("cpu"),
                        0.0)
    d.free()
    got = d.check()
    assert got["label_gap"] == 0.0 and got["sign_errors"] == 0
    assert got["codes_moved"] == 0
    assert got["grad_leaf_gap"] < 0.01 and got["change_leaf_gap"] < 0.01
    assert d.detail["loss_gaps"][0] < 1e-6
    assert max(d.detail["loss_gaps"]) < 2e-4
    assert all(0 <= r <= 1 + 1e-6 for r in d.detail["cancel"].values())
    ctl = d.control()
    assert ctl["grad_leaf_gap"] > 10 * got["grad_leaf_gap"]
    assert judge(ctl, load_limits(ROOT, cell))[0] is False


def test_terms_bound_their_gradient():
    """Each leaf's terms' magnitudes bound its gradient elementwise, and
    equal it where every term has one sign (the head's bias with every
    point above its label)."""
    from benchmark.drivers.ad_train import make_weights
    from benchmark.reference import decoder as ref
    from benchmark.yardstick import decoder_layers
    cfg, _ = _cell("c3.train.bank")
    ad = dict(cfg["ad"], code_reg_lambda=0.0)
    params, codes = make_weights(ad, torch.Generator().manual_seed(3), "cpu")
    S, P = ad["scenes_per_batch"], ad["samples_per_scene"]
    ids = torch.arange(S)
    xyz = torch.rand(S, P, 3) * 2 - 1
    for sdf, exact in ((torch.rand(S, P) * 0.2 - 0.1, False),
                       (torch.full((S, P), -5.0), True)):
        _, g, mag = ref.loss_and_grads(params, codes, ad, ids, xyz, sdf, 9,
                                       150.0, "fp32", 2, terms=True)
        for k in g:
            assert bool((g[k].abs() <= mag[k] * (1 + 1e-4) + 1e-9).all()), k
        if exact:
            head = f"lin{len(decoder_layers(ad['decoder'])) - 1}.b"
            assert torch.allclose(g[head].abs(), mag[head], rtol=1e-5)


def test_reference_decoder_eval_equals_port_fp32():
    """With dropout off and fp32 compute, the reference's forward is the
    port's decoder forward to fp32 rounding."""
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from benchmark.drivers.ad_train import make_weights
    from benchmark.reference import decoder as ref
    cfg, _ = _cell("c3.train.bank")
    ad = cfg["ad"]
    dec = dict(ad["decoder"], compute_dtype="float32")
    params, codes = make_weights(ad, torch.Generator().manual_seed(1), "cpu")
    m = SdfDecoder(DecoderConfig(**dict(dec, latent_in=tuple(
        dec["latent_in"])))).eval()
    m.load_state_dict(params)
    xyz = torch.rand(100, 3) * 2 - 1
    z = codes[:1].expand(100, -1)
    assert torch.allclose(m(z, xyz), ref.forward(params, dec, z, xyz, None),
                          atol=1e-6)


def test_stage2_step_against_reference(few_codes):
    from benchmark.drivers import diff_train
    cfg, traffic = _cell("c4.diff.train")
    d = diff_train.Driver(cfg, traffic, 11, torch.device("cpu"), 0.0)
    d.free()
    got = d.check()
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-4 and got["ema_gap"] < 1e-3


def test_serve_meshes_against_reference(few_codes):
    from benchmark.drivers import serve
    cfg, traffic = _cell("c4.serve.batch64")
    d = serve.Driver(cfg, traffic, 5, torch.device("cpu"), 0.0)
    d.run(0.0)
    d.free()
    got = d.check()
    # a 32^3 grid: the mesh lies within a few hundredths of the zero set
    assert 0 < got["surface_gap"] < 0.05 and got["missing"] == 0


def test_pack_reader_equals_the_ports():
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        load_stage1_pack)
    from benchmark.reference import decoder as ref
    path = ROOT / json.loads((ROOT / "benchmark/configs/"
                              "config4_conditional.json").read_text())["pack"]
    params, codes = ref.load_pack(path, "cpu")
    sd, c = load_stage1_pack(path)
    assert set(sd) == set(params)
    assert all(torch.equal(torch.as_tensor(sd[k]).float(), params[k])
               for k in sd)
    assert torch.equal(torch.from_numpy(c), codes)
