"""Tests of the port that need a CUDA card (marker `gpu`; they skip
without one). They import neither JAX nor the JAX package, so they run on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

(`--noconftest`: tests/conftest.py sets up JAX for the reference tests.)
"""

import pathlib

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_torch.config import DecoderConfig
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import chamfer_l2
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply)
from latent_diffusion_models_for_shape_sdfs_torch.serve import serve_meshes
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack)

pytestmark = pytest.mark.gpu

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "scale_chairs6k" / "stage1_pack.npz")

# the plans of tests/test_pallas_kernels.py, with torch-initialised weights
PLANS = {
    "small": dict(latent_size=16, hidden_dim=128, num_layers=3,
                  latent_in=(2,), use_dropout=False),
    "tanh": dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
                 use_tanh=True, use_dropout=False),
    "canonical": dict(use_dropout=False),
}
RD = ("relu_dropout_fwd", "relu_dropout_bwd")
BF16_ROLES = ("bf16_linear.fwd", "bf16_linear.dgrad", "bf16_linear.wgrad")
PADDED_ROLES = tuple(f"{k}.padded" for k in BF16_ROLES)
HEAD = ("head_fwd", "head_bwd")


def _since(before, names) -> dict:
    """{name: the launches of `name` counted since `before`, a copy of the
    launch record utils.profiling.LAUNCHES}."""
    return {k: profiling.LAUNCHES[k] - before[k] for k in names}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _decoder(name):
    if name == "trained":
        sd, codes = load_stage1_pack(PACK)
        return SdfDecoder(DecoderConfig()), sd, codes[11]
    torch.manual_seed(0)
    dec = SdfDecoder(DecoderConfig(**PLANS[name]))
    L = dec.cfg.latent_size
    z = np.random.default_rng(0).normal(size=L) / np.sqrt(L)
    return dec, dec.state_dict(), z.astype(np.float32)


@pytest.mark.parametrize("name", sorted(PLANS) + ["trained"])
@pytest.mark.parametrize("n", [1, 63, 64, 700, (1 << 16) + 131])
def test_kernel_matches_plain_version(name, n, cuda):
    """Kernel vs bf16 fast_apply, ragged tails included (tolerance of
    tests/test_pallas_kernels.py)."""
    dec, sd, z = _decoder(name)
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    xyz = torch.from_numpy(np.random.default_rng(n).uniform(
        -1, 1, (n, 3)).astype(np.float32)).to(cuda)
    got = apply(zt, xyz)
    torch.cuda.synchronize()
    assert apply.launches == 1 and got.shape == (n,)
    torch.testing.assert_close(got, fast_apply(apply.ew, zt, xyz),
                               atol=5e-3, rtol=0)


def test_kernel_wrapper_checks_inputs(cuda):
    dec, sd, z = _decoder("tanh")
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    with pytest.raises(ValueError, match="weights on"):
        apply(zt.cpu(), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="xyz must be"):
        apply.launch(torch.zeros(4, 4, device=cuda),
                     torch.zeros(1, device=cuda))
    with pytest.raises(ValueError, match="rows must be"):
        apply.launch(torch.zeros(4, 3, device=cuda),
                     torch.zeros(1, device=cuda))
    assert apply(zt, torch.zeros(0, 3, device=cuda)).shape == (0,)


@pytest.mark.parametrize("name", ["small", "trained"])
def test_kernel_launches_are_bit_identical(name, cuda):
    """No atomics and a fixed summation order: two launches on the same
    points and rows give the same bits."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        hoisted_rows)
    dec, sd, z = _decoder(name)
    apply = make_kernel_apply(dec, sd, device=cuda)
    rows = hoisted_rows(apply.ew, apply.meta, torch.from_numpy(z).to(cuda))
    gen = torch.Generator(device=cuda).manual_seed(0)
    xyz = torch.rand(100_003, 3, generator=gen, device=cuda) * 2 - 1
    first = apply.launch(xyz, rows)
    second = apply.launch(xyz, rows)
    torch.cuda.synchronize()
    assert apply.launches == 2 and torch.equal(first, second)


def test_kernel_serve_launch_sizes_match_plain_version(cuda):
    """One 256^3 shape's four launch sizes (serve's default caps: 4,096 +
    65,536 + 131,072 + 524,288 points), the small first launch included,
    on the trained decoder against bf16 fast_apply (5e-3)."""
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        _default_caps)
    dec, sd, z = _decoder("trained")
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    caps = _default_caps(256)
    sizes = [16 ** 3, caps[0] * 64, caps[1] * 8, caps[2] * 8]
    assert sizes == [4096, 65536, 131072, 524288]
    gen = torch.Generator(device=cuda).manual_seed(1)
    for n in sizes:
        xyz = torch.rand(n, 3, generator=gen, device=cuda) * 2 - 1
        got = apply(zt, xyz)
        torch.testing.assert_close(got, fast_apply(apply.ew, zt, xyz),
                                   atol=5e-3, rtol=0)
    assert apply.launches == 4


def test_kernel_launch_config(cuda):
    """The ring and cluster the kernel reports: 5 stages of 2 slabs in at
    most 227 KB of shared memory, clusters of 2, at least one resident."""
    dec, sd, _ = _decoder("trained")
    cfg = make_kernel_apply(dec, sd, device=cuda).config()
    assert cfg["stages"] == 5 and cfg["cluster"] == 2
    assert cfg["smem"] <= 232448 and cfg["max_clusters"] >= 1


def test_fused_eval_op_exports_and_counts_launches(cuda):
    """Kernel #1 as the op sdfldm::fused_eval under torch.export: a program
    around KernelApply.launch holds the op and equals the live launch bit
    for bit; a decode artifact equals the live decode bit for bit, and
    its launches are counted by the op (utils.profiling.LAUNCHES), not by
    the wrapper it was traced from."""
    from latent_diffusion_models_for_shape_sdfs_torch.export_artifact import (
        _Program, export_decode_program, load_decode_program)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        _decode_grid_hier3_impl)
    dec, sd, z = _decoder("small")
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    rows = ck.hoisted_rows(apply.ew, apply.meta, zt)
    xyz = torch.rand(5000, 3, device=cuda) * 2 - 1
    ep = torch.export.export(_Program(lambda x: apply.launch(x, rows)),
                             (xyz,), strict=False)
    assert any("sdfldm.fused_eval" in str(n.target) for n in ep.graph.nodes)
    n0 = profiling.LAUNCHES["fused_eval"]
    got = ep.module()(xyz)
    assert profiling.LAUNCHES["fused_eval"] == n0 + 1
    assert torch.equal(got, apply.launch(xyz, rows))

    caps = (64, 1024, 4096)
    art = load_decode_program(export_decode_program(
        apply, dec.cfg.latent_size, 64, caps, device=cuda))
    assert art.meta["platforms"] == ["cuda"]
    n0, l0 = profiling.LAUNCHES["fused_eval"], apply.launches
    got = art.payload(zt)
    torch.cuda.synchronize()
    assert profiling.LAUNCHES["fused_eval"] - n0 == 4 and apply.launches == l0
    live, *counts = _decode_grid_hier3_impl(
        apply, zt, 64, 16, 4, 2, *caps, safety=1.2, safety3=2.0,
        out_dtype="int8")
    for a, b in zip(got, [*live, *counts]):
        assert torch.equal(a, b)


def test_fused_eval_op_raises_on_malformed_operands(cuda):
    """On CUDA tensors the op launches or raises: a short rows vector, a
    layer table on the card, fp32 weights; nothing is launched."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    dec, sd, z = _decoder("tanh")
    apply = make_kernel_apply(dec, sd, device=cuda)
    rows = ck.hoisted_rows(apply.ew, apply.meta, torch.from_numpy(z).to(cuda))
    xyz = torch.rand(100, 3, device=cuda)
    n0 = profiling.LAUNCHES["fused_eval"]
    op = torch.ops.sdfldm.fused_eval
    with pytest.raises(ValueError, match="rows must be"):
        op(xyz, apply.w, rows[:-1], apply.meta_t, True)
    with pytest.raises(ValueError, match="meta must be"):
        op(xyz, apply.w, rows, apply.meta_t.to(cuda), True)
    with pytest.raises(ValueError, match="w must be"):
        op(xyz, apply.w.float(), rows, apply.meta_t, True)
    assert profiling.LAUNCHES["fused_eval"] == n0
    assert torch.equal(op(xyz, apply.w, rows, apply.meta_t, True),
                       apply.launch(xyz, rows))


def snapped_cube(z, xyz):
    """An SDF whose float32 evaluation is exact on any device."""
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


def test_serve_on_card_matches_cpu(cuda):
    """Same SDF values on both devices: the card's serve (async copies to
    pinned buffers on a second stream, event waits, escalation) yields the
    CPU serve's meshes and stats bit for bit."""
    lat = [np.asarray([0.1 * i, 0.0], np.float32) for i in range(6)]
    kw = dict(res=64, caps=(8, 64, 256), mesh_workers=3)
    on_card = list(serve_meshes(snapped_cube, lat, device=cuda, **kw))
    on_cpu = list(serve_meshes(snapped_cube, lat, device="cpu", **kw))
    for (v1, f1, s1), (v2, f2, s2) in zip(on_card, on_cpu):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(f1, f2)
        for k in ("active_l1", "active_l2", "active_l3", "escalations",
                  "payload_bytes", "mesher"):
            assert s1[k] == s2[k], k


def test_serve_through_kernel_matches_plain_version(cuda):
    """Trained chairs at 128^3 through the kernel vs through the plain
    version: the same crossings up to bf16 noise (vertex Chamfer-L2 far
    below a quarter voxel squared), 4 launches per shape."""
    dec, sd, _ = _decoder("trained")
    codes = load_stage1_pack(PACK)[1]
    lat = list(codes[[5, 3333]])
    apply = make_kernel_apply(dec, sd, device=cuda)
    got = list(serve_meshes(apply, lat, res=128, device=cuda))
    assert apply.launches >= 4 * len(lat)

    def plain(z, xyz):
        return fast_apply(apply.ew, z, xyz)

    want = list(serve_meshes(plain, lat, res=128, device=cuda))
    h = 2.0 / 127
    for (v1, f1, _), (v2, _f2, _) in zip(got, want):
        assert len(f1) > 1000
        assert chamfer_l2(v1, v2) < (h / 4) ** 2


# ---------------------------------------------- relu+dropout kernels (#3/#3b)

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1000, 253), (4096, 512), (777, 64),
                                   (3, 5)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_relu_dropout_kernels_match_plain_version(dtype, shape, rate, cuda):
    """Forward and backward kernels bit for bit equal to their plain
    versions (the same Philox mask), launched once each."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
    gen = torch.Generator(device=cuda).manual_seed(shape[0])
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    n0 = profiling.LAUNCHES.copy()
    y = rd.relu_dropout_fwd(x, 12345, rate)
    dx = rd.relu_dropout_bwd(x, g, 12345, rate)
    torch.cuda.synchronize()
    assert profiling.LAUNCHES["relu_dropout_fwd"] == n0["relu_dropout_fwd"] + 1
    assert profiling.LAUNCHES["relu_dropout_bwd"] == n0["relu_dropout_bwd"] + 1
    assert torch.equal(y, rd.relu_dropout_reference(x, 12345, rate))
    assert torch.equal(dx, rd.relu_dropout_bwd_reference(x, g, 12345, rate))


def test_relu_dropout_autograd_on_card(cuda):
    """d/dx sum(y^2) = 2 y / (1 - rate) through the backward kernel."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.relu_dropout import (
        relu_dropout)
    x = torch.randn(2048, 256, device=cuda, requires_grad=True)
    y = relu_dropout(x, 3, 0.3)
    (y ** 2).sum().backward()
    torch.testing.assert_close(x.grad, 2 * y.detach() / 0.7, rtol=1e-5,
                               atol=1e-6)
    keep = (y != 0).float().mean().item() / (x > 0).float().mean().item()
    assert abs(keep - 0.7) < 0.01


# ------------- #3/#3b's layer entries (the bf16 decoder's hidden layers)

DB_TOL = 2.0 ** -17         # db vs float64, relative to the column's sum|.|


def _layer_operands(rows, cols, cuda, offset=0):
    """yf [rows, cols] fp32 (one row in 64 zero, one NaN), b fp32, g
    bf16; `offset` > 0 starts each on an unaligned element of a larger
    buffer (the tile path's ragged spans)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + cols)

    def draw(n, dtype):
        buf = torch.randn(n + offset, generator=gen, device=cuda).to(dtype)
        return buf[offset:]

    yf = draw(rows * cols, torch.float32).view(rows, cols)
    yf[::64] = 0.0
    yf[min(5, rows - 1), :7] = float("nan")
    b = draw(cols, torch.float32)
    g = draw(rows * cols, torch.bfloat16).view(rows, cols)
    return yf, b, g


def _db_within_tol(db, gb):
    exact = gb.double().sum(0)
    return bool(((db.double() - exact).abs()
                 <= DB_TOL * gb.double().abs().sum(0)).all())


@pytest.mark.parametrize("rows,cols,offset", [
    (1 << 20, 512, 0), (1 << 20, 253, 0), ((1 << 20) + 131, 512, 0),
    ((1 << 20) + 131, 253, 0), (1000, 37, 0), (3, 5, 0), (777, 64, 0),
    (1000, 512, 3), (1000, 253, 5)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_relu_dropout_layer_kernels_match_plain_version(rows, cols, offset,
                                                        rate, cuda):
    """#3's layer entry bit for bit equal to relu_dropout_reference of
    bf16(yf + b); #3b's gb bit for bit equal to its plain version and to
    the x-reading backward at h = bf16(yf + b); db bit for bit equal to
    db_kernel_order and within DB_TOL of the float64 column sums; one
    launch of each."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
    yf, b, g = _layer_operands(rows, cols, cuda, offset)
    n0 = profiling.LAUNCHES.copy()
    out = rd.bias_relu_dropout_fwd(yf, b, 777, rate)
    gb, db = rd.relu_dropout_bwd_out(out, g, rate)
    torch.cuda.synchronize()
    assert _since(n0, RD) == {
        "relu_dropout_fwd": 1, "relu_dropout_bwd": 1}
    h = (yf + b).to(torch.bfloat16)
    assert torch.equal(out, rd.relu_dropout_reference(h, 777, rate))
    gb_p, db_p = rd.relu_dropout_bwd_out_reference(out, g, rate)
    assert torch.equal(gb, gb_p)
    assert torch.equal(gb, rd.relu_dropout_bwd_reference(h, g, 777, rate))
    plan = rd.bwd_plan(rows, cols, offset == 0)
    assert torch.equal(db, rd.db_kernel_order(gb, plan))
    assert _db_within_tol(db, gb) and _db_within_tol(db_p, gb)


@pytest.mark.parametrize("cols", [512, 253])
def test_relu_dropout_layer_launches_are_bit_identical(cols, cuda):
    """Two launches of each layer entry at 2^20 + 131 rows give the same
    bits, db included (fixed grid, fixed order, no atomics)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
    yf, b, g = _layer_operands((1 << 20) + 131, cols, cuda)
    runs = []
    for _ in range(2):
        out = rd.bias_relu_dropout_fwd(yf, b, 9, 0.2)
        runs.append((out, *rd.relu_dropout_bwd_out(out, g, 0.2)))
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_relu_dropout_layer_wrappers_check_inputs(cuda):
    """On the card the layer entries raise on a CPU tensor among CUDA
    ones, a wrong dtype or shape, or a non-contiguous input."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
    yf, b, g = _layer_operands(256, 64, cuda)
    out = rd.bias_relu_dropout_fwd(yf, b, 1, 0.2)
    bad_fwd = [(yf, b.cpu()), (yf.to(torch.bfloat16), b), (yf, b[:-1]),
               (yf.t(), b[:1].expand(256).contiguous()), (yf[:, ::2],
                                                          b[:32])]
    for a, c in bad_fwd:
        with pytest.raises(ValueError):
            rd.bias_relu_dropout_fwd(a, c, 1, 0.2)
    bad_bwd = [(out, g.cpu()), (out.float(), g), (out, g.float()),
               (out, g[:-1]), (out[:, ::2], g[:, ::2])]
    for a, c in bad_bwd:
        with pytest.raises(ValueError):
            rd.relu_dropout_bwd_out(a, c, 0.2)


def test_relu_dropout_layer_step_matches_parent_composition(cuda,
                                                            monkeypatch):
    """One config-3 autograd step (the committed 8x512 pack, bf16, dropout
    0.2, 16 scenes x 16,384 points) through bf16_linear_relu_dropout (the
    route configs 3-5 take) against the same step with that layer
    substituted by its composition, bf16_linear_relu_dropout_reference
    (bf16_linear, the cast and relu_dropout), on the same (padded) layout:
    the loss and every gradient but the 8 hidden biases bit for bit, each
    hidden db within DB_TOL of its sum of |terms| apart; #3/#3b launched
    8 times each."""
    from latent_diffusion_models_for_shape_sdfs_torch import losses
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.models import (
        decoder as decoder_module)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl, relu_dropout as rd)
    root = pathlib.Path(__file__).resolve().parents[1]
    ad = ExperimentConfig.load(root / "configs" / "config3_chairs_joint").ad
    sd, codes = load_stage1_pack(PACK)
    dec = SdfDecoder(ad.decoder).to(cuda)
    dec.load_state_dict({k: v.to(cuda) for k, v in sd.items()})
    dec.train()
    rng = np.random.default_rng(3)
    n = 16 * 16384
    z = torch.from_numpy(codes[rng.integers(0, 64, 16)].repeat(
        16384, 0)).to(cuda)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).to(cuda)
    sdf = torch.from_numpy((0.05 * rng.normal(size=n)).astype(
        np.float32)).to(cuda)
    seen = []
    real = rd.relu_dropout_bwd_out

    def recorded(out, g, rate):
        gb, db = real(out, g, rate)
        seen.append((gb, db))
        return gb, db

    monkeypatch.setattr(rd, "relu_dropout_bwd_out", recorded)
    runs = []
    for layer in (bl.bf16_linear_relu_dropout,
                  bl.bf16_linear_relu_dropout_reference):
        monkeypatch.setattr(decoder_module, "bf16_linear_relu_dropout", layer)
        dec.zero_grad(set_to_none=True)
        zz = z.clone().requires_grad_()
        n0 = profiling.LAUNCHES.copy()
        loss = losses.clamped_l1(dec(zz, xyz, seed=5), sdf, ad.clamp_dist)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach(), {"z": zz.grad, **{
            k: p.grad for k, p in dec.named_parameters()}},
            _since(n0, RD)))
    (l1, g1, n1), (l2, g2, n2) = runs
    assert n1 == n2 == {"relu_dropout_fwd": 8, "relu_dropout_bwd": 8}
    assert len(seen) == 8                 # the new layer's, lin7 .. lin0
    assert torch.equal(l1, l2)
    for i, (gb, db) in enumerate(seen):
        k = f"lin{7 - i}.b"
        w = g1[k].shape[0]              # the layout's pad columns hold 0
        assert not gb[:, w:].any() and not db[w:].any()
        gb, db = gb[:, :w], db[:w]
        assert torch.equal(g1[k], db)
        assert _db_within_tol(db, gb), k
        apart = (g1[k].double() - g2[k].double()).abs()
        assert bool((apart <= 2 * DB_TOL * gb.double().abs().sum(0)).all())
    for k in g2:
        if not (k.endswith(".b") and k != "lin8.b"):
            assert torch.equal(g1[k], g2[k]), k


# ------------------------------------------------- fused train kernel (#4)

def _train_inputs(name, S, P, cuda, seed=0):
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        precompute_eval_weights)
    if name == "trained":
        dec, sd, _ = _decoder("trained")
        codes = load_stage1_pack(PACK)[1]
        z = torch.from_numpy(codes[:S]).to(cuda)
    else:
        torch.manual_seed(seed)
        dec = SdfDecoder(DecoderConfig(**PLANS[name]))
        sd = dec.state_dict()
        L = dec.cfg.latent_size
        z = torch.randn(S, L, device=cuda) / np.sqrt(L)
    ew = precompute_eval_weights(dec, {k: v.to(cuda) for k, v in sd.items()},
                                 torch.bfloat16)
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(
        np.float32)).to(cuda)
    sdf = torch.from_numpy((0.15 * rng.normal(size=(S, P))).astype(
        np.float32)).to(cuda)
    return ew, z, xyz, sdf


def _grad_errors(got, want) -> dict:
    """max|kernel - plain| / max|plain| for dz and every folded gradient."""
    (_, dz_k, g_k), (_, dz_p, g_p) = got, want
    pairs = {"dz": (dz_k, dz_p)}
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        pairs.update({f"lin{i}.{k}": (a[k], b[k]) for k in b})
    out = {}
    for name, (a, b) in pairs.items():
        assert a.shape == b.shape, name
        out[name] = float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
    return out


@pytest.mark.parametrize("name,S,P", [("small", 2, 512), ("trained", 64, 256),
                                      ("trained", 4, 2048)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_fused_train_kernel_matches_plain_version(name, S, P, rate, cuda):
    """Kernel #4 vs fused_train_reference: loss to 1e-4 relative, every
    gradient to 1e-2 of its largest entry (summation order and the bf16
    roundings it flips; random targets on a random-init 8x512 net cancel
    so much in the sums that 1,024 points read 0.5-3%, so the full-width
    cases use the trained decoder), and bit-identical on a second pass."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    ew, z, xyz, sdf = _train_inputs(name, S, P, cuda)
    args = (ew, z, xyz, sdf, S * P, 0.1, rate, 77)
    n0 = profiling.LAUNCHES["fused_train"]
    got = ft.fused_train_loss_grads(*args)
    again = ft.fused_train_loss_grads(*args)
    torch.cuda.synchronize()
    assert profiling.LAUNCHES["fused_train"] == n0 + 2
    want = ft.fused_train_reference(*args)
    rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    errs = _grad_errors(got, want)
    print(name, rate, f"loss rel {rel:.2e}",
          {k: f"{v:.1e}" for k, v in errs.items()})
    assert rel <= 1e-4
    assert max(errs.values()) <= 1e-2, errs
    # deterministic: no atomics, so a second pass gives the same bits
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    for a, b in zip(got[2], again[2]):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("use_pallas,impl", [(False, "pallas"),
                                             (True, "pallas")])
def test_training_step_on_card(use_pallas, impl, cuda):
    """A few steps of train_auto_decoder on the card through each kernel
    route: finite losses, the kernels launched."""
    from latent_diffusion_models_for_shape_sdfs_torch.config import AdConfig
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
        SdfDataset)
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
        train_auto_decoder)
    cfg = AdConfig(decoder=DecoderConfig(**dict(
        PLANS["small"], use_dropout=True, compute_dtype="bfloat16",
        dropout_impl=impl)), num_scenes=3, scenes_per_batch=2,
        samples_per_scene=512, num_epochs=2, use_pallas=use_pallas,
        clamp_dist=0.2)
    ds = SdfDataset.from_analytic(analytic.make_synthetic_split(
        "chair", 3, seed=1), 2000, workers=1)
    n_rd, n_ft = profiling.LAUNCHES["relu_dropout_fwd"], profiling.LAUNCHES["fused_train"]
    losses = []
    train_auto_decoder(cfg, ds, device=cuda, on_step=lambda i, e, m:
                       losses.append(float(m["loss_l1"])))
    assert len(losses) == 4 and np.isfinite(losses).all()
    if use_pallas:
        assert profiling.LAUNCHES["fused_train"] == n_ft + 4
    else:
        assert profiling.LAUNCHES["relu_dropout_fwd"] == n_rd + 4 * 3


# ---------------------- kernel #4's forward/dgrad GEMM engine (wgmma, TMA)

GEMM_WIDTHS = [(512, 512), (512, 256), (256, 512), (128, 128)]   # (K, N)


def _bf16(rng, shape, scale=1.0, cuda=None):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).to(torch.bfloat16).to(cuda)


@pytest.mark.parametrize("k,n", GEMM_WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("skip", [False, True])
def test_train_gemm_fwd_matches_plain_version(k, n, rate, skip, cuda):
    """The forward role against a float32 product of the same bf16
    operands, then bias rows (per scene at the skip layer, with the xyz
    term), relu and relu_dropout_reference's mask: max error <= 1e-2 of
    the output's max, the mask bitwise, two launches bit-identical."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
    m, p, seed = 8192 + 128 * 4, 128 * 17, -4242
    rng = np.random.default_rng(k + n)
    h = torch.relu(_bf16(rng, (m, k), cuda=cuda))
    w = _bf16(rng, (n, k), 1 / np.sqrt(k), cuda)
    rows = torch.from_numpy(rng.normal(size=(m // p if skip else 1, n))
                            .astype(np.float32)).to(cuda)
    xyz = _bf16(rng, (m, 3), cuda=cuda) if skip else None
    wx = _bf16(rng, (n, 3), cuda=cuda) if skip else None
    n0 = profiling.LAUNCHES["gemm_fwd"]
    got = ft.gemm_fwd(h, w, rows, p, xyz, wx, seed, rate)
    again = ft.gemm_fwd(h, w, rows, p, xyz, wx, seed, rate)
    torch.cuda.synchronize()
    assert profiling.LAUNCHES["gemm_fwd"] == n0 + 2
    pre = h.float() @ w.float().T + rows.repeat_interleave(
        m // rows.shape[0], 0)
    if skip:
        pre = pre + xyz.float() @ wx.float().T
    want = rd.relu_dropout_reference(pre, seed, rate)
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max()), err
    keep = rd.dropout_keep_mask(m, n, seed, rate, device=cuda) if rate \
        else torch.ones_like(pre, dtype=torch.bool)
    assert not bool(((got != 0) & ~keep).any())
    clear = pre > 1e-2 * float(pre.abs().max())
    assert torch.equal((got != 0)[clear], keep[clear])
    assert torch.equal(got, again)


@pytest.mark.parametrize("k,n", GEMM_WIDTHS)
def test_train_gemm_dgrad_matches_plain_version(k, n, cuda):
    """The dgrad role, g [M, K] x W^T [N, K] masked by the keep bits of the
    stored activation, with the dropout scale, against the float32 product
    of the same bf16 operands: <= 1e-2 of the output's max, zeros where
    h_prev is not positive, two launches bit-identical."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    from latent_diffusion_models_for_shape_sdfs_torch.ops import train_gemm as tg
    m, scale = 8192 + 128 * 3, 1.25
    rng = np.random.default_rng(k * n)
    g = _bf16(rng, (m, k), 1e-3, cuda)
    wt = _bf16(rng, (n, k), 1 / np.sqrt(k), cuda)
    hprev = torch.relu(_bf16(rng, (m, n), cuda=cuda))
    bits = tg.pack_keep_bits(hprev > 0)
    n0 = profiling.LAUNCHES["gemm_dgrad"]
    got, _ = ft.gemm_dgrad(g, wt, bits, scale)
    again, _ = ft.gemm_dgrad(g, wt, bits, scale)
    torch.cuda.synchronize()
    assert profiling.LAUNCHES["gemm_dgrad"] == n0 + 2
    want = torch.where(hprev > 0, (g.float() @ wt.float().T) * scale, 0.0)
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max()), err
    assert bool((got[hprev <= 0] == 0).all())
    assert torch.equal(got, again)


@pytest.mark.parametrize("k,n", GEMM_WIDTHS)
@pytest.mark.parametrize("with_xyz", [False, True])
def test_train_gemm_dgrad_column_partials_match_plain_version(k, n, with_xyz,
                                                              cuda):
    """The dgrad's column partials (per 128-row tile: the column sums of
    the bf16 output it stores, and the three bf16(xyz)-weighted sums when
    xyz is given) against column_partials_reference of that output:
    <= 1e-3 of their max; small-integer sums (exact in any order) bit for
    bit; two launches bit-identical, output and partials."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    from latent_diffusion_models_for_shape_sdfs_torch.ops import train_gemm as tg
    m = 8192 + 128 * 5
    rng = np.random.default_rng(k + n + with_xyz)
    g = _bf16(rng, (m, k), 1e-3, cuda)
    wt = _bf16(rng, (n, k), 1 / np.sqrt(k), cuda)
    bits = tg.pack_keep_bits(torch.from_numpy(rng.random((m, n)) < 0.6)
                             .to(cuda))
    xyz = (torch.from_numpy(rng.uniform(-1, 1, (m, 3)).astype(np.float32))
           .to(torch.bfloat16).to(cuda) if with_xyz else None)
    got, part = ft.gemm_dgrad(g, wt, bits, 1.25, xyz)
    again, part2 = ft.gemm_dgrad(g, wt, bits, 1.25, xyz)
    torch.cuda.synchronize()
    want = ft.column_partials_reference(got, xyz)
    assert part.shape == want.shape == (m // 128, (4 if with_xyz else 1) * n)
    err = float((part - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err
    assert torch.equal(got, again) and torch.equal(part, part2)
    # small integers: g and W in {-2..2}, scale 1, xyz in {-1, 0, 1}
    gi = torch.from_numpy(rng.integers(-2, 3, (m, k)).astype(np.float32)).to(
        torch.bfloat16).to(cuda)
    wi = torch.from_numpy(rng.integers(-2, 3, (n, k)).astype(np.float32)).to(
        torch.bfloat16).to(cuda)
    xi = (torch.from_numpy(rng.integers(-1, 2, (m, 3)).astype(np.float32))
          .to(torch.bfloat16).to(cuda) if with_xyz else None)
    got, part = ft.gemm_dgrad(gi, wi, bits, 1.0, xi)
    assert torch.equal(part, ft.column_partials_reference(got, xi))


@pytest.mark.parametrize("k,n", GEMM_WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_train_gemm_fwd_keep_bits_are_those_of_its_output(k, n, rate, cuda):
    """The forward role's keep bits equal pack_keep_bits(out > 0) of its
    own output, bit for bit; the output is the one it writes without bits;
    two launches bit-identical. The dgrad of the next layer, masked by
    them, equals the dgrad masked by the bits packed from that output."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    from latent_diffusion_models_for_shape_sdfs_torch.ops import train_gemm as tg
    m, p, seed = 8192 + 128 * 4, 128 * 17, 99
    rng = np.random.default_rng(k * n + 1)
    h = torch.relu(_bf16(rng, (m, k), cuda=cuda))
    w = _bf16(rng, (n, k), 1 / np.sqrt(k), cuda)
    rows = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).to(
        cuda)
    out, bits = ft.gemm_fwd(h, w, rows, p, seed=seed, rate=rate,
                            keep_bits=True)
    out2, bits2 = ft.gemm_fwd(h, w, rows, p, seed=seed, rate=rate,
                              keep_bits=True)
    plain = ft.gemm_fwd(h, w, rows, p, seed=seed, rate=rate)
    torch.cuda.synchronize()
    assert bits.dtype == torch.int32 and bits.numel() * 32 == m * n
    assert torch.equal(bits, tg.pack_keep_bits(out > 0))
    assert torch.equal(out, plain)
    assert torch.equal(out, out2) and torch.equal(bits, bits2)
    g = _bf16(rng, (m, 256), 1e-3, cuda)
    wt = _bf16(rng, (n, 256), 1 / 16, cuda)
    a, _ = ft.gemm_dgrad(g, wt, bits, 1.25)
    b, _ = ft.gemm_dgrad(g, wt, tg.pack_keep_bits(out > 0), 1.25)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [128, 256, 384, 512])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_layer0_keep_bits_are_those_of_its_output(n, rate, cuda):
    """The layer-0 kernel's keep bits equal pack_keep_bits(h0 > 0) of its
    own output, bit for bit; h0 within bf16 rounding of its plain version
    with the mask of ops.relu_dropout; two launches bit-identical."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    from latent_diffusion_models_for_shape_sdfs_torch.ops import train_gemm as tg
    S, P = 3, 128 * 11
    rng = np.random.default_rng(n)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (S * P, 3)).astype(
        np.float32)).to(torch.bfloat16).to(cuda)
    wx = _bf16(rng, (n, 3), cuda=cuda)
    rows = torch.from_numpy(rng.normal(size=(S, n)).astype(np.float32)).to(
        cuda)
    out, bits = ft.layer0(xyz, rows, wx, P, seed=5, rate=rate)
    out2, bits2 = ft.layer0(xyz, rows, wx, P, seed=5, rate=rate)
    torch.cuda.synchronize()
    assert torch.equal(bits, tg.pack_keep_bits(out > 0))
    assert torch.equal(out, out2) and torch.equal(bits, bits2)
    want = ft.layer0_reference(xyz, rows, wx, P, 5, rate).float()
    err = float((out.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max()), err


def test_train_gemm_wrappers_check_inputs(cuda):
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    bf = torch.bfloat16
    h = torch.zeros(1024, 512, dtype=bf, device=cuda)
    w = torch.zeros(512, 512, dtype=bf, device=cuda)
    rows = torch.zeros(1, 512, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        ft.gemm_fwd(h[:1000], w, rows, 1000)
    with pytest.raises(ValueError, match="width"):
        ft.gemm_fwd(h, w[:320], rows[:, :320], 1024)
    with pytest.raises(ValueError, match="contiguous"):
        ft.gemm_fwd(h[:, :256], w[:, :256], rows, 1024)
    with pytest.raises(ValueError, match="bf16"):
        ft.gemm_fwd(h.float(), w, rows, 1024)
    with pytest.raises(ValueError, match="rows"):
        ft.gemm_fwd(h, w, torch.zeros(3, 512, device=cuda), 256)
    with pytest.raises(ValueError, match="multiple of 128"):
        ft.gemm_fwd(h, w, torch.zeros(16, 512, device=cuda), 64)
    with pytest.raises(ValueError, match="xyz"):
        ft.gemm_fwd(h, w, rows, 1024, torch.zeros(1024, 3, dtype=bf),
                    torch.zeros(512, 3, dtype=bf, device=cuda))
    bits = torch.zeros(1024 * 512 // 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="keep_bits"):
        ft.gemm_dgrad(h, w, bits[:100], 1.0)
    with pytest.raises(ValueError, match="keep_bits"):
        ft.gemm_dgrad(h, w, bits.float(), 1.0)
    with pytest.raises(ValueError, match="K"):
        ft.gemm_dgrad(h[:, :96].contiguous(), w[:, :96].contiguous(), bits,
                      1.0)
    with pytest.raises(ValueError, match="xyz"):
        ft.gemm_dgrad(h, w, bits, 1.0, torch.zeros(1024, 3, device=cuda))


# ------------- kernel #4's wgrad role (MN-major TMA + wgmma, split-K)

WGRAD_WIDTHS = [(512, 512), (256, 512), (512, 256), (128, 128)]  # (out, in)


@pytest.mark.parametrize("m,n", WGRAD_WIDTHS)
@pytest.mark.parametrize("k_split", [3072, 16384])
def test_train_gemm_wgrad_matches_plain_version(m, n, k_split, cuda):
    """The wgrad role at the decoder's (out, in) width pairs and two chunk
    sizes over 3 x 16,384 points: small-integer bf16 operands, whose f32
    sums are exact in any order, equal the plain version bit for bit (a
    layout or transpose fault shows as a wrong value, not as noise);
    random operands within 1e-3 of the output's max; two launches
    bit-identical."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
    k = 3 * 16384
    rng = np.random.default_rng(m + n + k_split)
    g, h = (torch.from_numpy(rng.integers(-3, 4, (k, w)).astype(np.float32))
            .to(torch.bfloat16).to(cuda) for w in (m, n))
    n0 = profiling.LAUNCHES["gemm_wgrad"]
    got = ft.gemm_wgrad(g, h, k_split)
    torch.cuda.synchronize()
    assert profiling.LAUNCHES["gemm_wgrad"] == n0 + 1
    assert got.shape == (k // k_split, m, n)
    assert torch.equal(got, ft.gemm_wgrad_reference(g, h, k_split))
    g = _bf16(rng, (k, m), 1e-3, cuda)
    h = torch.relu(_bf16(rng, (k, n), cuda=cuda))
    got = ft.gemm_wgrad(g, h, k_split)
    again = ft.gemm_wgrad(g, h, k_split)
    want = ft.gemm_wgrad_reference(g, h, k_split)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err
    assert torch.equal(got, again)


# ------------------------------------- per-point-latent eval kernel (#2)

MULTICAT = (pathlib.Path(__file__).resolve().parents[1] / "runs"
            / "multicat6k" / "stage1_pack.npz")


def _pairs_decoder(name):
    """A plan and z rows [n, L] drawn from 64 latents (mixed shapes)."""
    if name == "trained":
        sd, codes = load_stage1_pack(MULTICAT)
        return SdfDecoder(DecoderConfig()), sd, codes[:64]
    torch.manual_seed(0)
    dec = SdfDecoder(DecoderConfig(**PLANS[name]))
    L = dec.cfg.latent_size
    zs = np.random.default_rng(1).normal(size=(64, L)) / np.sqrt(L)
    return dec, dec.state_dict(), zs.astype(np.float32)


@pytest.mark.parametrize("name", sorted(PLANS) + ["trained"])
@pytest.mark.parametrize("n", [1, 63, 64, 700, (1 << 16) + 131])
def test_pairs_kernel_matches_plain_version(name, n, cuda):
    """Kernel #2 vs bf16 fast_apply over z rows, ragged tails included
    (tolerance of tests/test_pallas_kernels.py:79)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply_pairs)
    dec, sd, zs = _pairs_decoder(name)
    apply = make_kernel_apply_pairs(dec, sd, device=cuda)
    rng = np.random.default_rng(n)
    z_rows = torch.from_numpy(zs[rng.integers(0, len(zs), n)]).to(cuda)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).to(cuda)
    got = apply(z_rows, xyz)
    torch.cuda.synchronize()
    assert apply.launches == 1 and got.shape == (n,)
    torch.testing.assert_close(got, fast_apply(apply.ew, z_rows, xyz),
                               atol=5e-3, rtol=0)


@pytest.mark.parametrize("name", ["small", "tanh", "trained"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 700, (1 << 16) + 131])
@pytest.mark.parametrize("S", [1, 64])
def test_pairs_kernel_indexed_matches_plain_version(name, n, S, cuda):
    """Kernel #2 reading its rows by index: shuffled shape ids over S codes
    against bf16 fast_apply over codes[sids] (5e-3)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply_pairs)
    dec, sd, zs = _pairs_decoder(name)
    apply = make_kernel_apply_pairs(dec, sd, device=cuda)
    rng = np.random.default_rng(n + S)
    codes = torch.from_numpy(zs[:S]).to(cuda)
    sids = torch.from_numpy(rng.permutation(np.arange(n) % S).astype(
        np.int32)).to(cuda)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).to(cuda)
    got = apply.indexed(codes, sids, xyz)
    torch.cuda.synchronize()
    assert apply.launches == 1 and got.shape == (n,)
    torch.testing.assert_close(got, fast_apply(apply.ew, codes[sids.long()],
                                               xyz), atol=5e-3, rtol=0)


@pytest.mark.parametrize("name", ["small", "trained"])
def test_pairs_kernel_with_equal_rows_matches_kernel_1(name, cuda):
    """All rows one latent: kernel #2 computes kernel #1's function
    (tests/test_pallas_kernels.py:94-105, tolerance 1e-2), as expanded rows
    and as a one-row table read by index."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply_pairs)
    dec, sd, zs = _pairs_decoder(name)
    z = torch.from_numpy(zs[3]).to(cuda)
    xyz = torch.rand(5000, 3, device=cuda) * 2 - 1
    pairs = make_kernel_apply_pairs(dec, sd, device=cuda)
    want = make_kernel_apply(dec, sd, device=cuda)(z, xyz)
    torch.testing.assert_close(pairs(z.expand(5000, -1), xyz), want,
                               atol=1e-2, rtol=0)
    got = pairs.indexed(z[None], torch.zeros(5000, dtype=torch.int32,
                                             device=cuda), xyz)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=0)


@pytest.mark.parametrize("name", ["small", "trained"])
def test_pairs_kernel_launches_are_bit_identical(name, cuda):
    """No atomics and a fixed summation order: two launches give the same
    bits, and so do the (z_rows, xyz) call on the gathered rows."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply_pairs)
    dec, sd, zs = _pairs_decoder(name)
    apply = make_kernel_apply_pairs(dec, sd, device=cuda)
    codes = torch.from_numpy(zs).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 100_003
    sids = torch.randint(0, len(zs), (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    xyz = torch.rand(n, 3, generator=gen, device=cuda) * 2 - 1
    outs = [apply.indexed(codes, sids, xyz), apply.indexed(codes, sids, xyz),
            apply(codes[sids.long()], xyz)]
    torch.cuda.synchronize()
    assert apply.launches == 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_pairs_kernel_wrapper_checks_inputs(cuda):
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply_pairs)
    dec, sd, zs = _pairs_decoder("tanh")
    apply = make_kernel_apply_pairs(dec, sd, device=cuda)
    table = apply.table(torch.from_numpy(zs).to(cuda))
    assert table.dtype == torch.bfloat16 and table.shape == (64, apply.lt)
    xyz = torch.rand(10, 3, device=cuda)
    ids = torch.arange(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sids must be"):
        apply.launch(table, ids.long(), xyz)                 # dtype
    with pytest.raises(ValueError, match="sids must be"):
        apply.launch(table, ids[:9], xyz)                    # shape
    with pytest.raises(ValueError, match="sids must be"):
        apply.launch(table, torch.arange(20, dtype=torch.int32,
                                         device=cuda)[::2], xyz)
    with pytest.raises(ValueError, match="codes must be"):
        apply.launch(table.float(), ids, xyz)                # dtype
    with pytest.raises(ValueError, match="codes must be"):
        apply.launch(table.reshape(-1)[4:4 + 10 * apply.lt].reshape(
            10, apply.lt), ids, xyz)                         # alignment
    with pytest.raises(ValueError, match="xyz must be"):
        apply.launch(table, ids, xyz.double())
    assert apply(torch.zeros(0, 8, device=cuda),
                 torch.zeros(0, 3, device=cuda)).shape == (0,)
    # an unaligned row view is copied into an aligned table first
    z = torch.from_numpy(zs).to(cuda).to(torch.bfloat16)
    rows = z.reshape(-1)[1:1 + 10 * 8].reshape(10, 8)
    torch.testing.assert_close(apply(rows, xyz),
                               fast_apply(apply.ew, rows, xyz),
                               atol=5e-3, rtol=0)


def cube_rows(zr, xyz):
    """Per-row snapped cube (tests/test_torch_flat_decode.py): exact in
    float32 on any device."""
    q = torch.abs(torch.round(xyz * 256.0) - zr[:, 1:4] * 256.0)
    return torch.amax(q, dim=-1) / 256.0 - zr[:, 0]


@pytest.mark.parametrize("out_dtype", ["float32", "int8"])
def test_flat_decode_on_card_matches_cpu(out_dtype, cuda):
    """Same SDF values on both devices: the card's flat decode (no host
    sync, int32 index math) gives the CPU's grids and stats bit for bit."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_hierarchical3_batch_flat)
    zs = np.asarray([[0.2, 0, 0, 0], [0.3, 0.125, 0, -0.0625],
                     [0.45, 0, 0.03125, 0]], np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        g, st = decode_grid_hierarchical3_batch_flat(
            cube_rows, torch.from_numpy(zs).to(dev), 64, 16, 4, 2, 128,
            4096, 16384, out_dtype=out_dtype)
        out.append((g.cpu(), st))
    (g1, s1), (g2, s2) = out
    assert torch.equal(g1, g2)
    for k in ("active_l1", "active_l2", "active_l3", "capacity_exceeded"):
        assert s1[k] == s2[k], k
    np.testing.assert_array_equal(s1["per_shape_l1"], s2["per_shape_l1"])


def test_flat_decode_through_pairs_kernel_matches_plain_version(cuda):
    """Six multicat shapes at 128^3 through kernel #2 and through its
    plain version: the same actives up to bf16 noise at the thresholds,
    near-surface values within 1e-2, no sign flip where both |sdf| >= 1e-2."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply_pairs)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_hierarchical3_batch_flat, probe_flat_caps)
    dec, sd, codes = _pairs_decoder("trained")
    apply = make_kernel_apply_pairs(dec, sd, device=cuda)
    zs = torch.from_numpy(codes[:6]).to(cuda).to(torch.bfloat16)
    res = 128
    caps = probe_flat_caps(apply, zs, res)
    n0 = apply.launches
    g, st = decode_grid_hierarchical3_batch_flat(apply, zs, res, 16, 4, 2,
                                                 *caps)
    assert apply.launches > n0 and not st["capacity_exceeded"]

    def plain(z_rows, xyz):
        return fast_apply(apply.ew, z_rows, xyz)

    gp, sp = decode_grid_hierarchical3_batch_flat(plain, zs, res, 16, 4, 2,
                                                  *caps)
    for k in ("active_l1", "active_l2", "active_l3"):
        assert abs(st[k] - sp[k]) <= 0.002 * sp[k] + 16, k
    h = 2.0 / (res - 1)
    near = (g.abs() < h) & (gp.abs() < h)
    assert int(near.sum()) > 10_000
    assert float((g - gp)[near].abs().max()) <= 1e-2
    far = torch.minimum(g.abs(), gp.abs()) >= 1e-2
    assert torch.equal(g[far] < 0, gp[far] < 0)


# ---------------------------------------------- stage-2 trainer on the card

def _diff_setup(cuda, capturable=True, seed=0):
    """A small class + partial config (bank wider than partial_points),
    its state on the card, the DiffStep and one chunk's draws."""
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DenoiserConfig, DiffConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule \
        import DiffusionSchedule
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        diffusion as ttd)
    cfg = DiffConfig(denoiser=DenoiserConfig(
        latent_size=32, hidden_dim=128, num_blocks=2, time_embed_dim=32,
        num_classes=5, partial_sdf_cond=True, partial_points=24),
        timesteps=100, batch_size=16, lr=1e-3, scan_chunk=10, num_steps=30,
        snapshot_every=10)
    rng = np.random.default_rng(seed)
    banks = (torch.from_numpy(rng.normal(size=(12, 32)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 5, 12)),
             torch.from_numpy(rng.uniform(-1, 1, (12, 64, 3)).astype(
                 np.float32)),
             torch.from_numpy((0.1 * rng.normal(size=(12, 64))).astype(
                 np.float32)))
    state = ttd.init_diff_state(cfg, seed=seed, device=cuda)
    if not capturable:
        for g in state.optimizer.param_groups:
            g["capturable"] = False
    step = ttd.DiffStep(cfg, state, DiffusionSchedule.create(
        100, device=cuda), *(b.to(cuda) for b in banks))
    return cfg, state, step, banks, ttd


def _state_tensors(state):
    out = []
    for (k, p) in state.model.named_parameters():
        s = state.optimizer.state[p]
        out += [p.detach(), state.ema[k], s["exp_avg"], s["exp_avg_sq"],
                s["step"]]
    return out


def test_diff_graphed_chunk_equals_eager_chunk(cuda):
    """Two chunks replayed from the captured graph equal the same chunks
    of the eager step from the same state and draws, bit for bit."""
    cfg, a, step_a, _, ttd = _diff_setup(cuda)
    _, b, step_b, _, _ = _diff_setup(cuda)
    for start in (0, 10):
        draws = ttd.draw_chunk(cfg, 12, 64, start, cuda)
        la = step_a.eager(draws)
        lb = step_b.graphed(draws)
        assert torch.equal(la, lb)
    assert a.step == b.step == 20
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)


def test_diff_chunk_waits_on_the_device_once(cuda):
    """A graphed chunk (after the capture) enqueues its draws, copies and
    replays without a host sync; reading its mean loss is the one wait."""
    cfg, state, step, _, ttd = _diff_setup(cuda)
    step.graphed(ttd.draw_chunk(cfg, 12, 64, 0, cuda))     # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step.graphed(ttd.draw_chunk(cfg, 12, 64, 10, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss)) and state.step == 20


def test_diff_capture_failure_raises(cuda):
    """A step that cannot be captured (Adam without capturable) raises;
    the chunk does not fall back to the eager loop."""
    cfg, state, step, _, ttd = _diff_setup(cuda, capturable=False)
    with pytest.raises(RuntimeError, match="capturable"):
        step.graphed(ttd.draw_chunk(cfg, 12, 64, 0, cuda))
    assert state.step == 0 and step.graph is None


def test_diff_capturable_checkpoint_resumes_on_card(cuda, tmp_path):
    """train_diffusion (graphed) to step 10, save, restore into a fresh
    state on the card (Adam's step counts back on the card), train on to
    30 == 30 straight steps, bit for bit."""
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        StageCheckpointer, diff_state_tree, restore_diff_state)
    import dataclasses
    cfg, _, _, banks, ttd = _diff_setup(cuda)
    codes, cids, oxyz, osdf = banks
    kw = dict(class_ids=cids, obs_xyz=oxyz, obs_sdf=osdf, device=cuda)
    straight = ttd.train_diffusion(cfg, codes, **kw)[1]
    _, a, (mu, sigma), _ = ttd.train_diffusion(
        dataclasses.replace(cfg, num_steps=10), codes, **kw)
    ckpt = StageCheckpointer(tmp_path, "diffusion")
    ckpt.save(a.step, diff_state_tree(a, mu, sigma))
    b = ttd.init_diff_state(cfg, seed=7, device=cuda)
    restore_diff_state(b, ckpt.restore())
    for p in b.model.parameters():
        assert b.optimizer.state[p]["step"].device == p.device
    b = ttd.train_diffusion(cfg, codes, state=b, **kw)[1]
    assert b.step == straight.step == 30
    for x, y in zip(_state_tensors(straight), _state_tensors(b)):
        assert torch.equal(x, y)


# ----------------------------------------------- reconstruction, encoder

REC_DEC = dict(latent_size=32, hidden_dim=128, num_layers=3, latent_in=(2,),
               use_dropout=False)


def _recon_setup(cuda, k, sds, n=700, steps=30):
    from latent_diffusion_models_for_shape_sdfs_torch import reconstruct
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DenoiserConfig, DiffConfig, ReconstructConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler \
        import guided_denoise_fn
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule \
        import DiffusionSchedule
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        diffusion as ttd)
    torch.manual_seed(0)
    dec = SdfDecoder(DecoderConfig(**REC_DEC)).to(cuda)
    cfg = ReconstructConfig(num_steps=steps, lr_decay_at=steps // 2,
                            num_inits=k, clamp_dist=0.5)
    rng = np.random.default_rng(k)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).to(cuda)
    sdf = xyz.norm(dim=-1) - 0.5
    prior = None
    if sds:
        dcfg = DiffConfig(denoiser=DenoiserConfig(
            arch="unet", latent_size=32, hidden_dim=64, time_embed_dim=32),
            timesteps=100)
        st = ttd.init_diff_state(dcfg, seed=1, device=cuda)
        with torch.no_grad():
            for p in st.model.parameters():
                p.add_(0.02 * torch.randn_like(p))
        st.model.eval()
        prior = {"denoise_fn": guided_denoise_fn(st.model, 0.0),
                 "sched": DiffusionSchedule.create(100, device=cuda),
                 "mu": torch.zeros(32, device=cuda),
                 "sigma": torch.ones(32, device=cuda) * 0.5,
                 "weight": 0.05, "t_lo": 0.02, "t_hi": 0.98, "anneal": False}
    draws = reconstruct.draw_recon(cfg, k, 32, cuda, sds_prior=prior)
    return reconstruct, dec, cfg, xyz, sdf, prior, draws


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("sds", [False, True])
def test_recon_graphed_equals_eager(k, sds, cuda):
    """A reconstruction replayed from its captured step equals the eager
    run from the same draws, bit for bit (z and both histories), twice
    (the second run replays the same graph on new draws)."""
    rec, dec, cfg, xyz, sdf, prior, draws = _recon_setup(cuda, k, sds)
    a = rec.LatentOpt(dec, cfg, k, len(sdf), sds_prior=prior)
    b = rec.LatentOpt(dec, cfg, k, len(sdf), sds_prior=prior)
    for seed in (0, 1):
        d = rec.draw_recon(cfg, k, 32, cuda, seed=seed, sds_prior=prior)
        a.load(xyz, sdf, d)
        a.eager()
        b.load(xyz, sdf, d)
        b.graphed()
        for x, y in ((a.z, b.z), (a.hist, b.hist), (a.l1, b.l1)):
            assert torch.equal(x, y)
    assert torch.isfinite(a.hist).all()


def test_recon_waits_on_the_device_once(cuda):
    """After the capture, loading a run's draws and replaying its steps
    never waits on the device; reading the histories is the one wait."""
    rec, dec, cfg, xyz, sdf, prior, draws = _recon_setup(cuda, 2, True)
    opt = rec.LatentOpt(dec, cfg, 2, len(sdf), sds_prior=prior)
    opt.load(xyz, sdf, draws)
    opt.graphed()                                        # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = rec.draw_recon(cfg, 2, 32, cuda, seed=5, sds_prior=prior)
        opt.load(xyz, sdf, d)
        opt.graphed()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(opt.hist.cpu().numpy()).all()


def test_daemon_reuses_one_graph_per_request_size(cuda):
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ReconstructConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        make_obs_reconstruct_fn)
    dec = SdfDecoder(DecoderConfig(**REC_DEC)).to(cuda)
    fn = make_obs_reconstruct_fn(dec, rcfg=ReconstructConfig(num_steps=20))
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    sdf = np.linalg.norm(xyz, axis=-1) - 0.5
    z1 = fn(xyz, sdf)
    (opt,) = fn.cache.values()
    graph = opt.graph
    z2 = fn(xyz, sdf)
    assert len(fn.cache) == 1 and opt.graph is graph is not None
    np.testing.assert_array_equal(z1, z2)
    fn(xyz[:300], sdf[:300])
    assert len(fn.cache) == 2 and z1.shape == (32,)


def test_daemon_cache_frees_the_graphs_it_evicts(cuda):
    """Requests of ever new sizes keep the CACHE_SIZE latest graphs, and
    the card's reserved memory does not grow past what a full cache
    took."""
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ReconstructConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.reconstruct import (
        CACHE_SIZE)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        make_obs_reconstruct_fn)
    dec = SdfDecoder(DecoderConfig(**REC_DEC)).to(cuda)
    fn = make_obs_reconstruct_fn(dec, rcfg=ReconstructConfig(num_steps=5))
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    sdf = np.linalg.norm(xyz, axis=-1) - 0.5
    sizes = [4000 - 100 * i for i in range(3 * CACHE_SIZE)]
    torch.cuda.empty_cache()
    for i, n in enumerate(sizes):
        fn(xyz[:n], sdf[:n])
        if i == CACHE_SIZE - 1:
            full = torch.cuda.memory_reserved(cuda)
    assert [key[1] for key in fn.cache] == sizes[-CACHE_SIZE:]
    assert all(opt.graph is not None for opt in fn.cache.values())
    assert torch.cuda.memory_reserved(cuda) <= full


def _enc_setup(cuda, seed=0):
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        EncConfig, EncoderConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        encoder as ten)
    cfg = EncConfig(encoder=EncoderConfig(latent_size=32), n_obs=128,
                    batch_scenes=8, num_steps=40, scan_chunk=10,
                    warmup_steps=5)
    rng = np.random.default_rng(seed)
    S, P = 20, 512
    bank = torch.from_numpy(np.concatenate(
        [rng.uniform(-1, 1, (S, P, 3)), 0.1 * rng.normal(size=(S, P, 1))],
        -1).astype(np.float32)).to(cuda)
    codes_n = torch.from_numpy(rng.normal(size=(S, 32)).astype(
        np.float32)).to(cuda)
    state = ten.init_enc_state(cfg, seed=seed, device=cuda)
    return cfg, ten, state, ten.EncStep(cfg, state, bank, codes_n), S, P


def test_encoder_graphed_chunk_equals_eager_chunk(cuda):
    cfg, ten, a, step_a, S, P = _enc_setup(cuda)
    _, _, b, step_b, _, _ = _enc_setup(cuda)
    for start in (0, 10):
        draws = ten.draw_chunk(cfg, S, P, start, cuda)
        assert torch.equal(step_a.eager(draws), step_b.graphed(draws))
    assert a.step == b.step == 20
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_encoder_chunk_waits_on_the_device_once(cuda):
    cfg, ten, state, step, S, P = _enc_setup(cuda)
    step.graphed(ten.draw_chunk(cfg, S, P, 0, cuda))        # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step.graphed(ten.draw_chunk(cfg, S, P, 10, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss)) and state.step == 20


# ---------------------------------- render, device metrics, batched decodes


def test_render_kernel_matches_plain_version(cuda):
    """The sphere-traced render of a trained chair through kernel #1 (rows
    hoisted once: 96 + 6 launches) against the plain version's render:
    hit masks on 99.9% of the pixels; shading (central differences of
    bf16 evaluations) within 4 levels at the median where both hit."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.render import (
        render_sdf)
    dec, sd, z = _decoder("trained")
    apply = make_kernel_apply(dec, sd, device=cuda)
    zt = torch.from_numpy(z).to(cuda)
    view = dict(width=160, height=128, eye=(1.5, 1.05, 1.5))
    rgb, hit = render_sdf(apply, zt, **view)
    assert apply.launches == 102
    rgb_p, hit_p = render_sdf(lambda zz, x: fast_apply(apply.ew, zz, x), zt,
                              **view)
    assert (hit == hit_p).mean() >= 0.999 and hit.sum() > 1000
    both = hit & hit_p
    d = np.abs(rgb.astype(int) - rgb_p.astype(int)).max(-1)[both]
    assert np.median(d) <= 4


def test_render_march_waits_on_the_device_once(cuda):
    """The march and the shading enqueue without a host wait."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import render
    dec, sd, z = _decoder("small")
    apply = make_kernel_apply(dec, sd, device=cuda)
    sdf = apply.bind(torch.from_numpy(z).to(cuda))
    args = (64, 48, 96, (1.6, 1.2, 1.6), (0.0, 0.0, 0.0), 40.0, 2e-3, 0.9,
            1.05, (0.5, 0.75, 0.43), cuda)
    render._render(sdf, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, hit = render._render(sdf, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert img.shape == (48, 64, 3) and hit.shape == (48, 64)


def _clouds(k, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-0.5, 0.5, 3) + 0.2 * rng.normal(size=(n, 3)))
            .astype(np.float32) for _ in range(k)]


def test_device_metrics_on_card(cuda):
    """Chamfer on the card within 1e-5 of the host KD-tree, Sinkhorn-EMD
    in the entropic envelope of the exact assignment, and MMD / COV /
    1-NNA equal to the CPU run's to 1e-5."""
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        device_metrics as dm, generative as gm)
    a, b = _clouds(5, 1000, 0), _clouds(4, 1000, 1)
    got = dm.pairwise_metric(a, b, "chamfer", chunk=3, device=cuda)
    np.testing.assert_allclose(got, gm.pairwise_chamfer(a, b), rtol=1e-5,
                               atol=0)
    a, b = _clouds(3, 256, 2), _clouds(3, 256, 3)
    emd = dm.pairwise_metric(a, b, "emd", chunk=2, eps=0.005, iters=500,
                             device=cuda)
    for i in range(3):
        for j in range(3):
            exact = gm.emd_exact(a[i], b[j])
            assert exact - 1e-4 <= emd[i, j] < 1.05 * exact + 0.01
    card = dm.evaluate_generated_device(a, b, ("chamfer", "emd"), chunk=2,
                                        device=cuda)
    host = dm.evaluate_generated_device(a, b, ("chamfer", "emd"), chunk=2,
                                        device="cpu")
    assert set(card) == set(host)
    for k in host:
        np.testing.assert_allclose(card[k], host[k], rtol=1e-5, atol=0)


def _cube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0) - z[1:4] * 256.0)
    return torch.amax(q, dim=-1) / 256.0 - z[0]


def _host_tree(x):
    if isinstance(x, tuple):
        return tuple(_host_tree(a) for a in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("name, args, kw", [
    ("decode_grid_batch", (24,), {}),
    ("decode_grid_hierarchical2_batch", (64, 16, 4, 64, 1024), {}),
    ("decode_grid_hierarchical3_batch", (64, 16, 4, 2, 64, 1024, 6144),
     dict(layout="sparse2", out_dtype="int8")),
    ("decode_grid_hierarchical3_batch", (64, 16, 4, 2, 16, 256, 1024),
     dict(layout="xmajor")),
])
def test_batch_decodes_on_card_match_cpu(name, args, kw, cuda):
    """The batched decodes on the cube SDF (exact in fp32 on both): the
    card's grids and counts equal the CPU's bit for bit, overflow too."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval
    zs = torch.tensor([[0.2, 0.0, 0.1, 0.0], [0.3, 0.05, 0.0, -0.1],
                       [0.45, 0.0, 0.0, 0.1]])
    fn = getattr(grid_eval, name)
    cpu, card = fn(_cube, zs, *args, **kw), fn(_cube, zs.to(cuda), *args,
                                               **kw)
    if name == "decode_grid_batch":
        cpu, card = (cpu, {}), (card, {})
    for a, b in zip(_host_tree(card[0]) if isinstance(card[0], tuple)
                    else (card[0].cpu(),),
                    cpu[0] if isinstance(cpu[0], tuple) else (cpu[0],)):
        assert torch.equal(a, b)
    for k, v in cpu[1].items():
        np.testing.assert_array_equal(np.asarray(card[1][k]), np.asarray(v))


def test_batched_decode_through_kernel_matches_single_shapes(cuda):
    """decode_grid_hierarchical3_batch of 3 trained chairs at 128^3
    through kernel #1: each shape's grid and counts equal its single-shape
    decode's at the same caps, bit for bit."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval
    sd, codes = load_stage1_pack(PACK)
    apply = make_kernel_apply(SdfDecoder(DecoderConfig()), sd, device=cuda)
    zs = torch.from_numpy(codes[[0, 7, 21]]).to(cuda)
    caps = (512, 8192, 32768)
    grids, st = grid_eval.decode_grid_hierarchical3_batch(
        apply, zs, 128, 16, 4, 2, *caps, layout="block")
    assert not st["capacity_exceeded"]
    for i in range(3):
        g1, st1 = grid_eval.decode_grid_hierarchical3_device(
            apply, zs[i], 128, 16, 4, 2, *caps, safety=1.2, safety3=2.0,
            layout="block")
        assert torch.equal(grids[i], g1)
        assert st1["active_l3"] == st["active_l3"][i] > 0


def _bank_setup(cuda, route):
    """A chair bank built on the card and a small stage-1 state on it."""
    from latent_diffusion_models_for_shape_sdfs_torch.config import AdConfig
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        auto_decoder as tad)
    shapes = analytic.make_synthetic_split("chair", 8, seed=11)
    bank = adv.bank_from_chairs(shapes, 11, 4096, chunk=4, device=cuda)
    cfg = AdConfig(decoder=DecoderConfig(**{
        **PLANS["small"], "use_dropout": True, "dropout_prob": 0.2,
        "dropout_impl": "pallas", "compute_dtype": "bfloat16"}),
        num_scenes=8, scenes_per_batch=4, samples_per_scene=1024,
        device_data=True, use_pallas=route == "fused")
    st = tad.init_ad_state(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    return shapes, bank, cfg, st, gen


def test_chair_bank_on_card(cuda):
    """bank_from_chairs on the card: labels equal chair_sdf of the rows on
    the card and the host SDF to 3e-6; each side's counted rows have its
    sign; gather on the card equals gather on the CPU bit for bit for the
    same uniforms."""
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
        DeviceSampleBank)
    shapes, bank, *_ = _bank_setup(cuda, "fused")
    params = adv.pack_chairs(shapes, device=cuda)
    assert torch.equal(adv.chair_sdf(params, bank.pos[..., :3]),
                       bank.pos[..., 3])
    for i, s in enumerate(shapes):
        pc, nc = int(bank.pos_count[i]), int(bank.neg_count[i])
        assert pc + nc == 4096
        assert bool((bank.pos[i, :pc, 3] >= 0).all())
        assert bool((bank.neg[i, :nc, 3] < 0).all())
        rows = bank.pos[i].cpu().numpy()
        np.testing.assert_allclose(rows[:, 3], analytic.sdf(s, rows[:, :3]),
                                   atol=3e-6, rtol=0)
    ids = torch.tensor([3, 0, 7, 3], device=cuda)
    u1, u2 = bank.uniforms(torch.Generator(device=cuda).manual_seed(0), 4,
                           1000)
    on_card = bank.gather(ids, u1, u2)
    host = DeviceSampleBank(*(t.cpu() for t in bank))
    on_cpu = host.gather(ids.cpu(), u1.cpu(), u2.cpu())
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("route", ["fused", "autograd"])
def test_bank_step_waits_on_nothing(route, cuda):
    """A bank step (the draw on the card, then either kernel route and
    Adam) under set_sync_debug_mode("error"): no host sync; the kernels
    launch (#4 on the fused route, #3/#3b on the autograd one)."""
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        auto_decoder as tad)
    _, bank, cfg, st, gen = _bank_setup(cuda, route)
    step = tad.make_bank_step(st.decoder, cfg, bank, gen)
    ids = torch.tensor([[1, 5, 2, 6], [0, 3, 7, 4]], device=cuda)
    step(st, ids[0], 0.0, 1)
    before = (profiling.LAUNCHES["fused_train"], profiling.LAUNCHES["relu_dropout_fwd"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = step(st, ids[1], 1.0, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(m["loss"]))
    after = (profiling.LAUNCHES["fused_train"], profiling.LAUNCHES["relu_dropout_fwd"])
    assert (after[0] > before[0]) == (route == "fused")
    assert (after[1] > before[1]) == (route == "autograd")


# --------------- the bf16 decoder's hidden layers on the tensor cores

BF16_LAYERS = [(259, 512), (512, 512), (512, 253)]      # (in, out)


def _bf16_linear_operands(d_in, d_out, cuda, integer):
    """x [2^16, in] bf16, w [out, in], b [out], g [2^16, out] bf16-valued
    fp32; small integers (exact products and fp32 sums) or normals."""
    rng = np.random.default_rng(d_in + d_out)
    n = 1 << 16
    if integer:
        def draw(*shape):
            return rng.integers(-4, 5, shape).astype(np.float32)
    else:
        def draw(*shape):
            return rng.normal(size=shape).astype(np.float32)
    x = torch.from_numpy(draw(n, d_in)).to(cuda).to(torch.bfloat16)
    w = torch.from_numpy(draw(d_out, d_in) / (1 if integer else
                                              np.sqrt(d_in))).to(cuda)
    b = torch.from_numpy(draw(d_out)).to(cuda)
    g = torch.from_numpy(draw(n, d_out)).to(cuda).to(torch.bfloat16).float()
    return x, w, b, g


def _bf16_linear_run(fn, x, w, b, g):
    x = x.clone().requires_grad_()
    w, b = w.clone().requires_grad_(), b.clone().requires_grad_()
    y = fn(x, w, b)
    y.backward(g)
    torch.cuda.synchronize()
    return y.detach(), x.grad, w.grad, b.grad


@pytest.mark.parametrize("d_in,d_out", BF16_LAYERS)
@pytest.mark.parametrize("integer", [False, True])
def test_bf16_linear_matches_plain_version(d_in, d_out, integer, cuda):
    """bf16_linear on the tensor cores against the plain version (fp32
    products of the same bf16 values, TF32 off) at the 8x512 decoder's
    hidden widths and 2^16 rows: y
    within 1e-5 of its max, dx and dW within 1e-2 of each one's max (the
    sum order moves), db and the dtypes equal; with small-integer operands
    every output bit for bit. Each call makes one product of each role
    on the card."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl)
    ops = _bf16_linear_operands(d_in, d_out, cuda, integer)
    n0 = profiling.LAUNCHES.copy()
    got = _bf16_linear_run(bl.bf16_linear, *ops)
    assert _since(n0, BF16_ROLES) == dict.fromkeys(BF16_ROLES, 1)
    want = _bf16_linear_run(bl.bf16_linear_reference, *ops)
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
    if integer:
        for a, r in zip(got, want):
            assert torch.equal(a, r)
        return
    for a, r, tol in zip(got, want, (1e-5, 1e-2, 1e-2, 1e-6)):
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), (tol, err)


def test_bf16_linear_puts_the_flags_back(cuda):
    """TF32 and both halves of bf16 reduced-precision reduction read the
    same after a forward and backward as before, from each setting under
    which cuBLAS runs a bf16 product (split-K off needs cuBLASLt), and
    after a call that raises inside its product."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl)
    m = torch.backends.cuda.matmul

    def flags():
        return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
                m.allow_bf16_reduced_precision_reduction_split_k)

    saved = flags()
    x, w, b, g = _bf16_linear_operands(512, 253, cuda, False)
    try:
        for tf32 in (False, True):
            for red in ((False, True), (True, True)):
                m.allow_tf32 = tf32
                m.allow_bf16_reduced_precision_reduction = red
                before = flags()
                _bf16_linear_run(bl.bf16_linear, x, w, b, g)
                assert flags() == before
                with pytest.raises(RuntimeError):
                    bl.bf16_linear(x, w[:, :-1], b)    # inner sizes differ
                assert flags() == before
    finally:
        m.allow_tf32 = saved[0]
        m.allow_bf16_reduced_precision_reduction = saved[1:]


def _plain_hidden_layers(monkeypatch) -> None:
    """Every bf16 hidden layer with kernel dropout in the plain form: the
    layer substituted by its composition with the plain product
    (bf16_linear_relu_dropout_reference with bf16_linear_reference: fp32
    products of the same bf16 values, the cast, relu_dropout), and the
    padded layout turned off (ops.bf16_linear.pads)."""
    from latent_diffusion_models_for_shape_sdfs_torch.models import (
        decoder as decoder_module)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl)
    monkeypatch.setattr(bl, "pads", lambda t: False)
    monkeypatch.setattr(
        decoder_module, "bf16_linear_relu_dropout",
        lambda x, w, b, seed, rate, layout:
        bl.bf16_linear_relu_dropout_reference(
            x, w, b, seed, rate, linear=bl.bf16_linear_reference))


def test_bf16_training_step_matches_plain_form(cuda, monkeypatch):
    """One autograd step's loss and gradients of a small bf16 decoder
    (skip layer, relu+dropout kernels) with its hidden layers on the
    route configs 3-5 take (bf16_linear_relu_dropout: the tensor cores,
    the padded layout, #3/#3b's layer entries) against the same step with
    that layer substituted by its composition with the plain product
    (bf16_linear_relu_dropout_reference with bf16_linear_reference) and
    the layout turned off: loss 1e-4 relative, each gradient 1e-2 of its
    max."""
    from latent_diffusion_models_for_shape_sdfs_torch import losses
    torch.manual_seed(0)
    dec = SdfDecoder(DecoderConfig(**{
        **PLANS["small"], "use_dropout": True, "dropout_impl": "pallas",
        "compute_dtype": "bfloat16"})).to(cuda).train()
    rng = np.random.default_rng(0)
    n = 1 << 14
    z = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32) / 4
                         ).to(cuda).requires_grad_()
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).to(cuda)
    sdf = torch.from_numpy((0.1 * rng.normal(size=n)).astype(
        np.float32)).to(cuda)
    out = []
    for plain in (False, True):
        if plain:
            _plain_hidden_layers(monkeypatch)
        dec.zero_grad(set_to_none=True)
        z.grad = None
        loss = losses.clamped_l1(dec(z, xyz, seed=7), sdf, 0.1)
        loss.backward()
        out.append((float(loss.detach()), [z.grad.clone()] + [
            p.grad.clone() for p in dec.parameters()]))
    (l1, g1), (l2, g2) = out
    assert l1 == pytest.approx(l2, rel=1e-4)
    for a, r in zip(g1, g2):
        assert float((a - r).abs().max()) <= 1e-2 * float(r.abs().max())


def test_padded_bank_step_matches_plain_form(cuda, monkeypatch):
    """One config-3 bank step on the card (8 x 512, latent 256, 64 x
    16,384 points, bf16, #3/#3b dropout) from the committed chair pack's
    decoder with other chairs' codes (far from the optimum, where the
    batch gradient does not cancel). The hidden layers run on the padded
    layout: 3 padded products of each role (lin0's 259 inputs, lin3's 253
    outputs, the skip layer's cat), none on the 512-wide layers. Against
    the same step with the hidden layers in the plain form (their layer
    substituted by its composition with fp32 products of the same bf16
    values, the layout turned off): the loss within 6e-6, each
    gradient's distance within 0.02 of its norm, the codes' change within
    0.05 of its norm and the same rows moved, the limits of
    benchmark/limits/c3.train.bank.json."""
    import dataclasses
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        auto_decoder as tad)
    ad = ExperimentConfig.load(pathlib.Path(__file__).resolve().parents[1]
                               / "configs" / "config3_chairs_joint").ad
    S, P = ad.scenes_per_batch, ad.samples_per_scene
    cfg = dataclasses.replace(ad, num_scenes=S, use_pallas=False)
    sd, codes = load_stage1_pack(PACK)
    codes = codes[S:2 * S]
    bank = adv.bank_from_chairs(analytic.make_synthetic_split(
        "chair", S, seed=11), 11, P, device=cuda)
    ids = torch.arange(S, device=cuda)
    out = []
    for plain in (False, True):
        if plain:
            _plain_hidden_layers(monkeypatch)
        st = tad.init_ad_state(cfg, params=sd, codes=codes, device=cuda)
        step = tad.make_bank_step(st.decoder, cfg, bank, torch.Generator(
            device=cuda).manual_seed(5))
        n0 = profiling.LAUNCHES.copy()
        loss = float(step(st, ids, 0.0, 17)["loss"])
        grads = {k: p.grad.double() for k, p in
                 st.decoder.named_parameters()}
        grads["codes"] = st.codes.grad.double()
        change = st.codes.detach().double().cpu() - torch.from_numpy(codes)
        out.append((loss, grads, change, _since(n0, PADDED_ROLES)))
        del st, step
    (l1, g1, c1, n1), (l2, g2, c2, n2) = out
    assert n1 == dict.fromkeys(PADDED_ROLES, 3)
    assert not any(n2.values())
    assert abs(l1 - l2) <= 6e-6 * abs(l2)
    for k, r in g2.items():
        gap = float(torch.linalg.vector_norm(g1[k] - r)
                    / torch.linalg.vector_norm(r))
        assert gap <= 0.02, (k, gap)
    n_c1, n_c2 = (float(torch.linalg.vector_norm(c)) for c in (c1, c2))
    assert abs(n_c1 - n_c2) <= 0.05 * n_c2
    assert torch.equal((c1 != 0).any(1), (c2 != 0).any(1))


# ------------------------ the bf16 decoder's fp32 head (csrc/head.cu)

HEAD_SHAPES = [(1 << 20, 512), ((1 << 16) + 131, 512), (7, 512),
               (1000, 264), (300, 8)]
HEAD_WANTS = [("x", "w", "b"), ("x",), ("w", "b")]


def _head_operands(rows, cols, cuda, kind):
    """x [rows, cols] bf16, w [1, cols], b [1] fp32, g [rows, 1] fp32: the
    loss's +-1/rows or 0, or normals; neither bf16-valued."""
    gen = torch.Generator(device=cuda).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=gen, device=cuda).to(
        torch.bfloat16)
    w = torch.randn(1, cols, generator=gen, device=cuda) / cols ** 0.5
    b = torch.randn(1, generator=gen, device=cuda)
    g = torch.randn(rows, 1, generator=gen, device=cuda)
    if kind == "loss":
        g = torch.sign(torch.round(g)) / (rows + 3)
    return x, w, b, g


def _head_run(fn, x, w, b, g, wants=("x", "w", "b")):
    xs = x.clone().requires_grad_("x" in wants)
    ws = w.clone().requires_grad_("w" in wants)
    bs = b.clone().requires_grad_("b" in wants)
    y = fn(xs, ws, bs)
    y.backward(g)
    torch.cuda.synchronize()
    return y.detach(), xs.grad, ws.grad, bs.grad


def _bf16_ulp(t):
    """The bf16 spacing at |t| (the smallest normal's where t is 0)."""
    e = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("rows,cols", HEAD_SHAPES)
@pytest.mark.parametrize("kind", ["loss", "random"])
@pytest.mark.parametrize("wants", HEAD_WANTS, ids="+".join)
def test_head_kernels_match_plain_form(rows, cols, kind, wants, cuda):
    """bf16_head on the card against autograd of bf16_linear_reference
    (TF32 off): dx bit for bit; pred within 2 (cols + 1) 2^-24 of its sum
    of |terms| (fp32 sums in another order); db within 2 sqrt(rows) 2^-24
    sum |g| of g's float64 sum (a kernel that drops a share of the rows
    is further off); dW within one bf16 spacing per element (the same
    sums, rounded once to bf16); the outputs autograd does not ask for
    None; one forward and one backward launch, on row counts that are not
    multiples of either kernel's block."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear import (
        bf16_linear_reference)
    x, w, b, g = _head_operands(rows, cols, cuda, kind)
    n0 = profiling.LAUNCHES.copy()
    y, dx, dw, db = _head_run(hd.bf16_head, x, w, b, g, wants)
    assert _since(n0, HEAD) == {"head_fwd": 1, "head_bwd": 1}
    y_r, dx_r, dw_r, _ = _head_run(bf16_linear_reference, x, w, b, g,
                                   wants)
    u = 2.0 ** -24
    terms = x.float().abs() @ w.to(torch.bfloat16).float().abs().t()
    assert y.dtype == torch.float32 and y.shape == (rows, 1)
    assert bool(((y - y_r).abs() <= 2 * (cols + 1) * u
                 * (terms + b.abs())).all())
    if "x" in wants:
        assert dx.dtype == torch.bfloat16 and torch.equal(dx, dx_r)
    else:
        assert dx is None
    if "w" in wants:
        assert dw.dtype == torch.float32 and dw.shape == w.shape
        assert torch.equal(dw, dw.to(torch.bfloat16).float())
        assert bool(((dw - dw_r).abs() <= _bf16_ulp(
            torch.maximum(dw.abs(), dw_r.abs()))).all())
    else:
        assert dw is None
    if "b" in wants:
        g64 = g.double()
        assert db.shape == (1,) and db.dtype == torch.float32
        assert float((db.double() - g64.sum()).abs()) <= (
            2 * rows ** 0.5 * u * float(g64.abs().sum()))
    else:
        assert db is None


def test_head_launches_are_bit_identical(cuda):
    """Two forward and backward passes at 2^20 + 131 rows x 512 give the
    same bits in every output (a fixed grid, fixed orders, no atomics)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
    ops = _head_operands((1 << 20) + 131, 512, cuda, "loss")
    a = _head_run(hd.bf16_head, *ops)
    c = _head_run(hd.bf16_head, *ops)
    for p, q in zip(a, c):
        assert torch.equal(p, q)


def test_head_wrapper_checks_inputs(cuda):
    """On the card: rows that are not whole 16 bytes or wider than the
    kernels take, an fp32 x, and operands on two devices raise; takes()
    says the same of each input."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
    x, w, b, _ = _head_operands(64, 512, cuda, "random")
    assert hd.takes(x) and not hd.takes(x.float())
    for cols in (509, hd.MAX_COLS + 8):
        xo = torch.zeros(4, cols, dtype=torch.bfloat16, device=cuda)
        assert not hd.takes(xo)
        with pytest.raises(ValueError, match="multiples of 8"):
            hd.bf16_head(xo, torch.zeros(1, cols, device=cuda), b)
    with pytest.raises(ValueError, match="bfloat16"):
        hd.bf16_head(x.float(), w, b)
    with pytest.raises(ValueError, match="w on cpu"):
        hd.bf16_head(x, w.cpu(), b)


def test_head_step_counts_its_kernels_and_matches_plain_head(cuda,
                                                             monkeypatch):
    """One config-3 bank step (8 x 512, 64 x 16,384 points, bf16, #3/#3b
    dropout) from the committed chair pack with other chairs' codes: the
    head runs one forward and one backward launch of csrc/head.cu; the
    same step with the head in the plain form (bf16_linear_reference in
    place of bf16_head) reads the loss within 1e-6 and every gradient
    within 5e-3 of its norm (only the order of the head's fp32 sums
    moves)."""
    import dataclasses
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear import (
        bf16_linear_reference)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        auto_decoder as tad)
    ad = ExperimentConfig.load(pathlib.Path(__file__).resolve().parents[1]
                               / "configs" / "config3_chairs_joint").ad
    S, P = ad.scenes_per_batch, ad.samples_per_scene
    cfg = dataclasses.replace(ad, num_scenes=S, use_pallas=False)
    sd, codes = load_stage1_pack(PACK)
    codes = codes[S:2 * S]
    bank = adv.bank_from_chairs(analytic.make_synthetic_split(
        "chair", S, seed=11), 11, P, device=cuda)
    ids = torch.arange(S, device=cuda)
    out = []
    for head in (hd.bf16_head, bf16_linear_reference):
        monkeypatch.setattr(hd, "bf16_head", head)
        st = tad.init_ad_state(cfg, params=sd, codes=codes, device=cuda)
        step = tad.make_bank_step(st.decoder, cfg, bank, torch.Generator(
            device=cuda).manual_seed(5))
        n0 = profiling.LAUNCHES.copy()
        loss = float(step(st, ids, 0.0, 17)["loss"])
        grads = {k: p.grad.double() for k, p in
                 st.decoder.named_parameters()}
        grads["codes"] = st.codes.grad.double()
        out.append((loss, grads, _since(n0, HEAD)))
        del st, step
    (l1, g1, n1), (l2, g2, n2) = out
    assert n1 == {"head_fwd": 1, "head_bwd": 1}
    assert n2 == {"head_fwd": 0, "head_bwd": 0}
    assert abs(l1 - l2) <= 1e-6 * abs(l2)
    for k, r in g2.items():
        gap = float(torch.linalg.vector_norm(g1[k] - r)
                    / torch.linalg.vector_norm(r))
        assert gap <= 5e-3, (k, gap)


# ------- the decoder's input and skip operands from per-scene codes
#                                              (csrc/decoder_input.cu)

DI = ("decoder_input.fwd", "decoder_input.bwd", "skip_input.fwd",
      "skip_input.bwd")
# (S, P, L, W): config 3's step, odd scene counts, P off the work item's
# 128 rows, a latent width off 8 and 4
DI_SHAPES = [(64, 16384, 256, 256), (1, 1000, 256, 256), (3, 16384 + 131,
             256, 256), (3, 77, 13, 24), (2, 333, 37, 16), (5, 129, 8, 8)]


def _di_operands(S, P, L, W, cuda):
    """z [S, L] and xyz [S, P, 3] fp32, x [S P, W] bf16, and cotangents
    d0 [S P, T] (lin0's input) and d4 [S P, W + T] (the skip layer's)
    bf16, T = L + 3 rounded up to 8."""
    gen = torch.Generator(device=cuda).manual_seed(S * P + L)
    T = -(-(L + 3) // 8) * 8
    z = torch.randn(S, L, generator=gen, device=cuda) * 0.3
    xyz = torch.rand(S, P, 3, generator=gen, device=cuda) * 2 - 1
    x = torch.randn(S * P, W, generator=gen, device=cuda).to(torch.bfloat16)
    d0 = (torch.randn(S * P, T, generator=gen, device=cuda) / P).to(
        torch.bfloat16)
    d4 = (torch.randn(S * P, W + T, generator=gen, device=cuda) / P).to(
        torch.bfloat16)
    return z, xyz, x, d0, d4


def _di_composition(z, xyz):
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear import (
        pad_columns)
    S, P, L = *xyz.shape[:2], z.shape[1]
    zf = z[:, None, :].expand(S, P, L).reshape(S * P, L)
    return pad_columns([zf.to(torch.bfloat16),
                        xyz.reshape(-1, 3).to(torch.bfloat16)])


def _di_depth(P, chunks):
    """The most fp32 additions on any path of csrc/decoder_input.cu's
    column sums: a lane's rows of a work item, the lanes, the items."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        decoder_input as di)
    lanes = 256 // chunks
    return (-(-di._ITEM_ROWS // lanes) + lanes + -(-P // di._ITEM_ROWS))


@pytest.mark.parametrize("S,P,L,W", DI_SHAPES)
def test_decoder_input_kernels_match_composition(S, P, L, W, cuda):
    """decoder_input and skip_input on the card: both outputs bit for bit
    the cast + pad_columns (+ torch.cat after x); skip_input's x gradient
    bit for bit the cotangent's first W columns, dense; each dz within its
    fp32 sums' error (the summation's depth x 2^-24 x sum |d|) of the
    float64 per-scene sum; one launch of each pass."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        decoder_input as di)
    z0, xyz, x0, d0, d4 = _di_operands(S, P, L, W, cuda)
    ref = _di_composition(z0, xyz)
    for fn, d, xw in (("decoder_input", d0, 0), ("skip_input", d4, W)):
        z = z0.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        n0 = profiling.LAUNCHES.copy()
        out = (di.decoder_input(z, xyz) if fn == "decoder_input"
               else di.skip_input(x, z, xyz))
        want = ref if fn == "decoder_input" else torch.cat([x0, ref], -1)
        assert out.dtype == torch.bfloat16 and torch.equal(out, want)
        out.backward(d)
        torch.cuda.synchronize()
        assert _since(n0, (f"{fn}.fwd", f"{fn}.bwd")) == {
            f"{fn}.fwd": 1, f"{fn}.bwd": 1}
        if fn == "skip_input":
            assert x.grad.is_contiguous() and torch.equal(x.grad, d4[:, :W])
        part = d[:, xw:xw + L].double().reshape(S, P, L)
        depth = _di_depth(P, xw // 8 + -(-L // 8))
        bound = depth * 2.0 ** -24 * part.abs().sum(1)
        assert z.grad.dtype == torch.float32 and z.grad.shape == (S, L)
        assert bool(((z.grad.double() - part.sum(1)).abs() <= bound).all())


def test_decoder_input_dz_is_the_old_sum_without_its_rounding(cuda):
    """At config 3's step: the two functions' dz added against the flat
    route's, sum_p fp32(bf16(d0 + d4)) over each scene's rows: within one
    bf16 rounding of the add (2^-8 sum |d0 + d4|) and the sums' error;
    against the float64 sum of d0 + d4 closer than the flat route."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        decoder_input as di)
    S, P, L, W = DI_SHAPES[0]
    z0, xyz, x, d0, d4 = _di_operands(S, P, L, W, cuda)
    z = z0.clone().requires_grad_()
    torch.autograd.backward([di.decoder_input(z, xyz),
                             di.skip_input(x, z, xyz)], [d0, d4])
    zc = z0.clone().requires_grad_()     # lin0's input, two consumers
    _di_composition(zc, xyz).backward(d0 + d4[:, W:])
    a = d0[:, :L].double().reshape(S, P, L)
    b = d4[:, W:W + L].double().reshape(S, P, L)
    exact = (a + b).sum(1)
    bound = (2.0 ** -8 * (a + b).abs().sum(1)
             + 2 * P * 2.0 ** -24 * (a.abs() + b.abs()).sum(1))
    assert bool(((z.grad.double() - zc.grad.double()).abs() <= bound).all())
    assert float((z.grad.double() - exact).norm()) < float(
        (zc.grad.double() - exact).norm())


def test_decoder_input_launches_are_bit_identical(cuda):
    """Two passes of each function at 3 x (16,384 + 131) points give the
    same bits in every output (fixed work items, fixed orders, no
    atomics)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        decoder_input as di)
    z0, xyz, x0, d0, d4 = _di_operands(*DI_SHAPES[2], cuda)
    runs = []
    for _ in range(2):
        z, x = z0.clone().requires_grad_(), x0.clone().requires_grad_()
        a, b = di.decoder_input(z, xyz), di.skip_input(x, z, xyz)
        torch.autograd.backward([a, b], [d0, d4])
        runs.append((a, b, z.grad, x.grad))
    for p, q in zip(*runs):
        assert torch.equal(p, q)


def test_decoder_input_wrappers_refuse(cuda):
    """On the card: xyz with a gradient, fp64 codes, an x of another width
    than multiples of 8 and operands on two devices raise ValueError
    before a launch; a skip row wider than the backward's 256 chunks of 8
    columns fails at the backward's launch. bf16 xyz is taken: its rows
    are bit for bit those of its fp32 value."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        decoder_input as di)
    z, xyz, x, _, _ = _di_operands(2, 40, 16, 8, cuda)
    xg = xyz.clone().requires_grad_()
    n0 = profiling.LAUNCHES.copy()
    with pytest.raises(ValueError, match="xyz asks for a gradient"):
        di.decoder_input(z, xg)
    with pytest.raises(ValueError, match="xyz asks for a gradient"):
        di.skip_input(x, z, xg)
    with pytest.raises(ValueError, match="kernels take"):
        di.decoder_input(z.double(), xyz)
    with pytest.raises(ValueError, match="kernels take"):
        di.decoder_input(z, xyz.cpu())
    with pytest.raises(ValueError, match="skip_input"):
        di.skip_input(torch.zeros(80, 12, dtype=torch.bfloat16,
                                  device=cuda), z, xyz)
    assert _since(n0, DI) == dict.fromkeys(DI, 0)
    xb = xyz.to(torch.bfloat16)
    assert torch.equal(di.decoder_input(z, xb),
                       di.decoder_input(z, xb.float()))
    wide = torch.zeros(80, 8 * 256, dtype=torch.bfloat16, device=cuda,
                       requires_grad=True)
    zg = z.clone().requires_grad_()
    out = di.skip_input(wide, zg, xyz)
    with pytest.raises(RuntimeError, match="skip_input.bwd: launch failed"):
        out.backward(torch.ones_like(out))


DI_ROUTES = {          # decoder plans (latent 13 + xyz 3; hidden 40)
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


@pytest.mark.parametrize("route", sorted(DI_ROUTES))
def test_decoder_per_scene_routes_on_the_card(route, cuda):
    """The decoder given z [S, L] and xyz [S, P, 3] on the card against
    the same decoder given the flat inputs (z expanded over the points):
    the padded bf16 routes with kernel dropout or none go through
    decoder_input and skip_input (one launch of each pass), pred and every
    weight gradient bit for bit, z's gradient within one bf16 rounding of
    the cotangents' add (2^-8 of its norm); every other route expands z
    itself, bit for bit the flat form, launching neither."""
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    torch.manual_seed(3)
    dec = SdfDecoder(DecoderConfig(**{
        **dict(latent_size=13, hidden_dim=40, num_layers=4, latent_in=(2,),
               dropout_prob=0.2), **DI_ROUTES[route]})).to(cuda)
    dec.train(route != "bf16_eval")
    S, P = 3, 16384 + 131
    gen = torch.Generator(device=cuda).manual_seed(8)
    z0 = torch.randn(S, 13, generator=gen, device=cuda) * 0.3
    xyz = torch.rand(S, P, 3, generator=gen, device=cuda) * 2 - 1
    g = torch.randn(S, P, generator=gen, device=cuda) / P
    out = []
    for flat in (False, True):
        dec.zero_grad(set_to_none=True)
        z = z0.clone().requires_grad_()
        n0 = profiling.LAUNCHES.copy()
        pred = (dec(z[:, None, :].expand(S, P, 13).reshape(-1, 13),
                    xyz.reshape(-1, 3), seed=21).reshape(S, P) if flat
                else dec(z, xyz, seed=21))
        (pred * g).sum().backward()
        torch.cuda.synchronize()
        grads = {k: p.grad for k, p in dec.named_parameters()}
        out.append((pred.detach(), grads, z.grad, _since(n0, DI)))
    (p1, g1, z1, n1), (p2, g2, z2, n2) = out
    kernels = route in ("bf16_kernel_dropout", "bf16_eval")
    assert n1 == dict.fromkeys(DI, int(kernels))
    assert n2 == dict.fromkeys(DI, 0)
    assert p1.shape == (S, P) and torch.equal(p1, p2)
    for k, r in g2.items():
        assert torch.equal(g1[k], r), k
    if kernels:
        gap = float(torch.linalg.vector_norm(z1 - z2)
                    / torch.linalg.vector_norm(z2))
        assert gap <= 2.0 ** -8, gap
    else:
        assert torch.equal(z1, z2)


def test_bank_step_per_scene_matches_flat_entry(cuda):
    """One config-3 bank step (8 x 512, 64 x 16,384 points, bf16, #3/#3b
    dropout) from the committed chair pack with other chairs' codes, per
    scene (the package's route: one launch of each of decoder_input's and
    skip_input's passes) against the same draw and loss with the decoder
    given the flat inputs (z expanded over the points, no launch of
    theirs): the loss and every decoder gradient bit for bit; the codes'
    gradient within 2^-8 of its norm (one bf16 rounding of the
    cotangents' add fewer)."""
    import dataclasses
    from latent_diffusion_models_for_shape_sdfs_torch import losses
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.models.latent_table \
        import gather_codes
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        auto_decoder as tad)
    ad = ExperimentConfig.load(pathlib.Path(__file__).resolve().parents[1]
                               / "configs" / "config3_chairs_joint").ad
    S, P = ad.scenes_per_batch, ad.samples_per_scene
    cfg = dataclasses.replace(ad, num_scenes=S, use_pallas=False)
    sd, codes = load_stage1_pack(PACK)
    codes = codes[S:2 * S]
    bank = adv.bank_from_chairs(analytic.make_synthetic_split(
        "chair", S, seed=11), 11, P, device=cuda)
    ids = torch.arange(S, device=cuda)

    def flat_entry(st):
        """make_bank_step's draw and autograd loss, the decoder given z
        expanded over the points as [S P, L]."""
        xyz, sdf = bank.sample_batch(torch.Generator(
            device=cuda).manual_seed(5), ids, P)
        st.decoder.train()
        st.optimizer.zero_grad(set_to_none=True)
        z = gather_codes(st.codes, ids, cfg.code_bound)
        L = z.shape[-1]
        pred = st.decoder(z[:, None, :].expand(S, P, L).reshape(-1, L),
                          xyz.reshape(-1, 3), seed=17)
        l1 = losses.clamped_l1(pred, sdf.reshape(-1), cfg.clamp_dist, S * P)
        reg = losses.code_reg(z, 0.0, cfg.code_reg_lambda,
                              cfg.code_reg_warmup_epochs,
                              num_sdf_samples=S,
                              squared=cfg.code_reg_squared)
        (l1 + reg).backward()
        return float(l1.detach() + reg.detach())

    out = []
    for flat in (False, True):
        st = tad.init_ad_state(cfg, params=sd, codes=codes, device=cuda)
        n0 = profiling.LAUNCHES.copy()
        if flat:
            loss = flat_entry(st)
        else:
            step = tad.make_bank_step(st.decoder, cfg, bank, torch.Generator(
                device=cuda).manual_seed(5))
            loss = float(step(st, ids, 0.0, 17)["loss"])
        grads = {k: p.grad.clone() for k, p in
                 st.decoder.named_parameters()}
        grads["codes"] = st.codes.grad.clone()
        out.append((loss, grads, _since(n0, DI)))
        del st
    (l1, g1, n1), (l2, g2, n2) = out
    assert n1 == dict.fromkeys(DI, 1) and n2 == dict.fromkeys(DI, 0)
    assert l1 == l2
    for k, r in g2.items():
        if k != "codes":
            assert torch.equal(g1[k], r), k
    gap = float(torch.linalg.vector_norm(g1["codes"] - g2["codes"])
                / torch.linalg.vector_norm(g2["codes"]))
    assert gap <= 2.0 ** -8, gap


def test_recon_capture_failure_raises(cuda):
    """A step that cannot be captured (a prior that reads a value on the
    host) raises; the run does not fall back to the eager loop. Last in
    the file: the failed capture is left to the process's end."""
    rec, dec, cfg, xyz, sdf, prior, draws = _recon_setup(cuda, 1, True)
    fn = prior["denoise_fn"]
    prior["denoise_fn"] = lambda z_t, t: fn(z_t, t) * float(z_t.sum() != 0)
    opt = rec.LatentOpt(dec, cfg, 1, len(sdf), sds_prior=prior)
    opt.load(xyz, sdf, draws)
    with pytest.raises(RuntimeError):
        opt.graphed()
    assert opt.graph is None
