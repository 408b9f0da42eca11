"""PyTorch port vs the JAX package: utils/profiling on the CPU.

`debug_nans` (a NaN in a division, in a label, in backward, under
`no_grad`; healthy steps bit-equal with and without the checker; CUDA
graph capture refused), `cost_analysis` (a matrix product and a decoder
forward against XLA's count; each kernel's declared count against its
plain version's aten count), the kernel hooks, `trace`, and `span` off
and on. Same numpy inputs through both packages; JAX on the CPU."""

import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.train import auto_decoder as jad
from latent_diffusion_models_for_shape_sdfs_tpu.utils import profiling as jprof
from latent_diffusion_models_for_shape_sdfs_torch import cli
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import pipeline as tpipe
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import fused_train as ft
from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    hoisted_rows, pack_weights, pairs_flops)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_eval_op import (
    eval_flops, fused_eval, packed_plain)
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad
from latent_diffusion_models_for_shape_sdfs_torch.train.graph import (
    capture_step)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    params_from_jax)
from latent_diffusion_models_for_shape_sdfs_torch.utils.profiling import (
    LAUNCHES, check_kernel, cost_analysis, debug_nans, kernel_pass, launched,
    trace)

torch.set_num_threads(2)
NAN_PLAN = dict(latent_size=8, hidden_dim=128, num_layers=2, latent_in=(),
                use_dropout=False)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- debug_nans

def test_nan_in_a_division_raises_in_both_packages():
    with jprof.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jax.jit(lambda v: v / v)(jnp.zeros(())))
    with debug_nans():
        with pytest.raises(FloatingPointError,
                           match=r"invalid value \(nan\) encountered in "
                                 r"aten\.div"):
            torch.zeros(()) / torch.zeros(())


def test_nan_checker_sees_no_grad_and_backward_ops():
    with debug_nans():
        with torch.no_grad(), pytest.raises(FloatingPointError):
            torch.zeros(2) / torch.zeros(2)
        x = torch.zeros(3, requires_grad=True)
        norm = torch.linalg.vector_norm(x)          # 0: finite forward
        with pytest.raises(FloatingPointError):
            norm.backward()                         # x / |x| = 0 / 0
        torch.ones(2).reshape(2, 1)                 # views write nothing
        torch.empty(8)                              # nor allocations
    with debug_nans(False):
        torch.zeros(2) / torch.zeros(2)
    torch.zeros(2) / torch.zeros(2)


def _nan_batch(S=1, P=256):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (S, P, 3)).astype(np.float32)
    sdf = (0.1 * rng.normal(size=(S, P))).astype(np.float32)
    sdf[0, 17] = np.nan
    return xyz, sdf


def test_jax_nan_label_step_raises():
    """The reference's checker catches the NaN label at the first op that
    reads it."""
    cfg = jcfg.AdConfig(decoder=jcfg.DecoderConfig(**NAN_PLAN), num_scenes=1,
                        scenes_per_batch=1, samples_per_scene=256)
    dec = JaxDecoder(cfg.decoder)
    st = jad.init_ad_state(cfg, dec, jax.random.PRNGKey(0))
    xyz, sdf = _nan_batch()
    with jprof.debug_nans(True):
        with pytest.raises(FloatingPointError, match="reshape"):
            _, m = jad.make_ad_train_step(dec, cfg)(
                st, jnp.zeros((1,), jnp.int32), jnp.asarray(xyz),
                jnp.asarray(sdf), jnp.asarray(0.0), jax.random.PRNGKey(1))
            jax.block_until_ready(m["loss"])


@pytest.mark.parametrize("fused", [False, True])
def test_nan_label_step_raises_on_both_routes(fused):
    """The port's step on the NaN label: without the checker it returns
    loss nan with finite gradient norms; under it, it raises at the
    label's clamp on either route."""
    cfg = tcfg.AdConfig(decoder=tcfg.DecoderConfig(**NAN_PLAN),
                        num_scenes=1, scenes_per_batch=1,
                        samples_per_scene=256, use_pallas=fused)
    xyz, sdf = _nan_batch()
    args = (torch.zeros(1, dtype=torch.int64), _t(xyz), _t(sdf), 0.0, 1)
    st = tad.init_ad_state(cfg, device="cpu")
    m = tad.make_ad_train_step(st.decoder, cfg)(st, *args)
    assert np.isnan(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm_dec"]))
    st = tad.init_ad_state(cfg, device="cpu")
    step = tad.make_ad_train_step(st.decoder, cfg)
    with debug_nans(), pytest.raises(FloatingPointError, match="clamp"):
        step(st, *args)


HEALTHY_PLAN = dict(latent_size=8, hidden_dim=16, num_layers=2,
                    latent_in=(), use_dropout=False)


def _healthy_batch():
    rng = np.random.default_rng(3)
    return (rng.uniform(-1, 1, (1, 256, 3)).astype(np.float32),
            (0.1 * rng.normal(size=(1, 256))).astype(np.float32))


def test_jax_healthy_step_passes_under_the_checker():
    cfg = jcfg.AdConfig(decoder=jcfg.DecoderConfig(**HEALTHY_PLAN),
                        num_scenes=1, scenes_per_batch=1,
                        samples_per_scene=256)
    dec = JaxDecoder(cfg.decoder)
    st = jad.init_ad_state(cfg, dec, jax.random.PRNGKey(0))
    xyz, sdf = _healthy_batch()
    with jprof.debug_nans(True):
        _, m = jad.make_ad_train_step(dec, cfg)(
            st, jnp.zeros((1,), jnp.int32), jnp.asarray(xyz),
            jnp.asarray(sdf), jnp.asarray(0.0), jax.random.PRNGKey(1))
        assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("fused", [False, True])
def test_healthy_step_is_bit_equal_under_the_checker(fused):
    """A 2 x 16 step from JAX's initial state, with and without the
    checker: every metric, parameter, code and Adam moment the same
    bits."""
    jc = jcfg.AdConfig(decoder=jcfg.DecoderConfig(**HEALTHY_PLAN),
                       num_scenes=1, scenes_per_batch=1,
                       samples_per_scene=256)
    jst = jad.init_ad_state(jc, JaxDecoder(jc.decoder),
                            jax.random.PRNGKey(0))
    cfg = tcfg.AdConfig(decoder=tcfg.DecoderConfig(**HEALTHY_PLAN),
                        num_scenes=1, scenes_per_batch=1,
                        samples_per_scene=256, use_pallas=fused)
    xyz, sdf = _healthy_batch()
    runs = []
    for checked in (False, True):
        st = tad.init_ad_state(cfg, device="cpu", params=params_from_jax(
            jax.tree.map(np.asarray, jst.params)), codes=np.array(jst.codes))
        step = tad.make_ad_train_step(st.decoder, cfg)
        with debug_nans(checked):
            m = step(st, torch.zeros(1, dtype=torch.int64), _t(xyz), _t(sdf),
                     0.0, 1)
        runs.append((m, st))
    (m0, s0), (m1, s1) = runs
    for k in ("loss", "loss_l1", "grad_norm_dec", "grad_norm_lat"):
        assert torch.equal(m0[k], m1[k]), k
    assert torch.equal(s0.codes, s1.codes)
    for (k, a), b in zip(s0.decoder.state_dict().items(),
                         s1.decoder.state_dict().values()):
        assert torch.equal(a, b), k
    for p0, p1 in zip(s0.optimizer.state.values(),
                      s1.optimizer.state.values()):
        for k in p0:
            assert torch.equal(p0[k], p1[k]), k


def test_capture_step_raises_under_the_checker():
    with debug_nans(), pytest.raises(RuntimeError, match="debug_nans"):
        capture_step(lambda: None, [torch.zeros(1)])


def test_cli_debug_nans_stops_training_on_a_nan_label(tmp_path):
    """train-ad --debug-nans (run_train_ad(debug_nans=True)) on a store
    whose first scene has NaN labels raises; without the flag the same
    run completes (loss nan)."""
    d = tmp_path / "exp"
    cli.main(["--device", "cpu", "init-experiment", str(d), "--data",
              "analytic:sphere", "--scenes", "2",
              *(a for kv in ("ad.decoder.latent_size=8",
                             "ad.decoder.hidden_dim=32",
                             "ad.decoder.num_layers=2",
                             "ad.decoder.latent_in=[]",
                             "ad.decoder.use_dropout=false",
                             "ad.scenes_per_batch=2",
                             "ad.samples_per_scene=256",
                             "ad.num_epochs=2")
                for a in ("--set", kv))])
    ds = tpipe.build_dataset(tcfg.ExperimentConfig.load(d))
    ds.pos[0][:, 3] = np.nan
    ds.neg[0][:, 3] = np.nan
    with pytest.raises(FloatingPointError):
        tpipe.run_train_ad(str(d), dataset=ds, debug_nans=True,
                           device="cpu")
    tpipe.run_train_ad(str(d), dataset=ds, device="cpu")
    recs = [json.loads(x) for x in (d / "logs" / "train_ad.jsonl")
            .read_text().splitlines()]
    assert any(r.get("loss_l1") is not None and np.isnan(r["loss_l1"])
               for r in recs)


# ---------------------------------------------------------- cost_analysis

def test_matmul_cost_matches_jax():
    a = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    ref = jprof.cost_analysis(lambda x, y: x @ y, jnp.asarray(a),
                              jnp.asarray(a))
    ours = cost_analysis(lambda x, y: x @ y, _t(a), _t(a))
    assert ours["flops"] == ref["flops"] == 2 * 256 ** 3
    assert ours["bytes accessed"] == ref["bytes accessed"] == 3 * 256 ** 2 * 4


def test_decoder_forward_cost_within_5pct_of_jax():
    """A 4 x 128 decoder (skip at 2) forward over 1,000 points: the port
    counts its matrix products (2 x 49,280 a point); XLA also counts the
    elementwise ops, the weight norm's among them: it reads 1.2% more."""
    plan = dict(latent_size=8, hidden_dim=128, num_layers=4, latent_in=(2,),
                use_dropout=False)
    jdec = JaxDecoder(jcfg.DecoderConfig(**plan))
    params = jdec.init_params(jax.random.PRNGKey(0))
    dec = SdfDecoder(tcfg.DecoderConfig(**plan))
    dec.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(1)
    z = rng.normal(size=(1000, 8)).astype(np.float32)
    xyz = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    ref = jprof.cost_analysis(lambda p, a, b: jdec.apply({"params": p}, a, b),
                              params, jnp.asarray(z), jnp.asarray(xyz))
    with torch.no_grad():
        ours = cost_analysis(dec, _t(z), _t(xyz))
    assert ours["flops"] == 2 * 1000 * (11 * 128 + 128 * 117 + 128 * 128
                                        + 128 * 128 + 128)
    gap = ref["flops"] / ours["flops"] - 1
    assert 0 <= gap < 0.05, gap


PLANS = {"chair 8x512": dict(),
         "small skip": dict(latent_size=16, hidden_dim=128, num_layers=3,
                            latent_in=(2,))}


def _ew(plan):
    torch.manual_seed(0)
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False, **plan))
    return precompute_eval_weights(dec, dec.state_dict(), torch.bfloat16)


@pytest.mark.parametrize("plan", list(PLANS))
def test_eval_kernel_count_is_its_plain_versions(plan):
    """Kernel #1 through its op (the registered formula, eval_flops)
    counts what its plain version `packed_plain` counts on the same
    operands; at the padded widths it multiplies, within 1% of
    fast_apply's count at the true widths for the chair decoder."""
    ew = _ew(PLANS[plan])
    w, meta = pack_weights(ew)
    meta_t = torch.from_numpy(meta)
    z = torch.randn(ew.latent_size)
    rows = hoisted_rows(ew, meta, z)
    for n in (256, 1000):
        xyz = torch.rand(n, 3) * 2 - 1
        op = cost_analysis(fused_eval, xyz, w, rows, meta_t, ew.use_tanh)
        plain = cost_analysis(packed_plain, xyz, w, rows, meta_t,
                              ew.use_tanh)
        assert op["flops"] == plain["flops"] == eval_flops(n, meta)
        if plan == "chair 8x512":
            true = cost_analysis(fast_apply, ew, z, xyz)["flops"]
            assert abs(op["flops"] / true - 1) < 0.01


@pytest.mark.parametrize("plan", list(PLANS))
def test_pairs_kernel_count_is_its_plain_versions(plan):
    ew = _ew(PLANS[plan])
    for n, s in ((512, 3), (1000, 1)):
        codes = torch.randn(s, ew.latent_size)
        sids = torch.randint(0, s, (n,))
        xyz = torch.rand(n, 3) * 2 - 1
        plain = cost_analysis(lambda: fast_apply(ew, codes[sids], xyz))
        assert plain["flops"] == pairs_flops(ew, n)


@pytest.mark.parametrize("shape", [(300, 512), (64, 253)])
def test_relu_dropout_counts_no_flops(shape):
    x = torch.randn(*shape).to(torch.bfloat16)
    assert cost_analysis(rd.relu_dropout_reference, x, 3, 0.2)["flops"] == 0
    assert cost_analysis(rd.relu_dropout_bwd_reference, x, x, 3,
                         0.2)["flops"] == 0


@pytest.mark.parametrize("plan,S,P,rate", [
    (dict(latent_size=16, hidden_dim=128, num_layers=3, latent_in=(2,)),
     2, 256, 0.2),
    (dict(latent_size=8, hidden_dim=64, num_layers=2, latent_in=()),
     3, 512, 0.0)])
def test_train_kernel_count_is_its_plain_versions(plan, S, P, rate):
    """Kernel #4's train_flops equals its plain version's count: every
    point's forward, wgrad and dgrad products, and the per-scene latent
    rows with their two backward products."""
    ew = _ew(plan)
    rng = np.random.default_rng(0)
    z = _t(rng.normal(size=(S, ew.latent_size)).astype(np.float32))
    xyz = _t(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    sdf = _t((0.1 * rng.normal(size=(S, P))).astype(np.float32))
    plain = cost_analysis(ft.fused_train_reference, ew, z, xyz, sdf, S * P,
                          0.1, rate, 7)
    assert plain["flops"] == ft.train_flops(ew, S, P)
    assert ft.train_flops(ew, S, P) == 2 * S * P * ft.macs_per_point(ew) + 6 * S * sum(
        lay.w_z.numel() for lay in ew.layers if lay.w_z is not None)


def test_kernel_hooks_report_only_inside_the_modes():
    """The launch record adds a launch's work, a kernel_pass counts once
    what is launched and dispatched inside it; the record and the NaN
    hook raise naming the kernel; outside the modes they count the launch
    and nothing else."""
    a, b = torch.ones(2, 3), torch.ones(3, 5)
    bad = torch.tensor([1.0, float("nan")])
    launched("k", 0, bad, flops=10, nbytes=20)
    check_kernel("k", bad)

    def fn():
        launched("k", 0, flops=10, nbytes=20)
        with kernel_pass("pass", 100, 200):
            launched("inner", 0, flops=1, nbytes=1)
            a @ b
        a @ b

    assert cost_analysis(fn) == {"flops": 10 + 100 + 2 * 2 * 3 * 5,
                                 "bytes accessed": 20 + 200
                                 + 4 * (6 + 15 + 10)}
    with debug_nans():
        launched("k", 0, torch.ones(2), torch.tensor([1, 2]))
        check_kernel("k", torch.ones(2), torch.tensor([1, 2]))
        with pytest.raises(FloatingPointError, match="encountered in k$"):
            launched("k", 0, torch.ones(2), bad)
        with pytest.raises(FloatingPointError, match="encountered in k$"):
            check_kernel("k", torch.ones(2), bad)


@pytest.mark.parametrize("rc", [0, 2, -1])
def test_launch_record_counts_a_launch_or_raises(rc):
    """A zero return code counts one launch under its name; any other
    raises RuntimeError naming the launch and its code, and counts
    nothing."""
    before = LAUNCHES.copy()
    if rc:
        with pytest.raises(RuntimeError,
                           match=rf"^test\.launch: .*cudaError {rc}$"):
            launched("test.launch", rc, torch.ones(2), flops=1, nbytes=1)
        assert LAUNCHES == before
    else:
        launched("test.launch", rc)
        assert LAUNCHES - before == {"test.launch": 1}


@pytest.mark.parametrize("where", [0, 1])
def test_launch_record_nan_check_names_the_launch(where):
    """Under debug_nans a NaN in any tensor the launch reports, an input
    or an output, raises naming the launch; integer tensors and healthy
    floats pass; the launch is counted before the check."""
    ts = [torch.ones(4), torch.arange(3), torch.zeros(2, 2)]
    ts[2 * where][-1] = float("nan")
    before = LAUNCHES.copy()
    with debug_nans():
        launched("test.nan_ok", 0, torch.ones(4), torch.arange(3))
        with pytest.raises(FloatingPointError,
                           match=r"invalid value \(nan\) encountered in "
                                 r"test\.nan$"):
            launched("test.nan", 0, *ts)
    assert LAUNCHES - before == {"test.nan_ok": 1, "test.nan": 1}


@pytest.mark.parametrize("in_pass", [False, True])
def test_launch_record_adds_its_cost_once(in_pass):
    """Under cost_analysis a launch's FLOPs and bytes are added once; a
    launch inside a kernel_pass adds nothing beyond the pass's own."""
    def fn():
        launched("test.cost", 0, flops=7, nbytes=11)
        if in_pass:
            with kernel_pass("test.pass", 100, 200):
                launched("test.cost", 0, flops=7, nbytes=11)

    want = {"flops": 7 + (100 if in_pass else 0),
            "bytes accessed": 11 + (200 if in_pass else 0)}
    assert cost_analysis(fn) == want


# ------------------------------------------------------------------ trace

def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    a = torch.randn(64, 64)
    with trace(tmp_path, device="cpu"):
        (a @ a).sum()
    files = list(pathlib.Path(tmp_path).glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with trace(tmp_path / "cuda"):
            pass


# ------------------------------------------------------------------ spans

def test_span_off_is_one_shared_no_op(monkeypatch):
    """No profiler: the same object every call, no record kept, no CUDA
    event made and no record_function entered."""
    def refuse(*a, **k):
        raise AssertionError("called while off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = list(profiling._SPANS)
    a, b = profiling.span("ad.draw"), profiling.span("ad.update")
    assert a is b
    for _ in range(3):
        with profiling.span("test.off"):
            pass
    assert list(profiling._SPANS) == before
    assert profiling.span_records("test.off") == []


def test_span_on_records_host_time_and_nests_ops(tmp_path):
    with trace(tmp_path, device="cpu"):
        with profiling.span("test.on"):
            torch.randn(64, 64).sum()
    (host, dev), = profiling.span_records("test.on", last=1)
    assert host > 0 and dev is None          # no card: no device time
    path, = pathlib.Path(tmp_path).glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    on, = [e for e in events if e["name"] == "test.on"]
    inner = [e for e in events if e["name"] == "aten::randn"]
    assert inner and all(on["ts"] <= e["ts"] and e["ts"] + e["dur"]
                         <= on["ts"] + on["dur"] for e in inner)
    assert profiling.span_records("test.on", last=0) == []


def test_span_on_a_second_thread_is_recorded(tmp_path):
    done = []

    def work():
        with profiling.span("test.thread"):
            done.append(float(torch.ones(8).sum()))

    n = len(profiling.span_records("test.thread"))
    with trace(tmp_path, device="cpu"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and done == [8.0]
    recs = profiling.span_records("test.thread")
    assert len(recs) == n + 1 and recs[-1][0] > 0
