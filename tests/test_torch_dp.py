"""The port's data-parallel stage-1 steps (parallel/dp.py, parallel/mesh.py)
against its single-device steps, on the CPU over gloo.

Two ranks are spawned processes. On both routes (the fused train kernel's
plain version, and autograd) and both feeds (host batches, the sample
bank), 3 data-parallel steps from the same state and draws agree with the
single-device steps: each step's loss terms within 1e-6 relative (the
code-reg term normalised by the global scene count), the parameters and
codes within 1e-5 of their largest entry (only the f32 summation order
moves), and both ranks end equal bit for bit. A 1-rank group steps as one
device bit for bit. `train-ad` through the CLI under two ranks writes one
checkpoint that agrees with a 1-rank run's within the same tolerances."""

import datetime
import json
import multiprocessing
import os
import pathlib
import shutil
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
    DeviceSampleBank)
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.parallel import dp, mesh
from latent_diffusion_models_for_shape_sdfs_torch.train import auto_decoder as tad

torch.set_num_threads(2)

LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5
CASES = [("fused", "host", 0.0), ("fused", "bank", 0.0),
         ("autograd", "host", 0.0), ("autograd", "bank", 0.0),
         ("autograd", "bank", 0.3)]


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfg(route: str, rate: float, **kw) -> tcfg.AdConfig:
    return tcfg.AdConfig(
        decoder=tcfg.DecoderConfig(latent_size=16, hidden_dim=64,
                                   num_layers=3, latent_in=(2,),
                                   use_dropout=rate > 0, dropout_prob=rate,
                                   dropout_impl="pallas"),
        num_scenes=6, scenes_per_batch=4, samples_per_scene=256,
        clamp_dist=0.2, use_pallas=route == "fused", **kw)


def _inputs():
    """A random-row store (tests/test_torch_train.py's trajectory data),
    its bank, 3 host batches and a start state."""
    rng = np.random.default_rng(0)
    rows = [np.concatenate([rng.uniform(-1, 1, (700, 3)),
                            0.15 * rng.normal(size=(700, 1))], 1)
            .astype(np.float32) for _ in range(6)]
    ds = SdfDataset([r[r[:, 3] >= 0] for r in rows],
                    [r[r[:, 3] < 0] for r in rows])
    batches = []
    for _ in range(3):
        b = next(ds.epoch_batches(rng, 4, 256))
        batches.append((torch.from_numpy(b.scene_ids.astype(np.int64)),
                        torch.from_numpy(b.xyz), torch.from_numpy(b.sdf)))
    return DeviceSampleBank.from_dataset(ds, device="cpu"), batches


def _runs(group_mesh) -> dict:
    """Every case for 3 steps: single-device steps when group_mesh is
    None, else the data-parallel steps over it."""
    bank, batches = _inputs()
    out = {}
    for route, feed, rate in CASES:
        c = _cfg(route, rate)
        st = tad.init_ad_state(c, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(5)
        if feed == "bank":
            step = (tad.make_bank_step(st.decoder, c, bank, gen)
                    if group_mesh is None else
                    dp.make_dp_bank_step(st.decoder, c, group_mesh, bank, gen))
        else:
            step = (tad.make_ad_train_step(st.decoder, c)
                    if group_mesh is None else
                    dp.make_dp_ad_train_step(st.decoder, c, group_mesh))
        terms = []
        for i, (ids, xyz, sdf) in enumerate(batches):
            args = (ids,) if feed == "bank" else (ids, xyz, sdf)
            m = step(st, *args, 60.0 * i, 77 + i)
            terms.append([float(m[k]) for k in ("loss", "loss_l1",
                                                "loss_reg")])
        out[(route, feed, rate)] = dict(
            terms=terms, codes=st.codes.detach().clone(),
            params={k: v.clone() for k, v in st.decoder.state_dict().items()},
            checksum=(int(dp.state_checksum(st)) if group_mesh is None
                      else dp.check_replicas(st, group_mesh)))
    return out


def _rank_main(rank: int, port: int, path: str) -> None:
    """A spawned rank: a 2-rank gloo group, every case, results to path."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = _runs(mesh.make_mesh())
        torch.save(res, f"{path}.{rank}")
    finally:
        dist.destroy_process_group()


def _spawn(target, args_of, n=2, timeout=120) -> None:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    assert [p.exitcode for p in procs] == [0] * n


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp") / "res")
    port = _port()
    _spawn(_rank_main, lambda r: (r, port, path))
    ranks = [torch.load(f"{path}.{r}", weights_only=False) for r in range(2)]
    return ranks, _runs(None)


def _close(got: dict, ref: dict) -> None:
    for a, b in zip(got["terms"], ref["terms"]):
        for x, y in zip(a, b):
            assert x == pytest.approx(y, rel=LOSS_RTOL, abs=1e-12)
    pairs = [(got["codes"], ref["codes"], "codes")] + [
        (got["params"][k], v, k) for k, v in ref["params"].items()]
    for a, b, name in pairs:
        tol = PARAM_TOL * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: f"{c[0]}-{c[1]}")
def test_two_ranks_step_as_one_device(two_ranks, case):
    """3 data-parallel steps on 2 ranks against the single-device steps;
    the ranks end equal bit for bit. loss_reg is held on its own too: a
    shard normalising by its local scene count would double it."""
    (r0, r1), single = two_ranks
    _close(r0[case], single[case])
    assert r0[case]["checksum"] == r1[case]["checksum"]
    for k, v in r0[case]["params"].items():
        assert torch.equal(v, r1[case]["params"][k])
    assert torch.equal(r0[case]["codes"], r1[case]["codes"])
    assert r0[case]["terms"][1][2] > 0


def test_two_ranks_with_dropout_stay_replicas(two_ranks):
    """With dropout each rank folds its rank into the seed (other masks
    than one device draws), and the replicas still end equal."""
    (r0, r1), single = two_ranks
    case = CASES[4]
    assert r0[case]["checksum"] == r1[case]["checksum"]
    assert r0[case]["terms"] == r1[case]["terms"]
    assert r0[case]["terms"] != single[case]["terms"]
    assert np.isfinite(r0[case]["terms"]).all()


def test_rank_seed_and_divisibility():
    assert dp.rank_seed(1234, 0) == 1234
    seeds = {dp.rank_seed(1234, r) for r in range(1, 5)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 31 for s in seeds)
    assert dp.rank_seed(1234, 3) == dp.rank_seed(1234, 3)
    three = mesh.DataMesh(None, 0, 3, (mesh.DATA_AXIS,), (3,))
    c = _cfg("autograd", 0.0)
    st = tad.init_ad_state(c, seed=0, device="cpu")
    for make in (dp.make_dp_ad_train_step,
                 lambda d, cfg, m: dp.make_dp_bank_step(d, cfg, m, None,
                                                        None)):
        with pytest.raises(AssertionError, match="not divisible"):
            make(st.decoder, c, three)
    x = torch.arange(12).reshape(6, 2)
    two = mesh.DataMesh(None, 1, 2, (mesh.DATA_AXIS,), (2,))
    assert torch.equal(mesh.batch_sharded(two, x), x[3:])
    assert torch.equal(mesh.batch_sharded(two, x, axis=1), x[:, 1:])
    with pytest.raises(ValueError, match="not divisible"):
        mesh.batch_sharded(three, torch.zeros(4))
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()


def test_one_rank_group_steps_as_one_device():
    """A 1-rank gloo group: the meshes' checks; the data-parallel steps
    (dropout on) equal the single-device steps bit for bit, and
    train_auto_decoder with data_parallel takes the single-device step."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_port()}",
                            world_size=1, rank=0)
    try:
        m = mesh.make_mesh()
        assert (m.rank, m.size, m.axis_names) == (0, 1, ("data",))
        assert mesh.make_mesh_2level(1, 1).axis_names == ("dcn", "data")
        with pytest.raises(ValueError, match="need 2 devices"):
            mesh.make_mesh(2)
        with pytest.raises(ValueError, match="need 4 devices"):
            mesh.make_mesh_2level(2, 2)
        assert tad._dp_mesh(_cfg("fused", 0.0, data_parallel=True)) is None
        one = _runs(m)
    finally:
        dist.destroy_process_group()
    single = _runs(None)
    for case in CASES:
        assert one[case]["terms"] == single[case]["terms"], case
        assert one[case]["checksum"] == single[case]["checksum"], case


# ----------------------------------------------------- train-ad under 2 ranks

def _cli_rank(rank: int, port: int, exp: str) -> None:
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from latent_diffusion_models_for_shape_sdfs_torch import cli
    cli.main(["--device", "cpu", "train-ad", exp, "--dist-backend", "gloo"])


def test_cli_train_ad_under_two_ranks(tmp_path):
    """`train-ad` with ad.data_parallel and the bank under 2 gloo ranks
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT as torchrun sets
    them), dropout off (each rank would draw other masks): rank 0 alone
    writes the log and the checkpoint, which agrees
    with a 1-rank run's within 1e-5 of each tensor's max; the log records
    equal replicas. nccl on CPU ranks is refused."""
    from latent_diffusion_models_for_shape_sdfs_torch import cli
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        StageCheckpointer)
    exp = tmp_path / "two"
    sets = {"ad.num_scenes": 4, "ad.num_epochs": 2, "ad.scenes_per_batch": 4,
            "ad.samples_per_scene": 256, "ad.snapshot_every": 0,
            "ad.clamp_dist": 0.2, "ad.decoder.latent_size": 16,
            "ad.decoder.hidden_dim": 64, "ad.decoder.num_layers": 3,
            "ad.decoder.latent_in": [2], "ad.decoder.use_dropout": False,
            "ad.data_parallel": True, "ad.device_data": True}
    argv = ["--device", "cpu", "init-experiment", str(exp), "--data",
            "analytic:sphere"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    cli.main(argv)
    one = tmp_path / "one"
    shutil.copytree(exp, one)
    port = _port()
    _spawn(_cli_rank, lambda r: (r, port, str(exp)))
    cli.main(["--device", "cpu", "train-ad", str(one)])
    got = StageCheckpointer(exp, "auto_decoder").restore()
    ref = StageCheckpointer(one, "auto_decoder").restore()
    assert got["epoch"] == ref["epoch"] == 1
    pairs = [(got["codes"], ref["codes"])] + [
        (got["decoder"][k], v) for k, v in ref["decoder"].items()]
    for a, b in pairs:
        assert float((a - b).abs().max()) <= PARAM_TOL * float(b.abs().max())
    recs = [json.loads(x) for x in (exp / "logs" / "train_ad.jsonl")
            .read_text().splitlines()]
    assert [r["event"] for r in recs] == ["ad_epoch", "ad_epoch",
                                          "replicas_equal"]
    assert recs[-1]["ranks"] == 2
    ref_recs = [json.loads(x) for x in (one / "logs" / "train_ad.jsonl")
                .read_text().splitlines()]
    assert recs[1]["loss"] == pytest.approx(ref_recs[1]["loss"],
                                            rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        mesh.init_from_env("nccl", "cpu")
    assert pathlib.Path(exp, "checkpoints", "auto_decoder").is_dir()
