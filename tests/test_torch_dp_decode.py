"""The decode half of the port's parallel/dp.py, and
serve.serve_meshes_sharded, against their single-device counterparts on
the CPU over gloo (the cases of tests/test_dp_cpu.py).

Two ranks are spawned processes. The SDFs are the snapped Chebyshev
cubes of tests/test_torch_serve.py and tests/test_torch_flat_decode.py,
which evaluate exactly whatever the batch a point lands in, so every
sharded decode must equal its single-device counterpart bit for bit:
decode_points_sharded at a ragged N, decode_grid_sharded at 24^3 in
4096-point slabs, make_dp_pairs_fn under the flat batched decode (by
rows and by index), make_dp_sparse_decode_fn shape by shape, and
serve_meshes_sharded's meshes (a padded batch, an empty one, a shape
that overflows the caps and escalates). dp_ddim_sample of a guided
CondDenoiser, each rank holding its slice of the conditioning, agrees
with ddim_sample within 1e-5 of max|z| (a half-batch product may sum in
another order)."""

import datetime
import multiprocessing
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch import serve as tserve
from latent_diffusion_models_for_shape_sdfs_torch.diffusion import sampler
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
    CondDenoiser)
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge
from latent_diffusion_models_for_shape_sdfs_torch.parallel import dp, mesh

torch.set_num_threads(2)

N_POINTS = 4099                 # odd: ragged over 2 ranks
CAPS = (8, 64, 256)             # overflowed by the largest cube
LAT = [np.asarray([v, 0.0], np.float32) for v in (0.1, 0.5, 1.0)]
DDIM_TOL = 1e-5                 # of max|z|
DEN = dict(arch="mlp", latent_size=8, hidden_dim=32, num_blocks=1,
           time_embed_dim=16, num_classes=3, partial_sdf_cond=True,
           partial_points=12)
B = 8                           # dp_ddim_sample's batch


def cube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


def cube_rows(zr, xyz):
    q = torch.abs(torch.round(xyz * 256.0) - zr[:, 1:4] * 256.0)
    return torch.amax(q, dim=-1) / 256.0 - zr[:, 0]


class IndexedCubeRows:
    """cube_rows with an `indexed` form, as kernel #2's wrapper has."""

    def __call__(self, zr, xyz):
        return cube_rows(zr, xyz)

    def indexed(self, codes, sids, xyz):
        return cube_rows(codes[sids.long()], xyz)


def _cube_zs(S, seed):
    rng = np.random.default_rng(seed)
    hw = 0.2 + 0.3 * np.arange(S) / S
    c = rng.integers(-40, 41, size=(S, 3)) / 256.0
    return torch.from_numpy(np.concatenate([hw[:, None], c], 1)
                            .astype(np.float32))


def _points():
    return torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (N_POINTS, 3)).astype(np.float32))


def _denoise(rows=slice(None)):
    """A guided CondDenoiser (CFG 1.5, class + observations) over the
    batch's `rows`, on the exact denoiser of N(0, I) data so the latents
    stay O(1)."""
    torch.manual_seed(0)
    model = CondDenoiser(tcfg.DenoiserConfig(**DEN)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    rng = np.random.default_rng(11)
    cid = torch.from_numpy(np.arange(B) % 3)
    ox = torch.from_numpy(rng.uniform(-1, 1, (B, 12, 3)).astype(np.float32))
    od = torch.from_numpy((0.05 * rng.normal(size=(B, 12)))
                          .astype(np.float32))
    g = sampler.guided_denoise_fn(model, 1.5, class_id=cid[rows],
                                  obs_xyz=ox[rows], obs_sdf=od[rows])
    sched = DiffusionSchedule.create(16, device="cpu")
    abar = sched.alpha_bars

    def fn(z, t):
        return torch.sqrt(1 - abar[t.long()])[:, None] * z + 0.2 * g(z, t)

    return fn, sched


def _flat(pairs_fn, zs):
    grids, st = tge.decode_grid_hierarchical3_batch_flat(
        pairs_fn, zs, 32, 16, 4, 2, 64, 1024, 4096)
    return grids, [st[k] for k in ("active_l1", "active_l2", "active_l3")]


def _sparse_single(zs):
    return [tge.decode_grid_hierarchical3_sparse2(
        cube, z, 64, 16, 4, 2, *CAPS, safety=1.2, safety3=2.0,
        out_dtype="int8", check_overflow=True) for z in zs]


def _runs(m) -> dict:
    """Every decode-half function over the mesh m (on every rank)."""
    z = torch.tensor([0.3, 0.0])
    zs = torch.from_numpy(np.stack(LAT + [LAT[0]]))
    arrs, counts = dp.make_dp_sparse_decode_fn(cube, 64, 4, m, CAPS)(zs)
    out = dict(
        points=dp.decode_points_sharded(cube, z, _points(), m),
        grid=dp.decode_grid_sharded(cube, z, 24, m, slab_points=4096),
        flat_rows=_flat(dp.make_dp_pairs_fn(cube_rows, m), _cube_zs(5, 1)),
        flat_indexed=_flat(dp.make_dp_pairs_fn(IndexedCubeRows(), m),
                           _cube_zs(5, 1)),
        sparse=dp.all_gather_rows(m, [*arrs, *counts]),
        served=list(tserve.serve_meshes_sharded(cube, LAT, m, res=64,
                                                caps=CAPS, device="cpu")),
        empty=list(tserve.serve_meshes_sharded(cube, [], m, device="cpu")))
    fn, sched = _denoise(mesh.batch_sharded(m, torch.arange(B)))
    out["ddim"] = dp.dp_ddim_sample(fn, sched,
                                    torch.Generator().manual_seed(5), B,
                                    DEN["latent_size"], m, steps=8)
    return out


def _rank_main(rank: int, port: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(_runs(mesh.make_mesh()), f"{path}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dpdec") / "res")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, port, path))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(120)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(2)]


def test_points_and_grid_match_one_device(two_ranks):
    z = torch.tensor([0.3, 0.0])
    want = cube(z, _points())
    grid = tge.decode_grid(cube, z, 24, chunk=4096).numpy()
    for r in two_ranks:
        assert r["points"].shape == (N_POINTS,)
        assert torch.equal(r["points"], want)
        np.testing.assert_array_equal(r["grid"], grid)


@pytest.mark.parametrize("form", ["flat_rows", "flat_indexed"])
def test_pairs_under_flat_decode_match_one_device(two_ranks, form):
    grids, counts = _flat(cube_rows, _cube_zs(5, 1))
    for r in two_ranks:
        assert torch.equal(r[form][0], grids) and r[form][1] == counts


def test_sparse_decode_matches_one_device_shape_by_shape(two_ranks):
    zs = torch.from_numpy(np.stack(LAT + [LAT[0]]))
    for r in two_ranks:
        got = r["sparse"]
        for i, (arrs, st) in enumerate(_sparse_single(zs)):
            for a, b in zip(got[:5], arrs):
                assert torch.equal(a[i], b)
            assert [int(c[i]) for c in got[5:]] == [
                st["active_l1"], st["active_l2"], st["active_l3"]]


def test_serve_meshes_sharded_matches_serve_meshes(two_ranks):
    """3 shapes over 2 ranks (one padding shape), the largest past CAPS:
    rank 0 yields serve_meshes's meshes in order, rank 1 nothing; an empty
    batch yields nothing on either rank."""
    r0, r1 = two_ranks
    want = list(tserve.serve_meshes(cube, LAT, res=64, caps=CAPS,
                                    device="cpu"))
    assert len(r0["served"]) == 3 and r1["served"] == []
    assert r0["empty"] == [] and r1["empty"] == []
    assert want[2][2]["escalations"] >= 1
    for (v, f, st), (vw, fw, sw) in zip(r0["served"], want):
        assert len(f) > 100
        np.testing.assert_array_equal(v, vw)
        np.testing.assert_array_equal(f, fw)
        assert st["active_l2"] == sw["active_l2"]
    assert r0["served"][2][2]["escalations"] >= 1


def test_serve_meshes_sharded_refuses_iso_on_int8():
    one = mesh.DataMesh(None, 0, 1, (mesh.DATA_AXIS,), (1,))
    with pytest.raises(ValueError, match="iso != 0"):
        list(tserve.serve_meshes_sharded(cube, LAT, one, res=64, iso=0.1,
                                         device="cpu"))


def test_dp_ddim_matches_ddim(two_ranks):
    fn, sched = _denoise()
    want = sampler.ddim_sample(fn, sched, torch.Generator().manual_seed(5),
                               B, DEN["latent_size"], steps=8)
    top = float(want.abs().max())
    assert 0.5 < top < 10
    r0, r1 = two_ranks
    assert torch.equal(r0["ddim"], r1["ddim"])
    assert float((r0["ddim"] - want).abs().max()) <= DDIM_TOL * top


def test_gather_and_divisibility():
    three = mesh.DataMesh(None, 0, 3, (mesh.DATA_AXIS,), (3,))
    with pytest.raises(AssertionError, match="not divisible"):
        dp.make_dp_sparse_decode_fn(cube, 64, 4, three, CAPS)
    with pytest.raises(AssertionError, match="not divisible"):
        dp.make_dp_ddim_fn(None, None, 4, 8, three)
