"""PyTorch port vs the JAX package: the rest of ops.grid_eval, the batched
and device-resident decodes (decode_grid_batch,
decode_grid_hierarchical2_batch, decode_grid_hierarchical3_batch,
decode_grid_hierarchical_device, decode_grid_hierarchical2_device,
decode_grid_hierarchical3_device, decode_grid_hierarchical3_sparse,
probe_bench_caps, decode_grid_hierarchical).

On the Chebyshev cube of tests/test_torch_flat_decode.py, whose latent
sets its half-width (z[0]) and centre (z[1:4], on the 1/256 lattice), an
SDF both frameworks evaluate exactly, every grid and payload must equal
JAX's bit for bit and every stats dict must have JAX's keys and values,
with and without a capacity overflow. The port runs a batch shape by
shape; each shape's grid and counts must equal the single-shape decode's
at the same caps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.ops import grid_eval as jge
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge

torch.set_num_threads(2)


def jcube(z, xyz):
    q = jnp.abs(jnp.round(xyz * 256.0) - z[1:4] * 256.0)
    return jnp.max(q, axis=-1) / 256.0 - z[0]


def tcube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0) - z[1:4] * 256.0)
    return torch.amax(q, dim=-1) / 256.0 - z[0]


def _zs(S, seed):
    """Half-widths 0.2-0.45, centres within +-0.16 on the 1/256 lattice."""
    rng = np.random.default_rng(seed)
    hw = 0.2 + 0.25 * np.arange(S) / max(S - 1, 1)
    c = rng.integers(-40, 41, size=(S, 3)) / 256.0
    return np.concatenate([hw[:, None], c], 1).astype(np.float32)


def _host(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = _host(got), _host(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                       g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _same_stats(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, (np.ndarray, jnp.ndarray)):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w))
        else:
            assert got[k] == w and type(got[k]) is type(w), (k, got[k], w)


def _both(name, zs, *args, **kw):
    want = getattr(jge, name)(jcube, jnp.asarray(zs), *args, **kw)
    got = getattr(tge, name)(tcube, torch.from_numpy(zs), *args, **kw)
    return got, want


def test_decode_grid_batch_bitwise():
    zs = _zs(3, 0)
    got, want = _both("decode_grid_batch", zs, 24, chunk=4096)
    assert tuple(got.shape) == (3, 24, 24, 24)
    _same(got, want)
    for s in range(3):
        torch.testing.assert_close(got[s], tge.decode_grid(
            tcube, torch.from_numpy(zs[s]), 24), rtol=0, atol=0)


# (caps of a run that fits at res 64, caps that overflow)
CAPS2 = [(64, 1024), (16, 256)]
CAPS3 = [(64, 1024, 6144), (16, 256, 1024)]


@pytest.mark.parametrize("layout", ["block", "xmajor", "auto"])
@pytest.mark.parametrize("caps", CAPS2)
def test_hierarchical2_batch_bitwise(caps, layout):
    zs = _zs(3, 1)
    (grids, st), (jg, jst) = _both("decode_grid_hierarchical2_batch", zs,
                                   64, 16, 4, *caps, layout=layout)
    _same(grids, jg)
    _same_stats(st, jst)
    assert st["capacity_exceeded"] == (caps == CAPS2[1])
    for s in range(3):       # each shape = the single-shape decode
        g1, st1 = tge.decode_grid_hierarchical2_device(
            tcube, torch.from_numpy(zs[s]), 64, 16, 4, *caps, safety=1.2,
            layout=st["layout"])
        torch.testing.assert_close(grids[s], g1, rtol=0, atol=0)
        assert st1["active_l1"] == st["active_l1"][s]
        assert st1["active_l2"] == st["active_l2"][s]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["block", "xmajor", "sparse",
                                    "sparse2"])
@pytest.mark.parametrize("caps", CAPS3)
def test_hierarchical3_batch_bitwise(caps, layout, out_dtype):
    zs = _zs(3, 2)
    (grids, st), (jg, jst) = _both("decode_grid_hierarchical3_batch", zs,
                                   64, 16, 4, 2, *caps, layout=layout,
                                   out_dtype=out_dtype)
    _same(grids, jg)
    _same_stats(st, jst)
    assert st["capacity_exceeded"] == (caps == CAPS3[1])
    if layout in ("block", "xmajor") and out_dtype != "int8":
        for s in range(3):   # each shape = the single-shape decode
            g1, st1 = tge.decode_grid_hierarchical3_device(
                tcube, torch.from_numpy(zs[s]), 64, 16, 4, 2, *caps,
                safety=1.2, safety3=2.0, layout=layout,
                out_dtype=out_dtype)
            torch.testing.assert_close(grids[s], g1, rtol=0, atol=0)
            assert [st1[k] for k in ("active_l1", "active_l2",
                                     "active_l3")] == \
                [int(st[k][s]) for k in ("active_l1", "active_l2",
                                         "active_l3")]


def test_batch_counts_stay_on_the_device():
    """check_overflow=False: the counts are [S] tensors, no flag."""
    zs = torch.from_numpy(_zs(2, 3))
    _, st = tge.decode_grid_hierarchical3_batch(tcube, zs, 32,
                                                check_overflow=False)
    assert "capacity_exceeded" not in st
    assert isinstance(st["active_l3"], torch.Tensor)
    assert tuple(st["active_l3"].shape) == (2,)
    _, st = tge.decode_grid_hierarchical2_device(
        tcube, zs[0], 32, check_overflow=False)
    assert isinstance(st["active_l2"], torch.Tensor)


@pytest.mark.parametrize("block, capacity", [(8, 512), (8, 60), (4, 2048)])
@pytest.mark.parametrize("layout", ["block", "xmajor"])
def test_hierarchical_device_bitwise(block, capacity, layout):
    z = _zs(3, 4)[1]
    (g, st), (jg, jst) = _both("decode_grid_hierarchical_device", z, 64,
                               block, capacity, layout=layout)
    _same(g, jg)
    _same_stats(st, jst)
    assert st["capacity_exceeded"] == (capacity == 60)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("caps", CAPS2)
def test_hierarchical2_device_bitwise(caps, out_dtype):
    z = _zs(3, 5)[2]
    (g, st), (jg, jst) = _both("decode_grid_hierarchical2_device", z, 64,
                               16, 4, *caps, layout="auto",
                               out_dtype=out_dtype)
    _same(g, jg)
    _same_stats(st, jst)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["block", "xmajor"])
@pytest.mark.parametrize("caps", CAPS3)
def test_hierarchical3_device_bitwise(caps, layout, out_dtype):
    z = _zs(3, 6)[0]
    (g, st), (jg, jst) = _both("decode_grid_hierarchical3_device", z, 64,
                               16, 4, 2, *caps, safety3=2.0, layout=layout,
                               out_dtype=out_dtype)
    _same(g, jg)
    _same_stats(st, jst)
    with pytest.raises(ValueError, match="int8"):
        tge.decode_grid_hierarchical3_device(tcube, torch.from_numpy(z), 64,
                                             out_dtype="int8")


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32", "int8"])
def test_hierarchical3_sparse_bitwise(out_dtype):
    z = _zs(3, 7)[1]
    (arrs, st), (jarrs, jst) = _both("decode_grid_hierarchical3_sparse", z,
                                     64, 16, 4, 2, *CAPS3[0],
                                     out_dtype=out_dtype)
    _same(arrs, jarrs)
    _same_stats(st, jst)
    if out_dtype == "float32":
        # the payload reconstructs the block-layout grid of the full decode
        full, _ = tge.decode_grid_hierarchical3_device(
            tcube, torch.from_numpy(z), 64, 16, 4, 2, *CAPS3[0],
            layout="block")
        np.testing.assert_array_equal(
            tge.sparse_to_grid(*(a.numpy() for a in arrs), st["active_l2"],
                               64, 4),
            tge.unblock_grid(full.numpy(), 64, 4))


@pytest.mark.parametrize("res", [64, 32])
def test_probe_bench_caps_matches_jax(res):
    z = _zs(3, 8)[2]
    assert tge.probe_bench_caps(tcube, torch.from_numpy(z), res) == \
        jge.probe_bench_caps(jcube, jnp.asarray(z), res)


@pytest.mark.parametrize("block, per_call", [(8, 4096), (4, 300)])
def test_hierarchical_host_driven_bitwise(block, per_call):
    z = _zs(3, 9)[0]
    (g, st), (jg, jst) = _both("decode_grid_hierarchical", z, 64, block,
                               max_blocks_per_call=per_call)
    assert g.dtype == np.float32 and g.shape == (64, 64, 64)
    np.testing.assert_array_equal(g, jg)
    _same_stats(st, jst)
    dense = tge.decode_grid(tcube, torch.from_numpy(z), 64).numpy()
    assert ((g < 0) == (dense < 0)).all()


def test_bad_blocks_raise():
    z = torch.from_numpy(_zs(1, 0)[0])
    with pytest.raises(ValueError, match="need res"):
        tge.decode_grid_hierarchical3_device(tcube, z, 60)
    with pytest.raises(ValueError, match="need res"):
        tge.decode_grid_hierarchical(tcube, z, 64, block=6)
