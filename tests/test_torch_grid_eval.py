"""PyTorch port vs the JAX package: grid decoding (ops.grid_eval).

The analytic sphere ApplyFn of tests/test_serve.py goes through both
packages' three-level sparse decode at res 64: the active counts and all
five payload arrays must be equal, for every payload dtype: bitwise for
an analytic SDF both frameworks evaluate exactly, to a few ulps for the
sphere itself. The port's
dense decode is the oracle its hierarchical decode is held against."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.ops import grid_eval as jge
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as tge

torch.set_num_threads(2)


def jax_sphere(z, xyz):
    """The analytic ApplyFn of tests/test_serve.py: latent z[0] in [0,1]
    sets the radius."""
    r = 0.35 + 0.1 * z[0]
    return jnp.sqrt(jnp.sum(xyz * xyz, axis=-1)) - r


def torch_sphere(z, xyz):
    r = 0.35 + 0.1 * z[0]
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1)) - r


# An SDF both frameworks evaluate exactly: the Chebyshev-distance cube
# (1-Lipschitz, as the decode's selection assumes) on coordinates snapped
# to a 1/256 lattice, with no sqrt and no product to fuse. The plain
# sphere cannot be held to bitwise equality: XLA's CPU code contracts its
# sum of squares into fused multiply-adds, differently in each decode
# program, and torch's vectorised CPU sqrt is not correctly rounded.
def jax_snapped_cube(z, xyz):
    q = jnp.abs(jnp.round(xyz * 256.0))
    return jnp.max(q, axis=-1) / 256.0 - (0.35 + 0.1 * z[0])


def torch_snapped_cube(z, xyz):
    q = torch.abs(torch.round(xyz * 256.0))
    return torch.amax(q, dim=-1) / 256.0 - (0.35 + 0.1 * z[0])


def _host(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _decode_both(jfn, tfn, zv, caps, **kw):
    z = np.asarray([zv, 0.0], np.float32)
    ja, jst = jge.decode_grid_hierarchical3_sparse2(
        jfn, jnp.asarray(z), 64, 16, 4, 2, *caps, **kw)
    ta, tst = tge.decode_grid_hierarchical3_sparse2(
        tfn, torch.from_numpy(z), 64, 16, 4, 2, *caps, **kw)
    for k in ("active_l1", "active_l2", "active_l3", "capacity_exceeded",
              "cap1", "cap2", "cap3", "payload_bytes", "quant_scale"):
        assert tst.get(k) == jst.get(k), k
    assert tst["capacity_exceeded"] == (zv == 1.0)
    out = []
    for a, b in zip(ta, ja):
        b = np.asarray(b)
        if b.dtype not in (np.int8, np.uint8, np.int32, np.float32):
            b = b.astype(np.float32)                      # bfloat16
        a = _host(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        out.append((a, b))
    return out


CASES = [(0.5, (64, 1024, 4096)), (1.0, (8, 64, 256))]


@pytest.mark.parametrize("out_dtype", ["float32", "int8", "int4",
                                       "bfloat16"])
@pytest.mark.parametrize("zv, caps", CASES)
def test_sparse2_payload_matches_jax(out_dtype, zv, caps):
    """Equal counts and bitwise-equal payload arrays (including the
    zero-filled rows past the active counts, and a decode whose shell
    overflows the caps) for an ApplyFn both packages round alike."""
    for a, b in _decode_both(jax_snapped_cube, torch_snapped_cube, zv,
                             caps, safety=1.2, safety3=2.0,
                             out_dtype=out_dtype):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("zv, caps", CASES)
def test_sparse2_payload_matches_jax_plain_sphere(zv, caps):
    """test_serve.py's sphere itself: equal counts and index arrays, and
    SDF values within a few float32 ulps (values are O(1); ulp 1.2e-7) of
    the JAX program's."""
    for a, b in _decode_both(jax_sphere, torch_sphere, zv, caps,
                             safety=1.2, safety3=2.0, out_dtype="float32"):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=5e-7, atol=2.4e-7)


def test_sparse2_reconstruction_matches_dense_decode():
    """Sign-exactness: the hierarchical payload's reconstructed grid has
    the dense decode's sign everywhere, and its values wherever the fine
    level evaluated."""
    res = 64
    z = torch.tensor([0.6, 0.0])
    dense = tge.decode_grid(torch_sphere, z, res, chunk=50_000).numpy()
    np.testing.assert_allclose(
        dense.reshape(-1),
        np.linalg.norm(tge.make_grid_points(res), axis=1) - 0.41,
        atol=1e-6)
    arrs, st = tge.decode_grid_hierarchical3_sparse2(
        torch_sphere, z, res, 16, 4, 2, 64, 1024, 4096, safety=1.2,
        safety3=2.0, out_dtype="float32")
    assert not st["capacity_exceeded"]
    grid = tge.sparse2_to_grid(*(a.numpy() for a in arrs),
                               st["active_l1"], st["active_l2"], res, 16, 4)
    assert np.array_equal(np.signbit(grid), np.signbit(dense))
    near = np.abs(dense) < 2.0 / (res - 1)
    np.testing.assert_array_equal(grid[near], dense[near])


def test_flat_to_xyz_and_dense_decode_match_jax():
    """Chunked dense decode with a ragged last chunk. res 33 makes the
    spacing dyadic (1/16), so the coordinates are exact whether or not
    XLA fuses `ijk * h - 1` into one rounding; z[0] = 0.5 makes
    0.1 * z[0] exact for the same reason."""
    res = 33
    z = np.asarray([0.5, 0.0], np.float32)
    want = np.asarray(jge.decode_grid(jax_snapped_cube, jnp.asarray(z),
                                      res, chunk=5000))
    got = tge.decode_grid(torch_snapped_cube, torch.from_numpy(z), res,
                          chunk=5000).numpy()
    np.testing.assert_array_equal(got, want)


def test_eval_blocks_balanced_groups_match_jax():
    """Group balancing with edge padding: a K that does not divide into
    points_per_group evaluates every block once, in order."""
    rng = np.random.default_rng(0)
    ids = rng.choice(32 ** 3, size=37, replace=False).astype(np.int32)
    z = np.asarray([0.5, 0.0], np.float32)
    want = np.asarray(jge._eval_blocks(jax_snapped_cube, jnp.asarray(z),
                                       jnp.asarray(ids), 64, 2, 80))
    got = tge._eval_blocks(torch_snapped_cube, torch.from_numpy(z),
                           torch.from_numpy(ids), 64, 2, 80).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_rejects_bad_blocking():
    with pytest.raises(ValueError, match="res % b1"):
        tge.decode_grid_hierarchical3_sparse2(
            torch_sphere, torch.zeros(2), 60, 16, 4, 2)
    with pytest.raises(ValueError, match="unsupported payload dtype"):
        tge.decode_grid_hierarchical3_sparse2(
            torch_sphere, torch.zeros(2), 64, out_dtype="float16")
