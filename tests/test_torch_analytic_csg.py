"""PyTorch port vs the JAX package: the bank producers of
data/analytic_jax.py in data/analytic_device.py (the chair bank, and the
CSG half: CsgParams, pack_csg, csg_sdf, csg_apply_flat, the generic
sampler, the sign split, bank_from_csg).

Bitwise: pack_csg / flat(), the sign split on given rows (all-positive
and all-negative rows included). To 1e-6 absolute: csg_sdf against JAX's
and against data/analytic.py's host SDF on every classes13 family. To
1e-5: a CSG shape decoded through decode_grid_adaptive against JAX's.
Exact: bank labels against csg_sdf / chair_sdf of their rows, the signs
and counts of each side, two builds with one seed, a chunk keyed by
(seed, chunk start). Statistical (the random streams differ): each
family's surface-shell / inner-shell / uniform parts against the
reference sampler's on the same shapes. JAX on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.data import analytic_jax as aj
from latent_diffusion_models_for_shape_sdfs_tpu.ops import grid_eval as jge
from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
from latent_diffusion_models_for_shape_sdfs_torch.data import (
    analytic_device as ad)
from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval

torch.set_num_threads(2)

FAMILIES = ["sphere", "box", "torus", "capsule", "chair", "csg", "mixed"]


def _family(family: str, k: int = 3, seed: int = 0) -> list:
    """k shapes of a family; for csg, both a union and a difference."""
    rng = np.random.default_rng(seed)
    shapes = [analytic.make_shape(family, rng) for _ in range(k)]
    if family == "csg":
        while {s["type"] for s in shapes} != {"union", "difference"}:
            shapes.append(analytic.make_shape(family, rng))
    return shapes


def _jax_one(params, i):
    return jax.tree.map(lambda a: a[i], params)


def test_pack_csg_and_flat_bitwise():
    shapes = analytic.make_synthetic_split("classes13", 26, seed=5)
    ours, ref = ad.pack_csg(shapes), aj.pack_csg(shapes)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ours.flat().numpy(), np.asarray(ref.flat()))
    assert ours.flat().shape == (26, ad.MAX_PRIMS * 11 + 1)
    assert ours.slice(3, 2).ptype.shape == (2, ad.MAX_PRIMS)
    with pytest.raises(ValueError, match="not a primitive"):
        ad.pack_csg([{"type": "cone"}])


@pytest.mark.parametrize("family", FAMILIES)
def test_csg_sdf_matches_jax_and_host(family):
    """csg_sdf of every shape of a family at 2,048 points in [-1.1, 1.1]^3
    against JAX's csg_sdf and analytic.sdf, 1e-6 absolute."""
    shapes = _family(family)
    p = np.random.default_rng(1).uniform(-1.1, 1.1, (2048, 3)).astype(
        np.float32)
    params = ad.pack_csg(shapes)
    ours = ad.csg_sdf(params, torch.from_numpy(p)[None].expand(
        len(shapes), -1, -1)).numpy()
    jp = aj.pack_csg(shapes)
    f = jax.jit(aj.csg_sdf)
    for i, s in enumerate(shapes):
        ref = np.asarray(f(_jax_one(jp, i), jnp.asarray(p)))
        np.testing.assert_allclose(ours[i], ref, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ours[i], analytic.sdf(s, p), atol=1e-6,
                                   rtol=0)


def test_csg_apply_flat_decodes_as_jax():
    """A difference and a union through decode_grid_adaptive at 64^3 with
    csg_apply_flat as the ApplyFn: the grids agree with JAX's to 1e-5."""
    shapes = [s for s in _family("csg", 6, seed=2)
              if s["type"] == "difference"][:1] + _family("chair", 1)
    flat = ad.pack_csg(shapes).flat()
    jflat = aj.pack_csg(shapes).flat()
    for i in range(len(shapes)):
        ours = grid_eval.decode_grid_adaptive(ad.csg_apply_flat, flat[i], 64)
        ref = jge.decode_grid_adaptive(aj.csg_apply_flat, jflat[i], 64)
        assert (ours < 0).any() and (ours > 0).any()
        np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=0)


def test_sign_split_matches_jax_bitwise():
    """Stable pos/neg order and counts, with an all-positive row (its neg
    count falls back to n), an all-negative row (pos count n) and zeros
    (positive)."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(5, 40, 4)).astype(np.float32)
    d = rows[..., 3]
    d[1] = np.abs(d[1])
    d[2] = -np.abs(d[2]) - 1e-3
    d[3, ::5] = 0.0
    ours = ad._sign_split(torch.from_numpy(rows), torch.from_numpy(d))
    ref = aj._sign_split(jnp.asarray(rows), jnp.asarray(d))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    npos, nneg = ours[2].tolist(), ours[3].tolist()
    assert (npos[1], nneg[1], npos[2], nneg[2]) == (40, 40, 40, 40)
    assert npos[3] + nneg[3] == 40 and npos[3] >= 8


def _bank(kind: str, seed: int = 4, chunk: int = 4):
    if kind == "chair":
        shapes = analytic.make_synthetic_split("chair", 6, seed=3)
        return shapes, ad.bank_from_chairs(shapes, seed, 1024, chunk=chunk,
                                           device="cpu")
    shapes = analytic.make_synthetic_split("classes13", 13, seed=5)
    return shapes, ad.bank_from_csg(shapes, seed, 1024, chunk=chunk,
                                    device="cpu")


@pytest.mark.parametrize("kind", ["chair", "csg"])
def test_bank_labels_signs_and_counts(kind):
    """Labels equal chair_sdf / csg_sdf of their rows exactly and the host
    SDF to 3e-6; each side's first `count` rows have its sign, the counts
    add up to n; every row is in both arrays."""
    shapes, bank = _bank(kind)
    n = 1024
    assert bank.pos.shape == (len(shapes), n, 4) == bank.neg.shape
    if kind == "chair":
        params = ad.pack_chairs(shapes)
        again = ad.chair_sdf(params, bank.pos[..., :3])
    else:
        params = ad.pack_csg(shapes)
        again = ad.csg_sdf(params, bank.pos[..., :3])
    assert torch.equal(again, bank.pos[..., 3])
    for i, s in enumerate(shapes):
        pc, nc = int(bank.pos_count[i]), int(bank.neg_count[i])
        assert 0 < pc < n and 0 < nc < n and pc + nc == n
        assert bool((bank.pos[i, :pc, 3] >= 0).all())
        assert bool((bank.neg[i, :nc, 3] < 0).all())
        np.testing.assert_allclose(bank.pos[i, :, 3].numpy(), analytic.sdf(
            s, bank.pos[i, :, :3].numpy()), atol=3e-6, rtol=0)
        a, b = bank.pos[i].numpy(), bank.neg[i].numpy()
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])


@pytest.mark.parametrize("kind", ["chair", "csg"])
def test_bank_is_seeded_and_keyed_by_chunk_start(kind):
    """Two builds with one seed are equal bit for bit, another seed
    differs; the chunk at start 4 equals that chunk built alone from a
    generator keyed by (seed, 4)."""
    shapes, a = _bank(kind)
    _, b = _bank(kind)
    _, c = _bank(kind, seed=5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.pos, c.pos)
    if kind == "chair":
        part = ad._bank_chunk(ad.pack_chairs(shapes[4:8]),
                              ad._chunk_generator(4, 4, "cpu"), 1024)
    else:
        part = ad._bank_chunk_csg(ad.pack_csg(shapes[4:8]),
                                  ad._chunk_generator(4, 4, "cpu"), 1024)
    for x, y in zip(a, part):
        assert torch.equal(x[4:8], y)


def _parts(xyz: np.ndarray, d: np.ndarray, n: int) -> dict:
    """The design's three parts (std-0.05 shell, std-0.0158 shell,
    uniform filler) and their statistics."""
    n_surf = int(n * 0.95)
    half = n_surf // 2
    out = {}
    for name, sl in (("shell", slice(0, half)), ("inner", slice(half, n_surf)),
                     ("uniform", slice(n_surf, n))):
        dd = np.abs(d[:, sl])
        out[name] = dict(near=(dd < 0.01).mean(), mid=(dd < 0.05).mean(),
                         pos=(d[:, sl] >= 0).mean(), mean=dd.mean())
    out["in_cube"] = bool((np.abs(xyz[:, n_surf:]) <= 1.0).all())
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_sample_parts_match_reference_design(family):
    """sample_sdf_points_device_any on a family's shapes (4,000 samples
    each) against the reference sampler on the same shapes: in each part
    the shares with |d| < 0.01 and < 0.05 and the positive share within
    0.04, the mean |d| within 25%; the filler inside [-1, 1]^3; labels
    exact (csg_sdf of the points)."""
    shapes = _family(family, 4)
    n = 4000
    params = ad.pack_csg(shapes)
    xyz, d = ad.sample_sdf_points_device_any(
        lambda x: ad.csg_sdf(params, x), torch.Generator().manual_seed(0),
        n, len(shapes), "cpu")
    assert torch.equal(d, ad.csg_sdf(params, xyz))
    jp = aj.pack_csg(shapes)
    keys = jax.random.split(jax.random.PRNGKey(0), len(shapes))
    jx, jd = jax.jit(jax.vmap(lambda pr, k: aj.sample_sdf_points_device_any(
        lambda pt: aj.csg_sdf(pr, pt), k, n)))(jp, keys)
    ours = _parts(xyz.numpy(), d.numpy(), n)
    ref = _parts(np.asarray(jx), np.asarray(jd), n)
    assert ours["in_cube"] and ref["in_cube"]
    for part in ("shell", "inner", "uniform"):
        for k in ("near", "mid", "pos"):
            assert abs(ours[part][k] - ref[part][k]) < 0.04, (part, k)
        assert ours[part]["mean"] == pytest.approx(ref[part]["mean"],
                                                   rel=0.25), part
    assert ours["inner"]["near"] > ours["shell"]["near"] > \
        ours["uniform"]["near"]
