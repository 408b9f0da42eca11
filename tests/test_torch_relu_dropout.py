"""PyTorch port vs the JAX package: the relu+dropout kernel pair's plain
versions (ops/relu_dropout.py) and the Philox counter generator behind
their mask. JAX on the CPU; the kernels themselves run in
tests/test_torch_gpu.py on a card.

JAX's CPU `relu_dropout` draws a threefry mask and the TPU kernel its
hardware PRNG; neither bit stream can be reproduced (SEMANTICS.md s7), so
parity feeds JAX's own mask to the port's formula, and the port's Philox
stream is pinned by the Random123 known-answer vectors and by
statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu.ops.pallas_kernels import (
    _dropout_keep_mask_xla, relu_dropout as jax_relu_dropout)
from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

torch.set_num_threads(2)


def _u32(v):
    return torch.tensor([v], dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    got = rd.philox4x32_10([_u32(c) for c in ctr], key)
    assert [int(w) for w in got] == list(want)


def test_keep_bits_depend_on_row_and_column_only():
    """Slicing rows (with their offset) or chunking the generator does not
    change a single word; columns group by 4 into one Philox call."""
    full = rd.dropout_keep_bits(300, 253, seed=-17)
    for r0, n in [(0, 1), (5, 100), (299, 1), (131, 169)]:
        assert torch.equal(rd.dropout_keep_bits(n, 253, -17, row0=r0),
                           full[r0:r0 + n])
    assert torch.equal(rd.dropout_keep_bits(300, 8, -17), full[:, :8])
    big = rd.dropout_keep_bits(4, 8, 5, row0=(1 << 32) + 3)
    assert not torch.equal(big, rd.dropout_keep_bits(4, 8, 5, row0=3))
    old = rd._CHUNK_ROWS
    try:
        rd._CHUNK_ROWS = 7
        chunked = rd.dropout_keep_mask(300, 253, -17, 0.3)
    finally:
        rd._CHUNK_ROWS = old
    assert torch.equal(chunked, full >= rd.keep_threshold(0.3))
    assert rd.layer_seed(2 ** 31 - 1, 1) == -(2 ** 31) + 7918


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_keep_fraction_statistics(rate):
    """The keep fraction lies within 5 sigma of 1 - rate, and the mask
    has no column-phase bias (each of the 4 words of a Philox call)."""
    n = 512 * 1024
    keep = rd.dropout_keep_mask(1024, 512, 99, rate)
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 5 * sigma
    for j in range(4):
        part = keep[:, j::4].float().mean().item()
        assert abs(part - (1 - rate)) < 5 * sigma * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.2, 0.3])
def test_formula_matches_jax_with_its_mask(dtype, rate, monkeypatch):
    """Given JAX's own mask, the port's forward and backward equal JAX's
    relu_dropout and its custom VJP bit for bit, in f32 and bf16."""
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(64, 96)).astype(np.float32)
    g_np = rng.normal(size=(64, 96)).astype(np.float32)
    seed = jnp.asarray(7, jnp.int32)
    xj = jnp.asarray(x_np).astype(dtype)
    yj, vjp = jax.vjp(lambda a: jax_relu_dropout(a, seed, rate), xj)
    gj, = vjp(jnp.asarray(g_np).astype(dtype))
    mask = torch.from_numpy(np.array(
        _dropout_keep_mask_xla(x_np.shape, seed, rate)))
    monkeypatch.setattr(rd, "dropout_keep_mask",
                        lambda *a, **k: mask)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(x_np).to(tdt).requires_grad_(True)
    y = rd.relu_dropout(x, 7, rate)
    y.backward(torch.from_numpy(g_np).to(tdt))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(gj.astype(jnp.float32)))


def test_rate_zero_is_relu():
    """As tests/test_pallas_kernels.py's rate-0 check, on both packages."""
    x_np = np.random.default_rng(0).normal(size=(1024, 256)).astype(
        np.float32)
    y = rd.relu_dropout(torch.from_numpy(x_np), 7, 0.0)
    yj = jax_relu_dropout(jnp.asarray(x_np), jnp.asarray(7, jnp.int32), 0.0)
    np.testing.assert_array_equal(y.numpy(), np.maximum(x_np, 0))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_matches_mask(dtype):
    """d/dx sum(y^2) = 2 y / (1 - rate) on kept positive entries, 0
    elsewhere (tests/test_pallas_kernels.py's check), through the
    autograd Function; the backward stores no mask."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(512, 128)).astype(np.float32)).to(dtype).requires_grad_(True)
    rate = 0.3
    y = rd.relu_dropout(x, 3, rate)
    assert len(y.grad_fn.saved_tensors) == 1          # x only
    (y.float() ** 2).sum().backward()
    expect = 2.0 * y.detach().float() / (1.0 - rate)
    torch.testing.assert_close(x.grad.float(), expect.to(dtype).float(),
                               rtol=1e-2 if dtype == torch.bfloat16 else 1e-5,
                               atol=1e-6)
    assert torch.equal(rd.relu_dropout(x.detach(), 3, rate), y.detach())


def test_cpu_wrapper_counts_no_launch_and_refuses_other_devices():
    n0 = profiling.LAUNCHES.copy()
    rd.relu_dropout_fwd(torch.ones(4, 4), 0, 0.2)
    assert profiling.LAUNCHES == n0
    with pytest.raises(ValueError, match="CUDA tensors"):
        rd.relu_dropout_fwd(torch.ones(4, 4, device="meta"), 0, 0.2)
