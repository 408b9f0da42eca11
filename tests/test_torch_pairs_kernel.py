"""The per-point-latent decoder-eval kernel (ops.cuda_kernels pairs
wrapper, csrc/fused_eval_pairs.cu) and its plain version.

On the CPU: the port's bf16 fast_apply over z rows against JAX's; the
wrapper's plain path against the JAX Pallas pairs kernel (in interpret
mode) on the plans of tests/test_pallas_kernels.py with a ragged N; and the
kernel's data layout (W_z in fragment order, L padded to a multiple of 16,
bias-only rows, the six-column layer table) through an emulation of what
the kernel reads. tests/test_torch_gpu.py launches the kernel on the card.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops import (
    fused_decoder as jfd)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.pallas_kernels import (
    make_pallas_apply_pairs)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply, make_kernel_apply_pairs, pack_weights_pairs)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack, params_from_jax)

torch.set_num_threads(2)

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "multicat6k" / "stage1_pack.npz")

# the plans of tests/test_pallas_kernels.py: (config kwargs, seed, ragged n)
PLANS = {
    "small": (dict(latent_size=16, hidden_dim=128, num_layers=3,
                   latent_in=(2,), use_dropout=False), 0, 700),
    "tanh": (dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
                  use_tanh=True, use_dropout=False), 2, 300),
    "canonical": (dict(use_dropout=False), 1, 2048 + 131),
}


def _setup(name):
    """JAX decoder and params, the port's decoder and state dict, z rows
    [n, L] (one latent per point) and xyz [n, 3], from a seed."""
    kw, seed, n = PLANS[name]
    jdec = JaxDecoder(jcfg.DecoderConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    L = kw.get("latent_size", 256)
    zr = (rng.normal(size=(n, L)) / np.sqrt(L)).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    dec = SdfDecoder(tcfg.DecoderConfig(**kw))
    return jdec, params, dec, params_from_jax(params), zr, xyz


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fast_apply_over_z_rows_matches_jax(name):
    """The kernel's plain version: bf16 fast_apply with a latent row per
    point, against JAX's fast_apply on the same rows (JAX's oracle of its
    pairs kernel). Same rounding points, summation order aside."""
    jdec, params, dec, sd, zr, xyz = _setup(name)
    jew = jfd.precompute_eval_weights(jdec, params, jnp.bfloat16)
    want = np.asarray(jfd.fast_apply(jew, jnp.asarray(zr), jnp.asarray(xyz)))
    ew = precompute_eval_weights(dec, sd, torch.bfloat16)
    got = fast_apply(ew, torch.from_numpy(zr), torch.from_numpy(xyz)).numpy()
    assert got.shape == (xyz.shape[0],)
    np.testing.assert_allclose(got, want, atol=5e-3)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pairs_apply_cpu_matches_pallas_interpret(name):
    jdec, params, dec, sd, zr, xyz = _setup(name)
    want = np.asarray(make_pallas_apply_pairs(jdec, params, tile=1024,
                                              interpret=True)(
        jnp.asarray(zr), jnp.asarray(xyz)))
    apply = make_kernel_apply_pairs(dec, sd, device="cpu")
    got = apply(torch.from_numpy(zr), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert apply.launches == 0          # the CPU path launches nothing


def test_pairs_apply_with_equal_rows_matches_single_latent_apply():
    """Every row the same latent: the pairs path computes the single-latent
    path's function (tests/test_pallas_kernels.py:94-105)."""
    _, _, dec, sd, zr, xyz = _setup("small")
    z = torch.from_numpy(zr[0])
    rows = z.expand(xyz.shape[0], -1)
    pairs = make_kernel_apply_pairs(dec, sd, device="cpu")
    single = make_kernel_apply(dec, sd, device="cpu")
    torch.testing.assert_close(pairs(rows, torch.from_numpy(xyz)),
                               single(z, torch.from_numpy(xyz)),
                               atol=1e-2, rtol=0)


def _unfragment(flat, n, k):
    """Inverse of cuda_kernels.fragment_order: flat [n*k] -> [n, k]."""
    frag = flat.reshape(n // 16, k // 16, 8, 4, 2, 2, 2)
    return frag.permute(0, 4, 2, 1, 5, 3, 6).reshape(n, k)


def _emulate_pairs_kernel(ew, z_rows, xyz):
    """What csrc/fused_eval_pairs.cu computes, from the buffers it reads
    (pack_weights_pairs), in fp32 on the CPU: the tile's z rows padded to
    lz with zeros, hidden and latent products, xyz term, bias row."""
    w_all, wx_all, rows, meta, lz = pack_weights_pairs(ew)
    w_all, wx_all = w_all.float(), wx_all.float()
    assert lz % 16 == 0 and lz - ew.latent_size < 16
    zs = F.pad(z_rows.to(torch.bfloat16).float(), (0, lz - z_rows.shape[1]))
    xs = xyz.to(torch.bfloat16).float()
    h = None
    for i, (k, n, wo, wzo, ro, xo) in enumerate(meta.tolist()):
        acc = torch.zeros(xyz.shape[0], n)
        if i == len(meta) - 1:
            acc = h @ w_all[wo:wo + k]
        elif i > 0:
            acc = h @ _unfragment(w_all[wo:wo + n * k], n, k).T
        if wzo >= 0:
            acc = acc + zs @ _unfragment(w_all[wzo:wzo + n * lz], n, lz).T
        if xo >= 0:
            acc = acc + xs @ wx_all[xo:xo + 3 * n].reshape(n, 3).T
        acc = acc + rows[ro:ro + n]
        if i < len(meta) - 1:
            h = torch.relu(acc).to(torch.bfloat16).float()
    return torch.tanh(acc) if ew.use_tanh else acc


@pytest.mark.parametrize("name", ["small", "tanh", "trained"])
def test_pairs_packed_layout_reproduces_plain_version(name):
    """W_z in fragment order after the hidden weights, L padded to 16 (the
    tanh plan's L = 8), bias-only rows and the layer table hold the same
    function as fast_apply in bf16 over z rows."""
    if name == "trained":
        sd, codes = load_stage1_pack(PACK)
        dec = SdfDecoder(tcfg.DecoderConfig())
        rng = np.random.default_rng(0)
        z_rows = torch.from_numpy(codes[rng.integers(0, 64, 777)])
        xyz = torch.from_numpy(rng.uniform(-1, 1, (777, 3)).astype(
            np.float32))
    else:
        _, _, dec, sd, zr, xyz = _setup(name)
        z_rows, xyz = torch.from_numpy(zr), torch.from_numpy(xyz)
    ew = precompute_eval_weights(dec, sd, torch.bfloat16)
    got = _emulate_pairs_kernel(ew, z_rows, xyz)
    want = fast_apply(ew, z_rows, xyz)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=5e-3, rtol=0)


def test_pairs_pack_table():
    """The layer table of the canonical plan: W_z of layer 0 and of the
    skip layer after every hidden weight, 16-byte aligned, sizes n x lz."""
    dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False))
    ew = precompute_eval_weights(dec, dec.state_dict(), torch.bfloat16)
    w_all, wx_all, rows, meta, lz = pack_weights_pairs(ew)
    assert lz == 256 and meta.shape == (9, 6)
    has_z = [i for i in range(9) if meta[i, 3] >= 0]
    assert has_z == [0, 4]
    assert all(meta[i, 3] % 8 == 0 for i in has_z)      # 16-byte aligned
    assert meta[4, 3] == meta[0, 3] + 512 * 256
    assert w_all.numel() == meta[4, 3] + 512 * 256
    assert rows.numel() == int(meta[:, 1].sum()) and rows.dtype == torch.float32
    torch.testing.assert_close(rows[meta[4, 4]:meta[4, 4] + 512], ew.layers[4].b)


def test_make_kernel_apply_pairs_checks(monkeypatch):
    _, _, dec, sd, zr, xyz = _setup("tanh")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_kernel_apply_pairs(dec, sd)
    apply = make_kernel_apply_pairs(dec, sd, device="cpu")
    with pytest.raises(ValueError, match="z_rows"):
        apply(torch.from_numpy(zr[:5]), torch.from_numpy(xyz))
    with pytest.raises(ValueError, match="weights on"):
        apply(torch.from_numpy(zr).to("meta"), torch.from_numpy(xyz))
    big = SdfDecoder(tcfg.DecoderConfig(latent_size=520, hidden_dim=64,
                                        num_layers=2, latent_in=()))
    with pytest.raises(ValueError, match="latent size"):
        pack_weights_pairs(precompute_eval_weights(big, big.state_dict()))
