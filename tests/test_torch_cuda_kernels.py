"""The fused decoder-eval kernel (ops.cuda_kernels, csrc/fused_eval.cu).

On the CPU: the wrapper's plain path against the JAX Pallas kernel (in
interpret mode) on the plans of tests/test_pallas_kernels.py, and the
kernel's data layout (fragment order, padding, the layer table) through an
emulation of what the kernel reads. tests/test_torch_gpu.py launches the
kernel on the card.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_tpu import config as jcfg
from latent_diffusion_models_for_shape_sdfs_tpu.models.decoder import (
    SdfDecoder as JaxDecoder)
from latent_diffusion_models_for_shape_sdfs_tpu.ops.pallas_kernels import (
    make_pallas_apply)
from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    fragment_order, hoisted_rows, make_kernel_apply, pack_weights)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    load_stage1_pack, params_from_jax)

torch.set_num_threads(2)

PACK = (pathlib.Path(__file__).resolve().parents[1] / "runs"
        / "scale_chairs6k" / "stage1_pack.npz")

# the plans of tests/test_pallas_kernels.py: (config kwargs, seed, n)
PLANS = {
    "small": (dict(latent_size=16, hidden_dim=128, num_layers=3,
                   latent_in=(2,), use_dropout=False), 0, 700),
    "tanh": (dict(latent_size=8, hidden_dim=32, num_layers=2, latent_in=(),
                  use_tanh=True, use_dropout=False), 2, 300),
    "canonical": (dict(use_dropout=False), 1, 2048 + 131),
}


def _setup(name):
    kw, seed, n = PLANS[name]
    jdec = JaxDecoder(jcfg.DecoderConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    L = kw.get("latent_size", 256)
    z = (rng.normal(size=L) / np.sqrt(L)).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    dec = SdfDecoder(tcfg.DecoderConfig(**kw))
    return jdec, params, dec, params_from_jax(params), z, xyz


@pytest.mark.parametrize("name", sorted(PLANS))
def test_kernel_apply_cpu_matches_pallas_interpret(name):
    jdec, params, dec, sd, z, xyz = _setup(name)
    want = np.asarray(make_pallas_apply(jdec, params, tile=1024,
                                        interpret=True)(
        jnp.asarray(z), jnp.asarray(xyz)))
    apply = make_kernel_apply(dec, sd, device="cpu")
    got = apply(torch.from_numpy(z), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert apply.launches == 0          # the CPU path launches nothing


def test_fragment_order_matches_mma_operand_layout():
    """Per the PTX ISA, lane l = 4g + q of an m16n8k16 bf16 product holds
    B[k=2q+{0,1}][n=g] in b0 and B[k=8+2q+{0,1}][n=g] in b1. Rebuild the
    product from what each lane loads (two n8 tiles per 16-byte load) and
    compare with the plain product."""
    g = torch.Generator().manual_seed(0)
    n, k, m = 48, 64, 5
    w = torch.randn(n, k, generator=g).to(torch.bfloat16)
    a = torch.randn(m, k, generator=g).to(torch.bfloat16).float()
    frag = fragment_order(w).float().reshape(n // 16, k // 16, 32, 8)
    out = torch.zeros(m, n)
    for ntp in range(n // 16):
        for kt in range(k // 16):
            for lane in range(32):
                gg, q = divmod(lane, 4)
                vals = frag[ntp, kt, lane]
                for pair in range(2):
                    col = ntp * 16 + pair * 8 + gg
                    for j, kk in enumerate((2 * q, 2 * q + 1,
                                            8 + 2 * q, 9 + 2 * q)):
                        out[:, col] += a[:, kt * 16 + kk] * vals[pair * 4 + j]
    torch.testing.assert_close(out, a @ w.float().T, atol=1e-5, rtol=1e-5)


def _emulate_kernel(ew, z, xyz):
    """What csrc/fused_eval.cu computes, from the packed buffers it reads
    (pack_weights) and the wrapper's hoisted rows, in fp32 on the CPU."""
    w_all, wx_all, meta = pack_weights(ew)
    w_all, wx_all = w_all.float(), wx_all.float()
    rows = hoisted_rows(ew, meta, z)
    xs = xyz.to(torch.bfloat16).float()
    h = None
    for i, (k, n, wo, ro, xo) in enumerate(meta.tolist()):
        acc = 0.0
        if i == len(meta) - 1:
            acc = h @ w_all[wo:wo + k]
        elif i > 0:
            frag = w_all[wo:wo + n * k].reshape(n // 16, k // 16, 8, 4, 2,
                                                2, 2)
            w = frag.permute(0, 4, 2, 1, 5, 3, 6).reshape(n, k)
            acc = h @ w.T
        if xo >= 0:
            acc = acc + xs @ wx_all[xo:xo + 3 * n].reshape(n, 3).T
        acc = acc + rows[ro:ro + n]
        if i < len(meta) - 1:
            h = torch.relu(acc).to(torch.bfloat16).float()
    return torch.tanh(acc) if ew.use_tanh else acc


@pytest.mark.parametrize("name", ["small", "tanh", "trained"])
def test_packed_layout_reproduces_plain_version(name):
    """The padded, fragment-ordered weights and the layer table hold the
    same function as fast_apply in bf16 (253 -> 256 padding included)."""
    if name == "trained":
        sd, codes = load_stage1_pack(PACK)
        dec = SdfDecoder(tcfg.DecoderConfig())
        z = torch.from_numpy(codes[7])
        xyz = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (777, 3)).astype(np.float32))
    else:
        _, _, dec, sd, z, xyz = _setup(name)
        z, xyz = torch.from_numpy(z), torch.from_numpy(xyz)
    ew = precompute_eval_weights(dec, sd, torch.bfloat16)
    got = _emulate_kernel(ew, z, xyz)
    want = fast_apply(ew, z, xyz)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=5e-3, rtol=0)


def test_pack_rejects_unsupported_plans():
    for kw in (dict(hidden_dim=1024), dict(latent_in=(8,))):
        dec = SdfDecoder(tcfg.DecoderConfig(use_dropout=False, **kw))
        ew = precompute_eval_weights(dec, dec.state_dict())
        with pytest.raises(ValueError, match="fused kernel"):
            pack_weights(ew)


def test_make_kernel_apply_needs_card_unless_cpu(monkeypatch):
    dec = SdfDecoder(tcfg.DecoderConfig(latent_size=8, hidden_dim=32,
                                        num_layers=2, latent_in=()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_kernel_apply(dec, dec.state_dict())
    apply = make_kernel_apply(dec, dec.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="weights on"):
        apply(torch.zeros(8, dtype=torch.float64).to("meta"),
              torch.zeros(4, 3))
