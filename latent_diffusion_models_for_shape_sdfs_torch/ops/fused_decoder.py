"""Folded eval form of the SDF decoder: the plain version of the fused
decoder-eval kernel.

Counterpart of the JAX package's `ops/fused_decoder.py`:

  1. **Weight-norm folding**: the effective W = g * v/||v|| is materialised
     once per params instead of per point.
  2. **Latent hoisting**: layer 0's input is concat(z, xyz); its weight is
     split into W_z and W_x, and z @ W_z (+ bias) is computed once per
     latent instead of per query point. The skip layer's z/xyz slices are
     hoisted the same way. Per point only the 3-wide xyz product and the
     hidden products remain.
  3. **bf16 compute**: folded weights and activations are rounded to a
     configurable dtype (default bfloat16); products accumulate in fp32
     and the output is fp32.

Weights keep torch's [out, in] layout (`F.linear`). In bf16 mode the
operands are rounded to bf16 and then multiplied *as fp32*: a torch
matmul on bf16 tensors returns bf16, which would round the accumulator
before the bias is added, where JAX keeps fp32
(`preferred_element_type=float32`). `fast_apply` in bf16 is the plain
version that `ops.cuda_kernels` holds its kernels against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder, effective_weight)


class EvalLayer(NamedTuple):
    w_h: Optional[torch.Tensor]   # [H, H_prev] hidden-input slice (None: layer 0)
    w_z: Optional[torch.Tensor]   # [H, L] latent slice (layer 0 / skip layers)
    w_x: Optional[torch.Tensor]   # [H, 3] xyz slice (layer 0 / skip layers)
    b: torch.Tensor               # [H] fp32


class EvalWeights(NamedTuple):
    layers: tuple                 # tuple[EvalLayer]
    use_tanh: bool
    latent_size: int


def precompute_eval_weights(decoder: SdfDecoder, params: dict,
                            dtype=torch.bfloat16,
                            device=None) -> EvalWeights:
    """Fold the decoder's state dict (`params`, e.g. from
    utils.checkpoint.params_from_jax) into per-layer eval slices."""
    cfg = decoder.cfg
    if cfg.xyz_in_all or cfg.latent_dropout:
        raise ValueError(
            "fused eval paths support the canonical plan; use SdfDecoder "
            "for xyz_in_all / latent_dropout variants")
    L = cfg.latent_size
    layers = []
    for layer, (_, _, takes_skip) in enumerate(decoder.layer_dims()):
        v = params[f"lin{layer}.v"].to(device=device, dtype=torch.float32)
        w = (effective_weight(v, params[f"lin{layer}.g"].to(v))
             if cfg.weight_norm else v).to(dtype)
        b = params[f"lin{layer}.b"].to(device=device, dtype=torch.float32)
        if layer == 0:
            layers.append(EvalLayer(None, w[:, :L], w[:, L:L + 3], b))
        elif takes_skip:
            h_prev = w.shape[1] - (L + 3)
            layers.append(EvalLayer(w[:, :h_prev], w[:, h_prev:h_prev + L],
                                    w[:, h_prev + L:], b))
        else:
            layers.append(EvalLayer(w, None, None, b))
    return EvalWeights(tuple(layers), cfg.use_tanh, L)


def fast_apply(ew: EvalWeights, z: torch.Tensor,
               xyz: torch.Tensor) -> torch.Tensor:
    """z [L] (one latent) or [N, L] (a latent row per point), xyz [N,3] ->
    sdf [N] (fp32). Operands rounded to ew's dtype, products and sums in
    fp32. In bf16 it is the plain version of both fused eval kernels."""
    dtype = ew.layers[0].w_z.dtype

    def rounded(t):
        return t.to(dtype).float()

    z = rounded(z)
    xyz = rounded(xyz)
    n_lin = len(ew.layers)
    h = None
    for i, lay in enumerate(ew.layers):
        acc = lay.b
        if lay.w_z is not None:
            # latent hoist: one [L] x [L,H] GEMV per call, not per point
            acc = acc + F.linear(z, lay.w_z.float())
            acc = acc + F.linear(xyz, lay.w_x.float())
        if lay.w_h is not None:
            acc = acc + F.linear(h, lay.w_h.float())
        if i < n_lin - 1:
            h = rounded(torch.relu(acc))
        else:
            out = acc
    if ew.use_tanh:
        out = torch.tanh(out)
    return out[..., 0].float()


def make_fast_apply(decoder: SdfDecoder, params: dict,
                    dtype=torch.bfloat16) -> Callable:
    """(z [L], xyz [N,3]) -> sdf [N], with weights folded at closure time
    (on the device `params` lie on)."""
    ew = precompute_eval_weights(decoder, params, dtype)

    def apply_fn(z, xyz):
        return fast_apply(ew, z, xyz)

    return apply_fn


def make_reference_apply(decoder: SdfDecoder) -> Callable:
    """Exact decoder eval path with the same (z, xyz) contract (oracle)."""

    def apply_fn(z, xyz):
        zz = z.expand(xyz.shape[:-1] + z.shape)
        return decoder(zz, xyz)

    return apply_fn
