"""DeepSDF-style auto-decoder MLP (eval forward), torch `weight_norm` layout.

Counterpart of the JAX package's `models/decoder.py`, with the same layer
plan: `num_layers` hidden layers of width `hidden_dim` plus a final scalar
layer (9 linear layers lin0..lin8 for the canonical 8x512 net). Layers in
`latent_in` re-concatenate the full (z, xyz) input, and the layer before
shrinks its output by the input width so the concat lands back on
`hidden_dim` (512 = 253 + 259 for the defaults).

Weights are kept in torch's `nn.Linear` layout, `v [out, in]`, with the
`weight_norm(dim=0)` reparameterisation: each output unit o has its own
scale, W[o, :] = g[o] * v[o, :] / max(||v[o, :]||_2, 1e-12). The JAX tree
stores `v [in, out]`; `utils.checkpoint.params_from_jax` converts.

Compute is fp32, or bf16 operands with fp32 accumulation when
`compute_dtype="bfloat16"`: the hidden layers then go through
`ops.bf16_linear` (bf16 tensor-core products on the card, forward and
backward). The scalar head, whose cotangent need not be bf16-valued,
keeps the plain form's arithmetic (fp32 sums of exact products of bf16
values) through `ops.head.bf16_head`: on the card as its two kernels
(`csrc/head.cu`), on the CPU as torch's products bit for bit; an fp32
decoder's head stays `WNLinear`'s fp32 product. In training mode
(`decoder.train()`) the forward takes a `seed` and applies dropout after
every hidden relu:
`dropout_impl="pallas"` goes through the relu+dropout kernel
(`ops.relu_dropout`, Philox mask keyed by seed + 7919 * layer, as the JAX
decoder derives its per-layer seed), `dropout_impl="xla"` stays plain
torch (an inverted-dropout mask drawn from a `torch.Generator` seeded the
same way). In eval mode nothing is dropped.

In training with `dropout_impl="pallas"`, every bf16 hidden layer is one
function, `ops.bf16_linear.bf16_linear_relu_dropout` (the product, then
kernels #3/#3b on its fp32 output and bias: no fp32 activation or
cotangent of its own), equal to its composition
`ops.bf16_linear.bf16_linear_relu_dropout_reference`. Every other bf16
hidden layer is `bf16_linear`, then relu and the plain dropout where
there is one; an fp32 one is `WNLinear`'s product, then the standalone
`relu_dropout` or relu and the plain dropout.

Where `ops.bf16_linear.pads` says so (on the card), the bf16 hidden
layers run on that module's padded layout: the input cat writes [z,
xyz, 0...] to a multiple of 8 columns, each hidden output is as wide as
its width rounded up to 8 (zeros in the pad), and the skip cat joins the
two padded pieces; the head reads the logical columns. Widths already
multiples of 8 are left as they are. The plain dropout
(`dropout_impl="xla"`) draws its mask over the row as stored, so it
keeps the unpadded layout.

The forward also takes a training step's inputs per scene, one code z
[S, L] for the P points xyz [S, P, 3] of each scene, and returns [S, P]:
the flat form of z expanded over each scene's points. On the padded
layout on the card, with kernel dropout or none and neither
`latent_dropout` nor `xyz_in_all`, lin0's input and the skip layer's are
written straight from z and xyz (`ops.decoder_input`, the kernels of
`csrc/decoder_input.cu`, which raise on what they cannot take), so no
flat copy of the codes exists; the forward and every weight gradient are
the flat form's bit for bit, and z's gradient drops the bf16 rounding of
its two cotangents' add. Anywhere else the forward expands z itself and
runs the flat form.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.config import DecoderConfig
from latent_diffusion_models_for_shape_sdfs_torch.ops import (
    bf16_linear as bf16_ops)
from latent_diffusion_models_for_shape_sdfs_torch.ops import (
    decoder_input as di_ops)
from latent_diffusion_models_for_shape_sdfs_torch.ops import head as head_ops
from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear import (
    bf16_linear, bf16_linear_reference, bf16_linear_relu_dropout)
from latent_diffusion_models_for_shape_sdfs_torch.ops.relu_dropout import (
    layer_seed, relu_dropout)


def effective_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """W[o, :] = g[o] * v[o, :] / max(||v[o, :]||_2, 1e-12) for v [out, in]
    (torch weight_norm, dim=0)."""
    norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    return v * (g[:, None] / torch.clamp(norm, min=1e-12))


class WNLinear(nn.Module):
    """Linear layer with torch-`weight_norm(dim=0)` reparameterisation.

    Parameters `v [out, in]`, `g [out]`, `b [out]`; init matches torch's
    nn.Linear (U(-1/sqrt(in), 1/sqrt(in))) with g = ||v[o, :]|| so the
    initial effective weight equals the raw init."""

    def __init__(self, in_features: int, out_features: int,
                 use_weight_norm: bool = True):
        super().__init__()
        self.use_weight_norm = use_weight_norm
        self.v = nn.Parameter(torch.empty(out_features, in_features))
        self.b = nn.Parameter(torch.empty(out_features))
        if use_weight_norm:
            self.g = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        k = 1.0 / math.sqrt(self.v.shape[1])
        nn.init.uniform_(self.v, -k, k, generator=generator)
        nn.init.uniform_(self.b, -k, k, generator=generator)
        if self.use_weight_norm:
            self.g.copy_(torch.sqrt(torch.sum(self.v * self.v, dim=1)))

    def weight(self) -> torch.Tensor:
        return (effective_weight(self.v, self.g) if self.use_weight_norm
                else self.v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 in: fp32 product. bf16 in: bf16 operands, fp32 accumulation
        and fp32 bias (the JAX `preferred_element_type=float32` form)."""
        w = self.weight()
        if x.dtype == torch.bfloat16:
            return bf16_linear_reference(x, w, self.b)
        return F.linear(x, w.to(x.dtype), self.b.to(x.dtype))


class SdfDecoder(nn.Module):
    """f(z, xyz) -> sdf. See the module docstring for the layer plan."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig()):
        super().__init__()
        self.cfg = cfg
        for layer, (d_in, out, _) in enumerate(self.layer_dims()):
            self.add_module(f"lin{layer}",
                            WNLinear(d_in, out, cfg.weight_norm))

    def layer_dims(self) -> Sequence[tuple]:
        """[(in_dim, out_dim, takes_skip), ...] for each linear layer.

        A layer feeding a `latent_in` layer shrinks its output by the full
        input width; with `xyz_in_all`, every non-final layer shrinks by 3
        and layers > 0 (that are not latent_in) re-concat xyz."""
        c = self.cfg
        d_in = c.latent_size + 3
        dims = [d_in] + [c.hidden_dim] * c.num_layers + [1]
        n_lin = len(dims) - 1
        plan = []
        for layer in range(n_lin):
            out = dims[layer + 1]
            if (layer + 1) in c.latent_in:
                out = dims[layer + 1] - dims[0]
            elif c.xyz_in_all and layer != n_lin - 1:
                out -= 3
            takes_skip = layer in c.latent_in
            plan.append((dims[layer], out, takes_skip))
        return plan

    def forward(self, z: torch.Tensor, xyz: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        """z [..., L], xyz [..., 3] -> sdf [...] (fp32); or per scene, z
        [S, L] and xyz [S, P, 3] -> sdf [S, P], the flat form of z expanded
        over each scene's P points (rows scene-major). In training mode
        with dropout configured, `seed` (an int) fixes every dropout mask;
        the relu+dropout kernel keys its mask by the row of the flattened
        [..., H] activation, so pass flat [N, L] / [N, 3] inputs, or the
        per-scene form, to get the fused train kernel's masks."""
        c = self.cfg
        drop = self.training and c.use_dropout and c.dropout_prob > 0
        if (drop or (self.training and c.latent_dropout)) and seed is None:
            raise ValueError("training-mode dropout needs a seed")
        dtype = getattr(torch, c.compute_dtype)
        plan = self.layer_dims()
        n_lin = len(plan)
        fused = drop and c.dropout_impl == "pallas"
        pad = (dtype == torch.bfloat16 and bf16_ops.pads(z)
               and (fused or not drop))
        scenes = z.dim() == 2 and xyz.dim() == 3
        # the kernels' route; the padded layout asked for on the CPU (the
        # layout's tests) expands z, as the kernels run on the card alone
        if scenes and not (pad and z.is_cuda and not c.xyz_in_all
                           and not (c.latent_dropout and self.training)):
            S, P, L = *xyz.shape[:2], z.shape[-1]
            flat = z[:, None, :].expand(S, P, L).reshape(-1, L)
            return self.forward(flat, xyz.reshape(-1, 3),
                                seed).reshape(S, P)
        if scenes:      # the rows written from z and xyz (ops.decoder_input)
            inp = di_ops.decoder_input(z, xyz)
        else:
            z = z.to(dtype)
            xyz = xyz.to(dtype)
            if c.latent_dropout and self.training:
                # lineage option: dropout(0.2) on the latent half of the
                # input, drawn from the stream one past the last hidden
                # layer's
                z = _plain_dropout(z, 0.2, layer_seed(seed, n_lin))
            if pad:
                inp = bf16_ops.pad_columns([z, xyz])
                if c.xyz_in_all:
                    xyz = bf16_ops.pad_columns([xyz])
            else:
                inp = torch.cat([z, xyz], dim=-1)
        x = inp
        runs = (plan[0][0],)    # x's columns: logical widths of its pieces
        for layer, (_, out, takes_skip) in enumerate(plan):
            if takes_skip:
                x = (di_ops.skip_input(x, z, xyz) if scenes
                     else torch.cat([x, inp], dim=-1))
                runs += (plan[0][0],)
            elif c.xyz_in_all and layer != 0:
                x = torch.cat([x, xyz], dim=-1)
                runs += (3,)
            lin = getattr(self, f"lin{layer}")
            s = layer_seed(seed, layer) if drop else 0
            if x.dtype == torch.bfloat16 and layer < n_lin - 1:
                if fused:
                    x = bf16_linear_relu_dropout(x, lin.weight(), lin.b, s,
                                                 c.dropout_prob,
                                                 runs if pad else None)
                    runs = (out,)
                    continue
                if pad:
                    x = bf16_linear(x, lin.weight(), lin.b, runs)
                else:
                    x = bf16_linear(x, lin.weight(), lin.b)
            else:
                if pad:     # the head reads the logical columns
                    x = bf16_ops.logical_columns(x, runs)
                x = (head_ops.bf16_head(x, lin.weight(), lin.b)
                     if x.dtype == torch.bfloat16 else lin(x))
            runs = (out,)
            if layer < n_lin - 1:
                if fused:
                    x = relu_dropout(x.to(dtype), s, c.dropout_prob)
                else:
                    x = torch.relu(x).to(dtype)
                    if drop:
                        x = _plain_dropout(x, c.dropout_prob, s)
        if c.use_tanh:
            x = torch.tanh(x)
        x = x[..., 0].float()
        return x.reshape(xyz.shape[:2]) if scenes else x


def _plain_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout` semantics: keep with
    probability 1-rate, divide kept values by 1-rate in x's type), the
    mask drawn from a generator seeded with `seed` on x's device."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFFFFFF)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))
