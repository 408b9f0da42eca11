"""Plain reference of the SDF auto-decoder (DeepSDF, Park et al. 2019) and
of its stage-1 training step, in PyTorch's float32 arithmetic with TF32
off, its operands rounded as `product` and `store` say.

The decoder: linear layers lin0 .. lin{n} with weight normalisation
(W[o, :] = g[o] v[o, :] / ||v[o, :]||), relu and inverted dropout after
every hidden layer (the port's Philox mask, benchmark/frozen.py), the
(z, xyz) input concatenated again before each `latent_in` layer. The
step: clamped-L1 over the batch's points plus the warm-up code
regularisation, the gradients of every weight and of the code table, and
Adam with a decoder group and a code group. Nothing here imports the
port.

`product` is the form of every matrix product's operands: `fp32`;
`bf16`, the configuration's compute dtype (operands rounded to bf16,
products summed in fp32); `fp8` for the control (each operand rounded to
float8 e4m3 with a per-tensor scale, the next precision below bf16).
`store` is where a bf16 configuration rounds what it keeps: None keeps
fp32; otherwise the input (z, xyz) and every hidden activation are
bf16, the activation rounded as the route's kernels round it: `double`,
the layer's output plus bias rounded, then times the dropout scale and
rounded again (the autograd route, kernel #3); `single`, relu times the
scale in fp32 rounded once (the fused route, kernel #4). Rounding passes
the gradient straight through, so the backward is fp32 on the rounded
forward's values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import frozen
from benchmark.yardstick import decoder_layers


def load_pack(path, device) -> tuple:
    """A stage-1 pack (npz keyed "['params']['lin<i>']['v'|'g'|'b']" and
    "['codes']", v stored [in, out]) -> (leaves in the torch layout,
    v [out, in], and the codes [N, L]), float32 on `device`."""
    with np.load(path) as z:
        params = {}
        for key in z.files:
            parts = key.strip("[]'").split("']['")
            if parts[0] == "params":
                a = z[key].T if parts[2] == "v" else z[key]
                params[f"{parts[1]}.{parts[2]}"] = torch.from_numpy(
                    np.ascontiguousarray(a, np.float32)).to(device)
        codes = torch.from_numpy(z["['codes']"].astype(np.float32)).to(device)
    return params, codes


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    the gradient passed straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t).detach()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), the gradient passed straight
    through."""
    return t + (t.detach().to(torch.bfloat16).float() - t).detach()


PRODUCTS = {"fp32": lambda x, w: x @ w.t(),
            "bf16": lambda x, w: bf16_round(x) @ bf16_round(w).t(),
            "fp8": lambda x, w: fp8_round(x) @ fp8_round(w).t()}


def _activation(y: torch.Tensor, keep, scale: float, store) -> torch.Tensor:
    """relu and inverted dropout of a hidden layer's output y, kept as
    `store` says (module docstring); `keep` None is no dropout."""
    if store == "double":
        y = bf16_round(y)
    a = torch.relu(y)
    if keep is not None:
        a = torch.where(keep, a * scale, torch.zeros((), device=y.device))
    return a if store is None else bf16_round(a)


def weight(params: dict, i: int, weight_norm: bool = True) -> torch.Tensor:
    v = params[f"lin{i}.v"]
    if not weight_norm:
        return v
    norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    return v * (params[f"lin{i}.g"][:, None] / torch.clamp(norm, min=1e-12))


def forward(params: dict, dec: dict, z: torch.Tensor, xyz: torch.Tensor,
            seed, row0: int = 0, product: str = "fp32", store=None,
            taps: list | None = None) -> torch.Tensor:
    """f(z [N, L], xyz [N, 3]) -> sdf [N] for rows row0 .. row0 + N of the
    step's flat batch; `seed` None is eval mode (no dropout). With `taps`
    a list, each layer's (input, output before its activation) is
    appended to it, the output keeping its gradient."""
    prod = PRODUCTS[product]
    plan = decoder_layers(dec)
    rate = dec["dropout_prob"] if dec["use_dropout"] else 0.0
    if store is not None:
        z, xyz = bf16_round(z), bf16_round(xyz)
    inp = torch.cat([z, xyz], dim=-1)
    x = inp
    for i, (_, _, skip) in enumerate(plan):
        if skip:
            x = torch.cat([x, inp], dim=-1)
        y = prod(x, weight(params, i, dec["weight_norm"])) + params[f"lin{i}.b"]
        if taps is not None:
            y.retain_grad()
            taps.append((x, y))
        x = y
        if i < len(plan) - 1:
            keep = None
            if seed is not None and rate > 0:
                keep = frozen.dropout_keep_mask(
                    y.shape[0], y.shape[1], frozen.layer_seed(seed, i), rate,
                    row0=row0, device=y.device)
            x = _activation(y, keep, 1.0 / (1.0 - rate), store)
    if dec.get("use_tanh"):
        x = torch.tanh(x)
    return x[:, 0]


def step_lr(lr0: float, epoch: float, factor: float, interval: int) -> float:
    e = np.float32(epoch)
    return float(np.float32(lr0) * np.power(np.float32(factor),
                                            np.floor(e / np.float32(interval))))


def loss_and_grads(params: dict, codes: torch.Tensor, ad: dict,
                   ids: torch.Tensor, xyz: torch.Tensor, sdf: torch.Tensor,
                   seed: int, epoch: float, product: str,
                   block: int, terms: bool = False, store=None) -> tuple:
    """(loss, {leaf: gradient}, {leaf: magnitude of its terms} or None) of
    one step, the points taken `block` scenes at a time and the gradients
    summed. With `terms`, each leaf's gradient, a sum over the batch's
    points (and the code regularisation's scenes), has the sum of its
    terms' magnitudes beside it, of the same shape: for a layer's weight
    W = g v / ||v|| the terms dy_n x_n^T of the points n, so A = |dy|^T |x|;
    sum |dy| for its bias; for g, whose gradient is the sum over points
    and inputs of dy_n x_n v / ||v||, A |v| / ||v|| summed over the inputs;
    for v the bound (|g| / ||v||) (A + that sum |v| / ||v||); and sum |dz|
    of each code row. Where the gradient is a small part of it, its terms
    cancel."""
    dec = ad["decoder"]
    S, P = xyz.shape[:2]
    n = S * P
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    table = codes.detach().requires_grad_(True)
    z = table[ids]
    scale = float(np.float32(ad["code_reg_lambda"]) * np.minimum(
        np.float32(epoch) / np.float32(ad["code_reg_warmup_epochs"]),
        np.float32(1.0)))
    sq = torch.sum(z * z, dim=-1)
    reg = scale * (torch.sum(sq) if ad["code_reg_squared"]
                   else torch.sum(torch.sqrt(sq))) / S
    reg.backward()
    total = float(reg.detach())
    mag = None
    if terms:
        mag = {k: torch.zeros_like(v) for k, v in params.items()}
        mag["codes"] = table.grad.abs()
    d = ad["clamp_dist"]
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        zb = table[ids[s0:s1]]
        zr = zb[:, None, :].expand(s1 - s0, P, zb.shape[-1]).reshape(-1,
                                                                     zb.shape[-1])
        taps = None
        if terms:
            zr.retain_grad()
            taps = []
        pred = forward(leaves, dec, zr, xyz[s0:s1].reshape(-1, 3), seed,
                       row0=s0 * P, product=product, store=store, taps=taps)
        l1 = torch.sum(torch.abs(torch.clamp(pred, -d, d) - torch.clamp(
            sdf[s0:s1].reshape(-1), -d, d))) / n
        l1.backward()
        total += float(l1.detach())
        if terms:
            with torch.no_grad():
                _add_terms(mag, leaves, dec, taps)
                mag["codes"].index_add_(0, ids[s0:s1], zr.grad.abs().view(
                    s1 - s0, P, -1).sum(dim=1))
    grads = {k: v.grad for k, v in leaves.items()}
    grads["codes"] = table.grad
    return total, grads, mag


def _add_terms(mag: dict, leaves: dict, dec: dict, taps: list) -> None:
    """Add one block's terms' magnitudes of every layer to `mag`."""
    for i, (x, y) in enumerate(taps):
        dy = y.grad.abs()
        xw = dy.t() @ x.detach().abs()
        mag[f"lin{i}.b"] += dy.sum(dim=0)
        if not dec["weight_norm"]:
            mag[f"lin{i}.v"] += xw
            continue
        g, v = leaves[f"lin{i}.g"].detach(), leaves[f"lin{i}.v"].detach()
        vn = torch.sqrt(torch.sum(v * v, dim=1)).clamp(min=1e-12)
        vh = (v / vn[:, None]).abs()
        du = (xw * vh).sum(dim=1)
        mag[f"lin{i}.g"] += du
        mag[f"lin{i}.v"] += (g.abs() / vn)[:, None] * (xw + du[:, None] * vh)


class Adam:
    """torch.optim.Adam's update, written out (no amsgrad, no decay)."""

    def __init__(self, leaves: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0

    def step(self, leaves: dict, grads: dict, lr_of) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr_of(k) / c1)


def train_steps(params: dict, codes: torch.Tensor, ad: dict, batches: list,
                epoch: float, product: str = "fp32", block: int = 8,
                terms: bool = False, store=None) -> dict:
    """The reference's steps from (params, codes) over `batches` [(ids,
    xyz, sdf, dropout seed)]: each step's loss, the first step's
    gradients (with `terms`, their terms' magnitudes, see
    loss_and_grads), and the leaves after the last step."""
    leaves = {k: v.detach().clone().float() for k, v in params.items()}
    leaves["codes"] = codes.detach().clone().float()
    opt = Adam(leaves)
    lr_dec = step_lr(ad["lr_decoder"], epoch, ad["lr_decay_factor"],
                     ad["lr_decay_interval"])
    lr_lat = step_lr(ad["lr_latent"], epoch, ad["lr_decay_factor"],
                     ad["lr_decay_interval"])
    losses, first, mag = [], None, None
    for ids, xyz, sdf, seed in batches:
        dec_leaves = {k: v for k, v in leaves.items() if k != "codes"}
        loss, grads, m = loss_and_grads(dec_leaves, leaves["codes"], ad, ids,
                                        xyz, sdf, seed, epoch, product, block,
                                        terms=first is None and terms,
                                        store=store)
        losses.append(loss)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
            mag = m
        with torch.no_grad():
            opt.step(leaves, grads,
                     lambda k: lr_lat if k == "codes" else lr_dec)
    return {"losses": losses, "grad1": first, "terms1": mag,
            "leaves": leaves}
