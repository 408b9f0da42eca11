"""The yardstick: peaks, least times, and the operations and bytes of the
work each cell asks for, counted from the configuration's shapes.

`PEAK_BF16_FLOPS`, `PEAK_HBM_BYTES`, `bound` and `gemm_bound` are copies
of chip_smoke.py's (its lines 229-230, 285 and 467 at the commit that
introduced the benchmark). Every count here is the function's work, not
any implementation's: a kernel that redoes work or moves more bytes does
not raise its numerator.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth


def bound(n_points: int, macs: int, other_bytes: int) -> tuple:
    """Least time (ms) for n points: operations over the bf16 peak vs
    bytes (xyz in, sdf out, and `other_bytes` read once) over HBM
    bandwidth. Returns (ms, "operations" | "bytes")."""
    ops = 2.0 * macs * n_points / PEAK_BF16_FLOPS
    byt = (16.0 * n_points + other_bytes) / PEAK_HBM_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


def gemm_bound(m: int, n: int, k: int, read: int, write: int) -> tuple:
    """Least time (ms) of one product C[m, n] from K = k that reads `read`
    and writes `write` bytes."""
    ops = 2.0 * m * n * k / PEAK_BF16_FLOPS
    byt = (read + write) / PEAK_HBM_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


# ---------------------------------------------------------------- decoder

def decoder_layers(dec: dict) -> list:
    """[(in, out, takes_skip)] of the SDF decoder's linear layers (the
    DeepSDF plan: the layer before a `latent_in` layer shrinks its output
    by the input width, and the `latent_in` layer re-reads (z, xyz))."""
    d0 = dec["latent_size"] + 3
    dims = [d0] + [dec["hidden_dim"]] * dec["num_layers"] + [1]
    plan = []
    for i in range(len(dims) - 1):
        out = dims[i + 1] - (d0 if (i + 1) in dec["latent_in"] else 0)
        plan.append((dims[i], out, i in dec["latent_in"]))
    return plan


def decoder_macs_per_point(dec: dict) -> int:
    """Multiply-adds of one point's forward at the true widths (8x512,
    latent 256, skip at 4: 1,835,520)."""
    return sum(i * o for i, o, _ in decoder_layers(dec))


def decoder_point_macs(dec: dict) -> tuple:
    """(forward, hidden) multiply-adds a point with the latent products
    taken out (they are one row a scene): `forward` counts the xyz and
    hidden columns, `hidden` the hidden columns alone."""
    L = dec["latent_size"]
    fwd = hid = 0
    for i, (d_in, out, skip) in enumerate(decoder_layers(dec)):
        if i == 0:
            fwd += 3 * out
        elif skip:
            fwd += (d_in - L) * out
            hid += (d_in - L - 3) * out
        else:
            fwd += d_in * out
            hid += d_in * out
    return fwd, hid


def train_step_flops(dec: dict, scenes: int, points: int) -> int:
    """FLOPs of one stage-1 step (forward, the gradients of the weights
    and of every hidden input, and per scene the latent rows' three
    products), whatever route computes it: 9.892e12 for config 3's
    64 x 16,384 step."""
    fwd, hid = decoder_point_macs(dec)
    L = dec["latent_size"]
    rows = sum(L * out for i, (_, out, skip) in
               enumerate(decoder_layers(dec)) if i == 0 or skip)
    return 2 * (scenes * points * (2 * fwd + hid) + 3 * scenes * rows)


def eval_macs_per_point(dec: dict) -> int:
    """Multiply-adds a point of the eval kernel, the latent products
    hoisted into per-shape rows (8x512: 1,573,376)."""
    return decoder_point_macs(dec)[0]


def eval_weight_bytes(dec: dict) -> int:
    """bf16 weights the eval kernel reads once a launch."""
    L = dec["latent_size"]
    return 2 * sum((3 if i == 0 else d_in - L if skip else d_in) * out
                   for i, (d_in, out, skip) in
                   enumerate(decoder_layers(dec)))


def hier3_points(n1: int, n2: int, n3: int, res: int, b1: int = 16,
                 b2: int = 4, b3: int = 2) -> int:
    """Points the three-level sparse decode needs for a shape whose
    levels hold n1, n2, n3 active blocks: every b1-block center, the b2
    sub-centers of the n1 parents, the b3 sub-centers of the n2, and the
    b3^3 voxels of the n3."""
    return ((res // b1) ** 3 + n1 * (b1 // b2) ** 3 + n2 * (b2 // b3) ** 3
            + n3 * b3 ** 3)


def products_bound_ms(dec: dict, rows: int) -> float:
    """Least time (ms) of all the decoder's matrix products in one
    autograd step over `rows` points: for each layer the forward
    (x bf16, W bf16 in; y fp32 out), the input gradient (g bf16, W in;
    dx bf16 out; every layer, since the codes take lin0's) and the weight
    gradient (g, x in; dW out), each bounded by gemm_bound. The head
    (out 1) is fp32 products of bf16 values: 4-byte operands."""
    total = 0.0
    for d_in, out, _ in decoder_layers(dec):
        b = 4 if out == 1 else 2
        total += gemm_bound(rows, out, d_in, b * rows * d_in + b * out * d_in,
                            4 * rows * out)[0]
        total += gemm_bound(rows, d_in, out, b * rows * out + b * out * d_in,
                            b * rows * d_in)[0]
        total += gemm_bound(out, d_in, rows, b * rows * out + b * rows * d_in,
                            4 * out * d_in)[0]
    return total


def relu_dropout_bound_ms(dec: dict, rows: int) -> float:
    """Least time (ms) of kernels #3 and #3b over one step: every hidden
    layer's #3 reads its fp32 product (4 B) and writes bf16 (2 B) an
    element; #3b reads the bf16 output and cotangent and writes the bf16
    cotangent (6 B) and the fp32 column sums."""
    total = 0
    for d_in, out, _ in decoder_layers(dec)[:-1]:
        total += 6 * rows * out + 4 * out          # #3 (+ the bias)
        total += 6 * rows * out + 4 * out          # #3b (+ db)
    return total / PEAK_HBM_BYTES * 1e3


# --------------------------------------------------------------- denoiser

def denoiser_step_flops(den: dict, batch: int) -> int:
    """FLOPs of one stage-2 step of the conditioned MLP denoiser: the
    forward of every dense layer, its weight gradient, and its input
    gradient wherever the input carries a gradient (not for the layers
    that read z_t, the time features or the observations)."""
    H, T, L = den["hidden_dim"], den["time_embed_dim"], den["latent_size"]
    first = [T * H, L * H]                          # t1, in_proj
    rest = [H * H, H * L] + [2 * H * H] * den["num_blocks"]  # t2, out, blocks
    per_obs = 0
    if den["partial_sdf_cond"]:
        first.append(4 * 64 * den["partial_points"])          # pn0
        per_obs = (64 * 128 + 128 * 256) * den["partial_points"]  # pn1, pn2
        rest.append(256 * H)                                    # partial_proj
    macs = 2 * sum(first) + 3 * (sum(rest) + per_obs)
    return 2 * batch * macs
