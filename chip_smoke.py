"""Smoke run of the PyTorch port on one CUDA card: build, check, serve,
train (from the host feed and the on-device bank, on one and on two
ranks), decode on two ranks, generate, export, reconstruct, real meshes
in, renders and metrics out.

    python3 chip_smoke.py [--details PATH]

Builds the port's CUDA kernels (csrc/fused_eval.cu, csrc/relu_dropout.cu,
csrc/fused_train.cu, csrc/fused_eval_pairs.cu, csrc/head.cu: one nvcc
each for sm_90a, all started together) and the native mesher and
preprocess tool (native/, cmake or g++) from this checkout, while it
generates the training data
(64 analytic chairs, the 6,136 multicat scenes' observation banks, and
the analytic store that [cli]'s stages share, process pools started
before CUDA is), then:

  1. prints the card (nvidia-smi name and power limit) and turns TF32 off,
     and the form of ops.bf16_linear's products for the bf16 decoder's
     hidden layers on the tensor cores (torch.mm with out_dtype=float32
     and a bias add forward, bf16 dgrad and wgrad; with dropout through
     the kernels one function, bf16_linear_relu_dropout: the fp32
     product without its bias into #3, #3b's bf16 cotangent into dgrad
     and wgrad);
  2. [kernel] holds the decoder-eval kernel (#1) against its plain version
     (bf16 fast_apply) on the committed trained 8x512 decoder at the
     serving path's launch shapes and at 2^20+131 points, and on a small
     skip plan and a tanh plan; checks two launches are bit-identical;
     times both per 256^3 shape and per 2^20 points, beside kernel #2
     called with one code (S = 1) on the same points, and prints its
     launch configuration, the SM clock and power meanwhile, and its
     ptxas report;
  3. serves 8 trained chair latents at 256^3 through serve_meshes with the
     int8 payload and the payload-direct native mesher, counting kernel
     launches, and checks one mesh against the plain version's mesh;
     traces a repeat under torch.profiler;
  4. runs the watch-folder daemon on two latent requests;
  5. [dropout] holds the relu+dropout kernels (forward #3, backward #3b)
     bit for bit against their plain versions (and #3b against autograd
     of the plain forward); their layer entries (#3 from the fp32 product
     and bias, #3b from the output with db) at [2^20, 512], [2^20, 253]
     and 2^20+131 rows: out and gb bit for bit, db equal to
     db_kernel_order and within DB_TOL of the float64 sums, two launches
     bit-identical; times them at both widths beside their bytes bounds,
     the composed form's passes they replace, the standalone pair and
     the plain versions;
  6. [fused_train] holds the fused train kernel (#4) against its plain
     version at 64 scenes x 16,384 points on the trained decoder, dropout
     0 and 0.2, checks two passes are bit-identical, and times it; splits
     one traced pass into its forward, dgrad and wgrad GEMMs and side
     kernels, each beside its bound (the forward and dgrad launches must
     be the wgmma engine's tn_gemm_kernel, the 7 wgrad launches its
     MN-major mn_wgrad_kernel, and no column-sum kernel may run); times
     the engine's forward with keep bits (dropout 0.2 and 0), dgrad (from
     keep bits, with column partials) and wgrad roles alone at 2^20 x 512
     x 512 beside torch.matmul of the same bf16 product (a yardstick the
     port never calls), the forward's keep bits held bit for bit against
     those packed from its output, the dgrad and its partials and the
     wgrad against their plain versions;
 6b. [profile] utils/profiling on the committed 8x512 decoder: under
     debug_nans a fused pass (#4) with one NaN sdf label, #3 on a [2^20,
     512] fp32 product with one NaN row, #3b on a cotangent with one and
     #1 through KernelApply with a NaN code each raise FloatingPointError
     naming the kernel; the
     healthy pass and one autograd-route step (#3/#3b) bit-equal with the
     checker and without, and the pass's time with it beside without;
     cost_analysis of one #4 pass, one #1 launch and one #2 launch at
     2^20 points within 1% of their plain versions' aten counts, each
     count over the time measured above as TFLOP/s (#3/#3b: bytes, as
     GB/s); a trace of one fused pass and one 256^3 decode must name
     tn_gemm_kernel, mn_wgrad_kernel and fused_eval_kernel;
  7. [train] trains config 3's `ad` block (cut to 64 scenes, 20,000
     samples per shape, 4 epochs of one step) from the committed pack
     through both kernel routes (relu+dropout kernels; fused train
     kernel), and config 5's `ad` block (config 3's but data_parallel and
     num_scenes) on the same cut, data and start through the relu+dropout
     route, whose losses must equal config 3's bit for bit on one card;
     counts launches and the hidden layers' tensor-core products (8 per
     step of each role on the relu+dropout route, none on the fused one);
     holds one step of the relu+dropout route (hidden layers on the bf16
     tensor cores) against the same step with them in the plain form
     (fp32 products of the same bf16 values) and in float64 (the
     witness), the head each time in the same form as the hidden layers,
     each through the package's forward with its hidden layers and head
     swapped (hidden_layers_through), from the same state, batch
     and masks: loss TRAIN_LOSS_RTOL; with other chairs' codes every
     gradient TRAIN_GRAD_TOL of its max of the plain form's, with the
     chairs' own codes (the optimum) every gradient's distance from the
     witness at most WITNESS_RATIO times the plain form's; holds one step
     through the fused layer (bf16_linear_relu_dropout, #3/#3b's layer
     entries) against its composition
     (bf16_linear_relu_dropout_reference: the cast and the standalone
     #3/#3b): the loss and every gradient but
     the hidden biases bit for bit, each hidden db within DB_TOL of the
     float64 sums of #3b's gb; then writes the trained pack, reloads it and serves chair 0 at 256^3; traces
     one step of each of config 3's routes;
  8. [bank] trains stage 1 from the on-device sample bank
     (AdConfig.device_data) at the committed packs' scale: builds the
     chair bank (6,144 chairs x 16,384 samples, 3.0 GiB) on the card with
     bank_from_chairs and checks its contract (signs, counts, labels),
     runs one epoch (96 steps) of the fused route (#4) from the chair
     pack, timed on the card's clock, steps 2-4 under
     torch.cuda.set_sync_debug_mode("error"), and a second epoch traced
     for the device-busy share; 10 steps of the autograd route (#3/#3b,
     the hidden layers on the tensor cores, fused with relu+dropout, the
     fp32 head through csrc/head.cu: one launch of each of its passes a
     step) from the same bank, then 3 steps of the composed form timed
     beside them (the fused route must be faster) and one step of each
     for its peak memory, then 3 steps with the hidden layers in the plain
     form, timed beside them, and one step of each form held against the
     other (the plain form's and the witness's heads in their own forms),
     one step against the composed form as in [train], and one step whose
     head's pred, dx, dW and db (csrc/head.cu) are held against the head's
     plain form on the same operands and cotangent at [2^20, 512] (dx bit
     for bit; head_vs_plain_step); the head's passes timed alone at that
     shape beside the plain form and their bytes bounds; the CSG bank of
     the 6,136 multicat shapes
     (bank_from_csg) and one fused step from the multicat pack (step-0
     loss_l1 gates: 0.01 chair, 0.015 CSG);
  9. [dp] the data-parallel stage-1 steps (parallel/dp.py) on config 3's
     ad block cut to 64 scenes: on both routes, from the host feed and
     from the bank, 3 steps of two ranks sharing the card over gloo
     (spawned processes) against the single-device steps from the same
     state and draws (step 0's loss terms to 1e-6 relative, its summed
     gradients to 1e-2 of their max, the losses of 3 steps to 1e-4;
     the states after 3 steps reported),
     the ranks equal bit for bit, a 1-rank NCCL group's steps equal to
     the single-device steps bit for bit, and with dropout 0.2 the
     launches of #4 and #3/#3b per rank;
     then the decode half of parallel/dp.py in the same ranks (and the
     1-rank NCCL group) against its single-device counterparts, bit for
     bit: serve_meshes_sharded of 8 trained chairs at 256^3,
     make_dp_sparse_decode_fn's payloads, decode_points_sharded at
     2^20+131 points, decode_grid_sharded at 128^3, make_dp_pairs_fn
     under the flat decode of 8 multicat shapes at 128^3 (kernels #1
     and #2); dp_ddim_sample of 64 config-4 latents within 1e-5 of
     max|z| of ddim_sample;
 10. [pairs] holds the per-point-latent eval kernel (#2) against its plain
     version (bf16 fast_apply over codes[sids]) on the committed multicat
     decoder with rows of 64 codes read by shuffled shape ids at 2^19 and
     2^19+131 points and of one code, through the (z_rows, xyz) call, on a
     small and a tanh plan, and with all rows equal against kernel #1;
     checks two launches are bit-identical; times it and prints its launch
     configuration (cluster, ring stages, shared memory), the card's SM
     clock and power meanwhile, and its ptxas report;
 11. [flat] decodes config 4's batch of 64 heterogeneous multicat shapes
     (13 classes) at 256^3 through the flat batched decode (kernel #2, rows
     read by index): probed caps, one checked and three timed steps, one
     traced step (kernel #2 launches per step, no aten::index_select);
     holds it against the plain version's flat decode and, as meshes of 4
     shapes of 4 classes, against serve_meshes with kernel #1; times the
     same 64 codes through the per-shape decode, and 8 of them through
     the batched three-level decode (kernel #1, shape by shape), each
     shape bit-equal to its single-shape decode;
 12. [train_diff] trains config 4's stage 2 (CondDenoiser 1024x6, 13
     classes, 512 observation points, batch 128) on the 6,136 committed
     multicat codes with the conditioning banks `pipeline._cond_banks`
     builds (made while the kernels build): one chunk eager and the same
     chunk replayed from its CUDA graph must be equal bit for bit, then
     10,000 steps in graphed chunks of 100; prints steps/s eager and
     graphed, one traced graphed chunk, the first and last chunk's loss;
 13. [generate] samples 64 conditioned latents from the trained EMA weights
     (CFG 2.0, DDIM-50 and DPM-10; same seed, same latents), decodes them
     through the flat decode (at least one must have a surface) and two
     through generate_meshes;
 13b. [export] the serving artifacts through the CLI verbs on config 4's
     specs: export-decoder at config 5's 512^3 with the default caps,
     reloaded from its bytes; [generate]'s 64 latents through it, each
     payload bit-equal to the live decode (kernel #1's launches per call
     counted by its op), 8 meshes bit-equal to serve_meshes's, cut caps
     raising CapacityExceeded; config 5's sample decode (serve_meshes of
     the 64 latents at 512^3: ms a mesh, faces, escalations, caps, peak
     card memory; every grid with both signs meshes non-empty);
     export-sampler of [train_diff]'s EMA, DDIM-50 and DPM-10, each equal
     to the eager sampler from the same z_T bit for bit, with the export
     and load seconds, bytes and ms beside the eager sampler's;
 14. [unet] trains config 2-unet's stage 2 (the 1-D conv UNet, batch 256)
     on the 6,144 committed chair codes: one chunk eager == graphed bit for
     bit (two chunks), ms a step of each, one traced graphed chunk, 10,000
     steps (last loss < 0.5), then DDIM-50 on 16 latents from the EMA
     decoded at 128^3 through serve_meshes and kernel #1 (>= 1 with a
     surface);
 15. [recon] reconstructs chairs 0-3 and the held-out chair 6144 from
     8,000 observations on the committed decoder at cfg.reconstruct's
     defaults: MAP, 4 restarts, the SDS prior of [unet]'s EMA, and the
     encoder (trained here at full width on a bank from the device chair
     sampler, cut to 3,000 steps) one-shot and refined by 100 steps; a
     graphed run == the eager run bit for bit (MAP, restarts, SDS) and a
     graphed encoder chunk == the eager chunk; each mesh dense at 256^3
     through kernel #1 with its Chamfer-L2 (gates: MAP l1_last < 0.005,
     SDS < 0.01, encoder loss < 0.6, every mesh non-empty);
 16. [cli] runs the CLI in process on config 4's specs, cut in scale:
     init-experiment, train-ad (150 epochs) and train-diff with
     --tensorboard (each event file read back: every TFRecord CRC, one
     record per mirrored scalar of the JSONL log), train-diff
     --resume, sample at 256^3, eval, train-encoder (500 steps), reconstruct
     (MAP, --diffusion-prior, --encoder --refine-steps 0, --encoder) and
     serve-daemon --reconstruct encoder on one observation request, timing
     each stage and counting the launches of kernels #3/#3b (and the
     hidden layers' tensor-core products) in train-ad and
     #1 in the stages that decode; the stages share one analytic store,
     built with the data before CUDA (each stage would rebuild it, ~20-30
     s each on a spawn pool);
 17. [realdata] meshes 64 chairs of config 3's split (their analytic SDF
     on a 256^3 grid on the card, the native mesher, harmonize_winding in
     spawned workers; half binary PLY, half OBJ), runs `cli preprocess`
     at 100,000 samples a mesh (sample signs vs the analytic SDF), then
     `train-ad` from `sdf:<dir>` on config 3's `ad` block (50 epochs of
     one step; #3/#3b) and `eval` at 128^3 against the stores' surfaces;
     on the committed 8x512 pack: renders chairs 0, 7, 21 at 448^2
     through kernel #1 against the plain version's renders and the
     committed TPU previews, `cli render` (4 frames at 512^2), `cli
     interpolate` (lerp, slerp, 256^3), `cli decode --normals` (PLY, OBJ),
     and the generative metrics on the card against the host KD-tree
     Chamfer and the exact EMD;
 18. prints one JSON line per ported kernel and, last, the device line.

Any failure raises and exits non-zero; without a card (or outside a
checkout of the repository) it exits non-zero before printing a result.
`--details PATH` also writes every measured number as JSON to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth
TOL = 5e-3                   # tests/test_pallas_kernels.py:34
TRAIN_LOSS_RTOL = 1e-4       # fused train kernel vs plain: loss
TRAIN_GRAD_TOL = 1e-2        # ... every gradient, relative to its max
WITNESS_RATIO = 10.0         # tensor-core step's distance from float64 over
WITNESS_FLOOR = 1e-3         # ... the plain form's (floored), per gradient
DB_TOL = 2.0 ** -17          # #3b's db vs float64, of its column's sum |terms|
RATE = 0.2                   # config 3's dropout
PACK = ("runs", "scale_chairs6k", "stage1_pack.npz")
SRC = "latent_diffusion_models_for_shape_sdfs_torch/csrc/"


def log(*a):
    print(*a, flush=True)


def build_mesher() -> None:
    """native/build/libmarching_cubes_c.so (the mesher) and
    native/build/preprocess_mesh (the mesh -> SDF samples tool of `cli
    preprocess`): cmake if present, else g++."""
    build = ROOT / "native" / "build"
    outs = [build / "libmarching_cubes_c.so", build / "preprocess_mesh"]
    if all(o.exists() for o in outs):
        return
    if shutil.which("cmake"):
        subprocess.run(["cmake", "-S", str(ROOT / "native"), "-B",
                        str(build)], check=True, capture_output=True)
        subprocess.run(["cmake", "--build", str(build), "--target",
                        "marching_cubes_c", "preprocess_mesh", "-j", "8"],
                       check=True, capture_output=True)
    else:
        build.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-pthread",
                        str(ROOT / "native" / "marching_cubes" / "clib.cpp"),
                        "-o", str(outs[0])], check=True, capture_output=True)
        subprocess.run(["g++", "-O3", "-std=c++17", "-pthread",
                        str(ROOT / "native" / "preprocess" / "main.cpp"),
                        "-o", str(outs[1])], check=True, capture_output=True)
    for o in outs:
        if not o.exists():
            raise RuntimeError(f"native build produced no {o}")


def kernel_macs_per_point(decoder) -> int:
    """Multiply-adds per point the kernel must do (the latent products are
    hoisted out of it): xyz columns of layer 0, hidden and xyz columns of
    the skip layers, every other layer in full."""
    L = decoder.cfg.latent_size
    macs = 0
    for i, (d_in, out, skip) in enumerate(decoder.layer_dims()):
        macs += (3 if i == 0 else d_in - L if skip else d_in) * out
    return macs


def bound(n_points: int, macs: int, other_bytes: int) -> tuple:
    """Least time (ms) for n points on this card: operations over the bf16
    peak vs bytes (xyz in, sdf out, and `other_bytes` read once: the
    weights, and for kernel #2 its latent rows) over HBM bandwidth."""
    ops = 2.0 * macs * n_points / PEAK_BF16_FLOPS
    byt = (16.0 * n_points + other_bytes) / PEAK_HBM_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class SmiSampler:
    """Samples the card's SM clock (MHz) and power draw (W) with
    nvidia-smi in a background thread while a `with` block runs."""

    def __init__(self):
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip().splitlines()
            try:
                clk, pw = (float(v) for v in out[0].split(","))
                self.samples.append((clk, pw))
            except (IndexError, ValueError):
                pass

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        if not self.samples:
            return dict(n=0)
        clk, pw = zip(*self.samples)
        return dict(n=len(clk), sm_mhz_min=min(clk), sm_mhz_max=max(clk),
                    sm_mhz_median=sorted(clk)[len(clk) // 2],
                    power_w_max=max(pw))

    def text(self) -> str:
        s = self.summary()
        if not s["n"]:
            return "nvidia-smi gave no samples"
        return (f"SM clock {s['sm_mhz_min']:.0f}-{s['sm_mhz_max']:.0f} MHz "
                f"(median {s['sm_mhz_median']:.0f}), power up to "
                f"{s['power_w_max']:.0f} W over {s['n']} nvidia-smi samples")


def device_profile(fn, cpu_ops: dict | None = None,
                   warmup=None) -> tuple:
    """Runs fn() once under torch.profiler; returns (wall s, device busy
    ms as the union of device spans, [(name, ms, count)] by device time).
    `cpu_ops`, if given, receives the count of each host-side op name.
    `warmup`, if given, runs first in the same trace, then the card idles
    for 50 ms, and only events that start after the middle of that gap
    count: the profiler can drop the first launches of a trace (one pass
    of kernel #4 lost its first ~28, 2.5 ms of device time), so a gate on
    exact launch counts takes a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warmup is not None:
            with record_function("device_profile.warmup"):
                warmup()
                torch.cuda.synchronize()
            time.sleep(0.05)
        with record_function("device_profile.measured"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    start = float("-inf")
    if warmup is not None:
        mark = {e.name: e.time_range for e in events
                if e.name.startswith("device_profile.")}
        start = (mark["device_profile.warmup"].end
                 + mark["device_profile.measured"].start) / 2
    spans, by_name = [], {}
    for e in events:
        if e.time_range.start < start or e.name.startswith(
                "device_profile."):
            continue
        if cpu_ops is not None and e.device_type == DeviceType.CPU:
            cpu_ops[e.name] = cpu_ops.get(e.name, 0) + 1
        if e.device_type == DeviceType.CUDA:         # kernels and copies
            spans.append((e.time_range.start, e.time_range.end))
            ms, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy_us, reach = 0.0, float("-inf")          # union of device spans
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    top = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                 key=lambda r: -r[1])
    return wall, busy_us / 1e3, top


def log_profile(tag: str, what: str, wall: float, busy: float, top: list,
                card: str) -> None:
    if busy > 0:
        log(f"[{tag}] {what}: wall {wall * 1e3:.1f} ms, device busy "
            f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall) "
            f"[{card}]")
        for name, ms, cnt in top[:6]:
            log(f"[{tag}]   {ms:9.3f} ms  x{cnt:<5d} {name[:80]}")
    else:
        log(f"[{tag}] {what}: torch.profiler recorded no device time: "
            "not measured")


def train_split():
    """Chairs 0-63 of the split the committed pack was trained on
    (tools/scale_run.py: make_synthetic_split("chair", 6145, seed=11))."""
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    return analytic.make_synthetic_split("chair", 6145, seed=11)[:64]


MULTICAT = ("runs", "multicat6k", "stage1_pack.npz")
RES = 256
FLAT_KW = dict(safety=1.2, safety3=2.0)    # config 4's decode margins


def pairs_macs_per_point(decoder) -> int:
    """Kernel #2's multiply-adds per point: kernel #1's, plus the latent
    products of layer 0 and of every skip layer, which it runs per point."""
    L = decoder.cfg.latent_size
    return kernel_macs_per_point(decoder) + sum(
        L * out for i, (_, out, skip) in enumerate(decoder.layer_dims())
        if i == 0 or skip)


def pairs_bytes(pairs, n_points: int, n_codes: int) -> int:
    """Bytes kernel #2 must move besides xyz and sdf (bound() counts
    those), each read once: a 4-byte shape id per point, the codes table
    [n_codes, lt] bf16, and the weights and biases."""
    return (4 * n_points + 2 * pairs.lt * n_codes + pairs.w.nbytes
            + pairs.rows.nbytes)


def ptxas_report(source: str) -> dict:
    """Registers, stack and spill bytes of the kernel in csrc/<source>,
    from the compiler's report kept beside the built library."""
    import re
    from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
    text = _build.build(source).with_suffix(".log").read_text()
    out = {}
    for key, pat in [("registers", r"Used (\d+) registers"),
                     ("stack_bytes", r"(\d+) bytes stack frame"),
                     ("spill_stores", r"(\d+) bytes spill stores"),
                     ("spill_loads", r"(\d+) bytes spill loads")]:
        m = re.search(pat, text)
        out[key] = int(m.group(1)) if m else None
    out["warnings"] = [ln.strip() for ln in text.splitlines()
                       if "Performance Loss" in ln or "ignored" in ln]
    return out


def gemm_bound(m: int, n: int, k: int, read: int, write: int) -> tuple:
    """Least time (ms) of one GEMM launch C[m, n] from K = k that reads
    `read` and writes `write` bytes: the larger of its products at the
    bf16 peak and its bytes at HBM bandwidth."""
    ops = 2.0 * m * n * k / PEAK_BF16_FLOPS
    byt = (read + write) / PEAK_HBM_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


def train_role(name: str) -> str:
    """Kernel #4's launch roles by kernel name: the wgmma engine's forward
    (epilogue 0) and dgrad (epilogue 1) instantiations, its MN-major wgrad
    kernel, and every other launch of the pass."""
    import re
    if "tn_gemm_kernel" in name:
        return "forward" if re.search(r", 0>|ELi0E", name) else "dgrad"
    if "mn_wgrad_kernel" in name:
        return "wgrad"
    return "side"


def fwd_bytes(n_pts: int, k: int, n: int, keep: bool) -> tuple:
    """(read, written) bytes of a forward launch h [n_pts, k] -> h' [n_pts,
    n]: h in, h' and (keep) its keep bits out, a bit an element."""
    return 2 * n_pts * k, 2 * n_pts * n + (n_pts * n // 8 if keep else 0)


def dgrad_bytes(n_pts: int, k: int, n: int, xyz: bool) -> tuple:
    """(read, written) bytes of a dgrad launch g [n_pts, n] -> g' [n_pts,
    k]: g and the keep bits of h_prev [n_pts, k] (and bf16 xyz) in; g' and
    its column partials (f32, a row per 128 points, 4 rows with xyz)
    out."""
    nsum = 4 if xyz else 1
    return (2 * n_pts * n + n_pts * k // 8 + (6 * n_pts if xyz else 0),
            2 * n_pts * k + 4 * (n_pts // 128) * nsum * k)


def train_roles(ft, ft_args, card) -> dict:
    """[fused_train] one traced pass split by role: device ms and launches
    of each, beside the sum of its launches' bounds (each launch's bytes:
    its operands read once, its outputs written once). Fails if the pass
    launched a column-sum kernel (the dgrad and the final layer emit the
    column sums)."""
    ew, _, xyz = ft_args[:3]
    n_pts = xyz.shape[0] * xyz.shape[1]
    widths = [-(-lay.b.shape[0] // 128) * 128 for lay in ew.layers[:-1]]
    bounds = {"forward": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    k_split = ft.wgrad_chunk(n_pts)        # the chunk the pass gives wgrad
    for i in range(1, len(widths)):
        k, n = widths[i - 1], widths[i]
        bounds["forward"] += gemm_bound(
            n_pts, n, k, *fwd_bytes(n_pts, k, n, i < len(widths) - 1))[0]
        bounds["dgrad"] += gemm_bound(
            n_pts, k, n, *dgrad_bytes(n_pts, k, n,
                                      ew.layers[i - 1].w_x is not None))[0]
        bounds["wgrad"] += gemm_bound(n, k, n_pts, 2 * n_pts * (n + k),
                                      4 * (n_pts // k_split) * n * k)[0]
    wall, busy, top = device_profile(
        lambda: ft.fused_train_loss_grads(*ft_args),
        warmup=lambda: ft.fused_train_loss_grads(*ft_args))
    log_profile("fused_train", "one traced pass", wall, busy, top, card)
    roles = {r: dict(ms=0.0, launches=0) for r in
             ("forward", "dgrad", "wgrad", "side")}
    for name, ms, cnt in top:
        r = roles[train_role(name)]
        r["ms"] += ms
        r["launches"] += cnt
    for r, v in roles.items():
        v["bound_ms"] = bounds.get(r)
        log(f"[fused_train]   {r:8s} {v['ms']:8.3f} ms in {v['launches']:4d} "
            f"launches" + (f", bound {v['bound_ms']:.3f} ms (sum of the "
                           "launches' bounds)" if r in bounds else ""))
    if any(roles[r]["launches"] != len(widths) - 1
           for r in ("forward", "dgrad", "wgrad")):
        raise RuntimeError(f"kernel #4's forward/dgrad/wgrad launches are "
                           f"not the wgmma engine's {len(widths) - 1} each: "
                           f"{[(n, c) for n, _, c in top]}")
    colsum = [(n, c) for n, _, c in top if "colsum" in n.lower()]
    log(f"[fused_train]   column-sum kernel launches in the pass: "
        f"{sum(c for _, c in colsum)} (expected 0: the dgrad and final "
        f"kernels emit the column partials)")
    if colsum:
        raise RuntimeError(f"kernel #4's pass still launches a column-sum "
                           f"kernel: {colsum}")
    return dict(roles, busy_ms=busy, wall_s=wall, top=top[:16])


def train_gemms(ft, dev, card) -> dict:
    """[fused_train] the engine's forward role with keep bits (dropout 0.2
    and 0), dgrad (masked by keep bits, with column partials) and wgrad
    roles alone at 2^20 x 512 x 512, against the plain version and
    torch.matmul of the same bf16 product. Gates: the forward's keep bits
    are those of its own output, bit for bit; the dgrad's output within
    1e-2 of its plain version's max, its column partials within 1e-3 of
    the max of those summed from its own output; the wgrad role's
    partials within 1e-3 of their max; two launches bit-identical."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        train_gemm as tg)
    m, k, n = 1 << 20, 512, 512
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    h = torch.relu(torch.randn(m, k, generator=gen, device=dev)).to(bf)
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5).to(bf)
    rows = torch.randn(1, n, generator=gen, device=dev)
    g = (torch.randn(m, n, generator=gen, device=dev) * 1e-3).to(bf)
    wt = w.t().contiguous()
    k_split = ft.wgrad_chunk(m)
    out = {}
    fwd_b = gemm_bound(m, n, k, *fwd_bytes(m, k, n, True))
    dgrad_b = gemm_bound(m, k, n, *dgrad_bytes(m, k, n, False))
    wgrad_b = gemm_bound(n, k, m, 2 * m * (n + k),
                         4 * (m // k_split) * n * k)
    h2, bits = ft.gemm_fwd(h, w, rows, m, seed=9, rate=RATE, keep_bits=True)
    h3, bits3 = ft.gemm_fwd(h, w, rows, m, seed=9, rate=RATE, keep_bits=True)
    bits_ok = (torch.equal(bits, tg.pack_keep_bits(h2 > 0))
               and torch.equal(h2, h3) and torch.equal(bits, bits3))
    log(f"[fused_train] engine forward at 2^20 x 512 x 512, dropout {RATE}: "
        f"keep bits == pack_keep_bits(output > 0) bit for bit, two launches "
        f"bit-identical: {bits_ok} ({float((h2 > 0).float().mean()):.3f} of "
        f"the bits set)")
    if not bits_ok:
        raise RuntimeError("the forward role's keep bits are not those of "
                           "its output, or not deterministic")
    del h3, bits3
    got, part = ft.gemm_dgrad(g, wt, bits, 1.25)
    again, part2 = ft.gemm_dgrad(g, wt, bits, 1.25)
    want = ft.gemm_dgrad_reference(g, wt, bits, 1.25).float()
    dgrad_err = float((got.float() - want).abs().max())
    dgrad_max = float(want.abs().max())
    del want
    want = ft.column_partials_reference(got)
    part_err = float((part - want).abs().max())
    part_max = float(want.abs().max())
    same = torch.equal(got, again) and torch.equal(part, part2)
    log(f"[fused_train] engine dgrad at 2^20 x 512 x 512 from keep bits: "
        f"max |kernel - plain| {dgrad_err:.3e} of max {dgrad_max:.3e} (tol "
        f"1e-2 of max); column partials {part_err:.3e} of max "
        f"{part_max:.3e} (tol 1e-3 of max); two launches bit-identical: "
        f"{same}")
    if (dgrad_err > 1e-2 * dgrad_max or part_err > 1e-3 * part_max
            or not same):
        raise RuntimeError(f"the dgrad role disagrees with its plain "
                           f"version ({dgrad_err} of {dgrad_max}; partials "
                           f"{part_err} of {part_max}) or is not "
                           f"deterministic ({same})")
    del got, again, part, part2, want, h2

    def fwd_plain(**kw):
        o = ft.gemm_fwd_reference(h, w, rows, m, **kw)
        return o, tg.pack_keep_bits(o > 0)

    def dgrad_plain():
        o = ft.gemm_dgrad_reference(g, wt, bits, 1.25)
        return o, ft.column_partials_reference(o)

    got = ft.gemm_wgrad(g, h, k_split)
    want = ft.gemm_wgrad_reference(g, h, k_split)
    wgrad_err = float((got - want).abs().max())
    wgrad_max = float(want.abs().max())
    same = torch.equal(got, ft.gemm_wgrad(g, h, k_split))
    log(f"[fused_train] engine wgrad at 2^20 x 512 x 512, {m // k_split} "
        f"chunks of {k_split} points: max |kernel - plain| {wgrad_err:.3e} "
        f"of max {wgrad_max:.3e} (tol 1e-3 of max); two launches "
        f"bit-identical: {same}")
    if wgrad_err > 1e-3 * wgrad_max or not same:
        raise RuntimeError("the wgrad role disagrees with its plain version "
                           f"({wgrad_err} of {wgrad_max}) or is not "
                           f"deterministic ({same})")
    del got, want
    for name, fn, plain, (bnd, by) in [
            ("forward, dropout 0.2",
             lambda: ft.gemm_fwd(h, w, rows, m, seed=9, rate=RATE,
                                 keep_bits=True),
             lambda: fwd_plain(seed=9, rate=RATE), fwd_b),
            ("forward, dropout 0",
             lambda: ft.gemm_fwd(h, w, rows, m, keep_bits=True),
             fwd_plain, fwd_b),
            ("dgrad", lambda: ft.gemm_dgrad(g, wt, bits, 1.25),
             dgrad_plain, dgrad_b),
            ("wgrad", lambda: ft.gemm_wgrad(g, h, k_split),
             lambda: ft.gemm_wgrad_reference(g, h, k_split), wgrad_b)]:
        ms = time_ms(fn, 20)
        out[name] = dict(ms=ms, plain_ms=time_ms(plain, 2), bound_ms=bnd,
                         bound_by=by)
    out["wgrad"].update(max_abs_err=wgrad_err, max_abs=wgrad_max,
                        k_split=k_split)
    out["dgrad"].update(max_abs_err=dgrad_err, max_abs=dgrad_max,
                        partials_err=part_err, partials_max=part_max)
    out["forward, dropout 0.2"].update(keep_bits_equal=bits_ok)
    lib = {"forward": time_ms(lambda: torch.matmul(h, w.t()), 20),
           "dgrad": time_ms(lambda: torch.matmul(g, wt.t()), 20),
           "wgrad": time_ms(lambda: torch.matmul(g.t(), h), 20)}
    for name, v in out.items():
        v["library_ms"] = lib[name.split(",")[0]]
        log(f"[fused_train] engine {name} at 2^20 x 512 x 512: {v['ms']:.3f} "
            f"ms ({100 * v['bound_ms'] / v['ms']:.1f}% of its bound "
            f"{v['bound_ms']:.3f} ms, {v['bound_by']}), plain "
            f"{v['plain_ms']:.3f} ms, torch.matmul of the bf16 product "
            f"{v['library_ms']:.3f} ms [{card}]")
    return out


def pairs_phase(dev, card, sd_m, codes_m) -> dict:
    """[pairs] kernel #2 against its plain version (bf16 fast_apply over
    codes[sids]) at the flat decode's launch shape and a ragged N on the
    trained multicat decoder with rows of 64 codes read by shuffled shape
    ids, with one code, through the (z_rows, xyz) call, on the small and
    tanh plans, and with all rows equal against kernel #1; two launches
    bit for bit; then its times."""
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        PAIRS_LAYOUT, make_kernel_apply, make_kernel_apply_pairs)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        fast_apply)

    decoder = SdfDecoder(DecoderConfig())
    pairs = make_kernel_apply_pairs(decoder, sd_m)
    zs = torch.from_numpy(codes_m[:64]).to(dev)
    rng = np.random.default_rng(3)
    n19 = 1 << 19

    def ids_xyz(n, n_codes):
        sids = torch.from_numpy(rng.permutation(np.arange(n) % n_codes)
                                .astype(np.int32)).to(dev)
        xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
            np.float32)).to(dev)
        return sids, xyz

    torch.manual_seed(0)
    name8 = "trained multicat 8x512"
    plans = [(f"{name8}, 64 codes by index", pairs, zs, n19),
             (f"{name8}, 64 codes by index", pairs, zs, n19 + 131),
             (f"{name8}, 1 code by index", pairs, zs[7:8], 4096 + 77)]
    for name, kw in [("small (L 16, 3x128, skip 2)",
                      dict(latent_size=16, hidden_dim=128, num_layers=3,
                           latent_in=(2,), use_dropout=False)),
                     ("tanh (L 8, 2x32, no skip)",
                      dict(latent_size=8, hidden_dim=32, num_layers=2,
                           latent_in=(), use_tanh=True, use_dropout=False))]:
        small = SdfDecoder(DecoderConfig(**kw))
        L = small.cfg.latent_size
        plans.append((f"{name}, 64 codes by index",
                      make_kernel_apply_pairs(small, small.state_dict()),
                      torch.randn(64, L, device=dev) / np.sqrt(L), 4096 + 77))
    max_err = 0.0

    def check(name, n, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("kernel #2 produced non-finite values")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"[pairs] {name}, n={n}: max|kernel-plain| {err:.3e} (tol {TOL})")
        if err > TOL:
            raise RuntimeError(f"kernel #2 disagrees with plain version: {err}")

    for name, fn, zsrc, n in plans:
        sids, xyz = ids_xyz(n, len(zsrc))
        check(name, n, fn.indexed(zsrc, sids, xyz),
              fast_apply(fn.ew, zsrc[sids.long()], xyz))
    sids, xyz = ids_xyz(4096 + 77, 64)
    z_rows = zs[sids.long()]
    check(f"{name8}, (z_rows, xyz) call", len(xyz), pairs(z_rows, xyz),
          fast_apply(pairs.ew, z_rows, xyz))
    z0 = zs[5]
    xyz = torch.rand(1 << 16, 3, device=dev) * 2 - 1
    err1 = float((pairs.indexed(z0[None], torch.zeros(
        len(xyz), dtype=torch.int32, device=dev), xyz)
        - make_kernel_apply(decoder, sd_m)(z0, xyz)).abs().max())
    log(f"[pairs] all rows one latent vs kernel #1, n=2^16: max diff "
        f"{err1:.3e} (tol 1e-2)")
    if err1 > 1e-2:
        raise RuntimeError(f"kernel #2 with equal rows vs kernel #1: {err1}")

    # timing at the flat decode's launch shape: 2^19 points, ids over 64
    table = pairs.table(zs)
    sids, xyz = ids_xyz(n19, 64)
    first = pairs.launch(table, sids, xyz)
    same = torch.equal(first, pairs.launch(table, sids, xyz))
    log(f"[pairs] two launches at 2^19 points bit-identical: {same}")
    if not same:
        raise RuntimeError("kernel #2 is not deterministic")
    with SmiSampler() as smi:
        ms = time_ms(lambda: pairs.launch(table, sids, xyz), 100)
    plain_ms = time_ms(lambda: fast_apply(pairs.ew, zs[sids.long()], xyz), 3)
    macs = pairs_macs_per_point(decoder)
    bound_ms, bound_by = bound(n19, macs, pairs_bytes(pairs, n19, len(zs)))
    tflops = 2.0 * macs * n19 / (ms * 1e-3) / 1e12
    cfg = pairs.config()
    ptx = ptxas_report("fused_eval_pairs.cu")
    log(f"[pairs] 2^19 points (one flat-decode launch), rows of 64 codes by "
        f"index: kernel {ms:.3f} ms ({2 * ms:.3f} ms per 2^20, {tflops:.1f} "
        f"TFLOP/s, {100 * bound_ms / ms:.1f}% of its bound), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; {macs} "
        f"MAC/point) [{card}]")
    log(f"[pairs] during the 100 timed launches: {smi.text()}")
    log(f"[pairs] launch: cluster {cfg['cluster']} CTAs, {cfg['stages']} "
        f"ring stages of {PAIRS_LAYOUT['stage_slabs']} x 16 KB slabs, "
        f"{cfg['smem']} B shared memory, {cfg['max_clusters']} clusters "
        f"resident; ptxas: {ptx['registers']} registers a thread at launch "
        f"(before setmaxnreg), {ptx['stack_bytes']} B stack, spills "
        f"{ptx['spill_stores']}/{ptx['spill_loads']} B; warnings "
        f"{ptx['warnings'] or 'none'}")
    return dict(pairs=pairs, max_abs_err=max_err, equal_rows_vs_k1=err1,
                ms=ms, ms_2p20=2 * ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, tflops=tflops, bound_share=bound_ms / ms,
                macs_per_point=macs, config=cfg, ptxas=ptx,
                bit_identical=same,
                smi=smi.summary())


def flat_caps(pairs_fn, zs) -> tuple:
    """probe_flat_caps at config 4's margins, chunk 16; caps of at least
    512 (a level no shape reaches would probe to 0)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        probe_flat_caps)
    return tuple(max(512, c) for c in probe_flat_caps(
        pairs_fn, zs, RES, chunk=16, **FLAT_KW))


def flat_phase(dev, card, pairs, sd_m, codes_m) -> dict:
    """[flat] config 4's batched decode of 64 heterogeneous multicat
    shapes at 256^3 through kernel #2, held against the plain version's
    flat decode and (4 shapes, as meshes) against serve_meshes with kernel
    #1; the same codes through the per-shape decode for comparison."""
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        chamfer_l2)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        fast_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_hierarchical3_batch, decode_grid_hierarchical3_batch_flat,
        decode_grid_hierarchical3_device, decode_grid_hierarchical3_sparse2,
        unblock_grid)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
        extract_mesh)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import serve_meshes

    # the first five shapes of each of the 13 classes, cut to 64: shapes
    # 0-63 of the split the pack was trained on (class = index mod 13)
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    split = analytic.make_synthetic_split("classes13", 6136, seed=5)[:64]
    class_ids = [s["class_id"] for s in split]
    if class_ids != [i % 13 for i in range(64)]:
        raise RuntimeError(f"unexpected class ids {class_ids}")
    zs = torch.from_numpy(codes_m[:64]).to(dev).to(torch.bfloat16)
    S = len(zs)
    decoder = SdfDecoder(DecoderConfig())

    def flat(fn, caps, check, out_dtype="bfloat16"):
        return decode_grid_hierarchical3_batch_flat(
            fn, zs, RES, 16, 4, 2, *caps, out_dtype=out_dtype,
            check_overflow=check, **FLAT_KW)

    t0 = time.perf_counter()
    caps = flat_caps(pairs, zs)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    pairs.launches = 0                        # the main path starts here
    grids, st = flat(pairs, caps, True)
    if st["capacity_exceeded"]:
        raise RuntimeError(f"flat decode exceeded its probed caps: {st}")
    times = []
    with SmiSampler() as smi:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, _ = flat(pairs, caps, False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del g
    launches = pairs.launches                 # ... and ends here
    per_step = launches / 4
    ms = float(np.median(times))
    vox = S * RES ** 3 / (ms * 1e-3)
    acts = [st["active_l1"], st["active_l2"], st["active_l3"]]
    log(f"[flat] 64 multicat shapes (13 classes) at {RES}^3, bf16 codes and "
        f"grids, margins {FLAT_KW}: caps {caps} (probed in {probe_s:.2f} s, "
        f"chunk 16), actives {acts}, per-shape L1 actives "
        f"{int(st['per_shape_l1'].min())}-{int(st['per_shape_l1'].max())}")
    log(f"[flat] step times {[round(t, 1) for t in times]} ms: {ms:.1f} ms "
        f"per 64-shape step, {ms / S:.2f} ms per shape, {vox:.3e} effective "
        f"voxels/s; kernel #2 launches {launches} (1 checked + 3 timed "
        f"steps: {per_step:g} per step) [{card}]")
    log(f"[flat] during the 3 timed steps: {smi.text()}")
    ops: dict = {}
    wall, busy, top = device_profile(lambda: flat(pairs, caps, False), ops)
    log_profile("flat", "one traced 64-shape step", wall, busy, top, card)
    k2_ms = sum(ms_ for name, ms_, _ in top if "fused_eval_pairs" in name)
    k2_n = sum(c for name, _, c in top if "fused_eval_pairs" in name)
    gathers = ops.get("aten::index_select", 0)
    sel = [(n, round(m, 3), c) for n, m, c in top if "indexSelect" in n]
    log(f"[flat] traced step: kernel #2 launched {k2_n} times; "
        f"aten::index_select calls {gathers} (the per-group z-row gathers "
        f"are gone: {gathers == 0}); index_select kernels {sel or 'none'}")
    if gathers or k2_n != per_step:
        raise RuntimeError(f"flat step: {gathers} z-row gathers, {k2_n} "
                           f"kernel #2 launches (expected 0, {per_step})")
    # points kernel #2 evaluates per step (every level at its caps) and
    # the points the batch's actives need; the bound counts the latter
    r1, r2 = 4 ** 3, 2 ** 3
    evals = S * (RES // 16) ** 3 + caps[0] * r1 + (caps[1] + caps[2]) * r2
    needed = S * (RES // 16) ** 3 + acts[0] * r1 + (acts[1] + acts[2]) * r2
    step_bound, step_by = bound(needed, pairs_macs_per_point(decoder),
                                pairs_bytes(pairs, needed, S))
    log(f"[flat] kernel #2 in the traced step: {k2_ms:.1f} ms for {evals} "
        f"points at the caps ({needed} needed by the actives): "
        f"{k2_ms / evals * (1 << 20):.2f} ms per 2^20; bound for the needed "
        f"points {step_bound:.1f} ms ({step_by}) [{card}]")

    # (a) the same decode through the plain version
    def plain(z_rows, xyz):
        return fast_apply(pairs.ew, z_rows, xyz)

    t0 = time.perf_counter()
    g_p, st_p = flat(plain, caps, True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    acts_p = [st_p["active_l1"], st_p["active_l2"], st_p["active_l3"]]
    d_act = [abs(a - b) for a, b in zip(acts, acts_p)]
    h = 2.0 / (RES - 1)
    near_err, flips = 0.0, 0
    for s in range(S):
        a, b = grids[s].float(), g_p[s].float()
        near = (a.abs() < h) & (b.abs() < h)
        if bool(near.any()):
            near_err = max(near_err, float((a - b)[near].abs().max()))
        far = torch.minimum(a.abs(), b.abs()) >= 1e-2
        flips += int(((a < 0) != (b < 0))[far].sum())
    log(f"[flat] plain version's flat decode ({plain_s:.1f} s): actives "
        f"{acts_p} (|diff| {d_act}); near-surface voxels (|sdf| < h in "
        f"both): max |kernel-plain| {near_err:.3e} (tol 1e-2); sign flips "
        f"where both |sdf| >= 1e-2: {flips}")
    if (near_err > 1e-2 or flips
            or any(d > 0.002 * n + 16 for d, n in zip(d_act, acts_p))):
        raise RuntimeError("flat decode through kernel #2 differs from the "
                           "plain version's")
    del g_p

    # (b) 4 shapes of 4 classes as meshes vs serve_meshes with kernel #1
    apply1 = make_kernel_apply(decoder, sd_m)
    sel = [0, 1, 2, 3]
    served = list(serve_meshes(apply1, [codes_m[i] for i in sel], res=RES))
    cds = []
    for i, (v1, f1, _) in zip(sel, served):
        grid = unblock_grid(grids[i].float().cpu().numpy(), RES, 4)
        v, f = extract_mesh(grid)
        cds.append(chamfer_l2(v, v1))
        log(f"[flat] shape {i} (class {class_ids[i]}): flat-grid mesh "
            f"{len(v)} verts vs serve_meshes (kernel #1) {len(v1)}: "
            f"chamfer-L2 {cds[-1]:.3e} (limit {(h / 4) ** 2:.3e})")
        if len(f) == 0 or not cds[-1] < (h / 4) ** 2:
            raise RuntimeError(f"flat mesh of shape {i} disagrees")
    del grids

    # the same 64 codes through the per-shape decode with kernel #1, at
    # caps of 1.25x the largest shape's actives (the per-shape policy)
    zf = zs.float()
    big = ((RES // 16) ** 3, RES ** 2 // 2, 2 * RES ** 2)
    mx = [0, 0, 0]
    for z in zf:
        _, st1 = decode_grid_hierarchical3_sparse2(
            apply1, z, RES, 16, 4, 2, *big, check_overflow=True, **FLAT_KW)
        mx = [max(m, st1[k]) for m, k in zip(mx, ("active_l1", "active_l2",
                                                   "active_l3"))]
    caps1 = tuple(-(-int(1.25 * n) // 128) * 128 for n in mx)

    def per_shape():
        for z in zf:
            decode_grid_hierarchical3_sparse2(
                apply1, z, RES, 16, 4, 2, *caps1, check_overflow=False,
                **FLAT_KW)

    per_shape()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_shape()
    torch.cuda.synchronize()
    per_ms = (time.perf_counter() - t0) * 1e3
    log(f"[flat] per-shape decode of the same 64 codes with kernel #1 (int8 "
        f"payload, caps {caps1} = 1.25x the largest shape's actives): "
        f"{per_ms:.1f} ms per 64 shapes, {per_ms / S:.2f} ms per shape "
        f"[{card}]")

    # the batched three-level decode (the reference's vmapped one) of 8
    # codes through kernel #1 at the same caps: each shape bit-equal to
    # its single-shape decode
    zb = zf[:8]

    def batch():
        return decode_grid_hierarchical3_batch(
            apply1, zb, RES, 16, 4, 2, *caps1, layout="block",
            check_overflow=False, **FLAT_KW)

    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_b, st_b = batch()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    same_b = True
    for i in range(len(zb)):
        g1, st1 = decode_grid_hierarchical3_device(
            apply1, zb[i], RES, 16, 4, 2, *caps1, layout="block",
            check_overflow=True, **FLAT_KW)
        same_b = (same_b and torch.equal(g_b[i], g1) and not
                  st1["capacity_exceeded"] and all(
                      int(st_b[k][i]) == st1[k] for k in
                      ("active_l1", "active_l2", "active_l3")))
    log(f"[flat] decode_grid_hierarchical3_batch of 8 codes at {RES}^3 "
        f"through kernel #1 (float32 block grids, caps {caps1}): "
        f"{batch_ms:.1f} ms, {batch_ms / len(zb):.2f} ms per shape (flat "
        f"decode {ms / S:.2f}); each shape bit-equal to its single-shape "
        f"decode: {same_b} [{card}]")
    if not same_b:
        raise RuntimeError("batched decode differs from the single-shape "
                           "decodes")
    del g_b
    return dict(caps=caps, probe_s=probe_s, actives=acts,
                per_shape_l1=st["per_shape_l1"].tolist(), step_ms=times,
                ms=ms, ms_per_shape=ms / S, voxels_per_s=vox,
                launches=launches, launches_per_step=per_step,
                smi=smi.summary(),
                index_select_calls=gathers,
                trace=dict(wall_s=wall, device_busy_ms=busy, top=top[:12]),
                kernel2_step_ms=k2_ms, points_at_caps=evals,
                points_needed=needed, step_bound_ms=step_bound,
                plain_s=plain_s, plain_actives=acts_p, near_err=near_err,
                sign_flips=flips, chamfer=cds, per_shape_caps=caps1,
                per_shape_ms=per_ms, batch8_ms=batch_ms,
                batch8_ms_per_shape=batch_ms / len(zb), apply1=apply1)


def generate_phase(dev, card, pairs, apply1, trained) -> dict:
    """[generate] config 4's conditional generation at full width: DDIM-50
    with CFG 2.0 over class + 512 observed points, 64 latents, from the EMA
    weights [train_diff] trained (`trained`: state, mu, sigma);
    deterministic per seed; DPM-10; the latents through the flat decode
    (kernel #2: how many have a surface) and two through generate_meshes
    (kernel #1)."""
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        ddim_sample, dpm_solver_sample, guided_denoise_fn)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
        DiffusionSchedule)
    from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
        CondDenoiser)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_hierarchical3_batch_flat)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        generate_meshes)
    from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
        unnormalize_codes)

    exp = ExperimentConfig.load(ROOT / "configs" / "config4_conditional")
    dc, sc = exp.diff.denoiser, exp.sample
    state, mu, sigma = trained
    model = CondDenoiser(dc).to(dev)
    model.load_state_dict(state.ema)
    model.eval()
    sched = DiffusionSchedule.create(exp.diff.timesteps, exp.diff.beta_start,
                                     exp.diff.beta_end, device=dev)
    n = sc.num_samples
    split = analytic.make_synthetic_split("classes13", 6136, seed=5)[:n]
    rng = np.random.default_rng(7)
    obs = [analytic.sample_sdf_points(s, dc.partial_points, rng)
           for s in split]
    obs_xyz = torch.from_numpy(np.stack([o[0] for o in obs])).to(dev)
    obs_sdf = torch.from_numpy(np.stack([o[1] for o in obs])).to(dev)
    cid = torch.arange(n, device=dev) % dc.num_classes
    fn = guided_denoise_fn(model, sc.guidance_scale, class_id=cid,
                           obs_xyz=obs_xyz, obs_sdf=obs_sdf)
    L = dc.latent_size

    def sample(which, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if which == "ddim":
            return ddim_sample(fn, sched, gen, n, L, steps=sc.ddim_steps)
        return dpm_solver_sample(fn, sched, gen, n, L, steps=sc.dpm_steps)

    out = {}
    for which in ("ddim", "dpm"):
        sample(which, 0)                              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = sample(which, 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(z, sample(which, 0))
        other = not torch.equal(z, sample(which, 1))
        out[which] = dict(ms=ms, samples_per_s=n / (ms * 1e-3),
                          deterministic=same, z_abs_max=float(z.abs().max()))
        steps = sc.ddim_steps if which == "ddim" else sc.dpm_steps
        log(f"[generate] {which.upper()}-{steps}, CFG {sc.guidance_scale}, "
            f"{n} latents (CondDenoiser mlp {dc.hidden_dim}x{dc.num_blocks}, "
            f"{dc.num_classes} classes, {dc.partial_points} obs points, "
            f"trained EMA weights): "
            f"{ms:.1f} ms, {n / (ms * 1e-3):.0f} samples/s; same seed "
            f"identical: {same}, other seed differs: {other}; max|z| "
            f"{out[which]['z_abs_max']:.2f} [{card}]")
        if not (same and other and bool(torch.isfinite(z).all())):
            raise RuntimeError(f"{which} sampling is not deterministic per "
                               "seed or not finite")
        if which == "ddim":
            z_ddim = z
            wall, busy, top = device_profile(lambda: sample("ddim", 0))
            log_profile("generate", "one traced DDIM-50 batch", wall, busy,
                        top, card)
            out["ddim"]["trace"] = dict(wall_s=wall, device_busy_ms=busy,
                                        top=top[:12])
    # the same DDIM-50 from the raw (not averaged) weights, for comparison
    raw = CondDenoiser(dc).to(dev)
    raw.load_state_dict(state.model.state_dict())
    raw.eval()
    z_raw = ddim_sample(guided_denoise_fn(raw, sc.guidance_scale, class_id=cid,
                                          obs_xyz=obs_xyz, obs_sdf=obs_sdf),
                        sched, torch.Generator(device=dev).manual_seed(0), n,
                        L, steps=sc.ddim_steps)
    del raw

    def surfaces(z):
        """Flat decode of normalized latents z; (grids, stats, caps, how
        many shapes have both signs in their grid)."""
        lat_ = unnormalize_codes(z, mu, sigma).to(torch.bfloat16)
        caps_ = flat_caps(pairs, lat_)
        grids_, st_ = decode_grid_hierarchical3_batch_flat(
            pairs, lat_, RES, 16, 4, 2, *caps_, out_dtype="bfloat16",
            **FLAT_KW)
        g2 = grids_.flatten(1)
        return (grids_, st_, caps_,
                int(((g2 < 0).any(1) & (g2 > 0).any(1)).sum()))

    raw_surfaced = surfaces(z_raw)[3]
    log(f"[generate] DDIM-{sc.ddim_steps} from the raw (not EMA) weights: "
        f"max|z| {float(z_raw.abs().max()):.2f}, {raw_surfaced} of {n} "
        f"flat-decoded shapes with a surface (reported only)")
    n0 = pairs.launches
    grids, st, caps, surfaced = surfaces(z_ddim)
    ok = bool(torch.isfinite(grids.float()).all())
    log(f"[generate] {n} generated latents through the flat decode: caps "
        f"{caps}, actives {[st['active_l1'], st['active_l2'], st['active_l3']]}"
        f", kernel #2 launches {pairs.launches - n0}, grid "
        f"{tuple(grids.shape)} finite: {ok}; shapes with a surface (both "
        f"signs in the grid): {surfaced} of {n} (gate >= 1)")
    if (st["capacity_exceeded"] or not ok or pairs.launches == n0
            or surfaced < 1):
        raise RuntimeError(f"flat decode of generated latents: {st}, "
                           f"{surfaced} shapes with a surface")
    del grids
    fn2 = guided_denoise_fn(model, sc.guidance_scale, class_id=cid[:2],
                            obs_xyz=obs_xyz[:2], obs_sdf=obs_sdf[:2])
    n1 = apply1.launches
    meshes = list(generate_meshes(apply1, fn2, sched,
                                  torch.Generator(device=dev).manual_seed(0),
                                  2, L, mu=mu, sigma=sigma, steps=sc.ddim_steps,
                                  res=RES))
    for v, f, st2 in meshes:
        if not np.isfinite(v).all():
            raise RuntimeError("generate_meshes returned non-finite vertices")
    log(f"[generate] generate_meshes (DDIM-{sc.ddim_steps}, serve_meshes with "
        f"kernel #1, {apply1.launches - n1} launches): "
        f"{[(len(v), len(f)) for v, f, _ in meshes]} (verts, faces), "
        f"escalations {[st2['escalations'] for _, _, st2 in meshes]}")
    if len(meshes) != 2 or apply1.launches == n1:
        raise RuntimeError("generate_meshes did not serve through kernel #1")
    out.update(flat_caps=caps, surfaced=surfaced, raw_surfaced=raw_surfaced,
               flat_actives=[st["active_l1"], st["active_l2"],
                             st["active_l3"]],
               meshes=[(len(v), len(f)) for v, f, _ in meshes],
               latents=unnormalize_codes(z_ddim, mu, sigma))
    return out


EXPORT_RES = 512             # config 5's sample.grid_res
EXPORT_MESHES = 8            # artifact meshes held against serve_meshes
EXPORT_CLASS = 3             # export-sampler --class-id


def _both_signs(arrs, n1: int, n2: int, res: int, dq) -> bool:
    """Whether the grid a v2 payload reconstructs holds both signs: the
    b2 fill of the blocks without fine rows, and the fine rows."""
    import numpy as np
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        _sparse2_dequant, sparse2_fill2)
    c1, c2, i1, v2, i2 = (a.cpu().numpy() for a in arrs)
    fill2 = sparse2_fill2(c1, c2, i1, n1, res, 16, 4, dq)
    keep = np.ones(fill2.shape[0], bool)
    keep[i2[:n2]] = False
    vals = np.concatenate([fill2[keep],
                           _sparse2_dequant(v2[:n2], dq).reshape(-1)])
    return bool((vals < 0).any() and (vals > 0).any())


def export_phase(dev, card, apply1, sd_m, codes_m, trained,
                 latents) -> dict:
    """[export] the serving artifacts on the card, through the CLI verbs
    on an experiment of config 4's specs holding the committed multicat
    decoder (configs 4 and 5) and [train_diff]'s stage 2:
    export-decoder at config 5's 512^3 with _default_caps(512), reloaded
    from its bytes and held against the live decode of [generate]'s 64
    latents (payloads bit for bit, kernel #1's launches per call counted
    by its op) and against serve_meshes (8 meshes bit for bit); an
    artifact with cut caps raising CapacityExceeded; config 5's sample
    decode (serve_meshes of the 64 latents at 512^3, int8, as
    pipeline._decode_latents_to_meshes runs it) with its ms a mesh,
    faces, escalations, caps and peak card memory; export-sampler of the
    EMA (CFG 2.0, one class, 64 latents), DDIM-50 and DPM-10, each equal
    to the eager sampler from the same z_T bit for bit."""
    import contextlib
    import io
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch import cli
    from latent_diffusion_models_for_shape_sdfs_torch import (
        export_artifact as ea)
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig, override)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        ddim_sample, dpm_solver_sample, guided_denoise_fn)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
        DiffusionSchedule)
    from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
        CondDenoiser)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_hierarchical3_sparse2, hier3_int8_scale)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        _default_caps, serve_meshes)
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder \
        import init_ad_state
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import StageCheckpointer, ad_state_tree, diff_state_tree

    t_phase = time.perf_counter()
    res = EXPORT_RES
    caps = _default_caps(res)
    kw = dict(safety=1.2, safety3=2.0, out_dtype="int8")
    dq = hier3_int8_scale(res, 4, kw["safety"])
    state, mu, sigma = trained
    lat = list(latents)
    out: dict = {"res": res, "caps": list(caps)}

    def run_cli(*argv):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main(["--device", str(dev), *map(str, argv)])
        return text.getvalue()

    with tempfile.TemporaryDirectory() as td:
        exp = pathlib.Path(td) / "config4_export"
        c4 = ExperimentConfig.load(ROOT / "configs" / "config4_conditional")
        override(c4, **{"ad.num_scenes": len(codes_m)}).save(exp)
        cfg = ExperimentConfig.load(exp)
        ad = init_ad_state(cfg.ad, params=sd_m, codes=codes_m, device=dev)
        StageCheckpointer(exp, "auto_decoder").save(0, ad_state_tree(ad, 0))
        StageCheckpointer(exp, "diffusion").save(
            state.step, diff_state_tree(state, mu, sigma))
        del ad
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli("export-decoder", exp, "--res", res)
        out["export_s"] = time.perf_counter() - t0
        blob = (exp / f"decoder_{res}.zip").read_bytes()
        t0 = time.perf_counter()
        art = ea.load_decode_program(blob)
        out["load_s"] = time.perf_counter() - t0
        out["artifact_bytes"] = len(blob)
        if art.meta["platforms"] != ["cuda"] or art.meta["res"] != res or \
                [art.meta[k] for k in ("cap1", "cap2", "cap3")] != list(caps):
            raise RuntimeError(f"[export] artifact meta {art.meta}")

        # every latent: the artifact's payload == the live decode's
        fits, signs, per_call = [], [], []
        for i, z in enumerate(lat):
            arrs, st = decode_grid_hierarchical3_sparse2(
                apply1, z, res, 16, 4, 2, *caps, check_overflow=True, **kw)
            n0 = launch_record()["fused_eval"]
            got = art.payload(z)
            torch.cuda.synchronize()
            per_call.append(launch_record()["fused_eval"] - n0)
            counts = [st["active_l1"], st["active_l2"], st["active_l3"]]
            same = (all(torch.equal(a, b) for a, b in zip(got[:5], arrs))
                    and [int(x) for x in got[5:]] == counts)
            if not same:
                raise RuntimeError(f"[export] latent {i}: artifact payload "
                                   f"differs from the live decode")
            if not st["capacity_exceeded"]:
                fits.append(i)
                signs.append((i, _both_signs(arrs, counts[0], counts[1],
                                             res, dq)))
            del arrs, got
        if min(per_call) < 1:
            raise RuntimeError(f"[export] kernel #1 launches per artifact "
                               f"call {per_call}")
        out.update(launches_per_call=per_call[0],
                   launches=int(sum(per_call)), fits=len(fits))

        def timed(fn):
            fn(lat[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for z in lat:
                fn(z)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / len(lat) * 1e3

        out["artifact_ms"] = timed(art.payload)
        out["live_ms"] = timed(lambda z: decode_grid_hierarchical3_sparse2(
            apply1, z, res, 16, 4, 2, *caps, check_overflow=False, **kw))
        log(f"[export] export-decoder --res {res} (caps {caps}): "
            f"{out['export_s']:.2f} s, {len(blob)} bytes, reloaded from its "
            f"bytes in {out['load_s']:.2f} s; {len(lat)} generated latents: "
            f"payloads and counts bit-equal to the live decode, kernel #1 "
            f"{per_call[0]} launches per artifact call (counted by the op); "
            f"{out['artifact_ms']:.2f} ms a latent through the artifact, "
            f"{out['live_ms']:.2f} live; {len(fits)} of {len(lat)} within "
            f"the caps [{card}]")

        # meshes: the artifact's against serve_meshes's
        pick = fits[:EXPORT_MESHES]
        if len(pick) < EXPORT_MESHES:
            raise RuntimeError(f"[export] only {len(fits)} latents fit the "
                               "default caps")
        live_m = list(serve_meshes(apply1, [lat[i] for i in pick], res=res))
        for i, (v, f, _) in zip(pick, live_m):
            va, fa = art.mesh(lat[i])
            if not (np.array_equal(va, v) and np.array_equal(fa, f)):
                raise RuntimeError(f"[export] latent {i}: artifact mesh "
                                   "differs from serve_meshes's")
        del live_m
        small = (caps[0] // 32, caps[1] // 32, caps[2] // 32)
        cut = ea.load_decode_program(ea.export_decode_program(
            apply1, apply1.ew.latent_size, res, small, device=dev))
        try:
            cut.grid(lat[0])
            raised = False
        except ea.CapacityExceeded:
            raised = True
        log(f"[export] {len(pick)} artifact meshes bit-equal to "
            f"serve_meshes's; caps cut to {small}: CapacityExceeded "
            f"{raised}")
        if not raised:
            raise RuntimeError("[export] cut caps did not raise")
        del cut, art

        # config 5's sample decode: 64 latents at 512^3, int8 payload
        cfg5 = ExperimentConfig.load(ROOT / "configs" / "config5_multicat_dp")
        payload = ("float32" if cfg5.ad.decoder.compute_dtype == "float32"
                   else "int8")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = apply1.launches
        t0 = time.perf_counter()
        meshes = list(serve_meshes(apply1, lat, res=cfg5.sample.grid_res,
                                   iso=cfg5.sample.iso_level,
                                   out_dtype=payload, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        faces = [len(f) for _, f, _ in meshes]
        esc = [st["escalations"] for _, _, st in meshes]
        final = [(st["cap1"], st["cap2"], st["cap3"]) for _, _, st in meshes
                 if st["escalations"]]
        for i, (_, _, st) in enumerate(meshes):
            if st["escalations"]:     # its grid at the caps it ended with
                arrs, st2 = decode_grid_hierarchical3_sparse2(
                    apply1, lat[i], res, 16, 4, 2, st["cap1"], st["cap2"],
                    st["cap3"], check_overflow=True, **kw)
                signs.append((i, _both_signs(arrs, st2["active_l1"],
                                             st2["active_l2"], res, dq)))
        empty = [i for i, both in signs if both and faces[i] == 0]
        out["config5"] = dict(
            ms_per_mesh=wall / len(lat) * 1e3, faces=faces,
            escalations=esc, escalated_caps=final, peak_bytes=peak,
            launches=apply1.launches - n0, payload=payload,
            both_signs=sum(b for _, b in signs), empty_with_both=empty,
            capacity_exceeded=sum(st["capacity_exceeded"]
                                  for _, _, st in meshes))
        c5 = out["config5"]
        log(f"[export] config 5's sample decode (serve_meshes of the "
            f"{len(lat)} latents at {cfg5.sample.grid_res}^3, {payload}): "
            f"{c5['ms_per_mesh']:.1f} ms a mesh, faces median "
            f"{int(np.median(faces))} (max {max(faces)}), escalations "
            f"{sum(1 for e in esc if e)} shapes (caps {caps} -> "
            f"{sorted(set(final))}), still over caps "
            f"{c5['capacity_exceeded']}; peak card memory "
            f"{peak / 2 ** 30:.3f} GiB; {c5['launches']} kernel #1 "
            f"launches; {c5['both_signs']} grids with both signs, empty "
            f"meshes among them {empty} [{card}]")
        if empty or c5["capacity_exceeded"] or c5["launches"] < 1:
            raise RuntimeError(f"[export] config 5's decode: {c5}")
        out["launches"] += c5["launches"]
        del meshes

        # the sampler artifacts from the EMA
        model = CondDenoiser(cfg.diff.denoiser).to(dev)
        model.load_state_dict(state.ema)
        model.eval()
        sched = DiffusionSchedule.create(cfg.diff.timesteps,
                                         cfg.diff.beta_start,
                                         cfg.diff.beta_end, device=dev)
        n = len(lat)
        L = cfg.diff.denoiser.latent_size
        fn = guided_denoise_fn(model, cfg.sample.guidance_scale,
                               class_id=torch.full((n,), EXPORT_CLASS,
                                                   device=dev))
        z_T = torch.randn(n, L, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        out["sampler"] = {}
        for name, steps, live_fn in (("ddim", cfg.sample.ddim_steps,
                                      ddim_sample),
                                     ("dpm", cfg.sample.dpm_steps,
                                      dpm_solver_sample)):
            path = exp / f"sampler_{name}{steps}.zip"
            t0 = time.perf_counter()
            run_cli("export-sampler", exp, "--num", n, "--steps", steps,
                    "--sampler", name, "--class-id", EXPORT_CLASS)
            t_exp = time.perf_counter() - t0
            blob = path.read_bytes()
            t0 = time.perf_counter()
            sart = ea.load_sampler_program(blob)
            t_load = time.perf_counter() - t0
            got = sart.sample(z_T)
            want = (live_fn(fn, sched, None, n, L, steps=steps, z_init=z_T)
                    * sigma + mu).cpu().numpy()
            same = np.array_equal(got, want)

            def ms(f):
                f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            rec = dict(export_s=t_exp, load_s=t_load, bytes=len(blob),
                       bitwise=same,
                       max_diff=float(np.abs(got - want).max()),
                       z_abs_max=float(np.abs(want).max()),
                       ms=ms(lambda: sart.sample(z_T)),
                       eager_ms=ms(lambda: live_fn(
                           fn, sched, None, n, L, steps=steps,
                           z_init=z_T).cpu()))
            out["sampler"][name] = rec
            log(f"[export] export-sampler {name.upper()}-{steps} (CFG "
                f"{cfg.sample.guidance_scale}, class {EXPORT_CLASS}, {n} "
                f"latents, EMA of [train_diff]): {t_exp:.2f} s, "
                f"{len(blob)} bytes, loaded in {t_load:.2f} s; sample(z_T) "
                f"== the eager sampler from the same z_T, unnormalized, bit "
                f"for bit: {same} (max diff {rec['max_diff']:.3e}); "
                f"{rec['ms']:.1f} ms through the artifact, "
                f"{rec['eager_ms']:.1f} eager [{card}]")
            if not same:
                raise RuntimeError(f"[export] {name} artifact differs from "
                                   f"the eager sampler: {rec}")
    out["s"] = time.perf_counter() - t_phase
    log(f"[export] phase {out['s']:.1f} s [{card}]")
    return out


BANK_SAMPLES = 1024          # samples a multicat scene for the banks (cut)
# [train_diff] steps (config 4: 300,000). After 2,000 steps the EMA (decay
# 0.999) still carries 13.5% of the init and most of the early trajectory;
# sampled, such weights gave no surface in 64 shapes (max |z| 131.6)
DIFF_STEPS = 10_000


def multicat_banks() -> tuple:
    """Config 4's conditioning banks over the 6,136 multicat scenes the
    committed pack was trained on (tools/multicat6k_run.py:
    make_synthetic_split("classes13", 6136, seed=5)), built as
    pipeline._cond_banks builds them (4 x 512 observation rows a scene),
    from a store of BANK_SAMPLES samples a shape instead of 100,000."""
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
        SdfDataset)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        _cond_banks)
    exp = ExperimentConfig.load(ROOT / "configs" / "config4_conditional")
    ds = SdfDataset.from_analytic(
        analytic.make_synthetic_split("classes13", 6136, seed=5),
        BANK_SAMPLES, seed=0, workers=8)
    return _cond_banks(exp, ds)


def diff_tensors(state) -> list:
    """Every tensor of a stage-2 state: params, EMA, Adam's moments and
    step counts."""
    out = []
    for k, p in state.model.named_parameters():
        s = state.optimizer.state[p]
        out += [p.detach(), state.ema[k], s["exp_avg"], s["exp_avg_sq"],
                s["step"]]
    return out


def train_diff_phase(dev, card, codes_m, banks) -> dict:
    """[train_diff] config 4's stage 2 at full width on the multicat codes:
    a chunk eager vs the same chunk from the CUDA graph, bit for bit (two
    chunks), steps/s of each, one traced graphed chunk, then DIFF_STEPS
    steps through train_diffusion (graphed chunks of scan_chunk)."""
    import dataclasses
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
        DiffusionSchedule)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        diffusion as ttd)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
        MetricLogger)

    exp = ExperimentConfig.load(ROOT / "configs" / "config4_conditional")
    cfg = dataclasses.replace(exp.diff, num_steps=DIFF_STEPS,
                              snapshot_every=0)
    dc = cfg.denoiser
    class_ids, obs_xyz, obs_sdf = banks
    n, bank_n = len(codes_m), obs_xyz.shape[1]
    log(f"[train_diff] config4_conditional diff block: CondDenoiser "
        f"{dc.arch} {dc.hidden_dim}x{dc.num_blocks}, time embed "
        f"{dc.time_embed_dim}, {dc.num_classes} classes, {dc.partial_points} "
        f"observation points (bank {bank_n}), batch {cfg.batch_size}, T "
        f"{cfg.timesteps}, lr {cfg.lr} constant (config asks "
        f"{cfg.lr_schedule}), chunks of {cfg.scan_chunk}; cut: num_steps "
        f"{exp.diff.num_steps} -> {DIFF_STEPS}, bank store {BANK_SAMPLES} "
        f"samples a shape (100000); data: {n} multicat codes [{card}]")
    codes_t = torch.from_numpy(codes_m).to(dev)
    codes_n, mu, sigma = ttd.normalize_codes(codes_t)
    sched = DiffusionSchedule.create(cfg.timesteps, cfg.beta_start,
                                     cfg.beta_end, device=dev)
    cids = torch.as_tensor(class_ids, dtype=torch.long, device=dev)
    oxyz = torch.as_tensor(obs_xyz, device=dev)
    osdf = torch.as_tensor(obs_sdf, device=dev)

    def fresh():
        st = ttd.init_diff_state(cfg, seed=cfg.seed, device=dev)
        return st, ttd.DiffStep(cfg, st, sched, codes_n, cids, oxyz, osdf)

    a, step_a = fresh()
    b, step_b = fresh()
    chunk = cfg.scan_chunk
    times = {"eager": [], "graphed": []}
    same = True
    for start in (0, chunk):
        draws = ttd.draw_chunk(cfg, n, bank_n, start, dev)
        for name, fn in (("eager", step_a.eager), ("graphed", step_b.graphed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(fn(draws))
            times[name].append(time.perf_counter() - t0)
            if name == "eager":
                la = loss
        same = same and la == loss and all(
            torch.equal(x, y) for x, y in zip(diff_tensors(a),
                                              diff_tensors(b)))
    sps = {k: chunk / v[-1] for k, v in times.items()}
    log(f"[train_diff] chunk of {chunk} steps from the same state and draws, "
        f"twice: eager and graphed equal bit for bit (params, EMA, Adam "
        f"moments and counts, loss): {same}; second chunk: eager "
        f"{sps['eager']:.1f} steps/s ({1e3 / sps['eager']:.3f} ms a step), "
        f"graphed {sps['graphed']:.1f} steps/s ({1e3 / sps['graphed']:.3f} ms "
        f"a step); the first graphed chunk (capture included) "
        f"{times['graphed'][0]:.2f} s [{card}]")
    if not same:
        raise RuntimeError("the graphed chunk differs from the eager chunk")
    draws = ttd.draw_chunk(cfg, n, bank_n, 2 * chunk, dev)
    wall, busy, top = device_profile(lambda: float(step_b.graphed(draws)))
    log_profile("train_diff", f"one traced graphed chunk of {chunk} steps",
                wall, busy, top, card)
    del a, b, step_a, step_b
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "diff.jsonl"
        logger = MetricLogger(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, (mu_t, sigma_t), last = ttd.train_diffusion(
            cfg, codes_m, class_ids=class_ids, obs_xyz=obs_xyz,
            obs_sdf=obs_sdf, logger=logger, device=dev)
        run_s = time.perf_counter() - t0
        logger.close()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
    chunks = [r for r in recs if r["event"] == "diff_chunk"]
    losses = [r["loss"] for r in chunks]
    log(f"[train_diff] train_diffusion, {state.step} steps in {len(chunks)} "
        f"graphed chunks: {run_s:.2f} s ({state.step / run_s:.1f} steps/s, "
        f"one host wait a chunk); loss first chunk {losses[0]:.4f}, last "
        f"{losses[-1]:.4f} (an untrained zero-head denoiser reads 1.0; "
        f"gate < 0.5) [{card}]")
    if not (np.isfinite(last) and last < 0.5 and state.step == DIFF_STEPS
            and torch.equal(mu_t, mu)):
        raise RuntimeError(f"stage-2 training: last loss {last}, step "
                           f"{state.step}")
    return dict(trained=(state, mu_t, sigma_t), out=dict(
        steps_per_s=sps, chunk_s=times, bit_equal=same,
        trace=dict(wall_s=wall, device_busy_ms=busy, top=top[:12]),
        run_s=run_s, steps=state.step, losses=losses,
        lr_record=[r for r in recs if r["event"] == "lr_schedule"]))


UNET = ("configs", "config2_latent_ddpm_unet")
# [unet] steps (config 2-unet: 20,000); 10,000 is where config 4's EMA
# (decay 0.999) first sampled surfaces in [train_diff]
UNET_STEPS = 10_000
UNET_SAMPLES = 16


def unet_phase(dev, card) -> dict:
    """[unet] config 2-unet's `diff` block at full width (UNet base 64,
    batch 256, T 1000, the reference's constant lr 1e-4) on the 6,144
    committed chair codes: a chunk eager vs the same chunk from the CUDA
    graph, bit for bit (two chunks), ms a step of each, one traced graphed
    chunk, UNET_STEPS steps through train_diffusion, then DDIM-50 on
    UNET_SAMPLES latents from the EMA decoded at the config's grid_res
    through serve_meshes and kernel #1."""
    import dataclasses
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig, ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        ddim_sample, guided_denoise_fn)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
        DiffusionSchedule)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
        CondDenoiser)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        serve_meshes)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        diffusion as ttd)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        load_stage1_pack)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
        MetricLogger)

    exp = ExperimentConfig.load(ROOT.joinpath(*UNET))
    cfg = dataclasses.replace(exp.diff, num_steps=UNET_STEPS,
                              snapshot_every=0)
    dc = cfg.denoiser
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    n = len(codes)
    model0 = CondDenoiser(dc)
    body = model0.body
    log(f"[unet] config2_latent_ddpm_unet diff block: {dc.arch} (tokens "
        f"{body.tokens}, base {body.stem.out_channels}, "
        f"{sum(p.numel() for p in model0.parameters())} params), batch "
        f"{cfg.batch_size}, T {cfg.timesteps}, lr {cfg.lr} constant "
        f"(config asks {cfg.lr_schedule}), chunks of {cfg.scan_chunk}; cut: "
        f"num_steps {exp.diff.num_steps} -> {UNET_STEPS}; data: {n} "
        f"committed chair codes [{card}]")
    codes_n, mu, sigma = ttd.normalize_codes(torch.from_numpy(codes).to(dev))
    sched = DiffusionSchedule.create(cfg.timesteps, cfg.beta_start,
                                     cfg.beta_end, device=dev)
    cids = torch.zeros(n, dtype=torch.long, device=dev)
    oxyz = torch.zeros((n, 1, 3), device=dev)
    osdf = torch.zeros((n, 1), device=dev)

    def fresh():
        st = ttd.init_diff_state(cfg, seed=cfg.seed, device=dev)
        return st, ttd.DiffStep(cfg, st, sched, codes_n, cids, oxyz, osdf)

    a, step_a = fresh()
    b, step_b = fresh()
    chunk = cfg.scan_chunk
    times = {"eager": [], "graphed": []}
    same = True
    for start in (0, chunk):
        draws = ttd.draw_chunk(cfg, n, 1, start, dev)
        for name, fn in (("eager", step_a.eager), ("graphed", step_b.graphed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(fn(draws))
            times[name].append(time.perf_counter() - t0)
            if name == "eager":
                la = loss
        same = same and la == loss and all(
            torch.equal(x, y) for x, y in zip(diff_tensors(a),
                                              diff_tensors(b)))
    ms = {k: 1e3 * v[-1] / chunk for k, v in times.items()}
    log(f"[unet] chunk of {chunk} steps from the same state and draws, twice: "
        f"eager and graphed equal bit for bit (params, EMA, Adam moments "
        f"and counts, loss): {same}; second chunk: eager {ms['eager']:.3f} "
        f"ms a step, graphed {ms['graphed']:.3f} ms a step; the first "
        f"graphed chunk (capture included) {times['graphed'][0]:.2f} s "
        f"[{card}]")
    if not same:
        raise RuntimeError("[unet] the graphed chunk differs from the eager "
                           "chunk")
    draws = ttd.draw_chunk(cfg, n, 1, 2 * chunk, dev)
    wall, busy, top = device_profile(lambda: float(step_b.graphed(draws)))
    log_profile("unet", f"one traced graphed chunk of {chunk} steps", wall,
                busy, top, card)
    del a, b, step_a, step_b
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "diff.jsonl"
        logger = MetricLogger(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, (mu_t, sigma_t), last = ttd.train_diffusion(
            cfg, codes, logger=logger, device=dev)
        run_s = time.perf_counter() - t0
        logger.close()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
    losses = [r["loss"] for r in recs if r["event"] == "diff_chunk"]
    log(f"[unet] train_diffusion, {state.step} steps in {len(losses)} graphed "
        f"chunks: {run_s:.2f} s ({1e3 * run_s / state.step:.3f} ms a step); "
        f"loss first chunk {losses[0]:.4f}, last {losses[-1]:.4f} (gate < "
        f"0.5) [{card}]")
    if not (np.isfinite(last) and last < 0.5 and state.step == UNET_STEPS
            and torch.equal(mu_t, mu)):
        raise RuntimeError(f"[unet] training: last loss {last}, step "
                           f"{state.step}")

    ema = CondDenoiser(dc).to(dev)
    ema.load_state_dict(state.ema)
    ema.eval()
    sc = exp.sample
    fn = guided_denoise_fn(ema, sc.guidance_scale)
    gen = torch.Generator(device=dev).manual_seed(sc.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = ttd.unnormalize_codes(ddim_sample(fn, sched, gen, UNET_SAMPLES,
                                           dc.latent_size,
                                           steps=sc.ddim_steps), mu_t, sigma_t)
    torch.cuda.synchronize()
    ddim_ms = (time.perf_counter() - t0) * 1e3
    apply = ck.make_kernel_apply(SdfDecoder(DecoderConfig()), sd, device=dev)
    n0 = launch_record()["fused_eval"]
    t0 = time.perf_counter()
    meshes = list(serve_meshes(apply, list(zs), res=sc.grid_res, device=dev))
    serve_s = time.perf_counter() - t0
    launches = launch_record()["fused_eval"] - n0
    faces = [len(f) for _, f, _ in meshes]
    surfaced = sum(f > 0 for f in faces)
    log(f"[unet] DDIM-{sc.ddim_steps} of {UNET_SAMPLES} latents from the EMA: "
        f"{ddim_ms:.1f} ms, max|z| {float(zs.abs().max()):.2f}; decoded at "
        f"{sc.grid_res}^3 through serve_meshes in {serve_s:.2f} s, kernel #1 "
        f"{launches} launches; {surfaced} of {UNET_SAMPLES} with a surface "
        f"(gate >= 1), faces {faces} [{card}]")
    if surfaced < 1 or launches == 0:
        raise RuntimeError("[unet] no sampled shape has a surface")
    return dict(trained=(state, mu_t, sigma_t), out=dict(
        ms_per_step=ms, chunk_s=times, bit_equal=same,
        trace=dict(wall_s=wall, device_busy_ms=busy, top=top[:12]),
        run_s=run_s, steps=state.step, losses=losses, ddim_ms=ddim_ms,
        serve_s=serve_s, fused_eval_launches=launches, faces=faces,
        surfaced=surfaced))


RECON_TARGETS = (0, 1, 2, 3, 6144)   # 6144: held out of the committed pack
RECON_POINTS = 8000                  # observations a target (the CLI's)
RECON_RES = 256                      # the meshes' dense grid
ENC_STEPS = 3000                     # the encoder's cut (20,000)
REFINE_STEPS = 100


def recon_phase(dev, card, unet) -> dict:
    """[recon] reconstruction from 8,000 observations of chairs 0-3 and the
    held-out chair 6144 of the committed pack's split, on its 8x512
    decoder, at cfg.reconstruct's defaults: (a) MAP, (b) 4 restarts, (c)
    the SDS prior of [unet]'s EMA at weight 1e-3, (d) the encoder trained
    here at full width (cut to ENC_STEPS steps) one-shot and refined by
    REFINE_STEPS steps. Graphed == eager bit for bit for a-c and for an
    encoder chunk; each mesh decoded dense at 256^3 through kernel #1 and
    held by Chamfer-L2 against the analytic surface."""
    import dataclasses
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch import reconstruct as rec
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig, EncConfig, ExperimentConfig, ReconstructConfig,
        override)
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        guided_denoise_fn)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
        DiffusionSchedule)
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        chamfer_l2, sample_mesh_surface)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
        CondDenoiser)
    from latent_diffusion_models_for_shape_sdfs_torch.models.encoder import (
        encode_latent)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
        extract_mesh)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        _enc_bank)
    from latent_diffusion_models_for_shape_sdfs_torch.train import (
        encoder as ten)
    from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
        normalize_codes)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        load_stage1_pack)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
        MetricLogger)

    rcfg = ReconstructConfig()
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    decoder = SdfDecoder(DecoderConfig())
    decoder.load_state_dict(sd)
    decoder.to(dev)
    apply = ck.make_kernel_apply(SdfDecoder(DecoderConfig()), sd, device=dev)
    shapes = analytic.make_synthetic_split("chair", 6145, seed=11)
    targets = {}
    for i in RECON_TARGETS:
        ox, od = analytic.sample_sdf_points(shapes[i], RECON_POINTS,
                                            np.random.default_rng(1000 + i))
        gt = analytic.sample_surface(shapes[i], 30_000,
                                     np.random.default_rng(2000 + i))
        targets[i] = (torch.from_numpy(ox).to(dev),
                      torch.from_numpy(od).to(dev), gt)
    ref = json.loads((ROOT / "runs" / "scale_chairs6k" /
                      "heldout_eval.json").read_text())["held_out"]["rows"]
    log(f"[recon] committed 8x512 chair decoder (fp32, TF32 off), targets "
        f"chairs {RECON_TARGETS} of make_synthetic_split('chair', 6145, "
        f"seed=11), 8,000 observations each; cfg.reconstruct {rcfg}; the "
        f"reference's own held-out rows (runs/scale_chairs6k/"
        f"heldout_eval.json, {len(ref)} chairs): l1_last "
        f"{min(r['l1_last'] for r in ref):.5f}-"
        f"{max(r['l1_last'] for r in ref):.5f}, Chamfer "
        f"{min(r['chamfer'] for r in ref):.2e}-"
        f"{max(r['chamfer'] for r in ref):.2e} [{card}]")

    def mesh_chamfer(z, gt):
        grid = decode_grid(apply, z, RECON_RES, chunk=1 << 20).cpu().numpy()
        v, f = extract_mesh(grid)
        if len(f) == 0:
            return 0, float("inf")
        return len(f), chamfer_l2(sample_mesh_surface(v, f, 30_000, seed=1),
                                  gt)

    # the prior: [unet]'s EMA weights and code moments
    state_u, mu_u, sigma_u = unet
    exp_u = ExperimentConfig.load(ROOT.joinpath(*UNET))
    den = CondDenoiser(exp_u.diff.denoiser).to(dev)
    den.load_state_dict(state_u.ema)
    den.eval()
    sched = DiffusionSchedule.create(exp_u.diff.timesteps,
                                     exp_u.diff.beta_start,
                                     exp_u.diff.beta_end, device=dev)
    prior = {"denoise_fn": guided_denoise_fn(den, 0.0), "sched": sched,
             "mu": mu_u, "sigma": sigma_u, "weight": 1e-3, "t_lo": 0.02,
             "t_hi": 0.98, "anneal": True}
    modes = {"a_map": (rcfg, None),
             "b_restarts4": (dataclasses.replace(rcfg, num_inits=4), None),
             "c_sds": (rcfg, prior)}
    out: dict = {"modes": {}}
    n_eval0 = launch_record()["fused_eval"]

    def run_targets(mode, fn):
        """fn(ox, od) -> (z, l1_last) on every target: ms (host clock, the
        result read included; chair 0's includes the capture of its
        graph), l1_last, the RECON_RES^3 mesh's faces and Chamfer-L2."""
        rows = {}
        for i, (ox, od, gt) in targets.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z, l1_last = fn(ox, od)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            faces, cham = mesh_chamfer(z, gt)
            rows[i] = dict(ms=ms, l1_last=l1_last, faces=faces,
                           chamfer=cham)
            log(f"[recon]   ({mode}) chair {i}: {ms:.1f} ms, l1_last "
                f"{l1_last:.5f}, {RECON_RES}^3 mesh {faces} faces, Chamfer-L2 "
                f"{cham:.3e}")
        return rows

    for mode, (cfg, sp) in modes.items():
        k = cfg.num_inits
        # chair 0: a graphed run == the eager run from the same draws; the
        # graphed one timed on its second replay (the first captures)
        ox, od, _ = targets[0]
        draws = rec.draw_recon(cfg, k, decoder.cfg.latent_size, dev,
                               sds_prior=sp)
        opts, secs = {}, {}
        for how in ("eager", "graphed"):
            opts[how] = rec.LatentOpt(decoder, cfg, k, RECON_POINTS,
                                      sds_prior=sp)
            for _ in range(1 if how == "eager" else 2):
                opts[how].load(ox, od, draws)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                getattr(opts[how], how)()
                torch.cuda.synchronize()
                secs[how] = time.perf_counter() - t0
        e, g = opts["eager"], opts["graphed"]
        same = all(torch.equal(x, y) for x, y in
                   ((e.z, g.z), (e.hist, g.hist), (e.l1, g.l1)))
        per_step = 1e3 * secs["graphed"] / cfg.num_steps
        log(f"[recon] ({mode}) k {k}, {cfg.num_steps} steps, chair 0 from "
            f"the same draws: eager {1e3 * secs['eager']:.1f} ms, graphed "
            f"{1e3 * secs['graphed']:.1f} ms ({per_step:.3f} ms a step), "
            f"equal bit for bit (z, both histories): {same} [{card}]")
        if not same:
            raise RuntimeError(f"[recon] {mode}: graphed != eager")
        trace = None
        if k == 1:              # where a run's time goes: one traced run
            g.load(ox, od, draws)
            wall, busy, top = device_profile(g.graphed)
            log_profile("recon", f"({mode}) one traced graphed run of "
                        f"{cfg.num_steps} steps", wall, busy, top, card)
            trace = dict(wall_s=wall, device_busy_ms=busy, top=top[:12])
        del opts, e, g
        cache: dict = {}

        def fn(ox, od, cfg=cfg, sp=sp, cache=cache):
            z, info = rec.reconstruct_latent(decoder, ox, od, cfg,
                                             sds_prior=sp, cache=cache)
            return z, info["l1_last"]
        out["modes"][mode] = dict(eager_ms=1e3 * secs["eager"],
                                  graphed_ms=1e3 * secs["graphed"],
                                  bit_equal=same, trace=trace,
                                  rows=run_targets(mode, fn))
        torch.cuda.empty_cache()

    # (d) the encoder at full width on the committed codes, its bank from
    # the device sampler through pipeline._enc_bank
    ecfg = dataclasses.replace(EncConfig(), num_steps=ENC_STEPS)
    exp = override(ExperimentConfig(data_source="analytic:chair"),
                   **{"ad.num_scenes": len(codes), "ad.seed": 11})
    exp = dataclasses.replace(exp, encoder=ecfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bx, bs = _enc_bank(exp, None, device=dev)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    mib = (bx.numel() + bs.numel()) * 4 / 2**20
    log(f"[recon] (d) encoder bank: {tuple(bx.shape)} points from the device "
        f"chair sampler in {bank_s:.2f} s ({mib:.0f} MiB); encoder widths "
        f"{ecfg.encoder.point_widths} / "
        f"head {ecfg.encoder.head_widths}, batch {ecfg.batch_scenes} x "
        f"{ecfg.n_obs}, lr {ecfg.lr} {ecfg.lr_schedule} (warmup "
        f"{ecfg.warmup_steps}); cut: num_steps 20000 -> {ENC_STEPS} [{card}]")
    codes_n, _, _ = normalize_codes(torch.from_numpy(codes).to(dev))
    bank = ten.make_bank(bx, bs, dev)
    st_a = ten.init_enc_state(ecfg, seed=ecfg.seed, device=dev)
    st_b = ten.init_enc_state(ecfg, seed=ecfg.seed, device=dev)
    step_a = ten.EncStep(ecfg, st_a, bank, codes_n)
    step_b = ten.EncStep(ecfg, st_b, bank, codes_n)
    draws = ten.draw_chunk(ecfg, len(codes), bank.shape[1], 0, dev)
    enc_t = {}
    for name, fn in (("eager", step_a.eager), ("graphed", step_b.graphed)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(fn(draws))
        enc_t[name] = time.perf_counter() - t0
    same = float(step_a.last) == loss and all(
        torch.equal(p, q) and all(torch.equal(st_a.optimizer.state[p][k],
                                              st_b.optimizer.state[q][k])
                                  for k in st_a.optimizer.state[p])
        for p, q in zip(st_a.model.parameters(), st_b.model.parameters()))
    draws = ten.draw_chunk(ecfg, len(codes), bank.shape[1], ecfg.scan_chunk,
                           dev)
    t0 = time.perf_counter()
    float(step_b.graphed(draws))
    enc_t["graphed_replay"] = time.perf_counter() - t0
    wall, busy, top = device_profile(lambda: float(step_b.graphed(
        ten.draw_chunk(ecfg, len(codes), bank.shape[1],
                       2 * ecfg.scan_chunk, dev))))
    log(f"[recon] (d) encoder chunk of {ecfg.scan_chunk} steps from the same "
        f"state and draws: eager {1e3 * enc_t['eager'] / ecfg.scan_chunk:.3f}"
        f" ms a step, graphed (capture included) "
        f"{1e3 * enc_t['graphed'] / ecfg.scan_chunk:.3f}, graphed replay "
        f"{1e3 * enc_t['graphed_replay'] / ecfg.scan_chunk:.3f}; equal bit "
        f"for bit (params, Adam, loss): {same} [{card}]")
    log_profile("recon", "one traced graphed encoder chunk", wall, busy, top,
                card)
    if not same:
        raise RuntimeError("[recon] the graphed encoder chunk differs from "
                           "the eager chunk")
    del step_a, step_b, st_a, st_b
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "enc.jsonl"
        logger = MetricLogger(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, est, (emu, esig), enc_loss = ten.train_encoder(
            ecfg, codes, bx, bs, logger=logger, device=dev)
        enc_s = time.perf_counter() - t0
        logger.close()
        enc_losses = [json.loads(x)["loss"] for x in
                      path.read_text().splitlines()]
    log(f"[recon] (d) train_encoder, {est.step} steps in {len(enc_losses)} "
        f"graphed chunks: {enc_s:.2f} s ({1e3 * enc_s / est.step:.3f} ms a "
        f"step); loss first chunk {enc_losses[0]:.4f}, last {enc_loss:.4f} "
        f"(gate < 0.6; the reference read 0.42 at step 2,000) [{card}]")
    if not (np.isfinite(enc_loss) and enc_loss < 0.6):
        raise RuntimeError(f"[recon] encoder last loss {enc_loss}")
    del bx, bs, bank
    enc.eval()
    rcfg_d = dataclasses.replace(rcfg, num_steps=REFINE_STEPS,
                                 lr_decay_at=REFINE_STEPS // 2)
    cache_d: dict = {}

    def one_shot(ox, od):
        return encode_latent(enc, ox, od, emu, esig), float("nan")

    def refined(ox, od):
        z0 = encode_latent(enc, ox, od, emu, esig)
        z, info = rec.reconstruct_latent(decoder, ox, od, rcfg_d, z_init=z0,
                                         cache=cache_d)
        return z, info["l1_last"]

    out["modes"]["d_encoder"] = dict(
        bank_s=bank_s, chunk_s=enc_t, bit_equal=same, train_s=enc_s,
        losses=enc_losses, trace=dict(wall_s=wall, device_busy_ms=busy,
                                      top=top[:12]),
        one_shot=run_targets("d_one_shot", one_shot),
        refined=run_targets(f"d_refined_{REFINE_STEPS}", refined))
    out["fused_eval_launches"] = launch_record()["fused_eval"] - n_eval0
    m = out["modes"]
    meshes = [r["faces"] for v in m.values() for rows in (
        [v["rows"]] if "rows" in v else [v["one_shot"], v["refined"]])
        for r in rows.values()]
    bad = [i for i, r in m["a_map"]["rows"].items() if not r["l1_last"] < 5e-3]
    sds_bad = [i for i, r in m["c_sds"]["rows"].items()
               if not r["l1_last"] < 1e-2]
    log(f"[recon] gates: MAP l1_last < 0.005 on every chair (fails: {bad}); "
        f"SDS l1_last < 0.01 (fails: {sds_bad}); every mesh non-empty "
        f"({sum(f > 0 for f in meshes)} of {len(meshes)}); kernel #1 "
        f"{out['fused_eval_launches']} launches [{card}]")
    if bad or sds_bad or min(meshes) == 0 or out["fused_eval_launches"] == 0:
        raise RuntimeError(f"[recon] gates failed: {bad} {sds_bad} {meshes}")
    return out


CLI_SCENES = 64             # [cli]'s cut of config 4's scenes


def cli_store():
    """The analytic store of [cli]'s experiment (config 4's data source,
    cut to CLI_SCENES scenes), as pipeline.build_dataset builds it; made
    with the data before CUDA, on a fork pool."""
    from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
    from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
        SdfDataset)
    specs = json.loads((ROOT / "configs" / "config4_conditional"
                        / "specs.json").read_text())
    key = (specs["data_source"], CLI_SCENES, specs["ad"]["seed"])
    family = key[0].split(":", 1)[1]
    return key, SdfDataset.from_analytic(
        analytic.make_synthetic_split(family, CLI_SCENES, seed=key[2]),
        workers=8)


def check_event_file(logdir: pathlib.Path, jsonl: pathlib.Path) -> dict:
    """[cli]: the one TensorBoard event file under `logdir`, read as
    TFRecords with every masked CRC-32C checked (this machine has no
    proto decoder), and its record count against the JSONL log's: the
    file-version record plus one scalar per numeric field of each record
    with a step or epoch."""
    import struct
    from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
        masked_crc32c)
    f, = logdir.glob("events.out.tfevents.*")
    data, off, n = f.read_bytes(), 0, 0
    while off + 12 <= len(data):
        head = data[off:off + 8]
        size, = struct.unpack("<Q", head)
        body = data[off + 12:off + 12 + size]
        crcs = struct.unpack("<II", data[off + 8:off + 12]
                             + data[off + 12 + size:off + 16 + size])
        if crcs != (masked_crc32c(head), masked_crc32c(body)):
            raise RuntimeError(f"{f}: record {n} fails its CRC")
        off, n = off + 16 + size, n + 1
    want = 1
    for line in jsonl.read_text().splitlines():
        rec = json.loads(line)
        fields = {k: v for k, v in rec.items() if k not in ("event", "time")}
        if fields.get("step", fields.get("epoch")) is None:
            continue
        for k, v in fields.items():
            if k in ("step", "epoch"):
                continue
            try:
                float(v)
            except (TypeError, ValueError):
                continue
            want += 1
    if off != len(data) or n != want:
        raise RuntimeError(f"{f}: {n} records in {off} of {len(data)} "
                           f"bytes, the log mirrors {want - 1} scalars")
    return dict(file=f.name, bytes=len(data), records=n)


def cli_phase(dev, card, store) -> dict:
    """[cli] the CLI in process on config 4's specs (every field passed
    with --set), cut in scale: init-experiment, train-ad, train-diff,
    train-diff --resume, sample at 256^3, eval; each stage's wall time and
    the launches of kernels #3/#3b (train-ad) and #1 (sample, eval);
    train-ad's and train-diff's --tensorboard event files (read back by
    check_event_file). The stages take `store` (cli_store) for their
    analytic store."""
    import contextlib
    import io
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch import cli, pipeline

    specs = json.loads((ROOT / "configs" / "config4_conditional"
                        / "specs.json").read_text())

    def sets(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from sets(v, prefix + k + ".")
            elif prefix or k not in ("name", "data_source"):
                yield from ("--set", f"{prefix}{k}={json.dumps(v)}")

    # 150 epochs of one step: enough for the decoder to reach the surfaces
    # from its init (2 epochs left every eval mesh empty); 10,000 stage-2
    # steps: after 1,000 the EMA (decay 0.999) still weighed the init by
    # 37% and every sample was empty; the encoder's warmup cut with its
    # steps (500 of 20,000)
    cuts = {"ad.num_scenes": CLI_SCENES, "ad.num_epochs": 150,
            "diff.num_steps": 10_000, "diff.snapshot_every": 5000,
            "sample.num_samples": 8,
            "sample.grid_res": 128, "encoder.num_steps": 500,
            "encoder.warmup_steps": 12}
    out: dict = {"cuts": cuts, "stages": {}}
    with tempfile.TemporaryDirectory() as td:
        exp = str(pathlib.Path(td) / "config4_cli")
        points = 2000
        queue, served = pathlib.Path(td) / "q", pathlib.Path(td) / "served"
        recon = ["reconstruct", exp, "--analytic", "chair", "--name"]
        stages = [
            ("init-experiment", ["init-experiment", exp, "--data",
                                 specs["data_source"], *sets(specs),
                                 *(a for k, v in cuts.items()
                                   for a in ("--set", f"{k}={v}"))]),
            ("train-ad", ["train-ad", exp, "--tensorboard"]),
            ("train-diff", ["train-diff", exp, "--tensorboard"]),
            ("train-diff --resume", ["train-diff", exp, "--resume"]),
            ("sample", ["sample", exp, "--res", str(RES)]),
            ("eval", ["eval", exp, "--points", str(points)]),
            ("train-encoder", ["train-encoder", exp]),
            ("reconstruct", [*recon, "map"]),
            ("reconstruct --diffusion-prior", [*recon, "prior",
                                               "--diffusion-prior"]),
            ("reconstruct --encoder --refine-steps 0",
             [*recon, "one_shot", "--encoder", "--refine-steps", "0"]),
            ("reconstruct --encoder", [*recon, "refined", "--encoder"]),
            ("serve-daemon --reconstruct encoder",
             ["serve-daemon", exp, "--in", str(queue), "--out", str(served),
              "--poll", "0.1", "--max-idle", "1.0", "--reconstruct",
              "encoder"])]
        queue.mkdir()
        from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
        import numpy as np
        ox, od = analytic.sample_sdf_points(
            analytic.make_shape("chair", np.random.default_rng(3)), 8000,
            np.random.default_rng(4))
        np.savez(queue / "obs.npz", obs_xyz=ox, obs_sdf=od)
        build = pipeline.build_dataset
        key, ds = store

        def shared(cfg):
            if (cfg.data_source, cfg.ad.num_scenes, cfg.ad.seed) == key:
                return ds
            return build(cfg)

        pipeline.build_dataset = shared
        tb: dict = {}
        try:
            for name, argv in stages:
                reset_train_launches()
                text = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    cli.main(["--device", str(dev), *argv])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = launched_since({}, (*RD, "fused_eval"))
                out["stages"][name] = dict(s=wall, launches=launches,
                                           tc_products=tc_products())
                log(f"[cli] {name}: {wall:.2f} s, launches {launches}, "
                    f"hidden layers' tensor-core products {tc_products()} "
                    f"[{card}]")
                if "--tensorboard" in argv:     # before a resume appends
                    stage = {"train-ad": "ad", "train-diff": "diff"}[name]
                    tb[stage] = check_event_file(
                        pathlib.Path(exp) / "logs" / "tb" / stage,
                        pathlib.Path(exp) / "logs" / (
                            f"train_{stage}.jsonl"))
        finally:
            pipeline.build_dataset = build
        ev = json.loads((pathlib.Path(exp) / "evals" / "chamfer.json")
                        .read_text())
        samples = sorted((pathlib.Path(exp) / "samples").glob("*.obj"))
        n_faces = [sum(1 for ln in p.open() if ln.startswith("f "))
                   for p in samples]
        diff_ckpts = sorted(int(p.stem) for p in (
            pathlib.Path(exp) / "checkpoints" / "diffusion").glob("*.pt"))
        ad_last = [json.loads(x) for x in (pathlib.Path(exp) / "logs" /
                                           "train_ad.jsonl").open()][-1]
        enc_last = [json.loads(x) for x in (pathlib.Path(exp) / "logs" /
                                            "train_enc.jsonl").open()][-1]
        recon_faces = {p.stem: sum(1 for ln in p.open()
                                   if ln.startswith("f "))
                       for p in sorted((pathlib.Path(exp) /
                                        "reconstructions").glob("*.obj"))}
        daemon = json.loads((served / "obs.stats.json").read_text())
    log(f"[cli] --tensorboard event files, every CRC checked, one record "
        f"per mirrored scalar: {tb}")
    st = out["stages"]
    log(f"[cli] train-encoder's last loss {enc_last['loss']:.4f} at step "
        f"{enc_last['step']}; reconstructions at {cuts['sample.grid_res']}^3"
        f", faces {recon_faces}; the daemon's encoder reconstruction at "
        f"{RES}^3: {daemon[0]['faces']} faces [{card}]")
    log(f"[cli] config4_conditional through the CLI, cut {cuts} (eval "
        f"--points {points}): train-ad's last loss_l1 "
        f"{ad_last['loss_l1']:.5f}; eval over {len(ev['chamfer_l2'])} scenes: mean "
        f"chamfer-L2 {ev['mean']:.3e}, F-score@{ev['fscore_tau']} "
        f"{ev['fscore_mean']:.3f}, normal consistency "
        f"{ev.get('normal_consistency_mean', float('nan')):.3f}, failed "
        f"{ev['num_failed']}; {len(samples)} samples at {RES}^3, faces "
        f"{n_faces}; stage-2 checkpoints {diff_ckpts} [{card}]")
    ok = (st["train-ad"]["launches"]["relu_dropout_fwd"] > 0
          and st["train-ad"]["launches"]["relu_dropout_bwd"] > 0
          and min(st["train-ad"]["tc_products"].values()) > 0
          and st["sample"]["launches"]["fused_eval"] > 0
          and st["eval"]["launches"]["fused_eval"] > 0
          and len(samples) == cuts["sample.num_samples"]
          and min(n_faces) > 0
          and diff_ckpts == [5000, 10_000]
          and all(st[n]["launches"]["fused_eval"] > 0 for n in st
                  if n.startswith(("reconstruct", "serve-daemon")))
          and len(recon_faces) == 4 and min(recon_faces.values()) > 0
          and daemon[0]["faces"] > 0)
    if not ok:
        raise RuntimeError(f"CLI run: {out}")
    out.update(ad_loss_l1=ad_last["loss_l1"], eval_mean=ev["mean"],
               fscore_mean=ev["fscore_mean"],
               nc_mean=ev.get("normal_consistency_mean"),
               num_failed=ev["num_failed"], sample_faces=n_faces,
               enc_loss=enc_last["loss"], recon_faces=recon_faces,
               daemon_faces=daemon[0]["faces"], tensorboard=tb)
    return out


REAL_RES = 256              # grid of the chairs meshed for [realdata]
# Sinkhorn-EMD at 512 points: eps of tests/test_device_metrics.py, whose
# 500 iterations were set for 64 points; [realdata] logs 500 beside the
# exact assignment and gates 2,000
EMD_EPS, EMD_ITERS = 0.005, 2000
PREP_CALLS = 8              # concurrent `cli preprocess` calls
PREVIEW = ("runs", "scale_chairs6k")


def _harmonize_and_write(job: tuple) -> int:
    """[realdata] worker (a spawned process): make one chair mesh's winding
    consistent and outward, write it (.ply binary, .obj text); its faces."""
    path, v, f = job
    from latent_diffusion_models_for_shape_sdfs_torch.utils import meshio
    f = meshio.harmonize_winding(v, f)
    meshio.write_mesh(path, v, f)
    return len(f)


def _wall(fn) -> float:
    """Host seconds of fn(), ended by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _background(rgb, hit):
    """The background's grey level in each row of a render (rgb, hit):
    the colour of the row's first miss; -99 for a row with none."""
    import numpy as np
    bg = np.zeros(rgb.shape[0], np.int32)
    for y in range(rgb.shape[0]):
        row = rgb[y][~hit[y]]
        bg[y] = int(row[0, 0]) if len(row) else -99
    return bg


def march_hits_before_fix(sdf, view: dict, device, steps: int = 96,
                          eps: float = 2e-3, step_scale: float = 0.9,
                          bound: float = 1.05):
    """Hit mask of the reference's march as it was when the committed
    previews were rendered (runs/scale_chairs6k/preview_train_*.png, commit
    9defad9): a hit only where |sdf| < eps, no crossing test (the
    reference added the secant-interpolated crossing hit in 4a36048, two
    hours later). Built on the port's rays and sphere entry; a check of
    the previews only, not a path of the port."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import render
    o, d = render.camera_rays(view["width"], view["height"], view["eye"],
                              (0.0, 0.0, 0.0), 40.0, device)
    t0 = render._ray_sphere_entry(o, d, bound)
    alive = torch.isfinite(t0)
    t = torch.where(alive, t0, torch.zeros_like(t0))
    t_exit = t + 2.0 * bound + 0.2
    hit = torch.zeros_like(alive)
    for _ in range(steps):
        s = sdf(o + t[:, None] * d)
        hit_now = alive & (torch.abs(s) < eps)
        hit = hit | hit_now
        step = torch.clamp(s * step_scale, min=1e-4)
        t = torch.where(alive & ~hit_now, t + step, t)
        alive = alive & ~hit_now & (t < t_exit)
    return hit.reshape(view["height"], view["width"]).cpu().numpy()


def realdata_phase(dev, card) -> dict:
    """[realdata] the real-mesh data path and the read-outs on trained
    weights: 64 chairs of config 3's split meshed on the card (analytic
    SDF on a 256^3 grid, native mesher, harmonize_winding, half binary PLY
    and half OBJ), `cli preprocess` at 100,000 samples a mesh, `train-ad`
    from `sdf:` on config 3's `ad` block (cut to 50 epochs of one step)
    and `eval` at 128^3; then on the committed 8x512 pack: the render
    (kernel vs plain on the card, both vs the committed previews), `cli
    render`, `cli interpolate`, `cli decode --normals`, and the generative
    metrics on the card against their host oracles."""
    import concurrent.futures as cf
    import contextlib
    import io
    import multiprocessing
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch import cli
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig, override)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device)
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        sample_mesh_surface)
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        device_metrics as dm, generative as gm)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        fast_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
        extract_mesh)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.render import (
        render_sdf)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import serve_meshes
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
        init_ad_state)
    from latent_diffusion_models_for_shape_sdfs_torch.utils import meshio
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        StageCheckpointer, ad_state_tree, load_stage1_pack)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.image import (
        read_png)

    t_phase = time.perf_counter()
    out: dict = {}
    specs = json.loads((ROOT / "configs" / "config3_chairs_joint"
                        / "specs.json").read_text())
    n_scenes = 64

    def run_cli(name, argv):
        """cli.main in process: wall s and the launches of #1, #3, #3b."""
        reset_train_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--device", str(dev), *argv])
        torch.cuda.synchronize()
        rec = dict(s=time.perf_counter() - t0,
                   launches=launched_since({}, (*RD, "fused_eval")))
        out.setdefault("cli", {})[name] = rec
        log(f"[realdata] {name}: {rec['s']:.2f} s, launches "
            f"{rec['launches']}")
        return rec

    with contextlib.ExitStack() as stack:
        td = pathlib.Path(stack.enter_context(tempfile.TemporaryDirectory()))
        # ---- 64 chairs as meshes: analytic SDF on a 256^3 grid on the
        # card, the native mesher; winding and writing in spawned workers
        shapes = analytic.make_synthetic_split("chair", n_scenes,
                                               seed=specs["ad"]["seed"])
        params = analytic_device.pack_chairs(shapes, device=dev)
        axis = torch.linspace(-1.0, 1.0, REAL_RES, device=dev)
        gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
        pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
        del gx, gy, gz
        mesh_dir = td / "meshes"
        mesh_dir.mkdir()
        # (left before the directory is removed, even on a failure)
        pool = stack.enter_context(cf.ProcessPoolExecutor(
            max_workers=8, mp_context=multiprocessing.get_context("spawn")))
        t0 = time.perf_counter()
        jobs, n_faces_raw = [], []
        chunk = 1 << 22
        for i in range(n_scenes):
            p1 = params.slice(i, 1)
            grid = torch.empty(REAL_RES ** 3, device=dev)
            for c in range(0, len(pts), chunk):
                grid[c:c + chunk] = analytic_device.chair_sdf(
                    p1, pts[None, c:c + chunk])[0]
            v, f = extract_mesh(grid.reshape((REAL_RES,) * 3).cpu().numpy())
            n_faces_raw.append(len(f))
            ext = "ply" if i % 2 == 0 else "obj"
            jobs.append(pool.submit(_harmonize_and_write,
                                    (mesh_dir / f"chair_{i:03d}.{ext}", v,
                                     f)))
        t_grid = time.perf_counter() - t0
        del pts, grid

        # ---- the read-outs on trained weights run on the card while the
        # workers write the meshes
        sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
        pexp = td / "pack"
        pcfg = override(ExperimentConfig.load(ROOT / "configs"
                                              / "config3_chairs_joint"),
                        **{"name": "pack", "ad.num_scenes": len(codes),
                           "sample.grid_res": 256})
        pcfg.save(pexp)
        state = init_ad_state(pcfg.ad, SdfDecoder(pcfg.ad.decoder), params=sd,
                              codes=codes, device=dev)
        StageCheckpointer(pexp, "auto_decoder").save(0, ad_state_tree(state,
                                                                      0))
        del state
        decoder = SdfDecoder(pcfg.ad.decoder)
        apply = ck.make_kernel_apply(decoder, sd, device=dev)

        def plain(z, x):
            return fast_apply(apply.ew, z, x)

        view = dict(width=448, height=448, eye=(1.5, 1.05, 1.5))
        render_sdf(apply, torch.from_numpy(codes[1]).to(dev), **view)
        renders = []
        for i, scene in enumerate((0, 7, 21)):
            z = torch.from_numpy(codes[scene]).to(dev)
            apply.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rgb, hit = render_sdf(apply, z, **view)
            ms = (time.perf_counter() - t0) * 1e3
            n_launch = apply.launches
            rgb_p, hit_p = render_sdf(plain, z, **view)
            hit_old = march_hits_before_fix(apply.bind(z), view, dev)
            bg = _background(rgb, hit)
            ref = read_png(ROOT.joinpath(*PREVIEW,
                                         f"preview_train_{i}.png"))
            hit_ref = (np.abs(ref.astype(np.int32) - bg[:, None, None])
                       > 2).any(-1)
            both = hit & hit_p
            d_p = np.abs(rgb.astype(int) - rgb_p.astype(int)).max(-1)[both]
            both_r = hit & hit_ref
            d_r = np.abs(rgb.astype(int) - ref.astype(int)).max(-1)[both_r]
            r = dict(scene=scene, ms=ms, launches=n_launch,
                     hit_px=int(hit.sum()), tpu_hit_px=int(hit_ref.sum()),
                     hit_vs_plain=float((hit == hit_p).mean()),
                     hit_vs_tpu=float((hit == hit_ref).mean()),
                     plain_vs_tpu=float((hit_p == hit_ref).mean()),
                     before_fix_vs_tpu=float((hit_old == hit_ref).mean()),
                     tpu_only=float((hit_ref & ~hit).mean()),
                     shade_vs_plain=dict(
                         median=float(np.median(d_p)),
                         p95=float(np.quantile(d_p, 0.95)),
                         within8=float((d_p <= 8).mean())),
                     shade_vs_tpu=dict(
                         median=float(np.median(d_r)),
                         p95=float(np.quantile(d_r, 0.95)),
                         within8=float((d_r <= 8).mean())))
            renders.append(r)
            log(f"[realdata] render chair {scene} at 448^2 through kernel #1:"
                f" {ms:.1f} ms, {n_launch} launches, {r['hit_px']} hit px; "
                f"hit masks equal to the plain version's on "
                f"{100 * r['hit_vs_plain']:.3f}% of pixels (gate 99.9); the "
                f"committed TPU preview ({r['tpu_hit_px']} hit px, rendered "
                f"before the reference's crossing hits) equals the port's "
                f"march as it was then on {100 * r['before_fix_vs_tpu']:.3f}%"
                f" (gate 98), the port's render on "
                f"{100 * r['hit_vs_tpu']:.3f}% (plain: "
                f"{100 * r['plain_vs_tpu']:.3f}%), hit in the preview only: "
                f"{100 * r['tpu_only']:.3f}% (gate 0.2); shading |drgb| where"
                f" both hit, vs plain median "
                f"{r['shade_vs_plain']['median']:.0f} / p95 "
                f"{r['shade_vs_plain']['p95']:.0f} levels, vs TPU median "
                f"{r['shade_vs_tpu']['median']:.0f} / p95 "
                f"{r['shade_vs_tpu']['p95']:.0f} [{card}]")
            if not (r["hit_vs_plain"] >= 0.999
                    and r["before_fix_vs_tpu"] >= 0.98
                    and r["tpu_only"] <= 0.002
                    and r["shade_vs_plain"]["median"] <= 4
                    and r["shade_vs_tpu"]["median"] <= 8
                    and n_launch == 102):
                raise RuntimeError(f"render of chair {scene}: {r}")
        out["render"] = renders
        z0 = torch.from_numpy(codes[0]).to(dev)
        apply.launches = 0
        frame_ms = 1e3 * min(_wall(lambda: render_sdf(apply, z0))
                             for _ in range(3))
        out["render_512_ms"] = frame_ms
        out["render_512_launches"] = apply.launches
        log(f"[realdata] render_sdf at its default 512^2 (96 march steps, 6 "
            f"normal evaluations): {frame_ms:.1f} ms a frame, best of 3, "
            f"the image read back included [{card}]")

        # the CLI on the pack experiment: render, interpolate, decode
        rec = run_cli("render --frames 4", ["render", str(pexp), "--frames",
                                            "4", "--name", "tt"])
        pngs = sorted((pexp / "renders").glob("tt_*.png"))
        cli_ms = rec["s"] / 4 * 1e3
        log(f"[realdata] cli render at its default 512^2, 4 frames: "
            f"{rec['s']:.2f} s, {cli_ms:.1f} ms a frame with the stage-1 "
            f"state's load and the PNG writes, kernel #1 "
            f"{rec['launches']['fused_eval']} launches [{card}]")
        if len(pngs) != 4 or rec["launches"]["fused_eval"] != 4 * 102:
            raise RuntimeError(f"cli render: {len(pngs)} frames, {rec}")
        out["render_cli"] = dict(frame_ms=cli_ms, **rec)
        faces = {}
        for mode in ("lerp", "slerp"):
            run_cli(f"interpolate {mode}", [
                "interpolate", str(pexp), "0", "7", "--steps", "8", "--res",
                "256", "--mode", mode, "--name", mode, "--format", "ply"])
            faces[mode] = [len(meshio.read_ply(p)[1]) for p in sorted(
                (pexp / "interpolations").glob(f"{mode}_*.ply"))]
        log(f"[realdata] interpolate 0 -> 7, 8 steps at 256^3: faces "
            f"{faces}")
        if any(len(v) != 8 or min(v) == 0 for v in faces.values()):
            raise RuntimeError(f"interpolation meshes: {faces}")
        out["interpolate_faces"] = faces
        nrm_err = {}
        for fmt in ("ply", "obj"):
            run_cli(f"decode --normals {fmt}", [
                "decode", str(pexp), "--scene", "0", "7", "--res", "128",
                "--format", fmt, "--normals", "--out", str(td / fmt)])
            for p in sorted((td / fmt).glob(f"*.{fmt}")):
                if fmt == "ply":
                    v, f, n = meshio.read_ply(p, with_normals=True)
                else:
                    v, f = meshio.read_obj(p)
                    n = np.asarray([[float(x) for x in ln.split()[1:4]]
                                    for ln in p.read_text().splitlines()
                                    if ln.startswith("vn ")], np.float32)
                err = np.abs(n - meshio.vertex_normals(v, f)).max(1)
                unit = float(np.abs(np.linalg.norm(n, axis=1) - 1).max())
                nrm_err[f"{p.stem}.{fmt}"] = dict(
                    faces=len(f), max=float(err.max()),
                    p99=float(np.quantile(err, 0.99)), unit=unit)
                # OBJ writes 6 decimals: its normals agree to that
                ok = (err.max() == 0 if fmt == "ply" else
                      np.quantile(err, 0.99) < 1e-3 and err.max() < 5e-2)
                if not (ok and unit < 1e-5 and len(f) > 0
                        and n.shape == v.shape):
                    raise RuntimeError(f"normals of {p.name}: {nrm_err}")
        log(f"[realdata] decode --normals at 128^3, read back: |n - "
            f"vertex_normals(read mesh)| {nrm_err}")
        out["normals"] = nrm_err

        # ---- generative metrics: 64 decoded pack chairs vs their
        # analytic chairs (the pack's split), 2,048-point clouds
        apply.launches = 0
        gen = [sample_mesh_surface(v, f, 2048, seed=i) for i, (v, f, _) in
               enumerate(serve_meshes(apply, list(codes[:64]), res=256,
                                      device=dev))]
        out["metrics_decode_launches"] = apply.launches
        ref = [analytic.sample_surface(s, 2048, np.random.default_rng(i))
               for i, s in enumerate(train_split())]
        d_dev = dm.pairwise_metric(gen[:32], ref[:32], "chamfer", chunk=16,
                                   device=dev)
        d_host = gm.pairwise_chamfer(gen[:32], ref[:32])
        ch_rel = float(np.abs(d_dev / d_host - 1).max())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d64 = dm.pairwise_metric(gen, ref, "chamfer", chunk=16, device=dev)
        ms64 = (time.perf_counter() - t0) * 1e3
        g8 = [c[:512] for c in gen[:8]]
        r8 = [c[:512] for c in ref[:8]]
        t0 = time.perf_counter()
        e_dev = dm.pairwise_metric(g8, r8, "emd", chunk=64, eps=EMD_EPS,
                                   iters=EMD_ITERS, device=dev)
        ms_emd = (time.perf_counter() - t0) * 1e3
        e_ex = np.array([[gm.emd_exact(a, b) for b in r8] for a in g8])
        e_500 = dm.pairwise_metric(g8, r8, "emd", chunk=64, eps=EMD_EPS,
                                   iters=500, device=dev) / e_ex - 1
        env_ok = bool(((e_dev >= e_ex - 1e-4)
                       & (e_dev - e_ex < 0.05 * e_ex + 0.01)).all())
        ev_dev = dm.evaluate_generated_device(
            g8, r8, metrics=("chamfer", "emd"), chunk=64, eps=EMD_EPS,
            iters=EMD_ITERS, device=dev)
        ev_host = gm.evaluate_generated_emd_host(g8, r8, points=512)
        mmd_ok = (ev_dev["mmd_emd"] >= ev_host["mmd_emd"] - 1e-4
                  and ev_dev["mmd_emd"] - ev_host["mmd_emd"]
                  < 0.05 * ev_host["mmd_emd"] + 0.01)
        ev64 = dm.evaluate_generated_device(gen, ref, chunk=16, device=dev)
        out["metrics"] = dict(
            chamfer_max_rel=ch_rel, chamfer64_ms=ms64,
            chamfer_diag_mean=float(np.diag(d64).mean()),
            emd_ms=ms_emd, emd_rel_to_exact=float(np.max(e_dev / e_ex - 1)),
            emd_low_to_exact=float(np.min(e_dev / e_ex - 1)),
            emd500_rel_to_exact=[float(e_500.min()), float(e_500.max())],
            emd_envelope=env_ok, eval8_device=ev_dev, eval8_host=ev_host,
            eval64_device=ev64)
        log(f"[realdata] device Chamfer 32 x 32 at 2,048 points vs the host "
            f"KD-tree pairwise_chamfer: max rel {ch_rel:.2e} (gate 1e-5); "
            f"64 x 64 at 2,048 points {ms64:.1f} ms; Sinkhorn-EMD 8 x 8 at "
            f"512 points (eps {EMD_EPS}, {EMD_ITERS} iterations) "
            f"{ms_emd:.1f} ms, "
            f"{100 * out['metrics']['emd_low_to_exact']:.2f}% to "
            f"{100 * out['metrics']['emd_rel_to_exact']:.2f}% above the "
            f"exact assignment, in the envelope: {env_ok} (500 "
            f"iterations: {100 * e_500.min():.2f}% to "
            f"{100 * e_500.max():.2f}%); "
            f"evaluate_generated_device {ev_dev} vs "
            f"evaluate_generated_emd_host {ev_host}; decoded vs analytic "
            f"64 chairs: {ev64} [{card}]")
        if not (ch_rel <= 1e-5 and env_ok and mmd_ok):
            raise RuntimeError(f"generative metrics: {out['metrics']}")
        del apply, gen, ref
        torch.cuda.empty_cache()

        # ---- `cli preprocess` at the analytic store's 100,000 samples a
        # mesh: PREP_CALLS CLI calls over parts of the meshes at once (the
        # tool's file parsing and BVH build are single-threaded)
        t0 = time.perf_counter()
        n_faces = [j.result() for j in jobs]
        pool.shutdown()
        t_wait = time.perf_counter() - t0
        sdf_dir = td / "sdf"
        files, parts = sorted(mesh_dir.iterdir()), []
        for q in range(PREP_CALLS):
            qd = td / f"meshes_{q}"
            qd.mkdir()
            for p in files[q::PREP_CALLS]:
                p.rename(qd / p.name)
            parts.append(qd)
        errs: list = []

        def prep(qd):
            try:
                cli.main(["--device", str(dev), "preprocess", str(qd),
                          str(sdf_dir), "--samples", "100000"])
            except BaseException as e:      # re-raised below
                errs.append(e)

        # the CLI and the tool print a line a mesh: into a file, not here
        prep_log = td / "preprocess.log"
        t0 = time.perf_counter()
        with prep_log.open("w") as fh:
            sys.stdout.flush()
            saved = os.dup(1)
            os.dup2(fh.fileno(), 1)
            try:
                ths = [threading.Thread(target=prep, args=(qd,))
                       for qd in parts]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join()
            finally:
                sys.stdout.flush()
                os.dup2(saved, 1)
                os.close(saved)
        if errs:
            raise errs[0]
        t_prep = time.perf_counter() - t0
        stores = sorted(sdf_dir.glob("*.npz"))
        h = 2.0 / (REAL_RES - 1)
        signs = {}
        for i in (0, 33, 63):
            with np.load(stores[i]) as z:
                rows = np.concatenate([z["pos"], z["neg"]])
                center, scale = z["center"], float(z["scale"][0])
                n_surf = len(z["surface"])
            x = rows[:, :3] / scale + center
            d = analytic.sdf(shapes[i], x)
            far = np.abs(d) > 2 * h
            signs[stores[i].stem] = dict(
                agree=float(((d < 0) == (rows[:, 3] < 0))[far].mean()),
                far=float(far.mean()), rows=len(rows), surface=n_surf)
        log(f"[realdata] 64 chairs of config 3's split at {REAL_RES}^3 "
            f"(analytic_device SDF + native mesher: {t_grid:.1f} s; faces "
            f"{min(n_faces)}-{max(n_faces)}); winding + writing in 8 spawned "
            f"workers beside the read-outs, waited for after them: "
            f"{t_wait:.1f} s; cli preprocess of 64 meshes (32 PLY, 32 OBJ) "
            f"at 100,000 samples in {PREP_CALLS} concurrent calls: "
            f"{t_prep:.1f} s; sample signs vs the analytic SDF "
            f"beyond 2 cells: {signs} [{card}]")
        if len(stores) != n_scenes or any(
                s["agree"] < 0.99 or s["rows"] != 100_000
                for s in signs.values()):
            raise RuntimeError(f"preprocess: {len(stores)} stores, {signs}")
        out.update(grid_mesh_s=t_grid, faces=n_faces, write_wait_s=t_wait,
                   preprocess_s=t_prep,
                   signs=signs)

        # ---- train-ad from sdf: on config 3's ad block, eval at 128^3
        def sets(dd, prefix=""):
            for k, v in dd.items():
                if isinstance(v, dict):
                    yield from sets(v, prefix + k + ".")
                elif prefix or k not in ("name", "data_source"):
                    yield from ("--set", f"{prefix}{k}={json.dumps(v)}")

        cuts = {"ad.num_scenes": n_scenes, "ad.num_epochs": 50}
        exp = td / "real"
        run_cli("init-experiment", [
            "init-experiment", str(exp), "--data", f"sdf:{sdf_dir}",
            *sets(specs), *(a for k, v in cuts.items()
                            for a in ("--set", f"{k}={v}"))])
        tr_rec = run_cli("train-ad", ["train-ad", str(exp)])
        logs = [json.loads(x) for x in (exp / "logs" / "train_ad.jsonl")
                .open()]
        losses = [(r["epoch"], r["loss"]) for r in logs if "loss" in r]
        ev_rec = run_cli("eval", ["eval", str(exp), "--points", "2000"])
        ev = json.loads((exp / "evals" / "chamfer.json").read_text())
        log(f"[realdata] train-ad from sdf: on config 3's ad block (8x512, "
            f"{n_scenes} scenes x 16,384 points, bf16, dropout 0.2 through "
            f"#3/#3b), cut {cuts}: loss by epoch {losses}; eval at 128^3 "
            f"(--points 2000) vs the stores' surfaces: {len(ev['chamfer_l2'])}"
            f" scenes, mean chamfer-L2 {ev['mean']:.3e}, F-score "
            f"{ev['fscore_mean']:.3f}, failed {ev['num_failed']} [{card}]")
        if not (losses[-1][1] < losses[0][1]
                and tr_rec["launches"]["relu_dropout_fwd"] > 0
                and tr_rec["launches"]["relu_dropout_bwd"] > 0
                and ev_rec["launches"]["fused_eval"] > 0
                and len(ev["chamfer_l2"]) == n_scenes):
            raise RuntimeError(f"train-ad / eval from sdf: {losses}, "
                               f"{tr_rec}, {ev_rec}")
        out.update(losses=losses, eval_mean=ev["mean"],
                   eval_fscore=ev["fscore_mean"],
                   eval_failed=ev["num_failed"], cuts=cuts)
    cli_runs = out["cli"]
    out["launches_k1"] = (sum(r["launches"]["fused_eval"]
                              for r in cli_runs.values())
                          + sum(r["launches"] for r in renders)
                          + out["render_512_launches"]
                          + out["metrics_decode_launches"])
    out["launches_k3"] = cli_runs["train-ad"]["launches"]["relu_dropout_fwd"]
    out["launches_k3b"] = cli_runs["train-ad"]["launches"][
        "relu_dropout_bwd"]
    out["s"] = time.perf_counter() - t_phase
    log(f"[realdata] phase {out['s']:.1f} s; kernel #1 launched "
        f"{out['launches_k1']} times on these paths, #3 "
        f"{out['launches_k3']}, #3b {out['launches_k3b']}")
    return out


BANK_N = 16_384           # samples a shape: the committed packs' banks
# step-0 loss_l1 from each pack (trained levels 0.0022 and 0.0057; a draw,
# sign-split or fallback fault reads ~0.05)
BANK_GATES = {"chair": 0.01, "csg": 0.015}
# [dp], 2 ranks vs 1 from one state and the same draws. Both routes round
# f32 sums to bf16 (the activations on the autograd route, the folded
# gradients on the fused one), so where the two runs sum in another order
# an entry near a rounding edge moves by a bf16 ulp; Adam's first step
# then moves the entries whose gradient is that small by up to ~lr.
DP_LOSS_RTOL = 1e-6       # step 0's loss terms (l1, code-reg, sum)
DP_GRAD_TOL = 1e-2        # step 0's gradients, of each tensor's max (bf16)
DP_LOSS3_RTOL = 1e-4      # the losses of all 3 steps (TRAIN_LOSS_RTOL)
DP_PARAM_TOL = 1e-5       # reported: entries beyond it after 3 steps
DP_SEED = 123             # the bank draws' generator in [dp]
DP_CASES = [("fused", "host", 0.0), ("fused", "bank", 0.0),
            ("autograd", "host", 0.0), ("autograd", "bank", 0.0),
            ("fused", "bank", RATE), ("autograd", "bank", RATE)]


def _raises_naming(what: str, name: str, fn) -> str:
    """[profile]: fn() must raise FloatingPointError whose message names
    `name`; returns the message."""
    import torch
    try:
        fn()
        torch.cuda.synchronize()
    except FloatingPointError as e:
        if name not in str(e):
            raise RuntimeError(f"[profile] {what}: the NaN checker named "
                               f"another op: {e}") from e
        log(f"[profile] debug_nans, {what}: FloatingPointError({e})")
        return str(e)
    raise RuntimeError(f"[profile] {what}: no FloatingPointError")


def _same(a, b) -> bool:
    """Bitwise equality of two nests of tensors, lists and dicts."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def profile_phase(dev, card, decoder, apply, z0, p20, ft_args,
                  batch: tuple, ad_cfg, sd, codes, ms: dict) -> dict:
    """[profile] utils/profiling on the card, on the committed 8x512 chair
    decoder with TF32 off.

    debug_nans: one fused pass of #4 at 64 x 16,384 with one sdf label
    NaN, #3's layer entry on a [2^20, 512] fp32 product with one NaN row,
    #3b's on a cotangent with one and #1 through KernelApply with a NaN
    code each raise FloatingPointError naming the kernel; the healthy fused pass and one autograd-route step (#3/#3b)
    are bit-equal with the checker and without; the healthy pass's time
    with the checker beside its time without (a record, not a gate).
    cost_analysis: one #4 pass, one #1 launch at 2^20 points and one #2
    launch (one code, 2^20 points) each count their plain version's FLOPs
    within 1%; each count over the time [kernel] / [fused_train] /
    [dropout] measured, as TFLOP/s (GB/s for #3/#3b). trace: one fused
    pass and one 256^3 decode; the .pt.trace.json names tn_gemm_kernel,
    mn_wgrad_kernel and fused_eval_kernel. `ms` holds those earlier
    times; `batch` the [fused_train] batch (ids, xyz, sdf)."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        fused_train as ft, relu_dropout as rd)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        hoisted_rows, make_kernel_apply_pairs)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        fast_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_eval_op import (
        packed_plain)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_hierarchical3_sparse2)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        _default_caps)
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
        init_ad_state, make_ad_train_step)
    from latent_diffusion_models_for_shape_sdfs_torch.utils import (
        profiling as prof)

    t0 = time.perf_counter()
    out: dict = {"card": card}
    nan = float("nan")

    # ---- debug_nans: a NaN reaching each kernel
    ew, z, xyz, sdf = ft_args[:4]
    sdf_nan = sdf.clone()
    sdf_nan.view(-1)[12345] = nan
    bad_args = (ew, z, xyz, sdf_nan, *ft_args[4:])
    yf = torch.randn(1 << 20, 512, device=dev)
    b512 = torch.randn(512, device=dev)
    h512 = rd.bias_relu_dropout_fwd(yf, b512, 1, RATE)
    g_nan = torch.randn(1 << 20, 512, device=dev).to(torch.bfloat16)
    yf[777] = nan
    g_nan[778] = nan
    f_nan = apply.bind(torch.full_like(z0, nan))     # rows hoisted here
    msgs = {}
    with prof.debug_nans():
        msgs["fused_train"] = _raises_naming(
            "#4, one sdf label NaN", "fused_train",
            lambda: ft.fused_train_loss_grads(*bad_args))
        msgs["relu_dropout_fwd"] = _raises_naming(
            "#3, one NaN row of a [2^20, 512] fp32 product",
            "relu_dropout_fwd",
            lambda: rd.bias_relu_dropout_fwd(yf, b512, 1, RATE))
        msgs["relu_dropout_bwd"] = _raises_naming(
            "#3b, one NaN row of a [2^20, 512] bf16 cotangent",
            "relu_dropout_bwd",
            lambda: rd.relu_dropout_bwd_out(h512, g_nan, RATE))
        msgs["fused_eval"] = _raises_naming(
            "#1 through KernelApply, a NaN code", "fused_eval",
            lambda: f_nan(p20))
    out["nan_messages"] = msgs
    del sdf_nan, bad_args, yf, h512, g_nan, f_nan

    # ---- debug_nans: healthy work is bit-equal with the checker on
    plain_pass = ft.fused_train_loss_grads(*ft_args)
    with prof.debug_nans():
        checked_pass = ft.fused_train_loss_grads(*ft_args)
    same_pass = _same(plain_pass, checked_pass)
    del plain_pass, checked_pass
    steps = []
    for checked in (False, True):
        state = init_ad_state(ad_cfg, params=sd, codes=codes[:64],
                              device=dev)
        step = make_ad_train_step(state.decoder, ad_cfg)
        n0 = launch_record().copy()
        with prof.debug_nans(checked):
            m = step(state, *batch, 0.0, 4242)
            torch.cuda.synchronize()
        launched = launched_since(n0, RD)
        steps.append(({k: v for k, v in m.items()
                       if isinstance(v, torch.Tensor)},
                      state.decoder.state_dict(), state.codes.detach()))
        del state, step
    same_step = _same(steps[0], steps[1])
    if min(launched.values()) < 1:
        raise RuntimeError(f"[profile] the autograd step launched {launched}")
    del steps
    ms_plain = time_ms(lambda: ft.fused_train_loss_grads(*ft_args), 3)
    with prof.debug_nans():
        ms_checked = time_ms(lambda: ft.fused_train_loss_grads(*ft_args), 3)
    log(f"[profile] debug_nans, healthy work: the fused pass bit-equal with "
        f"the checker and without: {same_pass}; one autograd-route step "
        f"(#3/#3b launched {launched}) bit-equal: {same_step}; the fused "
        f"pass {ms_checked:.2f} ms with the checker, {ms_plain:.2f} ms "
        f"without [{card}]")
    if not (same_pass and same_step):
        raise RuntimeError("[profile] the NaN checker changed a result")
    out.update(same_pass=same_pass, same_step=same_step,
               pass_ms_checked=ms_checked, pass_ms_plain=ms_plain)

    # ---- cost_analysis: each kernel's count against its plain version's
    pairs1 = make_kernel_apply_pairs(decoder, sd, device=dev)
    table1 = pairs1.table(z0[None])
    sids1 = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    cases = {
        "fused_train": (lambda: ft.fused_train_loss_grads(*ft_args),
                        lambda: ft.fused_train_reference(*ft_args),
                        ms["fused_train"]),
        "fused_eval": (lambda: apply(z0, p20),
                       lambda: fast_apply(apply.ew, z0, p20),
                       ms["fused_eval"]),
        "fused_eval_pairs": (lambda: pairs1.launch(table1, sids1, p20),
                             lambda: fast_apply(pairs1.ew, z0[None].expand(
                                 1 << 20, -1), p20),
                             ms["fused_eval_pairs"])}
    counts = {}
    for name, (kernel, plain, k_ms) in cases.items():
        got = prof.cost_analysis(kernel)
        want = prof.cost_analysis(plain)
        rel = abs(got["flops"] / want["flops"] - 1)
        counts[name] = dict(flops=got["flops"], bytes=got["bytes accessed"],
                            plain_flops=want["flops"], rel=rel, ms=k_ms,
                            tflops=got["flops"] / k_ms / 1e9)
        log(f"[profile] cost_analysis {name}: {got['flops']:.6e} FLOPs, "
            f"{got['bytes accessed']:.6e} bytes; plain version "
            f"{want['flops']:.6e} FLOPs ({100 * rel:.3f}% apart, tol 1%); "
            f"over its {k_ms:.3f} ms: {counts[name]['tflops']:.1f} TFLOP/s "
            f"[{card}]")
        if rel > 0.01:
            raise RuntimeError(f"[profile] {name} counts {got} against its "
                               f"plain version's {want}")
    # #1 counts the padded widths it multiplies: its op's own plain version
    # on the packed operands counts the same; fast_apply, above, the true
    rows0 = hoisted_rows(apply.ew, apply.meta, z0)
    op = prof.cost_analysis(apply.launch, p20, rows0)["flops"]
    packed = prof.cost_analysis(packed_plain, p20, apply.w, rows0,
                                apply.meta_t, apply.ew.use_tanh)["flops"]
    log(f"[profile] cost_analysis fused_eval's op alone {op:.6e} FLOPs, "
        f"packed_plain on the same operands {packed:.6e}")
    if op != packed:
        raise RuntimeError(f"[profile] #1's op counts {op}, packed_plain "
                           f"{packed}")
    del pairs1, table1, sids1, rows0
    yf = torch.randn(1 << 20, 512, device=dev)
    h512 = rd.bias_relu_dropout_fwd(yf, b512, 1, RATE)
    g512 = torch.randn_like(h512)
    for name, fn, k_ms in (
            ("relu_dropout_fwd",
             lambda: rd.bias_relu_dropout_fwd(yf, b512, 1, RATE),
             ms["relu_dropout_fwd"]),
            ("relu_dropout_bwd",
             lambda: rd.relu_dropout_bwd_out(h512, g512, RATE),
             ms["relu_dropout_bwd"])):
        got = prof.cost_analysis(fn)
        counts[name] = dict(flops=got["flops"], bytes=got["bytes accessed"],
                            ms=k_ms, gbps=got["bytes accessed"] / k_ms / 1e6)
        log(f"[profile] cost_analysis {name}'s layer entry at [2^20, 512]: "
            f"{got['flops']:.0f} FLOPs (its plain version counts none), "
            f"{got['bytes accessed']:.6e} bytes; over its {k_ms:.3f} ms: "
            f"{counts[name]['gbps']:.0f} GB/s [{card}]")
    del yf, b512, h512, g512
    out["cost"] = counts

    # ---- trace: one fused pass and one 256^3 decode
    cap1, cap2, cap3 = _default_caps(RES)
    with tempfile.TemporaryDirectory() as td:
        with prof.trace(td):
            # the profiler can drop a trace's first launches (~28 seen)
            warm = torch.ones(1, device=dev)
            for _ in range(64):
                warm.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            ft.fused_train_loss_grads(*ft_args)
            decode_grid_hierarchical3_sparse2(
                apply, z0, RES, cap1=cap1, cap2=cap2, cap3=cap3,
                safety=1.2, safety3=2.0)
            torch.cuda.synchronize()
        files = list(pathlib.Path(td).glob("*.pt.trace.json"))
        if len(files) != 1:
            raise RuntimeError(f"[profile] trace wrote {files}")
        size = files[0].stat().st_size
        names = {e.get("name", "") for e in json.loads(
            files[0].read_text())["traceEvents"]}
    found = {k: sum(k in n for n in names)
             for k in ("tn_gemm_kernel", "mn_wgrad_kernel",
                       "fused_eval_kernel")}
    log(f"[profile] trace of one fused pass and one {RES}^3 decode: "
        f"{files[0].name}, {size} bytes; kernel names found {found}")
    if not all(found.values()):
        raise RuntimeError(f"[profile] the trace lacks a kernel: {found}")
    out.update(trace_bytes=size, trace_names=found,
               s=time.perf_counter() - t0)
    log(f"[profile] {out['s']:.1f} s")
    return out


RD = ("relu_dropout_fwd", "relu_dropout_bwd")               # #3, #3b
TRAIN_KERNELS = (*RD, "fused_train", "gemm_fwd", "gemm_dgrad", "gemm_wgrad",
                 "layer0")                                  # and #4's roles
ROLES = ("fwd", "dgrad", "wgrad")
HEAD = ("head_fwd", "head_bwd")                             # csrc/head.cu
DECODER_INPUT = ("decoder_input.fwd", "decoder_input.bwd", "skip_input.fwd",
                 "skip_input.bwd")                  # csrc/decoder_input.cu


def launch_record():
    """The port's one launch record, utils.profiling.LAUNCHES: a Counter of
    the launches of every kernel, and of the hidden layers' cuBLAS
    products, by name."""
    from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
    return profiling.LAUNCHES


def launched_since(before, names) -> dict:
    """{name: the record's count of `name` since `before`}, `before` a copy
    of the record ({} for the last reset_train_launches)."""
    rec = launch_record()
    return {k: rec[k] - before.get(k, 0) for k in names}


def reset_train_launches() -> None:
    """Zero the launch record: every kernel's launches and the hidden
    layers' products."""
    launch_record().clear()


def train_launches() -> dict:
    """The launches of kernels #3/#3b, #4 and #4's roles (layer 0 among
    them) since the last reset_train_launches."""
    return launched_since({}, TRAIN_KERNELS)


def tc_products(kind: str = "") -> dict:
    """The hidden layers' products made on the tensor cores, by role,
    since the last reset_train_launches; `kind` ".padded": those made on
    padded operands."""
    rec = launch_record()
    return {k: rec[f"bf16_linear.{k}{kind}"] for k in ROLES}


@contextlib.contextmanager
def hidden_layers_through(fn, head=None):
    """Inside the block the package's SdfDecoder.forward makes its bf16
    hidden layers' products through `fn` in place of ops.bf16_linear (the
    plain version, the float64 witness), on the unpadded layout
    (ops.bf16_linear.pads off): with dropout through the kernels each
    layer is `fn`'s product composed with the cast to bf16 and
    relu_dropout (ops.bf16_linear.bf16_linear_relu_dropout_reference) in
    place of the fused layer. `fn` ops.bf16_linear.bf16_linear leaves the
    package's route as it is; `fn`
    ops.bf16_linear.bf16_linear_relu_dropout_reference takes the place of
    the fused layer itself, on the layout the package's route runs. The
    bf16 head goes through `head` in place of ops.head.bf16_head where
    `head` is given (else the head keeps csrc/head.cu)."""
    from latent_diffusion_models_for_shape_sdfs_torch.models import (
        decoder as decoder_module)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl, head as hd)
    swaps = []
    if fn is bl.bf16_linear_relu_dropout_reference:
        swaps.append((decoder_module, "bf16_linear_relu_dropout", fn))
    elif fn is not bl.bf16_linear:
        swaps += [
            (bl, "pads", lambda t: False),
            (decoder_module, "bf16_linear", fn),
            (decoder_module, "bf16_linear_relu_dropout",
             lambda x, w, b, seed, rate, runs:
             bl.bf16_linear_relu_dropout_reference(x, w, b, seed, rate,
                                                   linear=fn))]
    if head is not None:
        swaps.append((hd, "bf16_head", head))
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, v in swaps:
        setattr(m, k, v)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def col_sums64(t) -> tuple:
    """(sum, sum of |.|) of each column of a [rows, cols] tensor in float64,
    a chunk of rows at a time."""
    import torch
    s = torch.zeros(t.shape[1], dtype=torch.float64, device=t.device)
    a = torch.zeros_like(s)
    for r in range(0, t.shape[0], 1 << 16):
        c = t[r:r + (1 << 16)].double()
        s += c.sum(0)
        a += c.abs().sum(0)
    return s, a


def db_distance(db, gb) -> float:
    """Largest |db - exact| / sum |terms| over the columns of gb."""
    exact, abs_sum = col_sums64(gb)
    return float(((db.double() - exact).abs()
                  / abs_sum.clamp(min=1e-300)).max())


def peak_step_gib(fn) -> tuple:
    """(peak GiB, rise over what was allocated before) of one call."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 2 ** 30, (peak - before) / 2 ** 30


def round_to_odd_f32(t):
    """float64 -> float32 rounded to odd: toward zero, then the last bit
    set where that was inexact. A float32 so rounded rounds to bf16 as
    the float64 would in one step (24 bits >= 8 + 2); torch's float64 ->
    bf16 cast rounds through float32 twice."""
    import torch
    r = t.float()
    r = torch.where(r.double().abs() > t.abs(),
                    torch.nextafter(r, torch.zeros_like(r)), r)
    odd = (r.view(torch.int32) | 1).view(torch.float32)
    return torch.where(r.double() != t, odd, r)


def bf16_linear_float64(x, w, b):
    """The witness: a hidden layer's products of the same bf16 operands
    summed in float64, each output rounded once from its float64 sum:
    the forward to float32 by round_to_odd_f32, so that the decoder's
    bf16 cast is the one rounding of the exact sum; dx and dW to bf16
    through the same; db to float32."""
    return _float64_linear_class().apply(x, w, b)


@functools.cache
def _float64_linear_class():
    import torch

    class Float64Linear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            x2, wb = x.reshape(-1, x.shape[-1]), w.to(torch.bfloat16)
            ctx.save_for_backward(x2, wb)
            ctx.x_shape = x.shape
            y = torch.addmm(b.double(), x2.double(), wb.double().t())
            return round_to_odd_f32(y).reshape(*x.shape[:-1], w.shape[0])

        @staticmethod
        def backward(ctx, g):
            x2, wb = ctx.saved_tensors
            g64 = g.reshape(-1, g.shape[-1]).double()
            dx = round_to_odd_f32(g64 @ wb.double()).to(torch.bfloat16)
            dw = round_to_odd_f32(g64.t() @ x2.double()).to(
                torch.bfloat16).float()
            return dx.reshape(ctx.x_shape), dw, g64.sum(0).float()

    return Float64Linear


def step_grads(decoder, cfg, codes, ids, xyz, sdf, epoch: float, seed: int,
               hidden, head=None) -> tuple:
    """One autograd step's loss and gradients (decoder parameters and the
    code table, by name) with the hidden layers through `hidden` and the
    head through `head` (hidden_layers_through); leaves no gradient
    behind."""
    from latent_diffusion_models_for_shape_sdfs_torch import losses
    from latent_diffusion_models_for_shape_sdfs_torch.models.latent_table \
        import gather_codes
    decoder.train()
    decoder.zero_grad(set_to_none=True)
    table = codes.detach().clone().requires_grad_()
    with hidden_layers_through(hidden, head):
        z = gather_codes(table, ids, cfg.code_bound)
        L = z.shape[-1]
        flat_z = z[:, None, :].expand(z.shape[0], xyz.shape[1], L)
        pred = decoder(flat_z.reshape(-1, L), xyz.reshape(-1, 3), seed=seed)
        loss = losses.clamped_l1(pred, sdf.reshape(-1), cfg.clamp_dist,
                                 sdf.numel()) + losses.code_reg(
            z, epoch, cfg.code_reg_lambda, cfg.code_reg_warmup_epochs,
            num_sdf_samples=z.shape[0], squared=cfg.code_reg_squared)
        loss.backward()
    grads = {"codes": table.grad}
    grads.update((k, p.grad) for k, p in decoder.named_parameters())
    decoder.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def grad_distance(g: dict, ref: dict) -> dict:
    """Per gradient, max |g - ref| over max |ref|."""
    return {k: float((g[k] - ref[k]).abs().max())
            / max(float(ref[k].abs().max()), 1e-30) for k in ref}


def tc_vs_plain_step(decoder, cfg, codes, ids, xyz, sdf, epoch: float,
                     seed: int, tag: str, card: str, case: str,
                     gate: str | None) -> dict:
    """One autograd step's loss and gradients (decoder parameters and the
    code table) from the same state, batch and dropout masks with the
    hidden layers three ways: on the tensor cores (ops.bf16_linear, the
    package's route, the head through csrc/head.cu), in the plain form
    (fp32 products of the same bf16 values, the head's too) and in float64
    (the witness, bf16_linear_float64, the head's too). The products are
    the same and only the sums' order and width move. Each
    form's distance from the witness is recorded per gradient (max |g -
    g_64| over max |g_64|). Gates: the loss within TRAIN_LOSS_RTOL of the
    plain form's; `gate` "plain" (far from the optimum: codes of other
    chairs) every gradient within TRAIN_GRAD_TOL of its max of the plain
    form's; `gate` "witness" (at the committed pack's optimum, the chairs'
    own codes, where the batch gradient nearly cancels and the sums'
    share of it grows) every gradient's distance from the witness at most
    WITNESS_RATIO times the plain form's, or WITNESS_FLOOR of its max
    where the plain form's is smaller; None records only. Leaves no
    gradient behind."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear \
        import bf16_linear, bf16_linear_reference
    (loss_tc, g_tc), (loss_pl, g_pl), (loss_64, g_64) = [
        step_grads(decoder, cfg, codes, ids, xyz, sdf, epoch, seed, hidden,
                   head)
        for hidden, head in ((bf16_linear, None),
                             (bf16_linear_reference, bf16_linear_reference),
                             (bf16_linear_float64, bf16_linear_float64))]
    rel = grad_distance(g_tc, g_pl)
    d_tc, d_pl = grad_distance(g_tc, g_64), grad_distance(g_pl, g_64)
    worst = max(rel, key=rel.get)
    ratio = {k: d_tc[k] / max(d_pl[k], WITNESS_FLOOR) for k in d_tc}
    far = max(ratio, key=ratio.get)
    out = dict(case=case, gate=gate, loss=loss_tc, loss_plain=loss_pl,
               loss_float64=loss_64,
               loss_rel=abs(loss_tc - loss_pl) / abs(loss_pl),
               worst_grad=worst, worst_grad_rel=rel[worst], grad_rel=rel,
               tc_from_float64=d_tc, plain_from_float64=d_pl,
               max_tc_from_float64=max(d_tc.values()),
               max_plain_from_float64=max(d_pl.values()),
               worst_ratio_grad=far, worst_ratio=ratio[far])
    log(f"[{tag}] one config-3 step ({case}) with the hidden layers on the "
        f"bf16 tensor cores vs the plain form (fp32 products of the same "
        f"bf16 values), same state, batch and masks: loss {loss_tc:.7f} vs "
        f"{loss_pl:.7f} ({out['loss_rel']:.2e} rel), worst gradient "
        f"{worst} {rel[worst]:.2e} of its max; from the float64 witness "
        f"(loss {loss_64:.7f}): tensor cores {out['max_tc_from_float64']:.2e}"
        f", plain form {out['max_plain_from_float64']:.2e} (worst of each), "
        f"{far} {d_tc[far]:.2e} vs {d_pl[far]:.2e} the largest ratio "
        f"{ratio[far]:.2f}; gates: loss {TRAIN_LOSS_RTOL}, "
        + {"plain": f"every gradient {TRAIN_GRAD_TOL} of its max",
           "witness": f"every gradient's distance from the witness <= "
                      f"{WITNESS_RATIO} x the plain form's (floor "
                      f"{WITNESS_FLOOR})",
           None: "gradients recorded"}[gate] + f" [{card}]")
    ok = out["loss_rel"] <= TRAIN_LOSS_RTOL and {
        "plain": rel[worst] <= TRAIN_GRAD_TOL,
        "witness": ratio[far] <= WITNESS_RATIO, None: True}[gate]
    if not ok:
        raise RuntimeError(f"[{tag}] tensor-core step vs plain form: {out}")
    return out


def layer_vs_parent_step(decoder, cfg, codes, ids, xyz, sdf, epoch: float,
                         seed: int, tag: str, card: str) -> dict:
    """One autograd step's loss and gradients from the same state, batch
    and masks through the package's route (the hidden layers as
    ops.bf16_linear.bf16_linear_relu_dropout: kernels #3/#3b's layer
    entries) and through its composition
    (bf16_linear_relu_dropout_reference: bf16_linear, the cast,
    relu_dropout) on the same layout. Gates: the loss and every
    gradient but the hidden biases bit for bit; each hidden layer's db
    (the bias gradient, #3b's column sums of its gb, recorded as it runs)
    within DB_TOL of its columns' sums of |gb| from their float64 sums,
    and the two forms' bias gradients within 2 DB_TOL of it apart."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl, relu_dropout as rd)
    seen = []
    real = rd.relu_dropout_bwd_out

    def recorded(out, g, rate):
        gb, db = real(out, g, rate)
        seen.append((db_distance(db, gb), col_sums64(gb)[1], db))
        return gb, db

    rd.relu_dropout_bwd_out = recorded
    try:
        loss_n, g_n = step_grads(decoder, cfg, codes, ids, xyz, sdf, epoch,
                                 seed, bl.bf16_linear)
    finally:
        rd.relu_dropout_bwd_out = real
    loss_p, g_p = step_grads(decoder, cfg, codes, ids, xyz, sdf, epoch, seed,
                             bl.bf16_linear_relu_dropout_reference)
    n_hidden = len(decoder.layer_dims()) - 1
    hidden_b = {f"lin{i}.b" for i in range(n_hidden)}
    same = {k: torch.equal(g_n[k], g_p[k]) for k in g_n if k not in hidden_b}
    db_rel, apart, own = {}, {}, True
    for j, (dist, abs_sum, db) in enumerate(seen):
        k = f"lin{n_hidden - 1 - j}.b"
        w = g_n[k].shape[0]         # the padded layout's columns hold 0
        own = own and torch.equal(g_n[k], db[:w]) and not db[w:].any()
        db_rel[k] = dist
        apart[k] = float(((g_n[k].double() - g_p[k].double()).abs()
                          / abs_sum[:w].clamp(min=1e-300)).max())
    out = dict(loss=loss_n, loss_parent=loss_p, loss_equal=loss_n == loss_p,
               grads_equal=all(same.values()),
               unequal=[k for k, v in same.items() if not v],
               db_from_float64=db_rel, db_apart=apart,
               max_db_from_float64=max(db_rel.values(), default=0.0),
               max_db_apart=max(apart.values(), default=0.0))
    log(f"[{tag}] one config-3 step through the fused layer (#3/#3b layer "
        f"entries) vs the composed form (bf16_linear, cast, "
        f"relu_dropout), same state, batch and masks: loss {loss_n:.7f} vs "
        f"{loss_p:.7f}, equal {out['loss_equal']}; every gradient but the "
        f"{n_hidden} hidden biases bit-equal: {out['grads_equal']} "
        f"{out['unequal']}; hidden db from float64 at most "
        f"{out['max_db_from_float64']:.2e} of the column's sum |gb| (gate "
        f"{DB_TOL:.2e}), the two forms' at most {out['max_db_apart']:.2e} "
        f"apart [{card}]")
    if not (out["loss_equal"] and out["grads_equal"] and own
            and len(seen) == n_hidden
            and out["max_db_from_float64"] <= DB_TOL
            and out["max_db_apart"] <= 2 * DB_TOL):
        raise RuntimeError(f"[{tag}] fused layer vs the composed form: "
                           f"{out}")
    return out


def bf16_spacing(t):
    """The bf16 spacing at |t| (the smallest normal's where t is 0)."""
    import torch
    e = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def head_vs_plain_step(decoder, cfg, codes, ids, xyz, sdf, epoch: float,
                       seed: int, tag: str, card: str) -> dict:
    """One autograd step of the package's route with the fp32 head's
    operands, cotangent and gradients recorded as csrc/head.cu gives them
    (ops.head.bf16_head), then the head's plain form (autograd of
    bf16_linear_reference) on the same x, w, b and cotangent g. Gates: one
    launch of each pass; dx bit for bit; pred within 2 (C + 1) 2^-24 of
    each row's sum |x w| + |b|; dW within one bf16 spacing plus 2 sqrt(rows)
    2^-24 of each column's sum |g x| of the plain form's; db within
    2 sqrt(rows) 2^-24 sum |g| of g's float64 sum. A kernel that drops or
    repeats rows fails each of these. Leaves no gradient behind."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl, head as hd)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear \
        import bf16_linear_reference
    rec: dict = {}
    real = hd.bf16_head

    def recorded(x, w, b):
        w, b = w.view_as(w), b.view_as(b)    # hooks on this call's views
        y = real(x, w, b)
        rec.update(x=x.detach(), w=w.detach(), b=b.detach(), y=y.detach())
        for k, t in (("dx", x), ("dw", w), ("db", b), ("g", y)):
            t.register_hook(lambda gr, k=k: rec.__setitem__(k, gr.detach()))
        return y

    n0 = launch_record().copy()
    loss, _ = step_grads(decoder, cfg, codes, ids, xyz, sdf, epoch, seed,
                         bl.bf16_linear, recorded)
    launches = launched_since(n0, HEAD)
    x, w, b, g = rec["x"], rec["w"], rec["b"], rec["g"]
    rows, cols = x.shape
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y_p = bf16_linear_reference(xs, ws, bs)
    y_p.backward(g)
    torch.cuda.synchronize()
    u = 2.0 ** -24
    wb = w.to(torch.bfloat16).float()
    terms = (x.float().abs() @ wb.abs().t() + b.abs()).clamp(min=1e-30)
    pred_rel = float(((rec["y"] - y_p.detach()).abs() / terms).max())
    gx = g.abs().t() @ x.float().abs()
    dw_gap = (rec["dw"] - ws.grad).abs()
    dw_bound = (bf16_spacing(torch.maximum(rec["dw"].abs(), ws.grad.abs()))
                + 2 * rows ** 0.5 * u * gx)
    g64 = g.double()
    db_gap = float((rec["db"].double() - g64.sum()).abs())
    db_bound = 2 * rows ** 0.5 * u * float(g64.abs().sum())
    out = dict(rows=rows, cols=cols, loss=loss, launches=launches,
               dx_equal=bool(torch.equal(rec["dx"], xs.grad)),
               pred_max_abs=float((rec["y"] - y_p.detach()).abs().max()),
               pred_rel=pred_rel, pred_gate=2 * (cols + 1) * u,
               dw_max_abs=float(dw_gap.max()),
               dw_over_bound=float((dw_gap / dw_bound).max()),
               dw_bf16=bool(torch.equal(
                   rec["dw"], rec["dw"].to(torch.bfloat16).float())),
               db=float(rec["db"]), db_gap=db_gap, db_bound=db_bound,
               db_plain=float(bs.grad))
    log(f"[{tag}] one config-3 step ({rows} x {cols} head rows) with the "
        f"fp32 head through csrc/head.cu, launches {launches}, against the "
        f"head's plain form (bf16_linear_reference under autograd) on the "
        f"same x, w, b and cotangent: dx bit-equal {out['dx_equal']}; pred "
        f"at most {pred_rel:.2e} of its row's sum |x w| + |b| (gate "
        f"{out['pred_gate']:.2e}); dW bf16-valued {out['dw_bf16']}, at most "
        f"{out['dw_over_bound']:.3f} of its bound (one bf16 spacing + "
        f"2 sqrt(rows) 2^-24 sum |g x|); db {out['db']:.9e} (plain "
        f"{out['db_plain']:.9e}) {db_gap:.2e} from float64, bound "
        f"{db_bound:.2e} [{card}]")
    if not (launches == dict.fromkeys(HEAD, 1) and out["dx_equal"]
            and pred_rel <= out["pred_gate"] and out["dw_bf16"]
            and out["dw_over_bound"] <= 1.0 and db_gap <= db_bound):
        raise RuntimeError(f"[{tag}] head kernels vs plain form: {out}")
    del rec, xs, ws, bs, y_p
    return out


def head_alone(dev, card) -> dict:
    """csrc/head.cu's passes alone at config 3's bank step, [2^20, 512]
    (bf16 x, a loss cotangent of +-2^-20 or 0), on CUDA events: the
    forward, the backward with dx, dW and db (its reduction launch
    included), the backward with dx alone; the plain form's forward
    (x.float() and the GEMV) and its autograd backward (the K = 1 dgrad,
    dW, db and the casts); each beside its bytes bound at PEAK_HBM_BYTES
    (x read once, and dx written once where made; g and pred)."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import head as hd
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear \
        import bf16_linear_reference
    rows, cols = 1 << 20, 512
    gen = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(rows, cols, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(1, cols, generator=gen, device=dev) / cols ** 0.5
    b = torch.randn(1, generator=gen, device=dev)
    g = torch.sign(torch.round(torch.randn(rows, 1, generator=gen,
                                           device=dev))) / rows
    wb = w.to(torch.bfloat16)
    every, dx_only = (True, True, True), (True, False, False)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y_p = bf16_linear_reference(xs, ws, bs)
    out = dict(
        fwd_ms=time_ms(lambda: hd._forward(x, wb, b), 20),
        bwd_ms=time_ms(lambda: hd._backward(g, x, wb, (1,), every), 20),
        bwd_dx_ms=time_ms(lambda: hd._backward(g, x, wb, (1,), dx_only), 20),
        plain_fwd_ms=time_ms(lambda: bf16_linear_reference(x, w, b), 20),
        plain_bwd_ms=time_ms(lambda: torch.autograd.grad(
            y_p, (xs, ws, bs), g, retain_graph=True), 10),
        bound_fwd_ms=(x.nbytes + rows * 4) / PEAK_HBM_BYTES * 1e3,
        bound_bwd_ms=(2 * x.nbytes + rows * 4) / PEAK_HBM_BYTES * 1e3,
        bound_bwd_dx_ms=(x.nbytes + rows * 4) / PEAK_HBM_BYTES * 1e3)
    log(f"[bank] the fp32 head's kernels alone at [{rows}, {cols}]: forward "
        f"{out['fwd_ms']:.3f} ms (bound {out['bound_fwd_ms']:.3f}, plain "
        f"form {out['plain_fwd_ms']:.3f}), backward with dx, dW and db "
        f"{out['bwd_ms']:.3f} ms (bound {out['bound_bwd_ms']:.3f}, plain "
        f"form's autograd backward {out['plain_bwd_ms']:.3f}), dx alone "
        f"{out['bwd_dx_ms']:.3f} ms (bound {out['bound_bwd_dx_ms']:.3f}) "
        f"[{card}]")
    del x, xs, ws, bs, y_p, g
    return out


def decoder_input_alone(dev, card) -> dict:
    """csrc/decoder_input.cu's four passes alone at config 3's bank step
    (64 scenes x 16,384 points, L 256, the skip layer's x 256 wide), on
    CUDA events, beside the plain passes each replaces and its bytes bound
    at PEAK_HBM_BYTES (each row read and written once, z and xyz once;
    not the partials). The plain passes: lin0's input from the expanded
    codes (expand, cast, pad_columns); the skip cat; the add of the two
    cotangents, the cast and the per-scene sum; gx's dense copy. Gates:
    one launch of each pass in the checked call; both forwards bit for bit the cast + pad_columns (+ torch.cat), gx
    bit for bit; each dz within its fp32 sums' error (the summation's
    depth x 2^-24 x sum |d|) of the float64 per-scene sum."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        decoder_input as di)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear \
        import pad_columns
    S, P, L, W = 64, 16384, 256, 256
    N, T, bf = S * P, 264, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(28)
    z = torch.randn(S, L, generator=gen, device=dev) * 0.3
    xyz = torch.rand(S, P, 3, generator=gen, device=dev) * 2 - 1
    x = torch.randn(N, W, generator=gen, device=dev).to(bf)
    d0 = (torch.randn(N, T, generator=gen, device=dev) / P).to(bf)
    d4 = (torch.randn(N, W + T, generator=gen, device=dev) / P).to(bf)

    def plain_inp():
        zf = z[:, None, :].expand(S, P, L).reshape(N, L)
        return pad_columns([zf.to(bf), xyz.reshape(-1, 3).to(bf)])

    inp = plain_inp()
    n0 = launch_record().copy()
    got_inp, got_skip = di._rows("decoder_input.fwd", None, z, xyz), \
        di._rows("skip_input.fwd", x, z, xyz)
    gx, dz4 = di._colsum("skip_input.bwd", d4, W, S, P, L)
    _, dz0 = di._colsum("decoder_input.bwd", d0, 0, S, P, L)
    out = dict(inp_equal=bool(torch.equal(got_inp, inp)),
               skip_equal=bool(torch.equal(got_skip,
                                           torch.cat([x, inp], -1))),
               gx_equal=bool(torch.equal(gx, d4[:, :W])),
               launches=launched_since(n0, DECODER_INPUT))
    del got_inp, got_skip, gx
    for tag, dz, part, chunks in (("decoder_input", dz0, d0[:, :L], L // 8),
                                  ("skip_input", dz4, d4[:, W:W + L],
                                   (W + L) // 8)):
        # the most fp32 additions on a path: a lane's rows of a work item,
        # the lanes, the work items
        lanes = 256 // chunks
        depth = -(-di._ITEM_ROWS // lanes) + lanes + -(-P // di._ITEM_ROWS)
        p64 = part.double().reshape(S, P, L)
        gap = (dz.double() - p64.sum(1)).abs()
        bound = depth * 2.0 ** -24 * p64.abs().sum(1)
        out[f"{tag}_dz_gap"] = float((gap / bound).max())
        out[f"{tag}_dz_max_abs"] = float(gap.max())
        del p64
    fp32, bf2, mb = 4, 2, PEAK_HBM_BYTES / 1e3
    by = dict(
        decoder_input_fwd=N * T * bf2 + (S * L + N * 3) * fp32,
        decoder_input_bwd=N * L * bf2 + S * L * fp32,
        skip_input_fwd=N * W * bf2 + N * (W + T) * bf2 + (S * L + N * 3)
        * fp32,
        skip_input_bwd=N * (W + L) * bf2 + N * W * bf2 + S * L * fp32)
    out.update(
        decoder_input_fwd_ms=time_ms(
            lambda: di._rows("decoder_input.fwd", None, z, xyz), 20),
        decoder_input_bwd_ms=time_ms(
            lambda: di._colsum("decoder_input.bwd", d0, 0, S, P, L), 20),
        skip_input_fwd_ms=time_ms(
            lambda: di._rows("skip_input.fwd", x, z, xyz), 20),
        skip_input_bwd_ms=time_ms(
            lambda: di._colsum("skip_input.bwd", d4, W, S, P, L), 20),
        decoder_input_fwd_plain_ms=time_ms(plain_inp, 10),
        decoder_input_bwd_plain_ms=time_ms(
            lambda: (d0 + d4[:, W:])[:, :L].float().reshape(S, P, L).sum(1),
            10),
        skip_input_fwd_plain_ms=time_ms(lambda: torch.cat([x, inp], -1), 10),
        skip_input_bwd_plain_ms=time_ms(
            lambda: d4[:, :W].contiguous(), 10),
        **{f"{k}_bound_ms": v / mb for k, v in by.items()})
    log(f"[bank] csrc/decoder_input.cu alone at {S} x {P} points, L {L}, "
        f"x {W}: " + "; ".join(
            f"{k} {out[k + '_ms']:.3f} ms (bound {out[k + '_bound_ms']:.3f}"
            f", {100 * out[k + '_bound_ms'] / out[k + '_ms']:.1f}%; plain "
            f"{out[k + '_plain_ms']:.3f})" for k in by)
        + f"; forwards bit-equal {out['inp_equal']} / {out['skip_equal']}, "
        f"gx bit-equal {out['gx_equal']}, dz at most "
        f"{out['decoder_input_dz_gap']:.3f} / {out['skip_input_dz_gap']:.3f}"
        f" of its sums' error bound [{card}]")
    if not (out["launches"] == dict.fromkeys(DECODER_INPUT, 1)
            and out["inp_equal"] and out["skip_equal"] and out["gx_equal"]
            and out["decoder_input_dz_gap"] <= 1.0
            and out["skip_input_dz_gap"] <= 1.0):
        raise RuntimeError(f"[bank] csrc/decoder_input.cu vs the plain "
                           f"passes: {out}")
    del z, xyz, x, d0, d4, inp
    return out


def check_bank(bank, sdf_fn_of, n: int, tag: str) -> dict:
    """A bank's contract: counts in (0, n], each side's first `count` rows
    of its sign where both sides hold rows (pos + neg == n), and labels
    equal to the analytic SDF of their rows (scenes 0-3)."""
    import torch
    pc, nc = bank.pos_count.long(), bank.neg_count.long()
    ar = torch.arange(n, device=pc.device)
    split = (pc + nc == n)[:, None]
    bad_pos = (split & (ar < pc[:, None]) & (bank.pos[..., 3] < 0)).sum()
    bad_neg = (split & (ar < nc[:, None]) & (bank.neg[..., 3] >= 0)).sum()
    counts_ok = bool(((pc > 0) & (pc <= n) & (nc > 0) & (nc <= n)).all())
    label_err = 0.0
    for i in range(4):
        rows = bank.pos[i:i + 1]
        label_err = max(label_err, float(
            (sdf_fn_of(i)(rows[..., :3]) - rows[..., 3]).abs().max()))
    out = dict(bad_pos=int(bad_pos), bad_neg=int(bad_neg),
               counts_ok=counts_ok, fallback=int((~split).sum()),
               label_err=label_err,
               pos_share=float(pc.sum()) / (n * pc.numel()))
    if out["bad_pos"] or out["bad_neg"] or not counts_ok \
            or label_err > 1e-6:
        raise RuntimeError(f"[bank] {tag} bank breaks its contract: {out}")
    return out


def bank_phase(dev, card, host_ms: float, k4_ms: float) -> dict:
    """[bank] stage 1 from the on-device sample bank (AdConfig.device_data)
    at the committed packs' scale: the chair bank built by
    bank_from_chairs, one epoch of the fused route from the chair pack
    (traced again for the busy share; no host sync in steps 2-4), 10
    steps of the autograd route, and the CSG bank from the multicat pack.
    `host_ms`, `k4_ms`: this run's host-fed fused step ([train]) and
    kernel #4 alone ([fused_train]), logged beside the bank route's."""
    import dataclasses
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        bf16_linear as bl)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear \
        import bf16_linear_reference
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder \
        import init_ad_state, make_bank_step, train_auto_decoder
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import load_stage1_pack

    out: dict = {"launches": {}}
    t_phase = time.perf_counter()
    ad3 = ExperimentConfig.load(ROOT / "configs" / "config3_chairs_joint").ad
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    shapes = analytic.make_synthetic_split("chair", 6145, seed=11)[:6144]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = adv.bank_from_chairs(shapes, 11, BANK_N, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = adv.pack_chairs(shapes[:4], device=dev)
    chk = check_bank(bank, lambda i: (lambda x, p=params.slice(i, 1):
                                      adv.chair_sdf(p, x)), BANK_N, "chair")
    out["chair"] = dict(build_s=build_s, gib=bank.nbytes / 2 ** 30,
                        check=chk)
    log(f"[bank] chair bank of {len(shapes)} chairs (make_synthetic_split("
        f"'chair', 6145, seed=11)[:6144]) x {BANK_N} samples, built on the "
        f"card by bank_from_chairs in {build_s:.2f} s: "
        f"{bank.nbytes / 2 ** 30:.3f} GiB; positive share "
        f"{chk['pos_share']:.3f}, {chk['fallback']} one-sided scenes, "
        f"labels vs chair_sdf max {chk['label_err']:.1e} [{card}]")

    # ---- the fused route (#4), one epoch from the committed chair pack
    fused = dataclasses.replace(ad3, num_scenes=len(shapes), num_epochs=1,
                                device_data=True, use_pallas=True)
    state = init_ad_state(fused, params=sd, codes=codes, device=dev)
    events, l1 = [], []

    def on_step(i, epoch, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        l1.append(m["loss_l1"])
        if i == 1:          # steps 2-4: any host sync raises
            torch.cuda.set_sync_debug_mode("error")
        elif i == 4:
            torch.cuda.set_sync_debug_mode(0)

    reset_train_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        train_auto_decoder(fused, None, state=state, device=dev, bank=bank,
                           on_step=on_step)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    wall = time.perf_counter() - t0
    launches = train_launches()
    ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    l1 = [float(v) for v in l1]
    traced = dataclasses.replace(fused, num_epochs=2)
    twall, busy, top = device_profile(lambda: train_auto_decoder(
        traced, None, state=state, start_epoch=1, device=dev, bank=bank))
    out["fused"] = dict(steps=len(events), ms_per_step=ms,
                        wall_s=wall, loss_l1=l1[:4] + l1[-2:],
                        step0_loss_l1=l1[0], launches=launches,
                        sync_free_steps=[2, 3, 4],
                        trace=dict(wall_s=twall, device_busy_ms=busy,
                                   busy_share=busy / (twall * 1e3),
                                   top=top[:12]))
    out["launches"]["fused_epoch"] = launches
    log(f"[bank] fused route (#4) from the bank, config 3's ad block "
        f"(8x{ad3.decoder.hidden_dim} bf16, dropout "
        f"{ad3.decoder.dropout_prob}, {ad3.scenes_per_batch} x "
        f"{ad3.samples_per_scene} a step) from the committed chair pack, "
        f"one epoch of {len(events)} steps: {ms:.2f} ms/step on the card's "
        f"clock (steps 1-{len(events) - 1}), {wall:.2f} s wall; host-fed "
        f"{host_ms:.1f} ms/step ([train]), #4 alone {k4_ms:.2f} ms "
        f"([fused_train]); step-0 loss_l1 "
        f"{l1[0]:.5f} (gate < {BANK_GATES['chair']}), last "
        f"{l1[-1]:.5f}; launches {launches}; steps 2-4 under "
        f"set_sync_debug_mode('error'): no host sync [{card}]")
    log_profile("bank", f"one traced epoch ({len(events)} steps) of the "
                "fused route from the bank", twall, busy, top, card)
    want = {"fused_train": len(events), "gemm_fwd": 7 * len(events),
            "gemm_dgrad": 7 * len(events), "gemm_wgrad": 7 * len(events),
            "layer0": len(events), "relu_dropout_fwd": 0,
            "relu_dropout_bwd": 0}
    if launches != want:
        raise RuntimeError(f"[bank] fused route launches {launches}, "
                           f"expected {want}")
    if not (l1[0] < BANK_GATES["chair"] and np.isfinite(l1).all()):
        raise RuntimeError(f"[bank] chair bank: step-0 loss_l1 {l1[0]}")
    del state
    torch.cuda.empty_cache()

    # ---- the autograd route (#3/#3b), 10 steps from the same bank
    auto = dataclasses.replace(fused, use_pallas=False)
    st = init_ad_state(auto, params=sd, codes=codes, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(auto.seed)
    step = make_bank_step(st.decoder, auto, bank, gen)
    ids = torch.from_numpy(np.random.default_rng(auto.seed + 1).permutation(
        len(shapes))[:640].astype(np.int64)).to(dev).reshape(10, -1)
    reset_train_launches()
    events, l1a = [], []
    try:
        for i in range(10):
            if i == 2:
                torch.cuda.set_sync_debug_mode("error")
            m = step(st, ids[i], 0.0, 1000 + i)
            if i == 4:
                torch.cuda.set_sync_debug_mode(0)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            l1a.append(m["loss_l1"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    la = train_launches()
    products = tc_products()
    padded = tc_products(".padded")
    head = launched_since({}, HEAD)
    inputs = launched_since({}, DECODER_INPUT)
    ms_a = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    l1a = [float(v) for v in l1a]
    n_hidden = len(st.decoder.layer_dims()) - 1
    out["autograd"] = dict(steps=10, ms_per_step=ms_a, loss_l1=l1a,
                           launches=la, tc_products=products,
                           padded_products=padded, head_launches=head,
                           input_launches=inputs)
    out["launches"]["autograd"] = la
    log(f"[bank] autograd route (#3/#3b, hidden layers on the bf16 tensor "
        f"cores) from the bank: 10 steps, {ms_a:.1f} ms/step (steps 1-9), "
        f"step-0 loss_l1 {l1a[0]:.5f}, launches {la}, tensor-core products "
        f"{products}, of them on padded operands {padded} (lin0, lin3 and "
        f"the skip layer); the fp32 head's kernels {head}; the input and "
        f"skip rows from the codes {inputs}; steps 2-4 without host sync "
        f"[{card}]")
    if la["relu_dropout_fwd"] != 80 or la["relu_dropout_bwd"] != 80 \
            or la["fused_train"] or not l1a[0] < BANK_GATES["chair"] \
            or products != {k: 10 * n_hidden
                            for k in ("fwd", "dgrad", "wgrad")} \
            or padded != {k: 30 for k in ("fwd", "dgrad", "wgrad")} \
            or head != dict.fromkeys(HEAD, 10) \
            or inputs != dict.fromkeys(DECODER_INPUT, 10):
        raise RuntimeError(f"[bank] autograd route: {out['autograd']}")
    # the composed form of the same route (bf16_linear, the cast,
    # relu_dropout: the bias add, casts and db sum as passes of their own),
    # 3 steps timed beside it; one step of each for its peak memory
    events = []
    with hidden_layers_through(bl.bf16_linear_relu_dropout_reference):
        parent = make_bank_step(st.decoder, auto, bank, gen)
        for i in range(3):
            parent(st, ids[i], 0.0, 1100 + i)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
        peak_p = peak_step_gib(lambda: parent(st, ids[5], 0.0, 1105))
    ms_c = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    peak_a = peak_step_gib(lambda: step(st, ids[6], 0.0, 1106))
    out["parent_composition"] = dict(steps=3, ms_per_step=ms_c,
                                     peak_gib=peak_p[0],
                                     step_rise_gib=peak_p[1])
    out["autograd"].update(peak_gib=peak_a[0], step_rise_gib=peak_a[1])
    log(f"[bank] the same route in the composed form (bf16_linear, the "
        f"cast, relu_dropout): {ms_c:.1f} ms/step (steps 1-2 of 3), against "
        f"{ms_a:.1f} through the fused layer; one step's peak memory "
        f"{peak_p[0]:.2f} GiB ({peak_p[1]:.2f} over what the step found "
        f"allocated) against {peak_a[0]:.2f} ({peak_a[1]:.2f}) [{card}]")
    if not ms_a < ms_c:
        raise RuntimeError(f"[bank] the fused layer's route ({ms_a:.1f} "
                           f"ms/step) is not faster than the composed "
                           f"form ({ms_c:.1f})")
    # the same route's steps with the hidden layers in the plain form
    # (fp32 SIMT products), timed in this run beside it; then one step of
    # each held against the other
    events = []
    products = tc_products()
    with hidden_layers_through(bf16_linear_reference):
        plain = make_bank_step(st.decoder, auto, bank, gen)
        for i in range(3):
            plain(st, ids[i], 0.0, 2000 + i)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
    ms_p = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    if tc_products() != products:
        raise RuntimeError("[bank] the plain form made tensor-core products")
    out["plain_form"] = dict(steps=3, ms_per_step=ms_p)
    log(f"[bank] the same route with the hidden layers in the plain form "
        f"(fp32 products, TF32 off): {ms_p:.1f} ms/step (steps 1-2 of 3), "
        f"against {ms_a:.1f} on the tensor cores [{card}]")
    xyz_b, sdf_b = bank.sample_batch(gen, ids[3], auto.samples_per_scene)
    out["tc_vs_plain"] = tc_vs_plain_step(
        st.decoder, auto, st.codes.roll(64, 0), ids[3], xyz_b, sdf_b, 0.0,
        3003, "bank", card, "codes of chairs 64 places on", "plain")
    out["layer_vs_parent"] = layer_vs_parent_step(
        st.decoder, auto, st.codes, ids[3], xyz_b, sdf_b, 0.0, 3004, "bank",
        card)
    out["head"] = head_vs_plain_step(
        st.decoder, auto, st.codes.roll(64, 0), ids[3], xyz_b, sdf_b, 0.0,
        3005, "bank", card)
    del st, step, plain, parent, bank, ids, xyz_b, sdf_b
    torch.cuda.empty_cache()
    out["head"].update(head_alone(dev, card))
    torch.cuda.empty_cache()
    out["decoder_input"] = decoder_input_alone(dev, card)
    torch.cuda.empty_cache()

    # ---- the CSG bank from the multicat pack
    ad5 = ExperimentConfig.load(ROOT / "configs" / "config5_multicat_dp").ad
    shapes_m = analytic.make_synthetic_split("classes13", 6136, seed=5)
    sd_m, codes_m = load_stage1_pack(ROOT.joinpath(*MULTICAT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = adv.bank_from_csg(shapes_m, 5, BANK_N, device=dev)
    torch.cuda.synchronize()
    build_m = time.perf_counter() - t0
    params_m = adv.pack_csg(shapes_m[:4], device=dev)
    chk_m = check_bank(bank, lambda i: (lambda x, p=params_m.slice(i, 1):
                                        adv.csg_sdf(p, x)), BANK_N, "csg")
    cfg_m = dataclasses.replace(ad5, num_scenes=len(shapes_m),
                                device_data=True, use_pallas=True)
    st = init_ad_state(cfg_m, params=sd_m, codes=codes_m, device=dev)
    gen.manual_seed(cfg_m.seed)
    step = make_bank_step(st.decoder, cfg_m, bank, gen)
    ids_m = torch.from_numpy(np.random.default_rng(cfg_m.seed + 1)
                             .permutation(len(shapes_m))[:64]
                             .astype(np.int64)).to(dev)
    reset_train_launches()
    l1m = float(step(st, ids_m, 0.0, 7)["loss_l1"])
    out["launches"]["csg"] = train_launches()
    out["csg"] = dict(build_s=build_m, gib=bank.nbytes / 2 ** 30,
                      check=chk_m, step0_loss_l1=l1m)
    log(f"[bank] CSG bank of {len(shapes_m)} classes13 shapes "
        f"(make_synthetic_split('classes13', 6136, seed=5)) x {BANK_N}, "
        f"built by bank_from_csg in {build_m:.2f} s: "
        f"{bank.nbytes / 2 ** 30:.3f} GiB; positive share "
        f"{chk_m['pos_share']:.3f}, {chk_m['fallback']} one-sided scenes, "
        f"labels vs csg_sdf max {chk_m['label_err']:.1e}; fused step 0 "
        f"from the multicat pack (config 5's ad block): loss_l1 {l1m:.5f} "
        f"(gate < {BANK_GATES['csg']}) [{card}]")
    if not l1m < BANK_GATES["csg"]:
        raise RuntimeError(f"[bank] CSG bank: step-0 loss_l1 {l1m}")
    del st, step, bank
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    return out


def _dp_runs(dev, inputs: dict, mesh) -> dict:
    """[dp] every case of DP_CASES for 3 steps from the same state and
    draws: the single-device steps when `mesh` is None, else the
    data-parallel steps over it. Per case: losses, launches, the final
    parameters and codes (on the CPU)."""
    import dataclasses
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank \
        import DeviceSampleBank
    from latent_diffusion_models_for_shape_sdfs_torch.parallel import dp
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder \
        import init_ad_state, make_ad_train_step, make_bank_step

    ad3 = ExperimentConfig.load(ROOT / "configs" / "config3_chairs_joint").ad
    bank = DeviceSampleBank(*(t.to(dev) for t in inputs["bank"]))
    batches = [tuple(t.to(dev) for t in b) for b in inputs["batches"]]
    out = {}
    for route, feed, rate in DP_CASES:
        c = dataclasses.replace(
            ad3, num_scenes=64, use_pallas=route == "fused",
            decoder=dataclasses.replace(ad3.decoder, use_dropout=rate > 0))
        st = init_ad_state(c, params=inputs["params"], codes=inputs["codes"],
                           device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(DP_SEED)
        if feed == "bank":
            step = (make_bank_step(st.decoder, c, bank, gen) if mesh is None
                    else dp.make_dp_bank_step(st.decoder, c, mesh, bank, gen))
        else:
            step = (make_ad_train_step(st.decoder, c) if mesh is None
                    else dp.make_dp_ad_train_step(st.decoder, c, mesh))
        reset_train_launches()
        losses, grads0 = [], None
        for i, (ids, xyz, sdf) in enumerate(batches):
            args = (ids,) if feed == "bank" else (ids, xyz, sdf)
            m = step(st, *args, 100.0 * (i + 1), 4242 + i)
            losses.append([m[k] for k in ("loss", "loss_l1", "loss_reg")])
            if i == 0:      # step 0's (summed) gradients, as Adam took them
                grads0 = {k: p.grad.detach().cpu()
                          for k, p in st.decoder.named_parameters()}
                grads0["codes"] = st.codes.grad.detach().cpu()
        torch.cuda.synchronize()
        out[f"{route}/{feed}/{rate}"] = dict(
            loss=[float(v[0]) for v in losses],
            terms0=[float(v) for v in losses[0]], grads0=grads0,
            lr=(c.lr_decoder, c.lr_latent), launches=train_launches(),
            checksum=(int(dp.state_checksum(st)) if mesh is None
                      else dp.check_replicas(st, mesh)),
            params={k: v.detach().cpu()
                    for k, v in st.decoder.state_dict().items()},
            codes=st.codes.detach().cpu())
        del st, step
        torch.cuda.empty_cache()
    return out


DP_DECODE_RES = 256       # serve_meshes_sharded, the sparse decode
DP_GRID_RES = 128         # decode_grid_sharded, the flat decode
DP_POINTS = (1 << 20) + 131
DP_DDIM_TOL = 1e-5        # dp_ddim_sample vs ddim_sample, of max|z|


def _digest(*arrays) -> str:
    """SHA-256 of arrays' dtypes, shapes and bytes (tensors or numpy): two
    results are bit-equal when their digests are."""
    import hashlib
    import numpy as np
    import torch
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().contiguous()
            h.update(f"{a.dtype}{tuple(a.shape)}".encode())
            h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _dp_decode_runs(dev, mesh) -> dict:
    """[dp] the decode half of parallel/dp.py over `mesh`, or with `mesh`
    None its single-device counterparts: serve_meshes_sharded (vs
    serve_meshes) of 8 trained chairs at 256^3, make_dp_sparse_decode_fn
    (vs the per-shape decode) of the same chairs, decode_points_sharded
    at 2^20+131 points (vs one KernelApply call), decode_grid_sharded at
    128^3 (vs decode_grid), make_dp_pairs_fn under the flat decode of 8
    multicat shapes at 128^3 (vs the flat decode), each as a digest;
    dp_ddim_sample (vs ddim_sample) of 64 latents through config 4's
    CondDenoiser (seeded weights, CFG 2.0 over class + 512 observed
    points, on the exact denoiser of N(0, I) data so the latents stay
    O(1)); and the launches of kernels #1 and #2 meanwhile."""
    import numpy as np
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig, ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        ddim_sample, guided_denoise_fn)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
        DiffusionSchedule)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
        CondDenoiser)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        cuda_kernels as ck)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import grid_eval as ge
    from latent_diffusion_models_for_shape_sdfs_torch.parallel import dp
    from latent_diffusion_models_for_shape_sdfs_torch.parallel.mesh import (
        batch_sharded)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        _default_caps, serve_meshes, serve_meshes_sharded)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import load_stage1_pack

    n0 = launch_record().copy()
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    apply = ck.make_kernel_apply(SdfDecoder(DecoderConfig()), sd, device=dev)
    sd_m, codes_m = load_stage1_pack(ROOT.joinpath(*MULTICAT))
    pairs = ck.make_kernel_apply_pairs(SdfDecoder(DecoderConfig()), sd_m,
                                       device=dev)
    lat = list(codes[::768])
    zs = torch.from_numpy(np.stack(lat)).to(dev)
    res, caps = DP_DECODE_RES, _default_caps(DP_DECODE_RES)
    out = {}
    meshes = list(serve_meshes(apply, lat, res=res, device=dev)
                  if mesh is None else
                  serve_meshes_sharded(apply, lat, mesh, res=res, device=dev))
    out["serve_n"] = len(meshes)
    out["serve"] = _digest(*(a for v, f, _ in meshes for a in (v, f)))
    out["serve_faces"] = [len(f) for _, f, _ in meshes]
    del meshes
    if mesh is None:
        per = [ge.decode_grid_hierarchical3_sparse2(
            apply, z, res, 16, 4, 2, *caps, safety=1.2, safety3=2.0,
            out_dtype="int8", check_overflow=False) for z in zs]
        sparse = [torch.stack([p[0][j] for p in per]) for j in range(5)] + [
            torch.stack([p[1][k] for p in per])
            for k in ("active_l1", "active_l2", "active_l3")]
        del per
    else:
        arrs, counts = dp.make_dp_sparse_decode_fn(apply, res, len(lat),
                                                   mesh, caps)(zs)
        sparse = dp.all_gather_rows(mesh, [*arrs, *counts])
        del arrs, counts
    out["sparse"] = _digest(*sparse)
    del sparse
    xyz = torch.rand(DP_POINTS, 3, device=dev, generator=torch.Generator(
        device=dev).manual_seed(7)) * 2 - 1
    out["points"] = _digest(apply(zs[0], xyz) if mesh is None else
                            dp.decode_points_sharded(apply, zs[0], xyz, mesh))
    out["grid"] = _digest(
        ge.decode_grid(apply, zs[0], DP_GRID_RES).cpu().numpy()
        if mesh is None else
        dp.decode_grid_sharded(apply, zs[0], DP_GRID_RES, mesh))
    zm = torch.from_numpy(codes_m[:8]).to(dev)
    grids, st = ge.decode_grid_hierarchical3_batch_flat(
        pairs if mesh is None else dp.make_dp_pairs_fn(pairs, mesh), zm,
        DP_GRID_RES, 16, 4, 2, out_dtype="bfloat16", **FLAT_KW)
    if st["capacity_exceeded"]:
        raise RuntimeError(f"[dp] flat decode over its caps: {st}")
    out["flat"] = _digest(grids)
    del grids, xyz

    exp = ExperimentConfig.load(ROOT / "configs" / "config4_conditional")
    dc, n = exp.diff.denoiser, 64
    torch.manual_seed(DP_SEED)
    model = CondDenoiser(dc).eval().to(dev)
    rng = np.random.default_rng(DP_SEED)
    ox = torch.from_numpy(rng.uniform(-1, 1, (n, dc.partial_points, 3))
                          .astype(np.float32)).to(dev)
    od = torch.from_numpy((0.1 * rng.normal(size=(n, dc.partial_points)))
                          .astype(np.float32)).to(dev)
    rows = torch.arange(n, device=dev)
    if mesh is not None:
        rows = batch_sharded(mesh, rows)
    g = guided_denoise_fn(model, exp.sample.guidance_scale,
                          class_id=rows % dc.num_classes, obs_xyz=ox[rows],
                          obs_sdf=od[rows])
    sched = DiffusionSchedule.create(exp.diff.timesteps, exp.diff.beta_start,
                                     exp.diff.beta_end, device=dev)

    def fn(z, t):
        a = sched.alpha_bars[t.long()][:, None]
        return torch.sqrt(1 - a) * z + 0.2 * g(z, t)

    gen = torch.Generator(device=dev).manual_seed(5)
    steps = exp.sample.ddim_steps
    z = (ddim_sample(fn, sched, gen, n, dc.latent_size, steps=steps)
         if mesh is None else
         dp.dp_ddim_sample(fn, sched, gen, n, dc.latent_size, mesh,
                           steps=steps))
    out["ddim"] = z.cpu()
    torch.cuda.synchronize()
    out["launches"] = launched_since(n0, ("fused_eval", "fused_eval_pairs"))
    return out


def _dp_rank(rank: int, port: int, workdir: str) -> None:
    """[dp] one of two ranks on the one card (a spawned process): a gloo
    group, then _dp_runs over the 2-rank mesh; results to workdir."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from latent_diffusion_models_for_shape_sdfs_torch.parallel import (
        make_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        inputs = torch.load(pathlib.Path(workdir) / "inputs.pt",
                            weights_only=False)
        res = _dp_runs(dev, inputs, make_mesh())
        res["decode"] = _dp_decode_runs(dev, make_mesh())
        torch.save(res, pathlib.Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_compare(ref: dict, got: dict) -> dict:
    """`got` (2 ranks) against `ref` (one device): step 0's loss terms
    relative; step 0's summed gradients, each tensor's max |diff| over
    its max; after the last step, each parameter's and the codes' max
    |diff| over its max, the share of entries that differ by more than
    DP_PARAM_TOL of their tensor's max, and the largest |diff| in units
    of the tensor's Adam lr."""
    loss0 = max(abs(a - b) / max(abs(a), 1e-30)
                for a, b in zip(ref["terms0"], got["terms0"]))
    g0 = {k: float((got["grads0"][k] - v).abs().max())
          / max(float(v.abs().max()), 1e-30) for k, v in ref["grads0"].items()}
    after = dict(ref["params"], codes=ref["codes"])
    mine = dict(got["params"], codes=got["codes"])
    rel, over, n, in_lr = {}, 0, 0, 0.0
    for k, v in after.items():
        d = (mine[k] - v).abs()
        top = max(float(v.abs().max()), 1e-30)
        rel[k] = float(d.max()) / top
        over += int((d > DP_PARAM_TOL * top).sum())
        n += d.numel()
        lr = ref["lr"][1] if k == "codes" else ref["lr"][0]
        in_lr = max(in_lr, float(d.max()) / lr)
    worst = max(rel, key=rel.get)
    gworst = max(g0, key=g0.get)
    return dict(loss0_rel=loss0, grad0_worst=gworst, grad0_rel=g0[gworst],
                worst=worst, worst_rel=rel[worst], share_over=over / n,
                max_in_lr=in_lr,
                loss_rel=max(abs(a - b) / abs(a)
                             for a, b in zip(ref["loss"], got["loss"])))


def dp_phase(dev, card) -> dict:
    """[dp] data-parallel stage-1 steps (parallel/dp.py) on config 3's ad
    block at full width, cut to 64 scenes: on both routes, from the host
    feed and from the bank, 3 steps of two ranks on the one card (gloo)
    against the single-device steps from the same state and draws (the
    DP_* tolerances), the ranks equal bit for bit, and a 1-rank NCCL
    group's steps equal to the single-device steps bit for bit."""
    import datetime
    import multiprocessing
    import numpy as np
    import torch
    import torch.distributed as dist
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic_device as adv)
    from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset \
        import SdfDataset
    from latent_diffusion_models_for_shape_sdfs_torch.parallel import (
        make_mesh)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint \
        import load_stage1_pack

    t_phase = time.perf_counter()
    ad3 = ExperimentConfig.load(ROOT / "configs" / "config3_chairs_joint").ad
    S, P = ad3.scenes_per_batch, ad3.samples_per_scene
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    shapes = train_split()
    bank = adv.bank_from_chairs(shapes, 11, BANK_N, device=dev)
    # the host feed's batches: 3 balanced draws from the bank's rows
    ds = SdfDataset([bank.pos[i, :bank.pos_count[i]].cpu().numpy()
                     for i in range(len(shapes))],
                    [bank.neg[i, :bank.neg_count[i]].cpu().numpy()
                     for i in range(len(shapes))])
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):            # one batch an epoch of 64 scenes
        b = next(ds.epoch_batches(rng, S, P))
        batches.append((torch.from_numpy(b.scene_ids.astype(np.int64)),
                        torch.from_numpy(b.xyz), torch.from_numpy(b.sdf)))
    # codes of chairs 64-127: a start away from the optimum, where the
    # batch gradient does not cancel
    inputs = dict(params=sd, codes=codes[64:128], batches=batches,
                  bank=tuple(t.cpu() for t in bank))
    del bank, ds
    torch.cuda.empty_cache()
    single = _dp_runs(dev, inputs, None)
    single["decode"] = _dp_decode_runs(dev, None)
    with tempfile.TemporaryDirectory() as wd:
        torch.save(inputs, pathlib.Path(wd) / "inputs.pt")
        port = _free_port()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_dp_rank, args=(r, port, wd))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        ranks_s = time.perf_counter() - t0
        codes_ = [p.exitcode for p in procs]
        if codes_ != [0, 0]:
            raise RuntimeError(f"[dp] rank processes exited {codes_}")
        ranks = [torch.load(pathlib.Path(wd) / f"rank{r}.pt",
                            weights_only=False) for r in range(2)]
    # a 1-rank NCCL group in this process
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        nccl1 = _dp_runs(dev, inputs, make_mesh())
        nccl1["decode"] = _dp_decode_runs(dev, make_mesh())
    finally:
        dist.destroy_process_group()
    out = dict(cases={}, ranks_s=ranks_s)
    log(f"[dp] config 3's ad block (8x{ad3.decoder.hidden_dim} bf16, "
        f"{S} x {P} a step) cut to 64 scenes (chairs 0-63 with the codes of "
        f"chairs 64-127); two ranks share the one card over gloo, which "
        f"the phase names itself: NCCL refuses two ranks on one device; "
        f"dropout off where 2 ranks are held against 1 (each rank folds "
        f"its rank into the dropout seed, so its masks differ by design)")
    bad = []
    for route, feed, rate in DP_CASES:
        key = f"{route}/{feed}/{rate}"
        s, r0, r1, one = single[key], ranks[0][key], ranks[1][key], \
            nccl1[key]
        replicas = r0["checksum"] == r1["checksum"] and all(
            torch.equal(r0["params"][k], r1["params"][k])
            for k in r0["params"]) and torch.equal(r0["codes"], r1["codes"])
        exact1 = s["loss"] == one["loss"] and s["checksum"] == \
            one["checksum"] and all(torch.equal(s["params"][k],
                                                one["params"][k])
                                    for k in s["params"])
        rec = dict(loss_single=s["loss"], loss_2rank=r0["loss"],
                   replicas_equal=replicas, nccl1_bitwise=exact1,
                   launches_rank0=r0["launches"],
                   launches_rank1=r1["launches"],
                   launches_single=s["launches"])
        if rate == 0:
            rec.update(_dp_compare(s, r0))
            ok = (rec["loss0_rel"] <= DP_LOSS_RTOL
                  and rec["grad0_rel"] <= DP_GRAD_TOL
                  and rec["loss_rel"] <= DP_LOSS3_RTOL)
        else:
            ok = True
        ok = ok and replicas and exact1
        if not ok:
            bad.append(key)
        out["cases"][key] = rec
        agree = (f"step-0 loss terms {rec['loss0_rel']:.2e} rel (tol "
                 f"{DP_LOSS_RTOL}), step-0 gradients worst "
                 f"{rec['grad0_worst']} {rec['grad0_rel']:.2e} of its max "
                 f"(tol {DP_GRAD_TOL}); losses of 3 steps "
                 f"{rec['loss_rel']:.2e} rel (tol {DP_LOSS3_RTOL}); worst "
                 f"after 3 steps {rec['worst']} {rec['worst_rel']:.2e} of its "
                 f"max, {100 * rec['share_over']:.4f}% of entries beyond "
                 f"{DP_PARAM_TOL} of their max, largest diff "
                 f"{rec['max_in_lr']:.3f} lr" if rate == 0 else
                 f"losses {[round(v, 6) for v in r0['loss']]} (masks of "
                 f"rank-folded seeds)")
        log(f"[dp] {route} route, {feed} feed, dropout {rate}: 2 ranks vs "
            f"1: {agree}; replicas equal {replicas}; 1-rank NCCL == single "
            f"device bit for bit {exact1}; launches per rank "
            f"{r0['launches']} / {r1['launches']} (single "
            f"{s['launches']})")
    out["decode"] = _dp_decode_compare(single["decode"],
                                       [r["decode"] for r in ranks],
                                       nccl1["decode"], bad, card)
    out["s"] = time.perf_counter() - t_phase
    log(f"[dp] phase {out['s']:.1f} s (the two ranks {ranks_s:.1f} s) "
        f"[{card}]")
    if bad:
        raise RuntimeError(f"[dp] cases out of tolerance: {bad}")
    return out


def _dp_decode_compare(single: dict, ranks: list, nccl1: dict,
                       bad: list, card: str) -> dict:
    """[dp]'s decode half: every digest of the two gloo ranks and of the
    1-rank NCCL group equal to the single-device one (serve_meshes_sharded
    yields on rank 0 only), dp_ddim_sample within DP_DDIM_TOL of max|z| on
    2 ranks and bit-equal on one; appends the failures to `bad`."""
    import torch
    keys = ("serve", "sparse", "points", "grid", "flat")
    rec = {}
    for k in keys:
        rec[k] = [r[k] == single[k] for r in (ranks[0], nccl1)]
        if k != "serve":
            rec[k].append(ranks[1][k] == single[k])
    rank1_serves = ranks[1]["serve_n"]
    top = float(single["ddim"].abs().max())
    diff = float((ranks[0]["ddim"] - single["ddim"]).abs().max())
    rec.update(ddim_rel=diff / top, ddim_max=top,
               ddim_ranks_equal=bool(torch.equal(ranks[0]["ddim"],
                                                 ranks[1]["ddim"])),
               ddim_nccl1_bitwise=bool(torch.equal(nccl1["ddim"],
                                                   single["ddim"])),
               launches=[r["launches"] for r in ranks]
               + [nccl1["launches"]], single_launches=single["launches"],
               serve_faces=single["serve_faces"])
    log(f"[dp] decode half, 2 ranks (rank 0, NCCL 1-rank[, rank 1]) vs one "
        f"device, bit for bit: serve_meshes_sharded of 8 chairs at "
        f"{DP_DECODE_RES}^3 {rec['serve']} (rank 1 yields "
        f"{rank1_serves} meshes), make_dp_sparse_decode_fn {rec['sparse']}, "
        f"decode_points_sharded at {DP_POINTS} points {rec['points']}, "
        f"decode_grid_sharded at {DP_GRID_RES}^3 {rec['grid']}, "
        f"make_dp_pairs_fn under the flat decode of 8 multicat shapes at "
        f"{DP_GRID_RES}^3 {rec['flat']}; dp_ddim_sample of 64 config-4 "
        f"latents vs ddim_sample: max diff {diff:.3e} = "
        f"{rec['ddim_rel']:.3e} of max|z| {top:.2f} (tol {DP_DDIM_TOL}), "
        f"ranks equal {rec['ddim_ranks_equal']}, 1-rank NCCL bitwise "
        f"{rec['ddim_nccl1_bitwise']}; launches (#1, #2) per rank "
        f"{[(r['fused_eval'], r['fused_eval_pairs']) for r in rec['launches']]}"
        f", single {single['launches']} [{card}]")
    ok = (all(all(v) for k, v in rec.items() if k in keys)
          and rank1_serves == 0 and rec["ddim_rel"] <= DP_DDIM_TOL
          and rec["ddim_ranks_equal"] and rec["ddim_nccl1_bitwise"]
          and all(r["fused_eval"] > 0 and r["fused_eval_pairs"] > 0
                  for r in rec["launches"]))
    if not ok:
        bad.append("decode half")
    return rec



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", type=pathlib.Path, default=None,
                    help="write the measured numbers as JSON here")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import latent_diffusion_models_for_shape_sdfs_torch as port
    if not pathlib.Path(port.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"port package not from this checkout: "
                           f"{port.__file__}")
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        DecoderConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
        chamfer_l2)
    from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
        SdfDecoder)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        hoisted_rows, make_kernel_apply, make_kernel_apply_pairs)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        fast_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
        reset_native_cache)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        _default_caps, serve_meshes, watch_and_serve)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        load_stage1_pack)

    details: dict = {}

    # ---- build: one nvcc per kernel source and the mesher, all at once,
    # while the training data is generated (a fork pool, before CUDA)
    t0 = time.perf_counter()
    sources = ["fused_eval.cu", "relu_dropout.cu", "fused_train.cu",
               "fused_eval_pairs.cu", "head.cu"]
    built: dict = {}
    errors: list = []

    def _run(name, fn):
        try:
            built[name] = fn()
        except Exception as e:   # re-raised on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=_run, args=(src, lambda s=src:
                                                   _build.build(s)))
               for src in sources]
    threads.append(threading.Thread(target=_run,
                                    args=("mesher", build_mesher)))
    for th in threads:
        th.start()
    from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
        SdfDataset)
    dataset = SdfDataset.from_analytic(train_split(), 20_000, seed=0,
                                       workers=8)
    banks = multicat_banks()
    store = cli_store()
    details["data_s"] = time.perf_counter() - t0
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    reset_native_cache()
    details["build_s"] = time.perf_counter() - t0
    log(f"[build] {details['build_s']:.1f}s (data {details['data_s']:.1f}s "
        f"in the same time): " + ", ".join(built[s].name for s in sources))
    for src in sources:
        log_path = built[src].with_suffix(".log")
        for line in (log_path.read_text() if log_path.exists()
                     else "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {src}: {line.strip()}")

    # ---- phase 1: card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = f"{smi}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log("[card] the bf16 decoder's hidden layers (ops.bf16_linear) on the "
        "bf16 tensor cores: forward torch.mm(x_bf16, bf16(W)^T, "
        "out_dtype=float32) + b, dgrad and wgrad bf16 x bf16 -> bf16; fp32 "
        "accumulation, bf16 reduced-precision reduction off around each "
        "product; with relu+dropout through the kernels one function "
        "(bf16_linear_relu_dropout): the fp32 product without b into #3 "
        "(bias, one rounding, relu, dropout), #3b's bf16 cotangent and db "
        "from the layer's output into dgrad and wgrad")

    # ---- phase 2: kernel #1 vs plain version
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    decoder = SdfDecoder(DecoderConfig())
    apply = make_kernel_apply(decoder, sd)
    macs = kernel_macs_per_point(decoder)
    # the weights, and each launch's rows, read once
    wbytes = apply.w.nbytes + 4 * int(apply.meta[:, 1].sum())
    res = 256
    caps = _default_caps(res)
    shape_points = [(res // 16) ** 3, caps[0] * 64, caps[1] * 8,
                    caps[2] * 8]
    rng = np.random.default_rng(0)
    max_err = 0.0
    for ci, n in [(0, p) for p in shape_points] + [(1000, (1 << 20) + 131),
                                                   (5000, (1 << 20) + 131)]:
        z = torch.from_numpy(codes[ci]).to(dev)
        xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
            np.float32)).to(dev)
        got = apply(z, xyz)
        want = fast_apply(apply.ew, z, xyz)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("kernel produced non-finite values")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"[kernel] trained 8x512 code {ci} n={n}: max|kernel-plain| "
            f"{err:.3e} (tol {TOL})")
        if err > TOL:
            raise RuntimeError(f"kernel disagrees with plain version: {err}")
    torch.manual_seed(0)
    plan_errs = {}
    for name, kw in [("small (L 16, 3x128, skip 2)",
                      dict(latent_size=16, hidden_dim=128, num_layers=3,
                           latent_in=(2,), use_dropout=False)),
                     ("tanh (L 8, 2x32, no skip)",
                      dict(latent_size=8, hidden_dim=32, num_layers=2,
                           latent_in=(), use_tanh=True, use_dropout=False))]:
        small = SdfDecoder(DecoderConfig(**kw))
        apply_s = make_kernel_apply(small, small.state_dict())
        L = small.cfg.latent_size
        zt = torch.randn(L, device=dev) / np.sqrt(L)
        xt = torch.rand(4096 + 77, 3, device=dev) * 2 - 1
        err_s = float((apply_s(zt, xt) - fast_apply(apply_s.ew, zt, xt))
                      .abs().max())
        plan_errs[name] = err_s
        log(f"[kernel] {name} plan, n={len(xt)}: max|kernel-plain| "
            f"{err_s:.3e} (tol {TOL})")
        if err_s > TOL:
            raise RuntimeError(f"{name} plan disagrees: {err_s}")
        max_err = max(max_err, err_s)

    # timing: one 256^3 shape's four launches, and 2^20 points, beside
    # kernel #2 called with one code (S = 1) on the same points and latent
    z0 = torch.from_numpy(codes[0]).to(dev)
    rows = hoisted_rows(apply.ew, apply.meta, z0)
    pts = [torch.rand(n, 3, device=dev) * 2 - 1 for n in shape_points]
    p20 = torch.rand(1 << 20, 3, device=dev) * 2 - 1
    first = apply.launch(p20, rows)
    same1 = torch.equal(first, apply.launch(p20, rows))
    log(f"[kernel] two launches at 2^20 points bit-identical: {same1}")
    if not same1:
        raise RuntimeError("kernel #1 is not deterministic")
    pairs1 = make_kernel_apply_pairs(decoder, sd, device=dev)
    table1 = pairs1.table(z0[None])
    sids1 = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    err_k2 = float((pairs1.launch(table1, sids1, p20) - first).abs().max())
    with SmiSampler() as smi1:
        ms_shape = time_ms(lambda: [apply.launch(p, rows) for p in pts], 20)
        ms_20a = time_ms(lambda: apply.launch(p20, rows), 20)
        k2_a = time_ms(lambda: pairs1.launch(table1, sids1, p20), 20)
        ms_20b = time_ms(lambda: apply.launch(p20, rows), 20)
        k2_b = time_ms(lambda: pairs1.launch(table1, sids1, p20), 20)
    ms_20, ms_k2 = (ms_20a + ms_20b) / 2, (k2_a + k2_b) / 2
    plain_shape = time_ms(lambda: [fast_apply(apply.ew, z0, p)
                                   for p in pts], 5)
    bound_shape, bound_by = bound(sum(shape_points), macs, wbytes)
    plain_20 = time_ms(lambda: fast_apply(apply.ew, z0, p20), 5)
    bound_20, _ = bound(1 << 20, macs, wbytes)
    tflops = 2.0 * macs * (1 << 20) / (ms_20 * 1e-3) / 1e12
    cfg1 = apply.config()
    ptx1 = ptxas_report("fused_eval.cu")
    log(f"[kernel] one 256^3 shape ({sum(shape_points)} points in "
        f"{len(shape_points)} launches): kernel {ms_shape:.3f} ms "
        f"({100 * bound_shape / ms_shape:.1f}% of its bound), plain "
        f"{plain_shape:.3f} ms, bound {bound_shape:.3f} ms ({bound_by}) "
        f"[{card}]")
    log(f"[kernel] 2^20 points: kernel {ms_20:.3f} ms ({ms_20a:.3f}, "
        f"{ms_20b:.3f}; {tflops:.1f} TFLOP/s), plain {plain_20:.3f} ms, "
        f"bound {bound_20:.3f} ms; kernel #2 with one code (S = 1) on the "
        f"same points {ms_k2:.3f} ms ({k2_a:.3f}, {k2_b:.3f}), max|#2-#1| "
        f"{err_k2:.3e} [{card}]")
    log(f"[kernel] during the timed launches: {smi1.text()}")
    log(f"[kernel] launch: cluster {cfg1['cluster']} CTAs, {cfg1['stages']} "
        f"ring stages of 2 x 16 KB slabs, {cfg1['smem']} B shared memory, "
        f"{cfg1['max_clusters']} clusters resident; ptxas: "
        f"{ptx1['registers']} registers a thread at launch (before "
        f"setmaxnreg), {ptx1['stack_bytes']} B stack, spills "
        f"{ptx1['spill_stores']}/{ptx1['spill_loads']} B; warnings "
        f"{ptx1['warnings'] or 'none'}")
    if err_k2 > 1e-2:
        raise RuntimeError(f"kernel #2 with one code vs kernel #1: {err_k2}")
    details["kernel"] = dict(
        max_abs_err=max_err, plan_errs=plan_errs, shape_points=shape_points,
        bit_identical=same1, ms_shape=ms_shape, plain_ms_shape=plain_shape,
        bound_ms_shape=bound_shape, ms_2p20=ms_20, ms_2p20_runs=[ms_20a,
                                                                 ms_20b],
        plain_ms_2p20=plain_20, bound_ms_2p20=bound_20, tflops_2p20=tflops,
        macs_per_point=macs, k2_s1_ms_2p20=ms_k2, k2_s1_runs=[k2_a, k2_b],
        k2_s1_vs_k1=err_k2, config=cfg1, ptxas=ptx1, smi=smi1.summary())
    del pairs1, table1, sids1, first

    # ---- phase 3: serve 8 trained chairs at 256^3 (the main path)
    lat = list(codes[::768])
    list(serve_meshes(apply, lat[:1], res=res))          # warm-up
    torch.cuda.synchronize()
    apply.launches = 0
    t0 = time.perf_counter()
    meshes = list(serve_meshes(apply, lat, res=res))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = apply.launches
    if len(meshes) != len(lat):
        raise RuntimeError(f"served {len(meshes)} of {len(lat)} shapes")
    if launches < 4 * len(lat):
        raise RuntimeError(f"only {launches} kernel launches for "
                           f"{len(lat)} shapes")
    for v, f, st in meshes:
        if len(f) == 0 or not np.isfinite(v).all() \
                or np.abs(v).max() > 1.0 + 1e-5:
            raise RuntimeError(f"bad mesh: {len(v)} verts {len(f)} faces")
        if st["mesher"] != "native-payload":
            raise RuntimeError(f"mesher {st['mesher']} != native-payload")
    ms_mesh = wall / len(lat) * 1e3
    pay = [st["payload_bytes"] for _, _, st in meshes]
    nverts = [len(v) for v, _, _ in meshes]
    log(f"[serve] {len(lat)} chairs at {res}^3 int8: {ms_mesh:.1f} "
        f"ms/mesh, {launches} kernel launches, payload "
        f"{int(np.mean(pay))} B/mesh, {int(np.mean(nverts))} verts/mesh, "
        f"escalations {[st['escalations'] for _, _, st in meshes]} "
        f"[{card}]")

    def plain(z, xyz):
        return fast_apply(apply.ew, z, xyz)

    (vp, fp, _), = list(serve_meshes(plain, lat[:1], res=res))
    h = 2.0 / (res - 1)
    cd = chamfer_l2(meshes[0][0], vp)
    log(f"[serve] kernel vs plain mesh of chair 0: chamfer-L2 over "
        f"vertices {cd:.3e} (limit {(h / 4) ** 2:.3e}), verts "
        f"{len(meshes[0][0])} vs {len(vp)}")
    if not cd < (h / 4) ** 2:
        raise RuntimeError(f"kernel mesh differs from plain mesh: {cd}")
    details["serve"] = dict(
        res=res, shapes=len(lat), ms_per_mesh=ms_mesh, wall_s=wall,
        launches=launches, payload_bytes=pay, verts=nverts,
        t_mesh_s=[st["t_mesh_s"] for _, _, st in meshes],
        t_d2h_wait_s=[st["t_d2h_wait_s"] for _, _, st in meshes],
        escalations=[st["escalations"] for _, _, st in meshes],
        chamfer_kernel_vs_plain=cd)

    # ---- where the serve time goes: one traced repeat of the same run
    traced_wall, busy, top = device_profile(
        lambda: list(serve_meshes(apply, lat, res=res)))
    log_profile("trace", f"serve of {len(lat)} shapes", traced_wall, busy,
                top, card)
    details["trace"] = dict(wall_s=traced_wall, device_busy_ms=busy,
                            top=top[:12])

    # ---- phase 4: watch-folder daemon on two latent requests
    with tempfile.TemporaryDirectory() as td:
        q = pathlib.Path(td) / "q"
        out = pathlib.Path(td) / "out"
        q.mkdir()
        np.save(q / "a.npy", codes[100])
        np.save(q / "b.npy", codes[200])

        def stop_when_done():
            deadline = time.time() + 300
            while time.time() < deadline and not all(
                    (q / f"{n}.npy.done").exists() for n in "ab"):
                time.sleep(0.05)
            (q / "STOP").touch()

        stopper = threading.Thread(target=stop_when_done)
        stopper.start()
        apply.launches = 0
        served = watch_and_serve(apply, q, out, res=res, poll=0.05)
        stopper.join()
        d_launches = apply.launches
        for n in "ab":
            stats = json.loads((out / f"{n}.stats.json").read_text())
            ply = (out / f"{n}_000.ply").read_bytes()
            header = ply[:ply.index(b"end_header")].decode()
            if not (stats[0]["verts"] > 0
                    and f"element vertex {stats[0]['verts']}" in header
                    and stats[0]["mesher"] == "native-payload"):
                raise RuntimeError(f"daemon output {n} is wrong: {stats}")
    if served != 2 or d_launches < 8:
        raise RuntimeError(f"daemon served {served}, {d_launches} launches")
    log(f"[daemon] served {served} requests, {d_launches} kernel launches")
    details["daemon"] = dict(served=served, launches=d_launches)

    # ---- phase 5: [dropout] relu+dropout kernels #3/#3b vs plain versions
    import dataclasses
    import math
    from torch.nn import functional as F
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        fused_train as ft, relu_dropout as rd)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
        precompute_eval_weights)
    from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
        init_ad_state, make_ad_train_step, train_auto_decoder)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
        save_stage1_pack)

    gen = torch.Generator(device=dev).manual_seed(0)
    for n_rows, n_cols, dt in [((1 << 20) + 131, 512, torch.bfloat16),
                               (1 << 20, 253, torch.bfloat16),
                               ((1 << 16) + 7, 512, torch.float32)]:
        x = torch.randn(n_rows, n_cols, generator=gen, device=dev).to(dt)
        g = torch.randn(n_rows, n_cols, generator=gen, device=dev).to(dt)
        y = rd.relu_dropout_fwd(x, 1234, RATE)
        dx = rd.relu_dropout_bwd(x, g, 1234, RATE)
        xr = x.clone().requires_grad_(True)
        y_p = rd.relu_dropout_reference(xr, 1234, RATE)
        dx_auto, = torch.autograd.grad(y_p, xr, g)
        dx_p = rd.relu_dropout_bwd_reference(x, g, 1234, RATE)
        torch.cuda.synchronize()
        pos = x.float() > 0
        n_pos = int(pos.sum())
        kept = int(((y != 0) & pos).sum()) / n_pos
        sigma = math.sqrt(RATE * (1 - RATE) / n_pos)
        same = (torch.equal(y, y_p.detach()) and torch.equal(dx, dx_p)
                and torch.equal(dx, dx_auto)
                and torch.equal(y != 0, y_p.detach() != 0))
        log(f"[dropout] [{n_rows}, {n_cols}] {str(dt)[6:]}: outputs, masks "
            f"and gradients bitwise equal to the plain version and to "
            f"autograd of it: {same}; keep fraction {kept:.5f} vs "
            f"{1 - RATE} ({(kept - (1 - RATE)) / sigma:+.2f} sigma)")
        if not same:
            raise RuntimeError("relu+dropout kernels differ from their "
                               "plain versions")
        if abs(kept - (1 - RATE)) > 5 * sigma:
            raise RuntimeError(f"keep fraction {kept} off by > 5 sigma")
        del x, g, y, dx, xr, y_p, dx_auto, dx_p, pos
    # the layer entries (each bf16 hidden layer's): #3 from the fp32
    # product and bias, #3b from the output, with db
    drop_t, k3b_err = {}, 0.0
    for n_rows, cols in [(1 << 20, 512), (1 << 20, 253),
                         ((1 << 20) + 131, 512), ((1 << 20) + 131, 253)]:
        yf = torch.randn(n_rows, cols, generator=gen, device=dev)
        b = torch.randn(cols, generator=gen, device=dev)
        g = torch.randn(n_rows, cols, generator=gen, device=dev).to(
            torch.bfloat16)
        out = rd.bias_relu_dropout_fwd(yf, b, 1234, RATE)
        gb, db = rd.relu_dropout_bwd_out(out, g, RATE)
        again = (rd.bias_relu_dropout_fwd(yf, b, 1234, RATE),
                 *rd.relu_dropout_bwd_out(out, g, RATE))
        h = (yf + b).to(torch.bfloat16)
        gb_p, db_p = rd.relu_dropout_bwd_out_reference(out, g, RATE)
        plan = rd.bwd_plan(n_rows, cols)
        same = (torch.equal(out, rd.bias_relu_dropout_reference(
                    yf, b, 1234, RATE))
                and torch.equal(gb, gb_p)
                and torch.equal(gb, rd.relu_dropout_bwd_reference(
                    h, g, 1234, RATE))
                and torch.equal(db, rd.db_kernel_order(gb, plan)))
        ident = all(torch.equal(a, c) for a, c in zip((out, gb, db), again))
        dist = db_distance(db, gb)
        plain_err = float((db - db_p).abs().max())
        k3b_err = max(k3b_err, plain_err)
        log(f"[dropout] layer entries [{n_rows}, {cols}]: #3 from the fp32 "
            f"product and bias bit-equal to relu_dropout_reference(bf16(yf "
            f"+ b)), #3b's gb to its plain version and to the x-reading "
            f"backward, db to db_kernel_order({plan}): {same}; two launches "
            f"bit-identical: {ident}; db from float64 {dist:.2e} of the "
            f"column's sum |gb| (gate {DB_TOL:.2e}), from the plain "
            f"version's torch sum max {plain_err:.3e}")
        if not (same and ident and dist <= DB_TOL):
            raise RuntimeError(f"#3/#3b layer entries at [{n_rows}, {cols}]"
                               f": same {same}, identical {ident}, db "
                               f"{dist}")
        if n_rows == 1 << 20:
            y = yf.clone()

            def parent_fwd():       # the composed form: bias add, cast, #3
                y.add_(b)
                return rd.relu_dropout_fwd(y.to(torch.bfloat16), 1, RATE)

            def parent_bwd():       # the composed form: #3b, casts, db
                g2 = rd.relu_dropout_bwd(h, g, 1, RATE).float()
                return g2.to(torch.bfloat16), g2.sum(0)

            n_el = yf.numel()
            drop_t[cols] = dict(
                fwd=time_ms(lambda: rd.bias_relu_dropout_fwd(yf, b, 1, RATE),
                            20),
                bwd=time_ms(lambda: rd.relu_dropout_bwd_out(out, g, RATE),
                            20),
                parent_fwd=time_ms(parent_fwd, 20),
                parent_bwd=time_ms(parent_bwd, 20),
                standalone_fwd=time_ms(
                    lambda: rd.relu_dropout_fwd(h, 1, RATE), 20),
                standalone_bwd=time_ms(
                    lambda: rd.relu_dropout_bwd(h, g, 1, RATE), 20),
                plain_fwd=time_ms(lambda: rd.bias_relu_dropout_reference(
                    yf, b, 1, RATE), 2),
                plain_bwd=time_ms(lambda: rd.relu_dropout_bwd_out_reference(
                    out, g, RATE), 2),
                library=time_ms(lambda: F.dropout(F.relu(h), RATE, True),
                                20),
                bound_fwd=6.0 * n_el / PEAK_HBM_BYTES * 1e3,
                bound_bwd=(6.0 * n_el + 8.0 * plan.ctas * cols + 4.0 * cols)
                / PEAK_HBM_BYTES * 1e3,
                plan=plan._asdict())
            t = drop_t[cols]
            del y
            share_f = 100 * t["bound_fwd"] / t["fwd"]
            share_b = 100 * t["bound_bwd"] / t["bwd"]
            log(f"[dropout] [2^20, {cols}] per launch: #3 from the fp32 "
                f"product {t['fwd']:.4f} ms ({share_f:.1f}% of its "
                f"{t['bound_fwd']:.4f} ms bytes bound), the composed form's "
                f"passes it replaces (bias add, cast, #3) "
                f"{t['parent_fwd']:.4f}; #3b from the output with db "
                f"{t['bwd']:.4f} ms ({share_b:.1f}% of {t['bound_bwd']:.4f}),"
                f" the composed form's passes (#3b, two casts, db's sum) "
                f"{t['parent_bwd']:.4f}; the standalone bf16 pair "
                f"{t['standalone_fwd']:.4f} / {t['standalone_bwd']:.4f}; "
                f"plain {t['plain_fwd']:.3f} / {t['plain_bwd']:.3f} ms; "
                f"library F.dropout(F.relu(h)) (two calls) "
                f"{t['library']:.4f} ms [{card}]")
        del yf, b, g, out, gb, db, again, h, gb_p, db_p
    details["dropout"] = dict(times=drop_t, db_max_abs_err=k3b_err)

    # ---- phase 6: [fused_train] kernel #4 vs its plain version
    exp = ExperimentConfig.load(ROOT / "configs" / "config3_chairs_joint")
    ad0 = exp.ad
    S, P = ad0.scenes_per_batch, ad0.samples_per_scene
    N = S * P
    batch = next(dataset.epoch_batches(np.random.default_rng(0), S, P))
    ids_t = torch.from_numpy(batch.scene_ids.astype(np.int64)).to(dev)
    xyz_t = torch.from_numpy(batch.xyz).to(dev)
    sdf_t = torch.from_numpy(batch.sdf).to(dev)
    ew_t = precompute_eval_weights(SdfDecoder(ad0.decoder),
                                   {k: v.to(dev) for k, v in sd.items()},
                                   torch.bfloat16)
    z_t = torch.from_numpy(codes[:64]).to(dev)[ids_t]
    # the chairs' own codes put the step near the training optimum, where
    # the batch gradient nearly cancels; the codes of chairs 64-127 put it
    # far from it (as at the start of training), where it does not
    z_far = torch.from_numpy(codes[64:128]).to(dev)[ids_t]
    ft_err, ft_rel = 0.0, {}
    for case, z_c, rate, gated in [("own codes", z_t, 0.0, True),
                                   ("other chairs' codes", z_far, RATE, True),
                                   ("own codes", z_t, RATE, False)]:
        ft_args = (ew_t, z_c, xyz_t, sdf_t, N, ad0.clamp_dist, rate, 4242)
        got = ft.fused_train_loss_grads(*ft_args)
        again = ft.fused_train_loss_grads(*ft_args)
        want = ft.fused_train_reference(*ft_args)
        torch.cuda.synchronize()
        pairs = {"dz": (got[1], want[1], again[1])}
        for i, (a, b, c) in enumerate(zip(got[2], want[2], again[2])):
            pairs.update({f"lin{i}.{k}": (a[k], b[k], c[k]) for k in b})
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        rel, size = {}, {}
        same = torch.equal(got[0], again[0])
        for name, (a, b, c) in pairs.items():
            err = float((a - b).abs().max())
            size[name] = float(b.abs().max())
            rel[name] = err / max(size[name], 1e-30)
            if gated:
                ft_err = max(ft_err, err)
            same = same and torch.equal(a, c)
        worst = max(rel, key=rel.get)
        ft_rel[f"{case}, rate {rate}"] = dict(
            loss=float(want[0]), loss_rel=loss_rel, grad_rel=rel,
            grad_max=size, gated=gated)
        log(f"[fused_train] 64x16384, {case}, rate {rate}: loss "
            f"{float(got[0]):.6f} (plain {float(want[0]):.6f}, rel "
            f"{loss_rel:.2e}, tol {TRAIN_LOSS_RTOL}); worst gradient {worst} "
            f"{rel[worst]:.2e} of its max {size[worst]:.3e} (tol "
            f"{TRAIN_GRAD_TOL}{'' if gated else ', reported only'}); "
            f"max|dW_h| of lin1 {size['lin1.w_h']:.3e}; two passes "
            f"bit-identical: {same}")
        if gated and (loss_rel > TRAIN_LOSS_RTOL
                      or rel[worst] > TRAIN_GRAD_TOL):
            raise RuntimeError(f"fused train kernel disagrees: {ft_rel}")
        if not same:
            raise RuntimeError("fused train kernel is not deterministic")
        del got, again, want, pairs
    ft_args = (ew_t, z_t, xyz_t, sdf_t, N, ad0.clamp_dist, RATE, 4242)
    ms_ft = time_ms(lambda: ft.fused_train_loss_grads(*ft_args), 5)
    plain_ft = time_ms(lambda: ft.fused_train_reference(*ft_args), 1)
    flops_ft = 2.0 * ft.macs_per_point(ew_t) * N
    bound_ft = flops_ft / PEAK_BF16_FLOPS * 1e3
    log(f"[fused_train] one 64x16384 step (dropout {RATE}): kernel "
        f"{ms_ft:.2f} ms ({flops_ft / ms_ft / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ft:.1f} ms, bound {bound_ft:.2f} ms (operations) [{card}]")
    details["fused_train"] = dict(ms=ms_ft, plain_ms=plain_ft,
                                  bound_ms=bound_ft, max_abs_err=ft_err,
                                  rel=ft_rel,
                                  roles=train_roles(ft, ft_args, card),
                                  gemm=train_gemms(ft, dev, card))
    ew_layers = ew_t.layers

    # ---- phase 6b: [profile] utils/profiling on kernels #1-#4
    details["profile"] = profile_phase(
        dev, card, decoder, apply, z0, p20, ft_args, (ids_t, xyz_t, sdf_t), dataclasses.replace(ad0, num_scenes=64), sd,
        codes, {"fused_train": ms_ft, "fused_eval": ms_20,
                "fused_eval_pairs": ms_k2,
                "relu_dropout_fwd": drop_t[512]["fwd"],
                "relu_dropout_bwd": drop_t[512]["bwd"]})
    del ew_t, ft_args
    torch.cuda.empty_cache()

    # ---- phase 7: [train] config 3's ad block through both kernel routes
    cfg = dataclasses.replace(ad0, num_scenes=64, num_epochs=4)
    log(f"[train] config3_chairs_joint ad block, cut: num_scenes "
        f"{ad0.num_scenes} -> 64, samples_per_shape 100000 -> 20000, "
        f"num_epochs {ad0.num_epochs} -> 4 (one step per epoch); kept: "
        f"8x{ad0.decoder.hidden_dim} decoder, L={ad0.decoder.latent_size}, "
        f"{ad0.decoder.compute_dtype}, dropout {ad0.decoder.dropout_prob}, "
        f"{S} scenes x {P} samples per step; start: the committed pack's "
        f"params and codes[:64]")
    ad5 = ExperimentConfig.load(ROOT / "configs" / "config5_multicat_dp").ad
    diff = {f.name for f in dataclasses.fields(ad0)
            if getattr(ad0, f.name) != getattr(ad5, f.name)}
    if diff != {"data_parallel", "num_scenes"} or not ad5.data_parallel:
        raise RuntimeError(f"config 5's ad block differs from config 3's in "
                           f"{diff}, not in data_parallel and num_scenes")
    routes = {"relu_dropout": cfg,
              "fused_train": dataclasses.replace(cfg, use_pallas=True),
              "config5": dataclasses.replace(ad5, num_scenes=64,
                                             num_epochs=4)}
    n_gemm = len(ew_layers) - 2         # hidden GEMM layers: one of each
    n_hidden = len(SdfDecoder(ad0.decoder).layer_dims()) - 1
    train = {}
    for route, c in routes.items():
        state = init_ad_state(c, params=sd, codes=codes[:64], device=dev)
        rec = []

        def on_step(i, epoch, m):
            torch.cuda.synchronize()
            rec.append((time.perf_counter(), float(m["loss_l1"]),
                        float(m["loss"])))

        reset_train_launches()
        train_auto_decoder(c, dataset, state=state, device=dev,
                           on_step=on_step)
        route_launches = train_launches()
        products = tc_products()
        ms_step = (rec[-1][0] - rec[0][0]) / (len(rec) - 1) * 1e3
        l1 = [r[1] for r in rec]
        train[route] = dict(loss_l1=l1, loss=[r[2] for r in rec],
                            ms_per_step=ms_step, launches=route_launches,
                            tc_products=products)
        log(f"[train] route {route}: loss_l1 per step "
            f"{[round(v, 6) for v in l1]}, {ms_step:.1f} ms/step after one "
            f"warm-up step, launches {route_launches}, hidden layers' "
            f"tensor-core products {products} [{card}]")
        want_products = {k: 0 if route == "fused_train" else 4 * n_hidden
                         for k in ("fwd", "dgrad", "wgrad")}
        if products != want_products:
            raise RuntimeError(f"route {route}: tensor-core products "
                               f"{products}, expected {want_products}")
        want = ({"relu_dropout_fwd": 32, "relu_dropout_bwd": 32,
                 "fused_train": 0, "gemm_fwd": 0, "gemm_dgrad": 0,
                 "gemm_wgrad": 0, "layer0": 0}
                if route != "fused_train" else
                {"relu_dropout_fwd": 0, "relu_dropout_bwd": 0,
                 "fused_train": 4, "gemm_fwd": 4 * n_gemm,
                 "gemm_dgrad": 4 * n_gemm, "gemm_wgrad": 4 * n_gemm,
                 "layer0": 4})
        if route_launches != want:
            raise RuntimeError(f"route {route}: launches {route_launches}, "
                               f"expected {want}")
        if not (np.isfinite([r[2] for r in rec]).all() and len(rec) == 4):
            raise RuntimeError(f"route {route}: losses {rec}")
        if not l1[0] < 0.01:
            raise RuntimeError(f"route {route}: step-0 loss_l1 {l1[0]} >= "
                               "0.01 from the trained pack")
        if route == "fused_train":
            trained = state
        else:
            del state
        torch.cuda.empty_cache()
    log(f"[train] step-0 loss_l1, relu_dropout route vs fused route (same "
        f"batch, same masks): {train['relu_dropout']['loss_l1'][0]:.6f} vs "
        f"{train['fused_train']['loss_l1'][0]:.6f}")
    same5 = (train["config5"]["loss_l1"] == train["relu_dropout"]["loss_l1"]
             and train["config5"]["loss"] == train["relu_dropout"]["loss"])
    log(f"[train] config5_multicat_dp (data_parallel, one card): step-0 "
        f"loss_l1 {train['config5']['loss_l1'][0]:.6f}, "
        f"{train['config5']['ms_per_step']:.1f} ms/step, vs config 3's "
        f"relu_dropout route {train['relu_dropout']['loss_l1'][0]:.6f}, "
        f"{train['relu_dropout']['ms_per_step']:.1f} ms/step; every loss "
        f"equal bit for bit: {same5} [{card}]")
    if not same5:
        raise RuntimeError("config 5 on one card does not train as config "
                           "3's relu_dropout route")
    state = init_ad_state(cfg, params=sd, codes=codes[:64], device=dev)
    train["tc_vs_plain"] = [tc_vs_plain_step(
        state.decoder, cfg, table, ids_t, xyz_t.to(torch.bfloat16), sdf_t,
        4.0, 4242, "train", card, case, gate) for case, table, gate in (
            ("the chairs' own codes", state.codes, "witness"),
            ("other chairs' codes", torch.from_numpy(codes[64:128]).to(dev),
             "plain"))]
    train["layer_vs_parent"] = layer_vs_parent_step(
        state.decoder, cfg, state.codes, ids_t, xyz_t.to(torch.bfloat16),
        sdf_t, 4.0, 4243, "train", card)
    del state
    torch.cuda.empty_cache()
    details["train"] = train

    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "stage1_pack.npz"
        save_stage1_pack(path, trained.decoder.state_dict(), trained.codes)
        sd2, codes2 = load_stage1_pack(path)
    if not (np.array_equal(codes2, trained.codes.detach().cpu().numpy())
            and all(torch.equal(sd2[k], v.cpu()) for k, v in
                    trained.decoder.state_dict().items())):
        raise RuntimeError("stage-1 pack did not round-trip")
    apply2 = make_kernel_apply(SdfDecoder(cfg.decoder), sd2)
    (v2, f2, st2), = list(serve_meshes(apply2, [codes2[0]], res=res))
    log(f"[train] trained pack written, reloaded and served: chair 0 at "
        f"{res}^3 -> {len(v2)} verts, {len(f2)} faces, mesher "
        f"{st2['mesher']}")
    if len(f2) == 0 or st2["mesher"] != "native-payload":
        raise RuntimeError(f"served mesh from the trained pack: {st2}")
    details["train"]["served"] = dict(verts=len(v2), faces=len(f2))

    # ---- where a training step's time goes: one traced step per route
    xyz_w = xyz_t.to(torch.bfloat16)
    details["train_trace"] = {}
    for route in ("relu_dropout", "fused_train"):
        c = routes[route]
        state = trained if route == "fused_train" else init_ad_state(
            c, params=sd, codes=codes[:64], device=dev)
        step = make_ad_train_step(state.decoder, c)
        step(state, ids_t, xyz_w, sdf_t, 4.0, 99)          # warm-up
        wall, busy, top = device_profile(
            lambda: step(state, ids_t, xyz_w, sdf_t, 4.0, 100))
        log_profile("trace", f"one training step, route {route}", wall,
                    busy, top, card)
        details["train_trace"][route] = dict(wall_s=wall,
                                             device_busy_ms=busy,
                                             top=top[:12])
        del state, step
        torch.cuda.empty_cache()

    del trained, dataset, xyz_t, xyz_w, sdf_t, ids_t, z_t, z_far
    torch.cuda.empty_cache()

    # ---- phase 8: [bank] stage 1 from the on-device sample bank
    bk = bank_phase(dev, card, train["fused_train"]["ms_per_step"], ms_ft)
    details["bank"] = bk
    torch.cuda.empty_cache()

    # ---- phase 9: [dp] data-parallel stage-1 steps, 2 ranks on the card
    details["dp"] = dp_phase(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 10: [pairs] kernel #2 vs its plain version
    sd_m, codes_m = load_stage1_pack(ROOT.joinpath(*MULTICAT))
    pr = pairs_phase(dev, card, sd_m, codes_m)
    pairs = pr.pop("pairs")
    details["pairs"] = pr

    # ---- phase 11: [flat] config 4's 64-shape batched decode at 256^3
    fl = flat_phase(dev, card, pairs, sd_m, codes_m)
    apply1 = fl.pop("apply1")
    details["flat"] = fl
    torch.cuda.empty_cache()

    # ---- phase 12: [train_diff] config 4's stage 2 on the multicat codes
    td = train_diff_phase(dev, card, codes_m, banks)
    details["train_diff"] = td["out"]
    del banks
    torch.cuda.empty_cache()

    # ---- phase 13: [generate] config 4's generation, trained weights
    trained_diff = td.pop("trained")
    gen_out = generate_phase(dev, card, pairs, apply1, trained_diff)
    generated = gen_out.pop("latents")
    details["generate"] = gen_out
    torch.cuda.empty_cache()

    # ---- phase 13b: [export] the serving artifacts, config 5's 512^3 decode
    ex = export_phase(dev, card, apply1, sd_m, codes_m, trained_diff,
                      generated)
    details["export"] = ex
    del trained_diff, generated
    torch.cuda.empty_cache()

    # ---- phase 14: [unet] config 2-unet's stage 2 on the chair codes
    un = unet_phase(dev, card)
    details["unet"] = un["out"]
    torch.cuda.empty_cache()

    # ---- phase 15: [recon] reconstruction from observations, 4 modes
    details["recon"] = recon_phase(dev, card, un.pop("trained"))
    torch.cuda.empty_cache()

    # ---- phase 16: [cli] the main path through the CLI
    details["cli"] = cli_phase(dev, card, store)
    del store
    torch.cuda.empty_cache()

    # ---- phase 17: [realdata] real meshes in, read-outs on trained weights
    rl = realdata_phase(dev, card)
    details["realdata"] = rl

    # ---- phase 18: summary
    t512 = drop_t[512]
    dp_launches = details["dp"]["decode"]["launches"]
    kernels = [{
        "name": "fused_decoder_eval",
        "route": "cuda",
        "source": "latent_diffusion_models_for_shape_sdfs_torch/csrc/"
                  "fused_eval.cu",
        "replaces": "latent_diffusion_models_for_shape_sdfs_tpu/ops/"
                    "pallas_kernels.py:46",
        "launches": launches + rl["launches_k1"] + ex["launches"]
        + sum(r["fused_eval"] for r in dp_launches),
        "max_abs_err": max_err,
        "ms": ms_shape,
        "plain_ms": plain_shape,
        "bound_ms": bound_shape,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "relu_dropout_fwd",
        "route": "cuda",
        "source": SRC + "relu_dropout.cu",
        "replaces": "latent_diffusion_models_for_shape_sdfs_tpu/ops/"
                    "pallas_kernels.py:289",
        "launches": train["relu_dropout"]["launches"]["relu_dropout_fwd"]
        + bk["autograd"]["launches"]["relu_dropout_fwd"] + rl["launches_k3"],
        "max_abs_err": 0.0,
        "ms": t512["fwd"],
        "plain_ms": t512["plain_fwd"],
        "bound_ms": t512["bound_fwd"],
        "bound_by": "bytes",
        "library_ms": t512["library"],
    }, {
        "name": "relu_dropout_bwd",
        "route": "cuda",
        "source": SRC + "relu_dropout.cu",
        "replaces": "latent_diffusion_models_for_shape_sdfs_tpu/ops/"
                    "pallas_kernels.py:346",
        "launches": train["relu_dropout"]["launches"]["relu_dropout_bwd"]
        + bk["autograd"]["launches"]["relu_dropout_bwd"]
        + rl["launches_k3b"],
        "max_abs_err": k3b_err,
        "ms": t512["bwd"],
        "plain_ms": t512["plain_bwd"],
        "bound_ms": t512["bound_bwd"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fused_train",
        "route": "cuda",
        "source": SRC + "fused_train.cu",
        "replaces": "latent_diffusion_models_for_shape_sdfs_tpu/ops/"
                    "fused_train.py:51",
        "launches": train["fused_train"]["launches"]["fused_train"]
        + bk["fused"]["launches"]["fused_train"]
        + bk["launches"]["csg"]["fused_train"],
        "max_abs_err": ft_err,
        "ms": ms_ft,
        "plain_ms": plain_ft,
        "bound_ms": bound_ft,
        "bound_by": "operations",
        "library_ms": None,
    }, {
        "name": "fused_decoder_eval_pairs",
        "route": "cuda",
        "source": SRC + "fused_eval_pairs.cu",
        "replaces": "latent_diffusion_models_for_shape_sdfs_tpu/ops/"
                    "pallas_kernels.py:163",
        "launches": fl["launches"]
        + sum(r["fused_eval_pairs"] for r in dp_launches),
        "max_abs_err": pr["max_abs_err"],
        "ms": pr["ms"],
        "plain_ms": pr["plain_ms"],
        "bound_ms": pr["bound_ms"],
        "bound_by": pr["bound_by"],
        "library_ms": None,
    }, {
        "name": "head_fwd",
        "route": "cuda",
        "source": SRC + "head.cu",
        "replaces": None,
        "launches": bk["autograd"]["head_launches"]["head_fwd"],
        "max_abs_err": bk["head"]["pred_max_abs"],
        "ms": bk["head"]["fwd_ms"],
        "plain_ms": bk["head"]["plain_fwd_ms"],
        "bound_ms": bk["head"]["bound_fwd_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "head_bwd",
        "route": "cuda",
        "source": SRC + "head.cu",
        "replaces": None,
        "launches": bk["autograd"]["head_launches"]["head_bwd"],
        "max_abs_err": bk["head"]["dw_max_abs"],
        "ms": bk["head"]["bwd_ms"],
        "plain_ms": bk["head"]["plain_bwd_ms"],
        "bound_ms": bk["head"]["bound_bwd_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": SRC + "decoder_input.cu",
        "replaces": None,
        "launches": bk["autograd"]["input_launches"][name],
        "max_abs_err": (0.0 if name.endswith("fwd") else
                        bk["decoder_input"][name[:-4] + "_dz_max_abs"]),
        "ms": bk["decoder_input"][key + "_ms"],
        "plain_ms": bk["decoder_input"][key + "_plain_ms"],
        "bound_ms": bk["decoder_input"][key + "_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    } for name in DECODER_INPUT for key in [name.replace(".", "_")]]
    if not all(k["launches"] > 0 for k in kernels):
        raise RuntimeError(f"a kernel was not launched on its main path: "
                           f"{[(k['name'], k['launches']) for k in kernels]}")
    details.update(card=card, kind=kind, kernels=kernels,
                   total_s=time.perf_counter() - t_start)
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
