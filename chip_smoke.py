"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, train.

    python3 chip_smoke.py [--details PATH]

Builds the port's CUDA kernels (csrc/fused_eval.cu, csrc/relu_dropout.cu,
csrc/fused_train.cu: one nvcc each for sm_90a, all started together) and
the native mesher (native/, cmake or g++) from this checkout, while it
generates the training data (64 analytic chairs, a process pool started
before CUDA is), then:

  1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
  2. holds the decoder-eval kernel against its plain version (bf16
     fast_apply) on the committed trained 8x512 decoder at the serving
     path's launch shapes and at 2^20+131 points, and on a small tanh
     plan, and times both;
  3. serves 8 trained chair latents at 256^3 through serve_meshes with the
     int8 payload and the payload-direct native mesher, counting kernel
     launches, and checks one mesh against the plain version's mesh;
     traces a repeat under torch.profiler;
  4. runs the watch-folder daemon on two latent requests;
  5. [dropout] holds the relu+dropout kernels (forward #3, backward #3b)
     bit for bit against their plain versions (and #3b against autograd
     of the plain forward) and times them;
  6. [fused_train] holds the fused train kernel (#4) against its plain
     version at 64 scenes x 16,384 points on the trained decoder, dropout
     0 and 0.2, checks two passes are bit-identical, and times it;
  7. [train] trains config 3's `ad` block (cut to 64 scenes, 20,000
     samples per shape, 4 epochs of one step) from the committed pack
     through both kernel routes (relu+dropout kernels; fused train
     kernel), counting launches, then writes the trained pack, reloads it
     and serves chair 0 at 256^3; traces one step of each route;
  8. prints one JSON line per ported kernel and, last, the device line.

Any failure raises and exits non-zero; without a card (or outside a
checkout of the repository) it exits non-zero before printing a result.
`--details PATH` also writes every measured number as JSON to PATH.
"""

from __future__ import annotations

import argparse
import json
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
RATE = 0.2                   # config 3's dropout
PACK = ("runs", "scale_chairs6k", "stage1_pack.npz")
SRC = "latent_diffusion_models_for_shape_sdfs_torch/csrc/"


def log(*a):
    print(*a, flush=True)


def build_mesher() -> None:
    """native/build/libmarching_cubes_c.so: cmake if present, else g++."""
    out = ROOT / "native" / "build" / "libmarching_cubes_c.so"
    if out.exists():
        return
    if shutil.which("cmake"):
        subprocess.run(["cmake", "-S", str(ROOT / "native"), "-B",
                        str(ROOT / "native" / "build")], check=True,
                       capture_output=True)
        subprocess.run(["cmake", "--build", str(ROOT / "native" / "build"),
                        "--target", "marching_cubes_c", "-j", "8"],
                       check=True, capture_output=True)
    else:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-pthread",
                        str(ROOT / "native" / "marching_cubes" / "clib.cpp"),
                        "-o", str(out)], check=True, capture_output=True)
    if not out.exists():
        raise RuntimeError(f"mesher build produced no {out}")


def kernel_macs_per_point(decoder) -> int:
    """Multiply-adds per point the kernel must do (the latent products are
    hoisted out of it): xyz columns of layer 0, hidden and xyz columns of
    the skip layers, every other layer in full."""
    L = decoder.cfg.latent_size
    macs = 0
    for i, (d_in, out, skip) in enumerate(decoder.layer_dims()):
        macs += (3 if i == 0 else d_in - L if skip else d_in) * out
    return macs


def bound(n_points: int, macs: int, weight_bytes: int) -> tuple:
    """Least time (ms) for n points on this card: operations over the bf16
    peak vs bytes (xyz in, sdf out, weights once) over HBM bandwidth."""
    ops = 2.0 * macs * n_points / PEAK_BF16_FLOPS
    byt = (16.0 * n_points + weight_bytes) / PEAK_HBM_BYTES
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


def device_profile(fn) -> tuple:
    """Runs fn() once under torch.profiler; returns (wall s, device busy
    ms as the union of device spans, [(name, ms, count)] by device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
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
        hoisted_rows, make_kernel_apply)
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
    sources = ["fused_eval.cu", "relu_dropout.cu", "fused_train.cu"]
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

    # ---- phase 2: kernel vs plain version
    sd, codes = load_stage1_pack(ROOT.joinpath(*PACK))
    decoder = SdfDecoder(DecoderConfig())
    apply = make_kernel_apply(decoder, sd)
    macs = kernel_macs_per_point(decoder)
    wbytes = apply.w_all.nbytes + apply.wx_all.nbytes
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
    small = SdfDecoder(DecoderConfig(latent_size=8, hidden_dim=32,
                                     num_layers=2, latent_in=(),
                                     use_tanh=True, use_dropout=False))
    apply_t = make_kernel_apply(small, small.state_dict())
    zt = torch.randn(8, device=dev) / np.sqrt(8)
    xt = torch.rand(4096 + 77, 3, device=dev) * 2 - 1
    err_t = float((apply_t(zt, xt) - fast_apply(apply_t.ew, zt, xt))
                  .abs().max())
    log(f"[kernel] tanh plan (latent 8, 2x32, no skip): max err "
        f"{err_t:.3e} (tol {TOL})")
    if err_t > TOL:
        raise RuntimeError(f"tanh plan disagrees: {err_t}")
    max_err = max(max_err, err_t)

    # timing: one 256^3 shape's four launches, and 2^20 points
    z0 = torch.from_numpy(codes[0]).to(dev)
    rows = hoisted_rows(apply.ew, apply.meta, z0)
    pts = [torch.rand(n, 3, device=dev) * 2 - 1 for n in shape_points]
    ms_shape = time_ms(lambda: [apply.launch(p, rows) for p in pts], 20)
    plain_shape = time_ms(lambda: [fast_apply(apply.ew, z0, p)
                                   for p in pts], 5)
    bound_shape, bound_by = bound(sum(shape_points), macs, wbytes)
    p20 = torch.rand(1 << 20, 3, device=dev) * 2 - 1
    ms_20 = time_ms(lambda: apply.launch(p20, rows), 20)
    plain_20 = time_ms(lambda: fast_apply(apply.ew, z0, p20), 5)
    bound_20, _ = bound(1 << 20, macs, wbytes)
    tflops = 2.0 * macs * (1 << 20) / (ms_20 * 1e-3) / 1e12
    log(f"[kernel] one 256^3 shape ({sum(shape_points)} points in "
        f"{len(shape_points)} launches): kernel {ms_shape:.3f} ms, plain "
        f"{plain_shape:.3f} ms, bound {bound_shape:.3f} ms ({bound_by}) "
        f"[{card}]")
    log(f"[kernel] 2^20 points: kernel {ms_20:.3f} ms ({tflops:.1f} "
        f"TFLOP/s), plain {plain_20:.3f} ms, bound {bound_20:.3f} ms "
        f"[{card}]")
    details["kernel"] = dict(
        max_abs_err=max_err, tanh_err=err_t, shape_points=shape_points,
        ms_shape=ms_shape, plain_ms_shape=plain_shape,
        bound_ms_shape=bound_shape, ms_2p20=ms_20, plain_ms_2p20=plain_20,
        bound_ms_2p20=bound_20, tflops_2p20=tflops, macs_per_point=macs)

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
    drop_t = {}
    for cols in (512, 253):
        x = torch.randn(1 << 20, cols, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn_like(x)
        n_el = x.numel()
        drop_t[cols] = dict(
            fwd=time_ms(lambda: rd.relu_dropout_fwd(x, 1, RATE), 20),
            bwd=time_ms(lambda: rd.relu_dropout_bwd(x, g, 1, RATE), 20),
            plain_fwd=time_ms(lambda: rd.relu_dropout_reference(x, 1, RATE),
                              2),
            plain_bwd=time_ms(lambda: rd.relu_dropout_bwd_reference(
                x, g, 1, RATE), 2),
            library=time_ms(lambda: F.dropout(F.relu(x), RATE, True), 20),
            bound_fwd=4.0 * n_el / PEAK_HBM_BYTES * 1e3,
            bound_bwd=6.0 * n_el / PEAK_HBM_BYTES * 1e3)
        t = drop_t[cols]
        log(f"[dropout] [2^20, {cols}] bf16 per launch: #3 {t['fwd']:.3f} ms "
            f"(bound {t['bound_fwd']:.3f}, bytes), #3b {t['bwd']:.3f} ms "
            f"(bound {t['bound_bwd']:.3f}), plain {t['plain_fwd']:.3f} / "
            f"{t['plain_bwd']:.3f} ms, library F.dropout(F.relu(x)) (two "
            f"calls) {t['library']:.3f} ms [{card}]")
        del x, g
    details["dropout"] = drop_t

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
                                  rel=ft_rel)
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
    routes = {"relu_dropout": cfg,
              "fused_train": dataclasses.replace(cfg, use_pallas=True)}
    train = {}
    for route, c in routes.items():
        state = init_ad_state(c, params=sd, codes=codes[:64], device=dev)
        rec = []

        def on_step(i, epoch, m):
            torch.cuda.synchronize()
            rec.append((time.perf_counter(), float(m["loss_l1"]),
                        float(m["loss"])))

        for k in rd.LAUNCHES:
            rd.LAUNCHES[k] = 0
        ft.LAUNCHES["fused_train"] = 0
        train_auto_decoder(c, dataset, state=state, device=dev,
                           on_step=on_step)
        route_launches = {**rd.LAUNCHES, **ft.LAUNCHES}
        ms_step = (rec[-1][0] - rec[0][0]) / (len(rec) - 1) * 1e3
        l1 = [r[1] for r in rec]
        train[route] = dict(loss_l1=l1, loss=[r[2] for r in rec],
                            ms_per_step=ms_step, launches=route_launches)
        log(f"[train] route {route}: loss_l1 per step "
            f"{[round(v, 6) for v in l1]}, {ms_step:.1f} ms/step after one "
            f"warm-up step, launches {route_launches} [{card}]")
        want = ({"relu_dropout_fwd": 32, "relu_dropout_bwd": 32,
                 "fused_train": 0} if route == "relu_dropout" else
                {"relu_dropout_fwd": 0, "relu_dropout_bwd": 0,
                 "fused_train": 4})
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
    for route, c in routes.items():
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

    # ---- phase 8: summary
    t512 = drop_t[512]
    kernels = [{
        "name": "fused_decoder_eval",
        "route": "cuda",
        "source": "latent_diffusion_models_for_shape_sdfs_torch/csrc/"
                  "fused_eval.cu",
        "replaces": "latent_diffusion_models_for_shape_sdfs_tpu/ops/"
                    "pallas_kernels.py:46",
        "launches": launches,
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
        "launches": train["relu_dropout"]["launches"]["relu_dropout_fwd"],
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
        "launches": train["relu_dropout"]["launches"]["relu_dropout_bwd"],
        "max_abs_err": 0.0,
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
        "launches": train["fused_train"]["launches"]["fused_train"],
        "max_abs_err": ft_err,
        "ms": ms_ft,
        "plain_ms": plain_ft,
        "bound_ms": bound_ft,
        "bound_by": "operations",
        "library_ms": None,
    }]
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
