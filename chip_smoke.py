"""Smoke run of the PyTorch port on one CUDA card: build, check, serve.

    python3 chip_smoke.py [--details PATH]

Builds the fused decoder-eval kernel (csrc/fused_eval.cu, nvcc for sm_90a)
and the native mesher (native/, cmake or g++) from this checkout, then:

  1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
  2. holds the kernel against its plain version (bf16 fast_apply) on the
     committed trained 8x512 decoder at the serving path's launch shapes
     and at 2^20+131 points, and on a small tanh plan, and times both;
  3. serves 8 trained chair latents at 256^3 through serve_meshes with the
     int8 payload and the payload-direct native mesher, counting kernel
     launches, and checks one mesh against the plain version's mesh;
  4. runs the watch-folder daemon on two latent requests;
  5. prints one JSON line per checked kernel and, last, the device line.

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

    # ---- build: kernel (nvcc) and mesher (cmake/g++) at the same time
    t0 = time.perf_counter()
    mesher_err: list = []

    def _mesher():
        try:
            build_mesher()
        except Exception as e:   # re-raised on the main thread below
            mesher_err.append(e)

    th = threading.Thread(target=_mesher)
    th.start()
    lib_path = _build.build("fused_eval.cu")
    th.join()
    if mesher_err:
        raise mesher_err[0]
    reset_native_cache()
    details["build_s"] = time.perf_counter() - t0
    ptxas = lib_path.with_suffix(".log").read_text() \
        if lib_path.with_suffix(".log").exists() else ""
    log(f"[build] {details['build_s']:.1f}s  {lib_path.name}")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")

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
    sd, codes = load_stage1_pack(ROOT / "runs" / "scale_chairs6k"
                                 / "stage1_pack.npz")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(serve_meshes(apply, lat, res=res))
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
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
    busy = busy_us / 1e3
    if busy > 0:
        log(f"[trace] serve of {len(lat)} shapes: wall "
            f"{traced_wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / (traced_wall * 1e3):.1f}% of wall) [{card}]")
        for name, ms, cnt in top[:6]:
            log(f"[trace]   {ms:9.3f} ms  x{cnt:<5d} {name[:80]}")
    else:
        log("[trace] torch.profiler recorded no device time: not measured")
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

    # ---- phase 5: summary
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
    }]
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
