"""End-to-end mesh-serving path: latents -> meshes.

Counterpart of the JAX package's `serve.py` (`serve_meshes`,
`serve_meshes_sharded`, `generate_meshes`, `watch_and_serve`). Latents ->
three-level sparse hierarchical decode on the card (every point
evaluation through the fused decoder-eval kernel when `apply_fn` is
`ops.cuda_kernels.make_kernel_apply`) -> compact int8 near-surface
payload -> copied to pinned host buffers -> meshed directly by the
native C++ library (no dense grid on the host; reconstruct +
marching tetrahedra is the fallback).

Pipelining: every decode is enqueued on the current CUDA stream up front,
each followed by a copy of its three active counts into pinned memory and
an event. The host waits on shape i's event only, slices the payload to
row buckets, and starts its device-to-host copy on a second stream that
waits on that same event, so the copy of shape i overlaps the device's
decode of the shapes after it. A host thread pool meshes shapes in
parallel; a mesh job waits on its copy's event before reading the pinned
buffers (reading a pinned non-blocking copy before that reads garbage).
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
    _sparse2_dequant, decode_grid_hierarchical3_sparse2, hier3_int8_scale,
    sparse2_fill2, sparse2_to_grid)
from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
    extract_mesh, extract_mesh_payload, mesher_impl, simplify_mesh)
from latent_diffusion_models_for_shape_sdfs_torch.utils import meshio
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)


def _auto_workers() -> int:
    """Meshing thread count: cores+1 capped at 4 (the +1 keeps one thread
    draining copies while another meshes; more threads on a small host
    just contend)."""
    return min(4, (os.cpu_count() or 1) + 1)


def _mesh_v2_payload(c1a, c2a, idx1, vals2, ids2, n1, n2, res, iso, dq):
    """Mesh one v2 payload (numpy arrays): payload-direct native path at
    iso=0 (no dense grid on the host), else reconstruct + marching
    tetrahedra. Returns (verts, faces, mesher), `mesher` naming the
    implementation that ran ("native-payload" | "native-lib" | "numpy"),
    so a silent fallback is visible in the stats."""
    if iso == 0.0:
        fill2 = sparse2_fill2(c1a, c2a, idx1, n1, res, 16, 4, dq)
        out = extract_mesh_payload(
            fill2, _sparse2_dequant(vals2, dq), ids2, n2, res, 4)
        if out is not None:
            return out[0], out[1], "native-payload"
    grid = sparse2_to_grid(c1a, c2a, idx1, vals2, ids2, n1, n2,
                           res, 16, 4, dequant_scale=dq)
    verts, faces = extract_mesh(grid, iso=iso)
    return verts, faces, mesher_impl()


def _maybe_simplify(verts, faces, simplify_faces, simplify_ratio):
    """Optional LOD post-pass (native QEM decimation). Returns
    (verts, faces, faces_before-or-None)."""
    if simplify_faces is None and simplify_ratio is None:
        return verts, faces, None
    nf0 = len(faces)
    verts, faces = simplify_mesh(verts, faces, target_faces=simplify_faces,
                                 ratio=simplify_ratio)
    return verts, faces, nf0


def _default_caps(res: int) -> tuple:
    # surface-shell-scale starting capacities
    nb1 = res // 16
    return (max(256, nb1 ** 3 // 4), max(2048, res ** 2 // 4),
            max(8192, res ** 2))


def _bucket(n: int, cap: int) -> int:
    """Smallest of {cap >> 5 .. cap} (power-of-two ladder, floor 256)
    holding n rows: the payload is shipped at a bucketed row count, so a
    shape's copy scales with its active rows, not with the caps."""
    b = cap
    while b // 2 >= max(256, n):
        b //= 2
    return min(b, cap)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """CPU tensor -> numpy (bf16 payloads widen to f32: numpy has no
    bfloat16)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def serve_meshes(apply_fn, latents: Sequence, res: int = 256,
                 safety: float = 1.2, safety3: float = 2.0,
                 iso: float = 0.0, caps: Optional[tuple] = None,
                 max_escalations: int = 4, out_dtype: str = "int8",
                 mesh_workers: Optional[int] = None,
                 simplify_faces: Optional[int] = None,
                 simplify_ratio: Optional[float] = None,
                 device="cuda") -> Iterator[tuple]:
    """Yield (verts, faces, stats) for each latent in `latents`, in order.

    `apply_fn`: ops.grid_eval ApplyFn on `device`, e.g.
    ops.cuda_kernels.make_kernel_apply(decoder, params). `device` defaults
    to "cuda" (raises when no card is present); pass "cpu" to serve on
    the CPU.

    Every decode ships the compact v2 payload with its row arrays sliced
    to the smallest power-of-two bucket holding the shape's active counts.
    A shape whose shell overflows the capacities is re-decoded (on this
    thread, synchronously) with fitted caps; if the escalation budget is
    exhausted, the mesh is built from the truncated payload and the stats
    carry ``capacity_exceeded=True`` with the final ``cap1/cap2/cap3``.

    `out_dtype`: "int8" (default; quantized at tau2/127 with sign
    preservation, so the crossing set is exactly the f32 payload's),
    "int4" (fine rows packed to nibbles), "bfloat16", or "float32" (the
    fp32 lineage-parity mode). `mesh_workers` (None = cores+1, max 4) > 1
    meshes shapes in parallel; 1 meshes serially. `simplify_faces` /
    `simplify_ratio`: optional QEM decimation per mesh (stats gain
    ``faces_before``).
    """
    dev = resolve_device(device)
    if iso != 0.0 and out_dtype in ("int8", "int4"):
        # int8/int4 payload values are clamped at tau2: any |iso| >= tau2
        # level set would come back silently empty
        raise ValueError(
            "serve_meshes: iso != 0 needs a magnitude-preserving "
            "payload; pass out_dtype='float32' (or 'bfloat16')")
    cap1, cap2, cap3 = caps or _default_caps(res)
    dq = (hier3_int8_scale(res, 4, safety)
          if out_dtype in ("int8", "int4") else None)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda else None

    def decode(z, c1, c2, c3, check):
        return decode_grid_hierarchical3_sparse2(
            apply_fn, z, res, 16, 4, 2, c1, c2, c3, safety=safety,
            safety3=safety3, out_dtype=out_dtype, check_overflow=check)

    def mark(counts=None):
        """Event after the work enqueued so far (None on the CPU), and
        the counts copied into pinned memory ahead of it."""
        if not cuda:
            return counts, None
        host = None
        if counts is not None:
            host = torch.empty(3, dtype=torch.int32, pin_memory=True)
            host.copy_(counts, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    # enqueue every decode before reading any result
    zs = [torch.as_tensor(z, dtype=torch.float32, device=dev)
          for z in latents]
    pending = []
    for z in zs:
        arrs, st = decode(z, cap1, cap2, cap3, False)
        counts, ev = mark(torch.stack([st["active_l1"], st["active_l2"],
                                       st["active_l3"]]))
        pending.append((arrs, counts, ev))

    def start_copy(arrs, ev):
        """Device-to-host copies of one payload into pinned buffers on
        the copy stream, after `ev`. Returns (host tensors, done event)."""
        if not cuda:
            return arrs, None
        copy_stream.wait_event(ev)
        host = []
        with torch.cuda.stream(copy_stream):
            for a in arrs:
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                a.record_stream(copy_stream)
                host.append(h)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return host, done

    def mesh_job(host, done, n1, n2, n3, c1, c2, c3, esc):
        # wait for the copy first, so the stats split copy wait from pure
        # host meshing (the two candidate bottlenecks of the loop)
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        c1a, c2a, idx1, vals2, ids2 = (_host_array(a) for a in host)
        t1 = time.perf_counter()
        verts, faces, mesher = _mesh_v2_payload(
            c1a, c2a, idx1, vals2, ids2, min(n1, c1), min(n2, c2), res,
            iso, dq)
        verts, faces, nf0 = _maybe_simplify(verts, faces, simplify_faces,
                                            simplify_ratio)
        t2 = time.perf_counter()
        stats = {
            "active_l1": n1, "active_l2": n2, "active_l3": n3,
            "escalations": esc, "cap1": c1, "cap2": c2, "cap3": c3,
            "capacity_exceeded": n1 > c1 or n2 > c2 or n3 > c3,
            "payload_bytes": int(sum(a.nbytes for a in host)),
            "mesher": mesher,
            "t_d2h_wait_s": t1 - t0, "t_mesh_s": t2 - t1}
        if nf0 is not None:
            stats["faces_before"] = nf0
        return verts, faces, stats

    def jobs():
        # escalation decodes stay on this (main) thread: one device
        # stream; only host meshing fans out
        for z, (arrs, counts, ev) in zip(zs, pending):
            if ev is not None:
                ev.synchronize()
            n1, n2, n3 = (int(x) for x in counts.tolist())
            c1, c2, c3 = cap1, cap2, cap3
            esc = 0
            while (n1 > c1 or n2 > c2 or n3 > c3) \
                    and esc < max_escalations:
                # jump straight to the measured count + 25% headroom
                # (rounded to 128); the count under-counts only when a
                # coarser level was also truncated, which the loop absorbs
                def fit(c, n):
                    return max(2 * c, -(-int(1.25 * n) // 128) * 128) \
                        if n > c else c
                c1, c2, c3 = fit(c1, n1), fit(c2, n2), fit(c3, n3)
                arrs, st = decode(z, c1, c2, c3, True)
                n1, n2, n3 = (st["active_l1"], st["active_l2"],
                              st["active_l3"])
                _, ev = mark()
                esc += 1
            # slice to row buckets, then start the copy so shape i's
            # transfer overlaps the device work and meshing after it
            k1 = _bucket(n1, c1)
            k2 = _bucket(n2, c2)
            c1a, c2a, idx1, vals2, ids2 = arrs
            host, done = start_copy(
                (c1a, c2a[:k1], idx1[:k1], vals2[:k2], ids2[:k2]), ev)
            yield (host, done, n1, n2, n3, c1, c2, c3, esc)

    if mesh_workers is None:
        mesh_workers = _auto_workers()
    if mesh_workers <= 1:
        # one-job lookahead: advancing jobs() is what starts shape i+1's
        # copy, so pull it BEFORE meshing shape i
        it = jobs()
        prev = next(it, None)
        while prev is not None:
            nxt = next(it, None)
            yield mesh_job(*prev)
            prev = nxt
        return
    with ThreadPoolExecutor(max_workers=mesh_workers) as pool:
        futures = [pool.submit(mesh_job, *job) for job in jobs()]
        for fut in futures:
            yield fut.result()


def serve_meshes_sharded(apply_fn, latents: Sequence, mesh,
                         res: int = 256, safety: float = 1.2,
                         safety3: float = 2.0, iso: float = 0.0,
                         caps: Optional[tuple] = None,
                         out_dtype: str = "int8",
                         simplify_faces: Optional[int] = None,
                         simplify_ratio: Optional[float] = None,
                         device="cuda") -> Iterator[tuple]:
    """serve_meshes over a parallel.mesh.DataMesh: the latent batch is split
    over the ranks (parallel.dp.make_dp_sparse_decode_fn), each rank
    decodes its shapes' compact v2 payloads on its device, and the
    payloads, sliced to row buckets shared by the batch (the largest
    shape's), are gathered (parallel.dp.all_gather_rows). Rank 0 meshes
    them on host threads and yields (verts, faces, stats) in input order.
    A shape whose shell overflows the shared capacities is re-decoded on
    rank 0 through the single-device serve_meshes with doubled caps. The
    latent list is padded to a multiple of mesh.size internally.

    Every rank must drive the generator, since the decode and the gathers
    are collective; on every rank but 0 it yields nothing. `latents` and
    the arguments must be the same on every rank, and `apply_fn`
    evaluates on `device` (this rank's card, or "cpu").
    """
    from latent_diffusion_models_for_shape_sdfs_torch.parallel.dp import (
        all_gather_rows, make_dp_sparse_decode_fn)

    if len(latents) == 0:
        return
    if iso != 0.0 and out_dtype in ("int8", "int4"):
        raise ValueError(
            "serve_meshes_sharded: iso != 0 needs a magnitude-preserving "
            "payload; pass out_dtype='float32' (or 'bfloat16')")
    dev = resolve_device(device)
    cap1, cap2, cap3 = caps or _default_caps(res)
    dq = (hier3_int8_scale(res, 4, safety)
          if out_dtype in ("int8", "int4") else None)
    n_shapes = len(latents)
    pad = (-n_shapes) % mesh.size
    zs = np.stack([np.asarray(z, np.float32) for z in latents]
                  + [np.asarray(latents[0], np.float32)] * pad)
    fn = make_dp_sparse_decode_fn(apply_fn, res, len(zs), mesh,
                                  (cap1, cap2, cap3), safety, safety3,
                                  out_dtype=out_dtype)
    (c1a, c2a, i1, v2, i2), counts = fn(torch.from_numpy(zs).to(dev))
    n1, n2, n3 = (c.cpu().numpy() for c in all_gather_rows(mesh, counts))
    # row buckets shared by the whole batch, sliced at the largest shape
    k1 = _bucket(int(n1[:n_shapes].max()), cap1)
    k2 = _bucket(int(n2[:n_shapes].max()), cap2)
    c1a, c2a, i1, v2, i2 = (_host_array(a.cpu()) for a in all_gather_rows(
        mesh, [c1a, c2a[:, :k1], i1[:, :k1], v2[:, :k2], i2[:, :k2]]))
    if mesh.rank != 0:
        return

    def mesh_job(i):
        verts, faces, mesher = _mesh_v2_payload(
            c1a[i], c2a[i], i1[i], v2[i], i2[i],
            min(int(n1[i]), cap1), min(int(n2[i]), cap2), res, iso, dq)
        verts, faces, nf0 = _maybe_simplify(verts, faces, simplify_faces,
                                            simplify_ratio)
        stats = {
            "active_l1": int(n1[i]), "active_l2": int(n2[i]),
            "active_l3": int(n3[i]), "escalations": 0,
            "cap1": cap1, "cap2": cap2, "cap3": cap3,
            "capacity_exceeded": False, "mesher": mesher,
            "payload_bytes": int(sum(a[i].nbytes for a in
                                     (c1a, c2a, i1, v2, i2)))}
        if nf0 is not None:
            stats["faces_before"] = nf0
        return verts, faces, stats

    # host meshing overlapped across shapes; escalation re-decodes stay on
    # this thread (one device stream)
    with ThreadPoolExecutor(max_workers=_auto_workers()) as pool:
        futures = {i: pool.submit(mesh_job, i) for i in range(n_shapes)
                   if not (n1[i] > cap1 or n2[i] > cap2 or n3[i] > cap3)}
        for i in range(n_shapes):
            if i in futures:
                yield futures[i].result()
            else:
                yield next(iter(serve_meshes(
                    apply_fn, [zs[i]], res=res, safety=safety,
                    safety3=safety3, iso=iso, out_dtype=out_dtype,
                    caps=(2 * cap1, 2 * cap2, 2 * cap3),
                    simplify_faces=simplify_faces,
                    simplify_ratio=simplify_ratio, device=dev)))


def generate_meshes(apply_fn, denoise_fn, schedule, generator, n: int,
                    latent_size: int, mu=None, sigma=None, steps: int = 50,
                    res: int = 256, sampler: str = "ddim",
                    **serve_kw) -> Iterator[tuple]:
    """Generation service: sample n latents on the schedule's device
    (`sampler` "ddim", or "dpm" = DPM-Solver++(2M), few-step: pair it with
    steps ~10) with `generator` (a torch.Generator on that device),
    un-normalize them with the stage-2 code moments mu/sigma
    (train.diffusion.normalize_codes; None skips it), then stream meshes
    through serve_meshes on the same device. Conditioning and CFG are the
    caller's: pass a wrapped denoise_fn (diffusion.sampler.guided_denoise_fn).
    """
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        ddim_sample, dpm_solver_sample)
    from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
        unnormalize_codes)

    sample_fn = {"ddim": ddim_sample, "dpm": dpm_solver_sample}[sampler]
    zs = sample_fn(denoise_fn, schedule, generator, n, latent_size,
                   steps=steps)
    if mu is not None:
        zs = unnormalize_codes(zs, mu, sigma)
    return serve_meshes(apply_fn, list(zs), res=res, device=schedule.device,
                        **serve_kw)


def make_obs_reconstruct_fn(decoder, encoder=None, enc_moments=None,
                            refine_steps: int = 0, rcfg=None):
    """The daemon's (obs_xyz [N,3], obs_sdf [N]) -> z [L] (numpy) hook, on
    the decoder's device.

    With `encoder` (models.encoder.LatentEncoder) and `enc_moments` (the
    encoder checkpoint's (mu, sigma): it predicts NORMALIZED codes): the
    one-shot prediction, refined by `refine_steps` of latent optimisation
    warm-started there when refine_steps > 0. Without an encoder: plain
    latent optimisation (reconstruct.reconstruct_latent) with `rcfg`
    (ReconstructConfig, default its defaults), from cfg.seed's z0 on
    every request. The optimisation's captured step is kept per (k, N,
    steps), so requests of one size replay one graph; the cache keeps the
    reconstruct.CACHE_SIZE latest sizes and frees the graphs it evicts."""
    import dataclasses

    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ReconstructConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.models.encoder import (
        encode_latent)
    from latent_diffusion_models_for_shape_sdfs_torch.reconstruct import (
        reconstruct_latent)
    rcfg = rcfg or ReconstructConfig()
    if encoder is not None and refine_steps > 0:
        rcfg = dataclasses.replace(rcfg, num_steps=refine_steps)
    dev = next(decoder.parameters()).device
    cache: dict = {}

    def fn(obs_xyz, obs_sdf):
        ox = torch.as_tensor(np.asarray(obs_xyz, np.float32), device=dev)
        od = torch.as_tensor(np.asarray(obs_sdf, np.float32), device=dev)
        z0 = None
        if encoder is not None:
            mu, sigma = enc_moments
            z0 = encode_latent(encoder, ox, od, mu, sigma)
            if refine_steps <= 0:
                return z0.cpu().numpy()
        z, _ = reconstruct_latent(decoder, ox, od, rcfg, z_init=z0,
                                  cache=cache)
        return z.cpu().numpy()

    fn.cache = cache
    return fn


def watch_and_serve(apply_fn, in_dir, out_dir, res: int = 256,
                    poll: float = 0.5, mesh_format: str = "ply",
                    max_idle: Optional[float] = None,
                    reconstruct_fn=None, device="cuda",
                    **serve_kw) -> int:
    """Long-running serving daemon: watch `in_dir` for request files,
    decode each through serve_meshes, write meshes + a stats sidecar
    under `out_dir`, and rename the input to `<name>.done`. One request
    file = one serve_meshes batch.

    Request types:
      - ``*.npy``: latents, [L] or [N, L].
      - ``*.npz`` with ``obs_xyz``/``obs_sdf`` arrays ([N,3]/[N] or
        batched [B,N,3]/[B,N]): observations of unseen shapes, served as
        reconstructions via `reconstruct_fn` ((xyz, sdf) -> z). Without a
        reconstruct_fn such a request is quarantined with an explanatory
        error sidecar. An ``*.npz`` carrying a ``z`` array is served as
        latents.

    A malformed request is quarantined (`<stem>.error.json`, input
    renamed `.failed`) and the daemon keeps serving. Stop conditions: a
    file named ``STOP`` in `in_dir` (consumed), or `max_idle` seconds
    without new work (None = run until STOP). Returns the number of
    request files served. Inputs are renamed only after their outputs
    are written, so a restarted daemon re-serves a half-done request. A
    request is loaded only once its (size, mtime) is unchanged across two
    polls, so a file still being written is never read; a reused name
    supersedes its stale ``.done`` marker.
    """
    dev = resolve_device(device)
    in_dir = pathlib.Path(in_dir)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    served = 0
    last_work = time.time()
    settling: dict = {}
    while True:
        stop = in_dir / "STOP"
        if stop.exists():
            stop.unlink()
            break
        reqs = []
        for p in sorted(list(in_dir.glob("*.npy"))
                        + list(in_dir.glob("*.npz"))):
            try:
                st = p.stat()
            except FileNotFoundError:
                settling.pop(p, None)
                continue
            sig = (st.st_size, st.st_mtime_ns)
            if settling.get(p) == sig:
                reqs.append((p, sig))
            else:
                settling[p] = sig  # new or still growing: settle one poll
        if not reqs:
            if (max_idle is not None and not settling
                    and time.time() - last_work > max_idle):
                break
            time.sleep(poll)
            continue
        for req, pickup_sig in reqs:
            settling.pop(req, None)
            done = req.with_suffix(req.suffix + ".done")
            done.unlink(missing_ok=True)

            def _retire(suffix):
                # if the client overwrote req while the old content was
                # served, leave the new file for the next poll
                try:
                    st2 = req.stat()
                except FileNotFoundError:
                    return
                if (st2.st_size, st2.st_mtime_ns) == pickup_sig:
                    req.rename(req.with_suffix(req.suffix + suffix))
            try:
                zs = _load_request(req, reconstruct_fn)
                stats_all = []
                for i, (v, f, st) in enumerate(serve_meshes(
                        apply_fn, list(zs), res=res, device=dev,
                        **serve_kw)):
                    meshio.write_mesh(
                        out_dir / f"{req.stem}_{i:03d}.{mesh_format}", v, f)
                    st["verts"] = len(v)
                    st["faces"] = len(f)
                    stats_all.append(st)
            except Exception as e:  # malformed request: quarantine and
                # keep serving (a daemon must outlive bad inputs)
                (out_dir / f"{req.stem}.error.json").write_text(
                    json.dumps({"error": f"{type(e).__name__}: {e}"}))
                _retire(".failed")
                last_work = time.time()
                continue
            (out_dir / f"{req.stem}.stats.json").write_text(
                json.dumps(stats_all, indent=2, default=float))
            _retire(".done")
            served += 1
            last_work = time.time()
    return served


def _load_request(req: pathlib.Path, reconstruct_fn) -> np.ndarray:
    """A request file -> latents [N, L] float32 (raises on a malformed
    request)."""
    if req.suffix == ".npz":
        with np.load(req) as d:
            if "obs_xyz" in d.files and "obs_sdf" in d.files:
                if reconstruct_fn is None:
                    raise ValueError(
                        "observation request but this daemon has no "
                        "reconstruct_fn")
                ox = np.asarray(d["obs_xyz"], np.float32)
                od = np.asarray(d["obs_sdf"], np.float32)
                if ox.ndim == 2:
                    ox, od = ox[None], od[None]
                if ox.ndim != 3 or od.ndim != 2:
                    raise ValueError(
                        f"obs must be [N,3]/[N] or [B,N,3]/[B,N], got "
                        f"{ox.shape}/{od.shape}")
                zs = np.stack([np.asarray(reconstruct_fn(ox[i], od[i]),
                                          np.float32)
                               for i in range(ox.shape[0])])
            elif "z" in d.files:
                zs = np.asarray(d["z"], np.float32)
            else:
                raise ValueError("npz request needs obs_xyz/obs_sdf "
                                 f"(or z); has {d.files}")
    else:
        zs = np.asarray(np.load(req), np.float32)
    zs = zs[None] if zs.ndim == 1 else zs
    if zs.ndim != 2:
        raise ValueError(f"latents must be [L] or [N, L], got shape "
                         f"{zs.shape}")
    return zs
