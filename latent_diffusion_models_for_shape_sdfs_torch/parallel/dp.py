"""Data parallelism over torch.distributed: the stage-1 steps, sampling
and the decodes.

Counterpart of the JAX package's `parallel/dp.py`. The training half
(`_shard_map_pallas_vag`, `make_dp_ad_train_step`, `make_dp_bank_step`):
Every rank holds the whole state (decoder, latent table, Adam) and takes
its slice of the batch's scenes. It computes its partial loss and
gradients on either route (the fused train kernel, or autograd with the
relu+dropout kernels), normalised globally: the clamped-L1 term divides
by the global S x P and the code-reg term by `cfg.scenes_per_batch`
(`reg_scene_count`). The partial sums (loss terms, the dense latent-table
gradient, and the decoder gradients: on the fused route those of the
folded weights, in f32, before the fold's chain rounds them to bf16) are
summed over the ranks by one `all_reduce(SUM)`, and every rank applies
the same Adam update, so the replicas stay equal. Only `all_reduce` is
used: gloo has it on CUDA tensors (and not `all_gather`).

The dropout seed is folded with the rank, so the shards draw other masks
(rank 0 keeps the seed: a group of one rank steps exactly as one device).

The decode half (`make_dp_ddim_fn`, `dp_ddim_sample`,
`make_decode_points_fn`, `decode_points_sharded`, `make_dp_pairs_fn`,
`make_dp_sparse_decode_fn`, `decode_grid_sharded`): each rank samples,
evaluates or decodes its slice of the batch (latents, points, shapes)
with the single-device function; there is no communication inside. In
JAX a sharded output is one array any host reads; here each rank holds
its shard, so a function whose reference returns a whole array gathers
the shards onto every rank (`all_gather_rows`), and
`make_dp_sparse_decode_fn`, whose reference leaves its payloads sharded,
returns this rank's shard. The gather moves raw bytes: under NCCL one
`all_gather_into_tensor`; under any other backend (gloo, which has no
all_gather on CUDA tensors) one `all_reduce(SUM)` of a uint8 buffer in
which each rank fills its own slice and leaves the others zero, exact
because every byte has one nonzero term.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from latent_diffusion_models_for_shape_sdfs_torch.config import AdConfig
from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
    DeviceSampleBank)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.parallel.mesh import (
    DataMesh, batch_sharded)
from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
    AdTrainState, make_ad_train_step)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of `rank`: the seed itself on rank 0, else a
    31-bit hash of (seed, rank)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint32)[0] >> 1)


def _all_reduce_fn(mesh: DataMesh) -> Callable:
    """all_reduce(tensors): sum a list of f32 tensors over the mesh in
    place, through one all_reduce(SUM) of their concatenation, in the
    span `ad.all_reduce`."""

    def all_reduce(tensors: list) -> None:
        with profiling.span("ad.all_reduce"):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            at = 0
            for t in tensors:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()

    return all_reduce


def _local_step(decoder: SdfDecoder, cfg: AdConfig,
                mesh: DataMesh) -> Callable:
    """step(state, local scene_ids, xyz, sdf, epoch, seed) on this rank's
    shard, summed over the mesh before the update."""
    if cfg.scenes_per_batch % mesh.size:
        raise AssertionError(f"scenes_per_batch={cfg.scenes_per_batch} not "
                             f"divisible by mesh size {mesh.size}")
    step = make_ad_train_step(decoder, cfg,
                              reg_scene_count=cfg.scenes_per_batch,
                              all_reduce=_all_reduce_fn(mesh))

    def local(state, scene_ids, xyz, sdf, epoch, seed: int):
        return step(state, scene_ids, xyz, sdf, epoch,
                    rank_seed(seed, mesh.rank))

    return local


def make_dp_ad_train_step(decoder: SdfDecoder, cfg: AdConfig,
                          mesh: DataMesh) -> Callable:
    """Data-parallel stage-1 step with the single-device step's signature:
    step(state, scene_ids [S], xyz [S,P,3], sdf [S,P], epoch, seed) on the
    global batch (the same on every rank), of which each rank takes its
    scenes. `cfg.scenes_per_batch` must be divisible by the mesh size."""
    local = _local_step(decoder, cfg, mesh)

    def step(state, scene_ids, xyz, sdf, epoch, seed: int):
        return local(state, *(batch_sharded(mesh, t)
                              for t in (scene_ids, xyz, sdf)), epoch, seed)

    return step


def make_dp_bank_step(decoder: SdfDecoder, cfg: AdConfig, mesh: DataMesh,
                      bank: DeviceSampleBank,
                      generator: torch.Generator) -> Callable:
    """Data-parallel bank step, bank_step(state, scene_ids [S], epoch,
    seed): every rank holds the whole bank and draws the whole batch's
    uniforms from `generator` (seeded alike on every rank), then gathers
    only its scenes' rows, so each position's draw equals the
    single-device draw."""
    local = _local_step(decoder, cfg, mesh)
    P = cfg.samples_per_scene

    def bank_step(state, scene_ids, epoch, seed: int):
        u_pos, u_neg = bank.uniforms(generator, scene_ids.shape[0], P)
        ids, u_pos, u_neg = (batch_sharded(mesh, t)
                             for t in (scene_ids, u_pos, u_neg))
        xyz, sdf = bank.gather(ids, u_pos, u_neg)
        return local(state, ids, xyz, sdf, epoch, seed)

    return bank_step


def state_checksum(state: AdTrainState) -> torch.Tensor:
    """An exact, order-free checksum of the decoder parameters and the
    codes: the sum of their float32 bit patterns as int64 (on the state's
    device)."""
    total = torch.zeros((), dtype=torch.int64, device=state.codes.device)
    for t in [*state.decoder.parameters(), state.codes]:
        total += t.detach().float().view(torch.int32).to(torch.int64).sum()
    return total


def check_replicas(state: AdTrainState, mesh: DataMesh) -> int:
    """Raise unless every rank holds the same parameters and codes: one
    all_reduce(MAX) of (checksum, -checksum). Returns the checksum."""
    c = state_checksum(state)
    both = torch.stack([c, -c])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    hi, lo = int(both[0]), -int(both[1])
    if hi != lo:
        raise RuntimeError(f"the ranks' parameters differ: checksums span "
                           f"{lo}..{hi}")
    return hi


# ------------------------------------------------------------ decode half


def all_gather_rows(mesh: DataMesh, tensors: Sequence) -> list:
    """Every rank's shards of `tensors` (each rank's tensor j has the same
    shape and dtype on every rank), concatenated along dim 0 in rank
    order, on every rank: one collective over the raw bytes (see the
    module)."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    mine = torch.cat(flat)
    n = mine.numel()
    if dist.get_backend(mesh.group) == "nccl":
        buf = mine.new_empty(mesh.size * n)
        dist.all_gather_into_tensor(buf, mine, group=mesh.group)
    else:
        buf = mine.new_zeros(mesh.size * n)
        buf[mesh.rank * n:(mesh.rank + 1) * n] = mine
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    buf = buf.reshape(mesh.size, n)
    out, at = [], 0
    for t, f in zip(tensors, flat):
        part = buf[:, at:at + f.numel()].contiguous().view(t.dtype)
        out.append(part.reshape((mesh.size * t.shape[0],) + tuple(t.shape[1:])
                                if t.ndim else (mesh.size,)))
        at += f.numel()
    return out


def _padded_rows(x: torch.Tensor, size: int) -> torch.Tensor:
    """x with its last row repeated up to a multiple of `size` rows."""
    pad = (-x.shape[0]) % size
    return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])]) if pad else x


def make_dp_ddim_fn(denoise_fn, schedule, num: int, latent_size: int,
                    mesh: DataMesh, steps: int = 50,
                    sampler: str = "ddim") -> Callable:
    """generator -> z0 [num, L] on every rank, the sample batch split over
    the mesh. `sampler`: "ddim" (eta 0) or "dpm" (DPM-Solver++(2M)); both
    steps are elementwise per latent, so no collective runs inside the
    loop. Every rank draws the whole z_T [num, L] from `generator`
    (seeded alike on every rank) and takes its rows, so each latent starts
    from the single-device sampler's z_T. `denoise_fn` is called on this
    rank's rows: its conditioning (class ids, observations) must be this
    rank's slice of the batch (parallel.mesh.batch_sharded), as the
    sharded batch is in JAX. num % mesh.size == 0."""
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
        _normal, ddim_sample, dpm_solver_sample)
    if num % mesh.size:
        raise AssertionError(f"num={num} not divisible by mesh size "
                             f"{mesh.size}")
    fn = {"ddim": ddim_sample, "dpm": dpm_solver_sample}[sampler]

    def run(generator: torch.Generator) -> torch.Tensor:
        z_T = _normal(generator, (num, latent_size), schedule.device)
        local = fn(denoise_fn, schedule, None, num // mesh.size,
                   latent_size, steps=steps,
                   z_init=batch_sharded(mesh, z_T))
        return all_gather_rows(mesh, [local])[0]

    return run


def dp_ddim_sample(denoise_fn, schedule, generator: torch.Generator,
                   num: int, latent_size: int, mesh: DataMesh,
                   steps: int = 50) -> torch.Tensor:
    """DDIM with the sample batch split over the mesh (make_dp_ddim_fn):
    z0 [num, L] on every rank."""
    return make_dp_ddim_fn(denoise_fn, schedule, num, latent_size, mesh,
                           steps)(generator)


def make_decode_points_fn(apply_fn, mesh: DataMesh) -> Callable:
    """(z [L], xyz [N,3]) -> sdf [N] on every rank, the point axis split
    over the mesh: each rank runs apply_fn (kernel #1 when it is
    ops.cuda_kernels.make_kernel_apply's wrapper) on its shard; queries
    are independent. A ragged N is padded up to the mesh size with the
    last point here (the JAX package leaves N % mesh.size == 0 to the
    caller)."""

    def run(z: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        n = xyz.shape[0]
        local = apply_fn(z, batch_sharded(mesh, _padded_rows(xyz,
                                                             mesh.size)))
        return all_gather_rows(mesh, [local])[0][:n]

    return run


def decode_points_sharded(apply_fn, z: torch.Tensor, xyz: torch.Tensor,
                          mesh: DataMesh) -> torch.Tensor:
    """Evaluate one latent on a flat point set split over the mesh
    (make_decode_points_fn): the 512^3 scale-out path, each rank one
    shard of every slab."""
    return make_decode_points_fn(apply_fn, mesh)(z, xyz)


class _DpPairs:
    """make_dp_pairs_fn's evaluator: the call, and `indexed` when the
    wrapped evaluator has it (kernel #2 reads each point's row by id)."""

    def __init__(self, pairs_fn, mesh: DataMesh):
        self.pairs_fn = pairs_fn
        self.mesh = mesh
        if hasattr(pairs_fn, "indexed"):
            self.indexed = self._indexed

    def _split(self, fn, rows: torch.Tensor, xyz: torch.Tensor
               ) -> torch.Tensor:
        n, size = xyz.shape[0], self.mesh.size
        local = fn(batch_sharded(self.mesh, _padded_rows(rows, size)),
                   batch_sharded(self.mesh, _padded_rows(xyz, size)))
        return all_gather_rows(self.mesh, [local])[0][:n]

    def __call__(self, z_rows: torch.Tensor, xyz: torch.Tensor
                 ) -> torch.Tensor:
        return self._split(self.pairs_fn, z_rows, xyz)

    def _indexed(self, codes: torch.Tensor, sids: torch.Tensor,
                 xyz: torch.Tensor) -> torch.Tensor:
        return self._split(
            lambda s, x: self.pairs_fn.indexed(codes, s, x), sids, xyz)


def make_dp_pairs_fn(pairs_fn, mesh: DataMesh) -> Callable:
    """(z_rows [N, L], xyz [N,3]) -> sdf [N] on every rank, the point axis
    split over the mesh: the flat batched decode's evaluator
    (ops.grid_eval.decode_grid_hierarchical3_batch_flat) under the mesh.
    Each rank evaluates its shard of every level's work list (each
    point's latent row rides along, or its shape id with `indexed`, which
    the result has when pairs_fn has it: kernel #2 then reads the rows by
    id), while the selection and compaction stay replicated. A ragged N
    is padded up to the mesh size here, not by the caller: the flat
    decode's group sizes depend on the data."""
    return _DpPairs(pairs_fn, mesh)


def make_dp_sparse_decode_fn(apply_fn, res: int, batch: int,
                             mesh: DataMesh, caps: tuple,
                             safety: float = 1.2, safety3: float = 2.0,
                             out_dtype: str = "int8") -> Callable:
    """zs [batch, L] (the same on every rank) -> this rank's shard of the
    sparse serving payloads, shape axis split over the mesh.

    Each rank runs the three-level sparse decode
    (ops.grid_eval._decode_grid_hier3_impl, layout "sparse2") on its
    batch / mesh.size shapes, one after another, with the single-device
    decode's program; there is no communication. Returns ((c1 [local,
    nb1^3], c2 [local, cap1, (b1/b2)^3], idx1 [local, cap1], vals2
    [local, cap2, b2^3], ids2 [local, cap2]), (n1, n2, n3) each
    [local]), rank r holding shapes [r * local, (r + 1) * local); the
    counts are device tensors (nothing waits on the device).
    batch % mesh.size == 0. out_dtype "int8" (default) is the
    sign-preserving quantized payload (dequantize scale:
    ops.grid_eval.hier3_int8_scale)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        _MAX_POINTS_PER_GROUP, _decode_grid_hier3_impl)
    if batch % mesh.size:
        raise AssertionError(f"batch={batch} not divisible by mesh size "
                             f"{mesh.size}")
    cap1, cap2, cap3 = caps
    local = max(1, batch // mesh.size)
    ppg = max(8, _MAX_POINTS_PER_GROUP // local)

    def run(zs: torch.Tensor) -> tuple:
        outs = [_decode_grid_hier3_impl(
            apply_fn, z, res, 16, 4, 2, cap1, cap2, cap3, safety=safety,
            safety3=safety3, layout="sparse2", points_per_group=ppg,
            out_dtype=out_dtype) for z in batch_sharded(mesh, zs)]
        arrs = tuple(torch.stack([o[0][j] for o in outs]) for j in range(5))
        counts = tuple(torch.stack([o[j] for o in outs]) for j in (1, 2, 3))
        return arrs, counts

    return run


def decode_grid_sharded(apply_fn, z: torch.Tensor, res: int,
                        mesh: DataMesh,
                        slab_points: int = 2_097_152) -> np.ndarray:
    """Full res^3 grid of one latent on every rank's host, the point axis
    split over the mesh (decode_points_sharded), streamed to the host
    slab by slab (bounded device memory for a 512^3 grid's 512 MB)."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        _flat_to_xyz)
    n = mesh.size
    slab = max(n, (slab_points // n) * n)
    total = res ** 3
    out = np.empty((total,), np.float32)
    run = make_decode_points_fn(apply_fn, mesh)
    for start in range(0, total, slab):
        count = min(slab, total - start)
        flat = torch.arange(start, start + count, dtype=torch.int32,
                            device=z.device)
        out[start:start + count] = run(z, _flat_to_xyz(flat, res)).cpu() \
            .numpy()
    return out.reshape(res, res, res)
