"""Data-parallel stage-1 steps over torch.distributed.

Counterpart of the training half of the JAX package's `parallel/dp.py`
(`_shard_map_pallas_vag`, `make_dp_ad_train_step`, `make_dp_bank_step`).
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
"""

from __future__ import annotations

from typing import Callable

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


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of `rank`: the seed itself on rank 0, else a
    31-bit hash of (seed, rank)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint32)[0] >> 1)


def _all_reduce_fn(mesh: DataMesh) -> Callable:
    """all_reduce(tensors): sum a list of f32 tensors over the mesh in
    place, through one all_reduce(SUM) of their concatenation."""

    def all_reduce(tensors: list) -> None:
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
