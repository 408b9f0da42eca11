"""The data mesh over a torch.distributed process group.

Counterpart of the JAX package's `parallel/mesh.py`. One axis, `data`,
carries every parallel dimension of stage-1 training: each rank is one
device, holds the whole state (decoder, latent table, Adam), and takes
its slice of the batch's scenes. Where JAX emits the gradient sums from
sharding annotations, the port sums them with `all_reduce`
(parallel/dp.py). The group is the caller's: `init_process_group` is
given its backend, address, world size and rank (or, under `torchrun`,
`init_from_env` reads them from the environment).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


class DataMesh(NamedTuple):
    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int
    size: int
    axis_names: tuple
    shape: tuple


def _group_rank_size(group) -> tuple:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call "
                           "init_process_group first")
    return dist.get_rank(group), dist.get_world_size(group)


def make_mesh(n_devices: Optional[int] = None,
              group: Optional[dist.ProcessGroup] = None) -> DataMesh:
    """1-D data mesh over every rank of `group` (default: the world);
    `n_devices`, if given, must be the group's size."""
    rank, size = _group_rank_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need {n_devices} devices, the group has {size} "
                         "ranks")
    return DataMesh(group, rank, size, (DATA_AXIS,), (size,))


def make_mesh_2level(n_slices: int, per_slice: int,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> DataMesh:
    """Two-level ('dcn', 'data') mesh: data parallel over both levels,
    rank = slice * per_slice + index within the slice, so the batch
    splits over both levels in the JAX mesh's order. The group must have
    n_slices * per_slice ranks."""
    rank, size = _group_rank_size(group)
    need = n_slices * per_slice
    if size != need:
        raise ValueError(f"need {need} devices, the group has {size} ranks")
    return DataMesh(group, rank, size, ("dcn", DATA_AXIS),
                    (n_slices, per_slice))


def batch_sharded(mesh: DataMesh, x: torch.Tensor,
                  axis: int = 0) -> torch.Tensor:
    """This rank's slice of dim `axis` of x (a view): rows
    [rank * n / size, (rank + 1) * n / size), over every mesh axis."""
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"batch of {n} not divisible by the mesh's "
                         f"{mesh.size} ranks")
    k = n // mesh.size
    return x.narrow(axis, mesh.rank * k, k)


def init_from_env(backend: str, device="cuda") -> torch.device:
    """Under `torchrun` (WORLD_SIZE > 1): start the default group from the
    environment with `backend` ("nccl" when each rank has its own card,
    "gloo" for CPU ranks; no backend is picked for the caller) and return
    this rank's device: cuda:LOCAL_RANK, or the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu" and backend == "nccl":
        raise ValueError("backend nccl needs CUDA ranks; pass gloo for "
                         "CPU ranks")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return dev
