"""Data-parallel groups (the port's counterpart of
``stylegan_tpu/parallel/mesh.py``).

The JAX package scales the reference's single-device loop by sharding the
minibatch over a 1-D 'data' mesh axis: one process drives every device,
parameters and optimizer state are replicated, and the compiled step pmeans
the gradients.  PyTorch runs one process per device instead (a rank; see
parallel/distributed.py), so the port's mesh is a group of ranks: the first
``n`` ranks of the world that ``initialize_distributed`` joined, each on its
own device.  A step built with ``mesh=`` runs in every rank of the group at
once, each on its own shard of the global batch, and its collectives run
over the group's process group (NCCL on the card, gloo on the CPU).

JAX's one process with N devices is the port's N ranks with one device
each; the device budget (``resolve_max_devices``) counts ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D group: `size` ranks, global ranks 0..size-1, and this
    process's index in it (`rank`, None outside the group).  Rank 0 of the
    group is rank 0 of the world.  `axis_name` says what the group splits:
    'data' (the batch) or 'spatial' (each image's rows,
    parallel/spatial.py)."""
    size: int
    rank: Optional[int]
    group: object           # the torch.distributed process group
    axis_name: str = "data"

    @property
    def is_member(self) -> bool:
        return self.rank is not None


def device_count(device="cuda") -> int:
    """The devices a run can spread over: the world's ranks once a process
    group is initialized (one device each); otherwise the visible CUDA
    devices, or one for the CPU (JAX's CPU backend counts one device)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def create_mesh(n_devices: Optional[int] = None,
                axis_name: str = "data") -> Mesh:
    """The group of the first n ranks (default: all).

    Every rank of the world calls it, in the same order, because creating a
    process group is itself a collective; the ranks outside the group get a
    Mesh whose `rank` is None.  Raises when n exceeds the world's ranks, as
    the JAX package asserts when n exceeds its devices.  `axis_name` names
    the mesh's one axis."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world} "
                         "(one rank per device)")
    if not initialized:
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.initialize_distributed() first")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(size=n, rank=rank if rank < n else None, group=group,
                axis_name=axis_name)


def compatible_mesh_size(n_devices: int, batch_sizes) -> int:
    """Largest mesh size <= n_devices dividing every global batch size.

    The batch is sharded over the mesh, so each per-depth batch must split
    evenly; progressive schedules end in tiny batches (e.g. [..., 4, 2])."""
    n = max(1, int(n_devices))
    while n > 1 and any(bs % n != 0 for bs in batch_sizes):
        n -= 1
    return n


def resolve_max_devices(parallel_cfg=None, flag_value: Optional[int] = None,
                        device="cuda") -> int:
    """Device budget for adaptive data parallelism.

    Precedence: the CLI flag, then the yaml's `parallel.data_axis` ('auto'
    = all visible devices), then all visible devices (`device_count`).  The
    trainer then sizes the group per depth (trainer._mesh_for_batch)."""
    if flag_value:
        return int(flag_value)
    if parallel_cfg is not None:
        axis = parallel_cfg.get("data_axis", "auto")
        if axis != "auto":
            return int(axis)
    return device_count(device)
