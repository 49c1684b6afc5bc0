"""Processes, ranks and the collectives of the data-parallel step (the port's
counterpart of ``stylegan_tpu/parallel/distributed.py``).

The JAX package drives every local device from one process and joins hosts
with ``jax.distributed``.  PyTorch runs one process per device: a rank.  A
run starts its ranks under ``torchrun`` (which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT), or with `spawn` below, and each
rank calls ``initialize_distributed()`` once:

    device = initialize_distributed()            # reads torchrun's env
    mesh = create_mesh()                         # all ranks, 1-D 'data'
    loader = DataLoader(..., shard_index=host_index(), num_shards=host_count())

The backend is NCCL on the card and gloo on the CPU.  The step's collectives
are all-reduces and broadcasts only (gloo takes both on CUDA tensors too, so
two ranks can share one card over gloo where NCCL refuses them).

`psum` / `pmean` / `all_gather` are differentiable, and their backward is
the JAX package's transpose under ``shard_map(check_vma=False)``: the
cotangents of an all-reduce are all-reduced.  Each rank differentiates its
own copy of a loss that holds global means, so its gradient is the group's
size times its shard's share of the global gradient; `average_gradients`
then divides the all-reduced sum by the size, as JAX pmeans the gradients,
and every rank holds the gradient of the global-batch loss.
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, device=None,
                           timeout: Optional[float] = None) -> torch.device:
    """Join this process to the world (``init_process_group``) and return
    its device.

    Without arguments it reads torchrun's environment; otherwise
    `coordinator_address` ('host:port', rank 0's), `num_processes` and
    `process_id` name the world, as in the JAX package.  `device`: 'cuda'
    (the default) puts rank r on card LOCAL_RANK (else r) and raises when
    that card does not exist; 'cuda:i' puts every rank on card i (two ranks
    on one card need backend='gloo': NCCL refuses them); 'cpu' runs on the
    CPU.  The backend is NCCL for the card and gloo for the CPU unless
    given.  `timeout` (seconds) bounds every collective's wait; a rank
    outside a smaller group waits through the depth in one."""
    from .. import resolve_device
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", 0))
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise ValueError(
                    f"rank {rank} has no card of its own: "
                    f"{torch.cuda.device_count()} visible")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=world, rank=rank, **kw)
    return dev


def host_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_count() -> int:
    """The world's ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multihost() -> bool:
    return host_count() > 1


def global_shard(mesh, batch, device=None) -> torch.Tensor:
    """This rank's contiguous shard of a global batch, on `device` (default:
    where the batch is).

    Torch has no global array: where the JAX package assembles the hosts'
    pieces into one batch-sharded ``jax.Array``, each rank here holds only
    its own rows, rows [r * B/n, (r + 1) * B/n) of the global batch of B
    over a mesh of n, and the collectives inside the step stand in for the
    global view."""
    batch = torch.as_tensor(batch, device=device)
    if batch.shape[0] % mesh.size:
        raise ValueError(f"global batch {batch.shape[0]} does not divide "
                         f"over {mesh.size} ranks")
    b = batch.shape[0] // mesh.size
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


# ------------------------------------------------------------ collectives --

class _AllReduceSum(torch.autograd.Function):
    """psum: the sum over the group; its backward is psum again (JAX's
    transpose of psum), itself differentiable for R1's double backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    return _AllReduceSum.apply(x, mesh.group)


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    return psum(x, mesh) / mesh.size


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The group's x concatenated along dim 0 in rank order (JAX's tiled
    all_gather): each rank's rows placed among zeros, then psum, which is
    exact and differentiable (the backward is JAX's psum_scatter)."""
    parts = [torch.zeros_like(x)] * mesh.size
    parts[mesh.rank] = x
    return psum(torch.cat(parts), mesh)


def _comm(tensors, mesh, op):
    """Run `op(flat)` (an in-place collective) over `tensors`, one flat
    buffer per (device, dtype), and copy the result back.  Under NCCL a
    tensor on the host (Adam's step count) travels through the rank's card."""
    nccl = dist.get_backend(mesh.group) == "nccl"
    staged = {}
    for t in tensors:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if nccl and t.device.type != "cuda" else t.device
        staged.setdefault((dev, t.dtype), []).append(t)
    for (dev, _), ts in staged.items():
        flat = torch.cat([t.detach().reshape(-1).to(dev) for t in ts])
        op(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.detach().copy_(part.view_as(t))


@torch.no_grad()
def broadcast_(tensors, mesh):
    """Overwrite `tensors` on every rank of the mesh with rank 0's, in place
    (bitwise)."""
    _comm(list(tensors), mesh,
          lambda flat: dist.broadcast(flat, src=0, group=mesh.group))


@torch.no_grad()
def average_gradients(module: torch.nn.Module, mesh):
    """The group's mean of `module`'s gradients, in place on every rank (the
    JAX step's pmean of the gradient tree): one all-reduce per module."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]

    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
    _comm(grads, mesh, mean)


def _state_tensors(obj):
    """The tensors that make `obj` (a module, an optimizer, a TrainState,
    a tensor) what it is, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        out = []
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state[p]
                if not st:      # never stepped here: Adam's initial state
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                out += [st[k] for k in sorted(st)]
        return out
    fields = ("generator", "discriminator", "g_shadow", "g_optimizer",
              "d_optimizer")
    return [t for f in fields if getattr(obj, f) is not None
            for t in _state_tensors(getattr(obj, f))]


def replicate(mesh, *objs):
    """Make `objs` (modules, optimizers, a TrainState, tensors) on every
    rank of the mesh bitwise equal to rank 0's: the JAX package's replicated
    placement.  Every rank of the mesh calls it with the same structure."""
    broadcast_([t for obj in objs for t in _state_tensors(obj)], mesh)


# --------------------------------------------------------------- launcher --

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, address, backend, device, timeout, args):
    dev = initialize_distributed(address, world, rank, backend=backend,
                                 device=device, timeout=timeout)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), *, backend: Optional[str] = None,
          device="cuda", timeout: Optional[float] = None,
          join_timeout: Optional[float] = None):
    """Run ``fn(rank, device, *args)`` in `nprocs` new processes (the spawn
    start method: each imports only what `fn`'s module imports), joined as
    one world over tcp://localhost before `fn` runs (initialize_distributed
    with `backend`, `device` and `timeout`) and leaving it after.  Returns
    when every rank has returned; raises when one fails, or after
    `join_timeout` seconds, and then ends the others."""
    import torch.multiprocessing as mp
    address = f"localhost:{_free_port()}"
    ctx = mp.start_processes(
        _rank_entry, args=(fn, nprocs, address, backend, device, timeout,
                           tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if join_timeout is None \
        else time.monotonic() + join_timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish in "
                                   f"{join_timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
