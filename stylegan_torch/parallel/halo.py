"""Row slabs of a feature map split by height over ranks, and the
collectives the spatial forward needs (the port's counterpart of the halo
exchanges that GSPMD inserts for ``stylegan_tpu/parallel/spatial.py``).

Rank r of n holds rows [r * H/n, (r + 1) * H/n) of an NHWC activation: a
contiguous slab, which the epilogue kernels take as it is.  An op that reads
neighbouring rows (a 3x3 conv, the blur, the sub-pixel upscale) first takes
one row from each neighbour (`exchange_halo`); a per-(b, c) statistic of the
whole plane gathers every rank's partials (`all_gather`).

Every collective is an all-reduce of a zero-padded buffer, each rank's part
in its own slot: exact (a value plus zeros), available in gloo on CUDA
tensors too (so that ranks can share one card), and made of
``torch.distributed``'s functional collectives, which ``torch.export``
records as ``_c10d_functional`` nodes.  The rank is a 0-d tensor, not a
Python int, so that an exported program takes it as an input: one program
serves every rank.

Under autograd (the spatial train step) the all-reduce is `_AllReduce`,
whose backward is the all-reduce again (its transpose), itself
differentiable, so that R1 differentiates the slab ops twice; the
functional collectives record no backward of their own (autograd passes a
gradient through them unchanged, with a warning), and run only where no
gradient is recorded.  Every op here is then differentiable with its
transpose as backward: a halo row's gradient goes back to the neighbour
that sent it and adds to its edge row, `all_gather`'s is each rank's slot
of the all-reduced gradients, and `take_rows`'s zero-pads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# The world's process group, by the name the functional collectives take.
WORLD_GROUP = "0"


@dataclass(frozen=True, eq=False)
class SpatialContext:
    """The split of a forward's rows: `n` ranks, this one's index `rank` (a
    0-d int64 tensor on the activations' device) and the process group, by
    name, that joins them."""
    n: int
    rank: torch.Tensor
    group_name: str = WORLD_GROUP


def check_shards(res: int, n: int):
    """Raise unless a `res` x `res` output splits over `n` ranks with at
    least 4 rows each (the JAX package's bound)."""
    if res % (n * 4):
        raise ValueError(f"resolution {res} must divide over {n} spatial "
                         f"shards with at least 4 rows each (the 4x4 base "
                         f"stage)")


def splits(res: int, ctx) -> bool:
    """Whether a stage of side `res` runs split over `ctx`'s ranks: at
    least 4 rows each (the bound above); a shorter stage runs whole on
    every rank."""
    return ctx is not None and res >= 4 * ctx.n


def _functional_all_reduce(t: torch.Tensor, group_name: str) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(t, "sum", group_name))


class _AllReduce(torch.autograd.Function):
    """The sum over the group; its backward is the sum again (the
    transpose), through this Function, so that it differentiates again."""

    @staticmethod
    def forward(ctx, t, group_name):
        ctx.group_name = group_name
        return _functional_all_reduce(t, group_name)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g.contiguous(), ctx.group_name), None


def _all_reduce(t: torch.Tensor, ctx: SpatialContext) -> torch.Tensor:
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduce.apply(t, ctx.group_name)
    return _functional_all_reduce(t, ctx.group_name)


def psum(t: torch.Tensor, ctx: SpatialContext) -> torch.Tensor:
    """The sum of t over `ctx`'s ranks, on every rank (differentiable)."""
    return _all_reduce(t, ctx)


def _placed(t: torch.Tensor, slot: torch.Tensor, slots: int) -> torch.Tensor:
    """(slots, *t.shape): t at index `slot` (a 0-d tensor), zeros elsewhere."""
    mask = torch.arange(slots, device=t.device) == slot
    return torch.where(mask.view(-1, *[1] * t.ndim), t[None],
                       torch.zeros((), dtype=t.dtype, device=t.device))


def all_gather(t: torch.Tensor, ctx: SpatialContext) -> torch.Tensor:
    """(n, *t.shape): every rank's t, in rank order, on every rank."""
    return _all_reduce(_placed(t, ctx.rank, ctx.n), ctx)


def take_rows(full: torch.Tensor, ctx: SpatialContext) -> torch.Tensor:
    """This rank's rows (dim 1) of a tensor every rank holds whole."""
    h = full.shape[1] // ctx.n
    return full.unflatten(1, (ctx.n, h)).index_select(
        1, ctx.rank.view(1)).squeeze(1)


def gather_rows(slab: torch.Tensor, ctx: SpatialContext) -> torch.Tensor:
    """The whole tensor from every rank's slab of rows (dim 1)."""
    parts = all_gather(slab, ctx)                 # (n, B, h, ...)
    return parts.transpose(0, 1).flatten(1, 2)


def exchange_halo(slab: torch.Tensor, ctx: SpatialContext,
                  rows: int = 1) -> torch.Tensor:
    """(B, h + 2 * rows, W, C): the slab between `rows` rows of each
    neighbour, zero rows past the image's top and bottom edges (the SAME
    padding the unsplit op applies there)."""
    edges = torch.stack([slab[:, :rows], slab[:, -rows:]])
    # slots 0 and n + 1 stay zero: the neighbours of the first and last rank
    parts = _all_reduce(_placed(edges, ctx.rank + 1, ctx.n + 2), ctx)
    above = parts.index_select(0, ctx.rank.view(1))[0, 1]
    below = parts.index_select(0, (ctx.rank + 2).view(1))[0, 0]
    return torch.cat([above, slab, below], dim=1)
