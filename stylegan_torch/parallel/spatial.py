"""Spatially split synthesis: each 1024^2 image's rows over ranks (the
port's counterpart of ``stylegan_tpu/parallel/spatial.py``).

This is the serving path: one image's forward spread over n devices cuts
each device's activation memory about n-fold.  The JAX package marks the
output H-sharded and lets GSPMD insert the halo exchanges; torch has no
such partitioner, so the port splits the forward itself
(``models/synthesis.py`` with a ``SpatialContext``, ``parallel/halo.py``):
each rank holds a slab of rows of every activation of a stage of side
res >= 4n, takes one row from each neighbour before a 3x3 conv, the blur
and the sub-pixel upscale, and runs the epilogue split (``ops/fused.py``:
K1-partial, a rank-order merge of the gathered partials, K2-apply).  The
mapping, the early stages too short to split, and everything per pixel run
as they are.  Like every port mesh, a spatial mesh is the first n ranks of
the world, one process each (``parallel/mesh.py``).

Exactness: the split forward equals the one-process forward to float32
roundoff (the instance norm's statistics are merged from slabs); a mesh of
one rank runs the unsplit forward, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .halo import SpatialContext, check_shards
from .halo import gather_rows as _gather_rows
from .mesh import Mesh, create_mesh

SPATIAL_AXIS = "spatial"


def create_spatial_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first n ranks of the world (default: all) as a 'spatial' mesh;
    every rank calls it (create_mesh)."""
    return create_mesh(n_devices, axis_name=SPATIAL_AXIS)


def spatial_context(mesh: Mesh, device) -> Optional[SpatialContext]:
    """This rank's split of a forward over `mesh` (None for one rank: the
    unsplit forward)."""
    if not mesh.is_member:
        raise ValueError("this rank is outside the spatial mesh")
    if mesh.size == 1:
        return None
    return SpatialContext(mesh.size, torch.tensor(mesh.rank, device=device),
                          mesh.group.group_name)


def build_spatial_sample_fn(gen_cfg, generator, mesh: Mesh, *, depth: int,
                            train_semantics: bool = False):
    """The generator forward with every activation of a stage of side
    res >= 4n split by height over `mesh`'s n ranks; every rank of the mesh
    calls the returned fn with the same arguments.

    Returns fn(z, seed) -> this rank's rows (B, H/n, W, 3) of the images
    (`gather_rows` gives the whole of them), under
    ``torch.inference_mode``; z (B, latent), float32 or bfloat16 (the bf16
    activation path), else cast to float32.  Conditional models are not
    supported on this path.  The output resolution 2^(depth+2) must divide
    by 4n (at least 4 output rows per rank), as in the JAX package.  Eval
    semantics unless `train_semantics`.  Architectures 'stylegan2' and
    'stylegan3' are refused.  The generator stays on its device; applies
    the process precision policy, as make_serving_fn does."""
    from ..ops.precision import get_precision, set_precision

    if gen_cfg.architecture != "stylegan1":
        raise ValueError(f"the spatial path does not support architecture "
                         f"{gen_cfg.architecture!r}")
    res = 2 ** (depth + 2)
    check_shards(res, mesh.size)
    if gen_cfg.conditional:
        raise ValueError("the spatial path does not support conditional "
                         "models (as the JAX package's)")
    device = next(generator.parameters()).device
    ctx = spatial_context(mesh, device)
    set_precision(get_precision())

    @torch.inference_mode()
    def fn(z, seed):
        z = torch.as_tensor(z, device=device)
        if z.dtype not in (torch.float32, torch.bfloat16):
            z = z.float()
        return generator(z, depth=depth, alpha=1.0, seed=int(seed),
                         train=train_semantics, spatial=ctx).images

    return fn


def gather_rows(slab: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (B, H, W, C) tensor on every rank of `mesh` from each
    rank's slab of rows."""
    ctx = spatial_context(mesh, slab.device)
    return slab if ctx is None else _gather_rows(slab, ctx)


def spatial_hbm_estimate(res: int, channels: int, n_shards: int,
                         dtype_bytes: int = 2) -> float:
    """Per-device bytes for one activation plane at `res` when split by
    height: the planning number for how many devices a serving deployment
    needs."""
    return res * res * channels * dtype_bytes / n_shards
