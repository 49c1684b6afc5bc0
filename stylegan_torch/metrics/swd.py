"""Sliced Wasserstein Distance over a Laplacian pyramid (ProGAN, Karras et
al. 2018 §5 / appendix A; the port's counterpart of
``stylegan_tpu/metrics/swd.py``).

Per pyramid level: extract 7x7xC patches around random locations, normalize
per channel (mean/std over the patch set), project onto random unit
directions, sort, and average |sorted_real - sorted_fake|.  Lower is better;
reported per level and averaged.  No pretrained features, so it works
without downloads.

The draws (per level: the real and the fake patch indices, then the
projection directions) come from an explicit ``torch.Generator`` on the
host, or are passed pinned (``draws=``), as the parity tests pass JAX's.
The images stay on their device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import avg_pool2d, blur2d, make_blur_kernel, upscale2d

_PATCH = 7


def laplacian_pyramid(images: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """NHWC batch -> list of detail levels, finest first (last = residual)."""
    kernel = make_blur_kernel([1, 4, 6, 4, 1]).to(images.device)
    pyramid = []
    cur = images
    for _ in range(levels - 1):
        down = avg_pool2d(blur2d(cur, kernel), 2)
        up = blur2d(upscale2d(down), kernel)
        pyramid.append(cur - up)
        cur = down
    pyramid.append(cur)
    return pyramid


def _draw_patch_indices(shape: Sequence[int], n_patches: int,
                       generator: torch.Generator):
    """(batch, y, x) start indices of `n_patches` 7x7 patches of a level of
    `shape` (B, H, W, C), as int64 tensors on the host."""
    b, h, w, _ = shape
    return tuple(torch.randint(0, hi, (n_patches,), generator=generator)
                 for hi in (b, max(1, h - _PATCH + 1), max(1, w - _PATCH + 1)))


def _extract_patches(level: torch.Tensor, indices) -> torch.Tensor:
    """Patches at `indices` -> (n_patches, 7*7*C), channel-normalized."""
    _, h, w, _ = level.shape
    bi, yi, xi = (torch.as_tensor(i, dtype=torch.long, device=level.device)
                  for i in indices)
    rows = yi[:, None] + torch.arange(min(_PATCH, h), device=level.device)
    cols = xi[:, None] + torch.arange(min(_PATCH, w), device=level.device)
    patches = level[bi[:, None, None], rows[:, :, None], cols[:, None, :]]
    # per-channel normalization over the patch set (ProGAN appendix A)
    mean = patches.mean(dim=(0, 1, 2), keepdim=True)
    std = patches.std(dim=(0, 1, 2), keepdim=True, correction=0) + 1e-8
    return ((patches - mean) / std).reshape(len(bi), -1)


def _swd_1d(a: torch.Tensor, b: torch.Tensor, dirs: torch.Tensor) -> float:
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=a.device)
    dirs = dirs / (torch.linalg.norm(dirs, dim=0, keepdim=True) + 1e-12)
    pa = torch.sort(a @ dirs, dim=0).values
    pb = torch.sort(b @ dirs, dim=0).values
    return float((pa - pb).abs().mean())


def sliced_wasserstein_distance(real, fake, generator=None,
                                levels: Optional[int] = None,
                                n_patches: int = 2048, n_proj: int = 128,
                                draws=None) -> Dict[str, float]:
    """real/fake: (B, H, W, C) in [-1, 1] at the same resolution (tensors on
    any device, or arrays).

    generator: the host ``torch.Generator`` of the draws (seed 0 if None);
    draws: pinned draws instead, one (real indices, fake indices,
    directions (7*7*C, n_proj)) per level.  Returns {"level_{res}": swd,
    ..., "avg": mean} (x1e3 like the paper's tables is left to the
    caller)."""
    real = torch.as_tensor(real, dtype=torch.float32)
    fake = torch.as_tensor(fake, dtype=torch.float32).to(real.device)
    assert real.shape == fake.shape, (real.shape, fake.shape)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    h = real.shape[1]
    if levels is None:
        levels = max(1, int(math.log2(h)) - 2)  # down to 8x8-ish

    pyr_r = laplacian_pyramid(real, levels)
    pyr_f = laplacian_pyramid(fake, levels)
    out = {}
    vals = []
    for lvl, (lr, lf) in enumerate(zip(pyr_r, pyr_f)):
        if draws is not None:
            idx_r, idx_f, dirs = draws[lvl]
        else:
            idx_r = _draw_patch_indices(lr.shape, n_patches, generator)
            idx_f = _draw_patch_indices(lf.shape, n_patches, generator)
            dim = min(_PATCH, lr.shape[1]) * min(_PATCH, lr.shape[2]) \
                * lr.shape[3]
            dirs = torch.randn((dim, n_proj), generator=generator)
        v = _swd_1d(_extract_patches(lr, idx_r), _extract_patches(lf, idx_f),
                    dirs)
        out[f"level_{lr.shape[1]}"] = v
        vals.append(v)
    out["avg"] = float(sum(vals) / len(vals))
    return out
