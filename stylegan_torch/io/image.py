"""Image output (the port's copy of ``stylegan_tpu/io/image.py``): the
trainer's feedback grids, which replace torchvision.utils.save_image
(reference GAN.py:661-680: normalize=True, scale_each=True, padding=1, white
padding), and the generate CLIs' single images."""

from __future__ import annotations

import math
import os

import numpy as np


def adjust_dynamic_range(data, drange_in=(-1, 1), drange_out=(0, 1)):
    """Linear range remap + clamp (reference generate_samples.py:47-62)."""
    if drange_in != drange_out:
        scale = (float(drange_out[1]) - float(drange_out[0])) / (
            float(drange_in[1]) - float(drange_in[0]))
        bias = float(drange_out[0]) - float(drange_in[0]) * scale
        data = data * scale + bias
    return np.clip(data, 0.0, 1.0)


def _minmax_per_image(imgs: np.ndarray) -> np.ndarray:
    """Per-image min-max normalization to [0,1] (save_image scale_each)."""
    flat = imgs.reshape(imgs.shape[0], -1)
    lo = flat.min(axis=1)[:, None, None, None]
    hi = flat.max(axis=1)[:, None, None, None]
    return (imgs - lo) / np.maximum(hi - lo, 1e-5)


def upscale_nearest(imgs: np.ndarray, factor: int) -> np.ndarray:
    if factor <= 1:
        return imgs
    return imgs.repeat(factor, axis=1).repeat(factor, axis=2)


def save_image_grid(samples, path: str, nrow: int = None,
                    scale_factor: int = 1, normalize: bool = True,
                    padding: int = 1, pad_value: float = 1.0):
    """samples: (N, H, W, C) float array; writes a PNG grid.

    Mirrors the reference's create_grid (GAN.py:661-680): optional nearest
    upscale to the final canvas, per-image min-max normalize, sqrt(N) columns.
    """
    from PIL import Image
    imgs = np.asarray(samples, dtype=np.float32)
    imgs = upscale_nearest(imgs, scale_factor)
    if normalize:
        imgs = _minmax_per_image(imgs)
    else:
        imgs = np.clip(imgs, 0.0, 1.0)
    n, h, w, c = imgs.shape
    if nrow is None:
        nrow = int(math.sqrt(n))
    ncol = nrow
    nrows = -(-n // ncol)
    canvas = np.full((nrows * (h + padding) + padding,
                      ncol * (w + padding) + padding, c),
                     pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        canvas[y:y + h, x:x + w] = imgs[i]
    arr = (canvas * 255.0 + 0.5).astype(np.uint8)
    if c == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(arr).save(path)


def save_single_image(img, path: str):
    """img: (H, W, C) or (1, H, W, C) in [0, 1]."""
    from PIL import Image
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    arr = (np.clip(arr, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
