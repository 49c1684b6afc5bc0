"""Image output (the port's copy of the single-image half of
``stylegan_tpu/io/image.py``)."""

from __future__ import annotations

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
