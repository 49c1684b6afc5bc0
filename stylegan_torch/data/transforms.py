"""Standalone image transform (the port's copy of
``stylegan_tpu/data/transforms.py``, API parity with the reference's
data/transforms.py).

get_transform(new_size) returns a callable mapping a PIL image or HWC array to
a normalized float32 HWC array in [-1, 1]: random horizontal flip -> bilinear
resize -> scale, identical to the reference's torchvision Compose
(RandomHorizontalFlip, Resize, ToTensor, Normalize(.5, .5)) except that the
output layout is HWC instead of CHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .datasets import _transform


def get_transform(new_size: Optional[Tuple[int, int]] = None):
    res = new_size[0] if new_size is not None else None

    def apply(img, rng: Optional[np.random.RandomState] = None):
        flip = bool(rng.randint(2)) if rng is not None else False
        if res is None:
            from PIL import Image
            if not isinstance(img, Image.Image):
                img = Image.fromarray(np.asarray(img))
            return _transform(img, img.size[0], flip)
        return _transform(img, res, flip)

    return apply
