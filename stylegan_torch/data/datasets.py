"""Image datasets (the port's copy of ``stylegan_tpu/data/datasets.py``:
reference data/datasets.py + torchvision.ImageFolder).

Decode semantics match the reference pipeline exactly
(data/transforms.py:11-33 + datasets.py:61-85):
  * PIL decode -> RGB (alpha dropped); `.npy` files hold CHW float arrays
  * random horizontal flip (p=0.5)
  * bilinear resize to the *final* config resolution (progressive
    downsampling to the current depth happens on the device, GAN.py:557-589)
  * scale to [-1, 1]
Output layout is NHWC float32 numpy, the port's feature-map layout.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".npy")


def _is_image(path: str) -> bool:
    return path.lower().endswith(IMG_EXTENSIONS)


def _decode(path: str):
    """Decode a file to an HWC uint8/float RGB array (or a PIL image)."""
    if path.endswith(".npy"):
        arr = np.load(path)  # CHW like the reference (datasets.py:73-76)
        if arr.ndim == 3 and arr.shape[0] in (1, 3, 4):
            arr = np.transpose(arr, (1, 2, 0))
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        return arr
    from PIL import Image
    return Image.open(path).convert("RGB")


def _native_decode(path: str, resolution: int, flip: bool):
    """Decode via the C++ core (GIL-free, PIL-equivalent); None on failure."""
    from . import native
    if not native.available():
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
        return native.decode_resize(data, resolution, flip)
    except (ValueError, OSError):
        return None


def _transform(img, resolution: int, flip: bool) -> np.ndarray:
    """flip -> bilinear resize -> [-1, 1] float32 HWC."""
    from PIL import Image
    if isinstance(img, np.ndarray):
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        img = Image.fromarray(img)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if img.size != (resolution, resolution):
        img = img.resize((resolution, resolution), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - 0.5) / 0.5


class ImageDatasetBase:
    """files: list of paths; labels: optional per-file int labels."""

    def __init__(self, files: List[str], resolution: int,
                 labels: Optional[List[int]] = None,
                 random_flip: bool = True):
        if not files:
            raise ValueError("dataset found no image files")
        self.files = files
        self.labels = labels
        self.resolution = resolution
        self.random_flip = random_flip

    def __len__(self) -> int:
        return len(self.files)

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None):
        flip = bool(rng.randint(2)) if (self.random_flip and rng is not None) \
            else False
        path = self.files[idx]
        img = None
        if path.lower().endswith((".jpg", ".jpeg", ".png")):
            img = _native_decode(path, self.resolution, flip)
        if img is None:
            img = _transform(_decode(path), self.resolution, flip)
        if self.labels is not None:
            return img, self.labels[idx]
        return img

    # torch-Dataset-style access (no flip without an rng)
    def __getitem__(self, idx: int):
        return self.get(idx)


class FlatDirectoryImageDataset(ImageDatasetBase):
    """All image files directly inside one directory (datasets.py:17-85)."""

    def __init__(self, img_dir: str, resolution: int, **kw):
        files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                       if _is_image(os.path.join(img_dir, f)))
        super().__init__(files, resolution, **kw)


class FoldersDistributedDataset(ImageDatasetBase):
    """One level of subdirectories (FFHQ layout, datasets.py:88-157)."""

    def __init__(self, img_dir: str, resolution: int, **kw):
        files = []
        for d in sorted(os.listdir(img_dir)):
            sub = os.path.join(img_dir, d)
            if not os.path.isdir(sub):
                continue
            files.extend(sorted(os.path.join(sub, f) for f in os.listdir(sub)
                                if _is_image(os.path.join(sub, f))))
        super().__init__(files, resolution, **kw)


class ClassFolderDataset(ImageDatasetBase):
    """Subdirectory-per-class with integer labels (torchvision ImageFolder
    semantics: classes sorted alphabetically)."""

    def __init__(self, img_dir: str, resolution: int, **kw):
        classes = sorted(d for d in os.listdir(img_dir)
                         if os.path.isdir(os.path.join(img_dir, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        files, labels = [], []
        for c in classes:
            sub = os.path.join(img_dir, c)
            for f in sorted(os.listdir(sub)):
                p = os.path.join(sub, f)
                if _is_image(p):
                    files.append(p)
                    labels.append(self.class_to_idx[c])
        super().__init__(files, resolution, labels=labels, **kw)


class SyntheticDataset(ImageDatasetBase):
    """Random-image dataset for tests and benchmarks (no disk IO)."""

    def __init__(self, n: int, resolution: int, channels: int = 3,
                 n_classes: int = 0, seed: int = 0, random_flip: bool = False):
        self.n = n
        self.resolution = resolution
        self.channels = channels
        self.random_flip = random_flip
        rs = np.random.RandomState(seed)
        self.labels = (list(rs.randint(0, n_classes, size=n))
                       if n_classes > 0 else None)
        self.files = [str(i) for i in range(n)]
        self._seed = seed

    def get(self, idx: int, rng=None):
        # the flip decision consumes `rng` exactly like the base class does
        flip = bool(rng.randint(2)) if (self.random_flip and rng is not None) \
            else False
        rs = np.random.RandomState(self._seed + idx)
        img = rs.uniform(-1, 1, (self.resolution, self.resolution,
                                 self.channels)).astype(np.float32)
        if flip:
            img = img[:, ::-1].copy()
        if self.labels is not None:
            return img, self.labels[idx]
        return img


def make_dataset(dataset_cfg, conditional: bool = False):
    """Factory mirroring reference data/__init__.py:16-29."""
    res = int(dataset_cfg.resolution)
    if conditional:
        return ClassFolderDataset(dataset_cfg.img_dir, res)
    if dataset_cfg.folder:
        return FoldersDistributedDataset(dataset_cfg.img_dir, res)
    return FlatDirectoryImageDataset(dataset_cfg.img_dir, res)
