"""The port's data pipeline (stylegan_torch/data/) against the JAX package's
(stylegan_tpu/data/): the same files, seeds, epochs and shards give bitwise
equal batches; the native decoder agrees with PIL; the loader survives an
abandoned iterator and surfaces decode errors; device_prefetch on the CPU
keeps order and values."""

import io
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_tpu import data as jdata
from stylegan_tpu.data import datasets as jdatasets
from stylegan_tpu.data import native as jnative
from stylegan_tpu.data.transforms import get_transform as jax_get_transform
from stylegan_torch import data as tdata
from stylegan_torch.data import datasets as tdatasets
from stylegan_torch.data import native
from stylegan_torch.data.transforms import get_transform


def _write_images(d, n, size=16, prefix="img", fmt="png", seed=0):
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        arr = rs.randint(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(d, f"{prefix}{i:03d}.{fmt}"))


def _tree(tmp_path, kind):
    """A directory of `kind` and the constructor arguments of both
    packages' dataset for it."""
    root = str(tmp_path / kind)
    if kind == "flat":
        _write_images(root, 6, size=20)
        _write_images(root, 2, size=12, prefix="j", fmt="jpg", seed=1)
        return "FlatDirectoryImageDataset", (root, 16)
    if kind == "folders":
        _write_images(os.path.join(root, "00000"), 4, size=20)
        _write_images(os.path.join(root, "01000"), 3, size=24, seed=2)
        return "FoldersDistributedDataset", (root, 16)
    if kind == "class_folders":
        _write_images(os.path.join(root, "cat"), 4)
        _write_images(os.path.join(root, "dog"), 3, seed=3)
        return "ClassFolderDataset", (root, 8)
    if kind == "npy":
        os.makedirs(root)
        rs = np.random.RandomState(4)
        for i in range(5):   # CHW like the reference, some with alpha
            np.save(os.path.join(root, f"x{i}.npy"), rs.randint(
                0, 255, (3 + i % 2, 16, 16)).astype(np.float32))
        return "FlatDirectoryImageDataset", (root, 8)
    return "SyntheticDataset", (9, 8)


KINDS = ["flat", "folders", "class_folders", "npy", "synthetic"]


@pytest.fixture
def same_decoder(monkeypatch):
    """Both packages' datasets decode JPEG and PNG files with one decoder,
    so that their pixels can be held bitwise: the C++ core on both sides
    where both built it, else PIL on both.  The JAX package builds its
    library in place at first use (stylegan_tpu/data/native.py), so a
    process that loads it while another is writing it falls back to PIL
    for its lifetime, and PIL differs from the C++ core by up to 2/255
    (test_native_decoder_agrees_with_pil_and_jax holds the two cores to
    each other and to PIL)."""
    if native.available() != jnative.available():
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "available", lambda: False)
    return native.decoder()


@pytest.mark.parametrize("kind", KINDS)
def test_dataset_items_equal_jax(tmp_path, kind, same_decoder):
    name, args = _tree(tmp_path, kind)
    kw = {"n_classes": 3, "random_flip": True} if kind == "synthetic" else {}
    theirs = getattr(jdata, name)(*args, **kw)
    ours = getattr(tdata, name)(*args, **kw)
    assert ours.files == theirs.files and len(ours) == len(theirs)
    assert ours.labels == theirs.labels
    for idx in range(len(ours)):
        for seed in (None, 0, 1, 2, 3):
            rng = lambda: None if seed is None else np.random.RandomState(seed)
            a, b = ours.get(idx, rng()), theirs.get(idx, rng())
            if isinstance(a, tuple):
                assert a[1] == b[1]
                a, b = a[0], b[0]
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b), (idx, seed)


@pytest.mark.parametrize(
    "seed,shards,flip,shuffle",
    [(0, 1, True, True), (5, 1, False, True), (3, 2, True, True),
     (3, 3, True, False)], ids=["seed0", "seed5_noflip", "2_shards",
                                "3_shards_ordered"])
@pytest.mark.parametrize("kind", ["folders", "class_folders", "synthetic"])
def test_loader_batches_equal_jax(tmp_path, kind, seed, shards, flip,
                                  shuffle, same_decoder):
    """Over two epochs and every shard: the same batches, bitwise."""
    name, args = _tree(tmp_path, kind)
    kw = ({"n_classes": 3, "random_flip": flip} if kind == "synthetic"
          else {"random_flip": flip})
    for shard in range(shards):
        loaders = [pkg.DataLoader(getattr(pkg, name)(*args, **kw),
                                  batch_size=2, num_workers=2, seed=seed,
                                  shuffle=shuffle, shard_index=shard,
                                  num_shards=shards, drop_last=shard % 2 == 0)
                   for pkg in (tdata, jdata)]
        assert len(loaders[0]) == len(loaders[1]) > 0
        for _ in range(2):
            ours, theirs = (list(dl) for dl in loaders)
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype and np.array_equal(x, y)


def test_get_data_loader_and_make_dataset(tmp_path, same_decoder):
    _write_images(str(tmp_path / "sub"), 4)

    class Cfg(dict):
        __getattr__ = dict.__getitem__
    cfg = Cfg(img_dir=str(tmp_path), folder=True, resolution=8)
    assert isinstance(tdata.make_dataset(cfg), tdata.FoldersDistributedDataset)
    flat = Cfg(img_dir=str(tmp_path / "sub"), folder=False, resolution=8)
    assert isinstance(tdata.make_dataset(flat),
                      tdata.FlatDirectoryImageDataset)
    dl = tdata.get_data_loader(tdata.make_dataset(cfg), 2, 2)
    want = jdata.get_data_loader(jdata.make_dataset(cfg), 2, 2)
    assert len(dl) == 2
    for a, b in zip(dl, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("size", [None, (8, 8)], ids=["native_size", "8"])
def test_transform_equals_jax(size):
    arr = np.random.RandomState(5).randint(0, 255, (12, 12, 3), np.uint8)
    for seed in range(4):
        a = get_transform(size)(Image.fromarray(arr),
                                np.random.RandomState(seed))
        b = jax_get_transform(size)(Image.fromarray(arr),
                                    np.random.RandomState(seed))
        assert np.array_equal(a, b)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("src,dst,flip", [(16, 16, False), (64, 16, False),
                                          (48, 32, True), (16, 32, True)])
def test_native_decoder_agrees_with_pil_and_jax(src, dst, flip):
    if not native.available():
        pytest.skip("no g++ with libjpeg and libpng")
    assert native.decoder() == "native"
    arr = np.random.RandomState(src + dst).randint(0, 255, (src, src, 3),
                                                   dtype=np.uint8)
    data = _png(arr)
    ours = native.decode_resize(data, dst, flip)
    pil = tdatasets._transform(Image.open(io.BytesIO(data)).convert("RGB"),
                               dst, flip)
    # PIL's filter coefficients are fixed point: +-2 of 255 in [-1, 1]
    np.testing.assert_allclose(ours, pil, atol=2.5 / 255 * 2)
    assert ours.shape == (dst, dst, 3) and ours.dtype == np.float32
    if jnative.available():   # the same C++ source: the same pixels
        assert np.array_equal(ours, jnative.decode_resize(data, dst, flip))
    # and the PIL paths of the two packages agree bitwise
    assert np.array_equal(pil, jdatasets._transform(
        Image.open(io.BytesIO(data)).convert("RGB"), dst, flip))


def test_native_invalid_data_raises_and_dataset_falls_back(tmp_path):
    if not native.available():
        pytest.skip("no g++ with libjpeg and libpng")
    with pytest.raises(ValueError):
        native.decode_resize(b"not an image at all", 16, False)
    arr = np.random.RandomState(1).randint(0, 255, (24, 24, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    ds = tdata.FlatDirectoryImageDataset(str(tmp_path), 16,
                                         random_flip=False)
    pil = tdatasets._transform(tdatasets._decode(ds.files[0]), 16, False)
    np.testing.assert_allclose(ds[0], pil, atol=2.5 / 255 * 2)


def test_native_library_is_built_outside_the_package():
    if not native.available():
        pytest.skip("no g++ with libjpeg and libpng")
    assert native.BUILD_DIR.parts[-2:] == ("build", "stylegan_torch")
    assert any(p.name.startswith("libstylegan_io-")
               for p in native.BUILD_DIR.iterdir())
    pkg = os.path.dirname(native.__file__)
    assert not any(f.endswith(".so")
                   for f in os.listdir(os.path.join(pkg, "native")))


def test_abandoned_iterator_does_not_deadlock():
    """Breaking out of iteration mid-epoch must not leave the producer
    thread blocked forever on a full queue."""
    ds = tdata.SyntheticDataset(n=64, resolution=8)
    before = threading.active_count()
    for _ in range(5):
        it = iter(tdata.DataLoader(ds, batch_size=4, num_workers=2,
                                   prefetch=1))
        next(it)
        it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_decode_error_surfaces(tmp_path):
    (tmp_path / "broken.png").write_bytes(b"not a png")
    ds = tdata.FlatDirectoryImageDataset(str(tmp_path), resolution=8)
    dl = tdata.DataLoader(ds, batch_size=1, num_workers=1, drop_last=False)
    with pytest.raises(Exception):
        list(dl)


def test_empty_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="no image files"):
        tdata.FlatDirectoryImageDataset(str(tmp_path), resolution=8)


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("size", [1, 2, 5])
def test_device_prefetch_on_cpu_keeps_order_and_values(conditional, size):
    ds = tdata.SyntheticDataset(n=12, resolution=8,
                                n_classes=3 if conditional else 0)
    dl = tdata.DataLoader(ds, batch_size=2, num_workers=2, seed=1)
    want = list(dl)
    dl.set_epoch(0)
    got = list(tdata.device_prefetch(iter(dl), "cpu", size=size))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            assert np.array_equal(x.numpy(), y)
