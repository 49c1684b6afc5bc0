"""The port's copies of the JAX package's host utilities: the feedback grid
writer (stylegan_torch/io/image.py) gives the same PNG pixels as
stylegan_tpu/io/image.py, and the run logger, source snapshot and metrics
stream (stylegan_torch/utils/) behave as the JAX package's."""

import json
import logging

import numpy as np
import pytest
from PIL import Image

from stylegan_tpu.io import image as jimage
from stylegan_tpu.train.trainer import adjust01 as jax_adjust01
from stylegan_torch.io import image as timage
from stylegan_torch.train import adjust01
from stylegan_torch.train.trainer import StyleGAN
from stylegan_torch.utils import MetricsWriter, make_logger, snapshot_sources


@pytest.mark.parametrize("n,res,channels,scale,normalize", [
    (4, 8, 3, 1, True), (4, 4, 3, 4, True), (9, 8, 3, 2, True),
    (6, 8, 1, 1, True), (5, 8, 3, 1, False)],
    ids=["2x2", "upscaled", "3x3", "gray_ragged", "clipped"])
def test_grid_png_equals_jax(tmp_path, n, res, channels, scale, normalize):
    samples = np.random.RandomState(n + res).randn(
        n, res, res, channels).astype(np.float32)
    if normalize:
        samples[0] = 0.25        # a flat image: the min-max floor of 1e-5
    paths = [str(tmp_path / f"{name}.png") for name in ("port", "jax")]
    for mod, path in zip((timage, jimage), paths):
        mod.save_image_grid(adjust01(samples), path, scale_factor=scale,
                            normalize=normalize)
    port, jax_png = (np.asarray(Image.open(p)) for p in paths)
    assert port.dtype == np.uint8 and np.array_equal(port, jax_png)
    side = int(np.sqrt(n))
    rows = -(-n // side)
    assert port.shape[:2] == (rows * (res * scale + 1) + 1,
                              side * (res * scale + 1) + 1)


def test_grid_helpers_equal_jax():
    imgs = np.random.RandomState(2).rand(3, 4, 4, 3).astype(np.float32)
    assert np.array_equal(timage._minmax_per_image(imgs),
                          jimage._minmax_per_image(imgs))
    assert np.array_equal(timage.upscale_nearest(imgs, 3),
                          jimage.upscale_nearest(imgs, 3))
    x = np.linspace(-2, 2, 11, dtype=np.float32)
    assert np.array_equal(adjust01(x), jax_adjust01(x))


def test_create_grid_writes_the_trainer_grid(tmp_path):
    samples = np.random.RandomState(3).randn(4, 4, 4, 3).astype(np.float32)
    StyleGAN.create_grid(samples, 2, str(tmp_path / "g.png"))
    assert np.asarray(Image.open(tmp_path / "g.png")).shape == (19, 19, 3)


def test_make_logger_writes_file_and_stdout(tmp_path, capsys):
    logger = make_logger("torch_utils_test", str(tmp_path), "log")
    logger.info("hello %d", 5)
    for h in logger.handlers:
        h.flush()
    assert "hello 5" in (tmp_path / "log.txt").read_text()
    assert "hello 5" in capsys.readouterr().out
    assert logger.level == logging.DEBUG and len(logger.handlers) == 2
    logger.handlers.clear()


def test_snapshot_sources_takes_kernels_and_skips_builds(tmp_path):
    root = tmp_path / "repo"
    for rel in ("a.py", "pkg/b.yaml", "pkg/csrc/k.cu", "pkg/csrc/k.h",
                "build/x.py", "chiprun_out/y.txt", ".git/z.py",
                "configs/c.yaml", "pkg/lib.so", "__pycache__/m.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(rel)
    out = tmp_path / "src"
    snapshot_sources(str(root), str(out))
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                 if p.is_file())
    assert got == ["a.py", "pkg/b.yaml", "pkg/csrc/k.cu", "pkg/csrc/k.h"]


def test_metrics_writer_appends_json_lines(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    for _ in range(2):
        w = MetricsWriter(str(path))
        w.write(step=1, d_loss=0.5, imgs_per_sec=None)
        w.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["d_loss"] == 0.5
    assert rows[0]["imgs_per_sec"] is None and "time" in rows[0]


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(logdir) writes a Chrome/Perfetto trace JSON naming the aten
    ops run inside it, creating the directory; the context's value is the
    profile."""
    import torch
    from stylegan_torch.utils import trace
    logdir = tmp_path / "new" / "traces"
    with trace(str(logdir)) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    files = list(logdir.glob("*.json"))
    assert len(files) == 1 and prof is not None
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::mm") for e in events)
    files[0].unlink()


def test_trace_without_logdir_is_a_no_op(tmp_path, monkeypatch):
    from stylegan_torch.utils import trace
    monkeypatch.chdir(tmp_path)
    for logdir in (None, ""):
        with trace(logdir) as prof:
            pass
        assert prof is None
    assert list(tmp_path.iterdir()) == []
