"""The port's generate CLI (python -m stylegan_torch.cli.generate_samples)
as a real subprocess on the CPU, at a tiny configuration."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_torch.cli import generate_samples
from stylegan_torch.config import get_default_cfg
from stylegan_torch.convert import save_generator_file
from stylegan_torch.models import Generator, generator_config_from_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16


def _run(args, ok=True):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m",
                        "stylegan_torch.cli.generate_samples"] + args,
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    if ok:
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    cfg_path = tmp / "toy.yaml"
    cfg_path.write_text(f"""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
    truncation_psi: 0.7
dataset:
  resolution: {RES}
""")
    cfg = get_default_cfg()
    cfg.merge_from_file(str(cfg_path))
    gen = Generator(generator_config_from_cfg(cfg),
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():   # exercise the noise term (it inits to zero)
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.normal_(0.0, 0.3)
    npz = tmp / "gen.npz"
    save_generator_file(gen, str(npz))
    return tmp, cfg_path, npz


@pytest.mark.parametrize("mode", ["train_quirks", "eval"])
def test_cli_writes_pngs_on_cpu(toy, mode):
    tmp, cfg_path, npz = toy
    out = tmp / f"samples_{mode}"
    args = ["--config", str(cfg_path), "--generator_file", str(npz),
            "--num_samples", "2", "--output_dir", str(out), "--seed", "3",
            "--device", "cpu"] + (["--eval"] if mode == "eval" else [])
    _run(args)
    imgs = [np.asarray(Image.open(out / f"{i}.png")) for i in (1, 2)]
    for img in imgs:
        assert img.shape == (RES, RES, 3) and img.dtype == np.uint8
    assert not np.array_equal(imgs[0], imgs[1])


def test_cli_w_code_input(toy):
    tmp, cfg_path, npz = toy
    w = np.random.RandomState(0).randn(6, 512).astype(np.float32)
    np.save(tmp / "w.npy", w)
    out = tmp / "from_w.png"
    _run(["--config", str(cfg_path), "--generator_file", str(npz),
          "--input", str(tmp / "w.npy"), "--output", str(out),
          "--device", "cpu"])
    assert np.asarray(Image.open(out)).shape == (RES, RES, 3)


def test_cli_refuses_missing_cuda(toy):
    """The default device is CUDA: without a card the CLI fails rather than
    carry on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, cfg_path, npz = toy
    r = _run(["--config", str(cfg_path), "--generator_file", str(npz),
              "--num_samples", "1", "--output_dir", str(tmp / "no")],
             ok=False)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_cli_spatial_devices_not_ported(toy):
    tmp, cfg_path, npz = toy
    args = generate_samples.parse_arguments(
        ["--config", str(cfg_path), "--generator_file", str(npz),
         "--spatial_devices", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError):
        generate_samples.main(args)
