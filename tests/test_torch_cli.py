"""The port's CLIs (python -m stylegan_torch.cli.generate_samples and
python -m stylegan_torch.cli.train) as real subprocesses on the CPU, at a
tiny configuration."""

import os
import shutil
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


# --------------------------------------------------------------------------
# python -m stylegan_torch.cli.train

TRAIN_RES = 8


def _run_train(args, ok=True):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "stylegan_torch.cli.train"]
                       + args, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    if ok:
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r


@pytest.fixture(scope="module")
def train_toy(tmp_path_factory):
    """A flat directory of 8 PNGs and a toy yaml (resolution 8, batch 4,
    one epoch per depth); its output directories are removed afterwards
    (the 512-channel checkpoints take hundreds of MB)."""
    tmp = tmp_path_factory.mktemp("torch_cli_train")
    data = tmp / "data"
    data.mkdir()
    rs = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rs.randint(0, 255, (12, 12, 3), np.uint8)).save(
            data / f"{i:02d}.png")

    def config(name):
        path = tmp / f"{name}.yaml"
        path.write_text(f"""
output_dir: '{tmp / name}'
structure: 'linear'
feedback_factor: 1
checkpoint_factor: 1
num_samples: 4
num_works: 1
loss: 'logistic'
model:
  gen: {{latent_size: 32, mapping_layers: 2}}
dataset: {{img_dir: '{data}', folder: False, resolution: {TRAIN_RES}}}
sched:
  epochs: [1, 1]
  batch_sizes: [4, 4]
  fade_in_percentage: [50, 50]
""")
        return str(path)
    yield tmp, config
    shutil.rmtree(tmp, ignore_errors=True)


def test_train_cli_runs_and_resumes_on_cpu(train_toy):
    """One depth from scratch (--start_depth 1), then a resume from its five
    files into a new output_dir; the first run's directory is refused."""
    tmp, config = train_toy
    first = config("first")
    _run_train(["--config", first, "--start_depth", "1", "--device", "cpu"])
    out = tmp / "first"
    assert sorted(os.listdir(out / "samples")) == ["gen_1_1_1.png"]
    assert sorted(os.listdir(out / "models")) == sorted(
        f"GAN_{k}_1_1.npz" for k in ("GEN", "DIS", "GEN_OPTIM", "DIS_OPTIM",
                                     "GEN_SHADOW"))
    assert (out / "log.txt").exists() and (out / "metrics.jsonl").exists()
    assert (out / "first.yaml").exists()
    assert (out / "src" / "stylegan_torch" / "cli" / "train.py").exists()
    assert (out / "src" / "stylegan_torch" / "csrc" / "epilogue.cu").exists()
    grid = np.asarray(Image.open(out / "samples" / "gen_1_1_1.png"))
    assert grid.shape == (2 * TRAIN_RES + 3, 2 * TRAIN_RES + 3, 3)

    r = _run_train(["--config", first, "--device", "cpu"], ok=False)
    assert r.returncode != 0 and "already exists" in r.stderr

    models = out / "models"
    second = config("second")
    flags = ["--generator_file", "GAN_GEN_1_1.npz",
             "--gen_shadow_file", "GAN_GEN_SHADOW_1_1.npz",
             "--discriminator_file", "GAN_DIS_1_1.npz",
             "--gen_optim_file", "GAN_GEN_OPTIM_1_1.npz",
             "--dis_optim_file", "GAN_DIS_OPTIM_1_1.npz"]
    flags = [str(models / f) if f.endswith(".npz") else f for f in flags]
    r = _run_train(["--config", second, "--start_depth", "1", "--device",
                    "cpu"] + flags)
    log = (tmp / "second" / "log.txt").read_text()
    for what in ("generator params", "EMA shadow", "discriminator params",
                 "generator optimizer", "discriminator optimizer"):
        assert f"Restoring {what}" in log, what
    with np.load(tmp / "second" / "models" / "GAN_GEN_OPTIM_1_1.npz") as z:
        assert int(z["1.0.count"]) == 2 * int(
            np.load(models / "GAN_GEN_OPTIM_1_1.npz")["1.0.count"])


def test_train_cli_refuses_more_devices(train_toy):
    from stylegan_torch.cli import train
    _, config = train_toy
    args = train.parse_arguments(["--config", config("many"),
                                  "--num_devices", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1, parallelism"):
        train.main(args)
