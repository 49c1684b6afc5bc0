"""Fixtures of the benchmark's tests: a copy of the benchmark at a tiny
size for runs on the CPU, and the ``card`` marker of tests that need an
NVIDIA GPU (they skip elsewhere, decided inside the fixture)."""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
TINY_RES, TINY_DEPTH = 16, 2


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tiny_copy(tmp: Path) -> Path:
    """A copy of the benchmark and BENCHMARK.json whose configurations
    run at 16x16 with 2 mapping layers (published widths otherwise)."""
    shutil.copytree(BENCH, tmp / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    b = tmp / "gpubench"
    for path in (b / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["architecture"].update(resolution=TINY_RES, mapping_layers=2)
        c["overlay"]["dataset"]["resolution"] = TINY_RES
        c["overlay"]["model"]["gen"]["mapping_layers"] = 2
        path.write_text(json.dumps(c))
    for path in (b / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["depth"] = TINY_DEPTH
        if "pool" in t:
            t["pool"] = 4
        path.write_text(json.dumps(t))
    return b


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path)
