"""On the card: each cell's control fails one of its limits, on three
seeds, at the cell's own size (python -m pytest gpubench -m card)."""

import json

import pytest

from gpubench import cells, control
from gpubench.conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_the_control_is_not_correct(card, name):
    cell = cells.load_cell(name)
    limits = cell.workload["limits"]
    for seed in SEEDS:
        numbers = control.readings(cell, seed)["control"]
        assert any(numbers[k] > lim for k, lim in limits.items()), \
            (seed, numbers, limits)
