"""On the CPU at 16x16: the harness drives a whole run (all but its look
for a card) against the program, and `correct` holds; with the timed path
broken underneath, `correct` comes out false, once for each fault a cell
can have.  The same runs hold the reference to the program's CPU path."""

import json
import time

import pytest

from gpubench import cells, run
from gpubench.conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
FAMILY = {w["name"]: cells.kind(cells.load_cell(w["name"]).kind).Load.family
          for w in SPEC["workloads"]}
SERVE = [n for n, f in FAMILY.items() if f == "serve"]
TRAIN = [n for n, f in FAMILY.items() if f == "train"]
SEED = 2 ** 31 + 77


def _unchanged(program):
    class Unchanged(program):
        """An update that leaves the state as it found it."""

        def step(self, images):
            s = self.gan.state
            mods = [s.generator, s.discriminator, s.g_shadow]
            saved = [{k: v.detach().clone()
                      for k, v in m.state_dict().items()} for m in mods]
            out = super().step(images)
            for m, sd in zip(mods, saved):
                m.load_state_dict(sd)
            return out
    return Unchanged


def _half_batch(program):
    class HalfBatch(program):
        """An update on the first half of the batch, its means over that."""

        def step(self, images):
            return super().step(images[:images.shape[0] // 2])
    return HalfBatch


def _altered(program):
    class Altered(program):
        """An answer altered where it is produced: one pixel of each
        request pushed far outside the image's range."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            serve = self.serve

            def altered(z, seed):
                images = serve(z, seed).clone()
                images[0, 0, 0, 0] += 10 * images.abs().max() + 1
                return images
            self.serve = altered
    return Altered


def _run(tiny, name, fault=None):
    cell = cells.load_cell(name, tiny)
    hook = fault and fault(cells.kind(cell.kind, tiny).Program)
    return run.execute(cell, SEED, 0.3, False, device="cpu",
                       t_start=time.perf_counter(), bench=tiny, hook=hook)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_runs_are_correct(tiny, name):
    line, extra = _run(tiny, name)
    assert line["correct"], (line["checks"], extra)


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_answer_is_not_correct(tiny, name):
    line, _ = _run(tiny, name, _altered)
    assert not line["correct"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_update_is_not_correct(tiny, name, fault):
    line, _ = _run(tiny, name, fault)
    assert not line["correct"], line["checks"]
