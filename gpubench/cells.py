"""Finding a cell's files by name.

A cell ``<name>`` is ``workloads/<name>.json`` (its configuration, its
traffic mix, the chips it takes and the limits of its checks); its
configuration is ``configs/<config>.json`` (the architecture, the
program's settings as run, the source); its traffic mix is
``traffic/<traffic>.json``, parameters for the traffic kind its ``kind``
names, the module ``traffic/<kind>.py`` (drive.py says what it holds).  A
metric ``<metric>`` is read by ``metrics/<metric>.py``'s ``read(run)``,
which returns a number or None.  Which metrics a cell reports is
``BENCHMARK.json``'s, at the root of the checkout.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _json(bench: Path, kind: str, name: str) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_cell(name: str, bench: Path = BENCH) -> Cell:
    w = _json(bench, "workloads", name)
    return Cell(name, w, _json(bench, "configs", w["config"]),
                _json(bench, "traffic", w["traffic"]))


_MODULES: dict = {}


def module(path: Path):
    """The module in the file `path`, loaded once a process."""
    path = Path(path).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no module {path}")
        name = "gpubench_" + "_".join(path.with_suffix("").parts[-2:])
        spec = importlib.util.spec_from_file_location(
            name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def kind(name: str, bench: Path = BENCH):
    """The traffic kind `name`'s module."""
    return module(bench / "traffic" / f"{name}.py")


def reader(metric: str, bench: Path = BENCH):
    return module(bench / "metrics" / f"{metric}.py").read


def benchmark(bench: Path = BENCH) -> dict:
    return json.loads((bench.parent / "BENCHMARK.json").read_text())


def metrics_for(spec: dict, cell: str, traced: bool) -> list | None:
    """The metric entries a cell reports (per-layer ones when `traced`),
    or None for a cell BENCHMARK.json does not list."""
    if cell not in {w["name"] for w in spec["workloads"]}:
        return None
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
