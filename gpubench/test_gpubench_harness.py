"""The harness on the CPU: files found by name, a cell added as files,
the result line, no fallback to the CPU, the trace's reduction."""

import hashlib
import json
import time
import types

import pytest
import torch

from gpubench import cells, run, trace
from gpubench.conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_listed_file_is_found_by_name():
    for w in SPEC["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.chips == w["chips"]
        kind = cells.kind(cell.kind)
        assert kind.Load.family in ("serve", "train")
        assert callable(kind.Program) and callable(kind.readings)
    for c in SPEC["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
        assert cells.load_cell(next(
            w["name"] for w in SPEC["workloads"]
            if w["config"] == c["name"])).config["name"] == c["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in cells.metrics_for(SPEC, w["name"], False)}
        layer = cells.metrics_for(SPEC, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)


def test_no_configuration_keeps_a_w_average():
    """Truncation is off in every configuration, as in the published ones,
    so the program's G holds no W average (its strict state-dict load of
    the reference's names would fail if it did) and the reference has none
    to follow."""
    for w in SPEC["workloads"]:
        config = cells.load_cell(w["name"]).config
        assert config["architecture"]["truncation_psi"] <= 0
        assert config["overlay"]["model"]["gen"]["truncation_psi"] <= 0


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        cells.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        cells.kind("no_such_kind")


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_runs_and_reports(tiny):
    before = _digests(tiny.parent)
    (tiny / "traffic" / "serve-b2.json").write_text(json.dumps(
        {**json.loads((tiny / "traffic" / "serve-b8.json").read_text()),
         "batch": 2}))
    (tiny / "workloads" / "ffhq1024-f32.serve-b2.json").write_text(
        json.dumps({"config": "ffhq1024-f32", "traffic": "serve-b2",
                    "chips": 1, "limits": {"image_gap": 1e-4}}))
    after = _digests(tiny.parent)
    assert all(after[p] == d for p, d in before.items())
    cell = cells.load_cell("ffhq1024-f32.serve-b2", tiny)
    line, _ = run.execute(cell, 2 ** 31 + 11, 2.0, False, device="cpu",
                          t_start=time.perf_counter(), bench=tiny)
    assert list(line) == LINE_KEYS + ["checks"]
    assert line["correct"], line
    assert {"serve_img_s", "serve_p95_ms", "setup_s"} <= set(line["metrics"])
    assert line["attempted"] > 0 and line["failed"] == 0


PROBE = '''"""A traffic kind of a test: every rank adds its rank + 1
over the process group, `rounds` times."""
import time

import torch
import torch.distributed as dist


class Program:
    def __init__(self, *args):
        pass


class Load:
    family = "serve"

    def __init__(self, program, cell, seed, device, ranks=None):
        self.rank, self.world, _ = ranks or (0, 1, None)
        self.rounds = cell.traffic["rounds"]
        self.sums = []

    def warm(self):
        pass

    def window(self, run, seconds, tracer=None):
        t0 = time.perf_counter()
        for _ in range(self.rounds):
            t = time.perf_counter()
            x = torch.tensor([float(self.rank + 1)])
            if self.world > 1:
                dist.all_reduce(x)
            self.sums.append(float(x))
            run.latencies_s.append(time.perf_counter() - t)
            run.images += 1
        run.units = self.rounds
        run.window_s = time.perf_counter() - t0

    def release(self):
        pass

    def numbers(self):
        want = self.world * (self.world + 1) / 2
        return {"sum_gap": max(abs(s - want) for s in self.sums)}


def readings(cell, seed, device):
    return {}
'''


def _probe(tiny, chips):
    before = _digests(tiny.parent)
    (tiny / "traffic" / "probe.py").write_text(PROBE)
    (tiny / "traffic" / "probe-4.json").write_text(json.dumps(
        {"kind": "probe", "rounds": 4}))
    (tiny / "workloads" / f"probe.c{chips}.json").write_text(json.dumps(
        {"config": "ffhq1024-f32", "traffic": "probe-4", "chips": chips,
         "limits": {"sum_gap": 0.0}}))
    after = _digests(tiny.parent)
    assert all(after[p] == d for p, d in before.items())
    return cells.load_cell(f"probe.c{chips}", tiny)


def test_a_traffic_kind_added_as_files_runs(tiny):
    cell = _probe(tiny, 1)
    line, _ = run.execute(cell, 2 ** 31 + 12, 1.0, False, device="cpu",
                          t_start=time.perf_counter(), bench=tiny)
    assert line["correct"] and line["attempted"] == 4, line


def test_a_cell_on_several_chips_runs_one_process_a_rank(tiny):
    cell = _probe(tiny, 2)
    args = types.SimpleNamespace(workload=cell.name, seed=2 ** 31 + 13,
                                 seconds=1.0, bench=tiny)
    line, _ = run.launch(args, cell.chips, backend="gloo")
    assert line["correct"], line
    assert line["device"]["count"] == 2 and line["attempted"] == 4


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", SPEC["workloads"][0]["name"], "--seed",
                   "5", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "stylegan_tpu_torch_like", object())
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert run.banned_modules() == ["flax"]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reduction():
    ev = [
        _x(trace.STRETCH, "user_annotation", 0, 100),
        _x("aten::convolution", "cpu_op", 10, 20),
        _x("aten::cudnn_convolution", "cpu_op", 12, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 14, 2, correlation=1),
        _x("stylegan_torch::epilogue", "cpu_op", 40, 10,
           **{"Input Dims": [[2, 4, 4, 8], [8], [2, 4, 4, 1], [2, 16]],
              "Input type": ["float"] * 4}),
        _x("cudaLaunchKernelExC", "cuda_runtime", 42, 2, correlation=2),
        _x("aten::copy_", "cpu_op", 60, 30),
        _x("conv_kernel", "kernel", 20, 30, tid=7, correlation=1),
        _x("epi_kernel", "kernel", 45, 10, tid=7, correlation=2),
        _x("Memcpy DtoH", "gpu_memcpy", 70, 40, tid=8),   # runs past t1
    ]
    r = trace.reduce(ev)
    assert r["conv_s"] == pytest.approx(30e-6)
    assert r["epilogue_s"] == pytest.approx(10e-6)
    n = 2 * 4 * 4
    assert r["epilogue_bytes"] == 4 * n * (2 * 8 + 1) + 4 * (8 + 2 * 2 * 8)
    # gaps [0, 20] and [55, 70], named by the host op at their middle
    assert dict(r["idle_gaps"]) == {
        "aten::convolution": pytest.approx(20e-6),
        "aten::copy_": pytest.approx(15e-6)}


def test_device_stretch_reduction():
    ev = [
        _x("cudaLaunchKernel", "cuda_runtime", 0, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 2, correlation=2),
        _x("k1", "kernel", 10, 30, tid=7, correlation=1),
        _x("k2", "kernel", 20, 30, tid=7, correlation=2),   # overlaps k1
        _x("Memcpy DtoH", "gpu_memcpy", 60, 20, tid=8),
        _x("cudaDeviceSynchronize", "cuda_runtime", 8, 92),
    ]
    r = trace.reduce_device(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(60e-6)       # [10, 50], [60, 80]
    assert r["kernels"] == 2
    assert dict(r["device_ops"]) == {"k1": pytest.approx(30e-6),
                                     "k2": pytest.approx(30e-6),
                                     "Memcpy DtoH": pytest.approx(20e-6)}
