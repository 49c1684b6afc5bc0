"""The join of the program's spans with a device trace (spans.py), on
synthetic traces; and on the card, a launch inside a span of the port's
recorder lies inside it on the device trace's clock."""

import json

import pytest

from gpubench import spans

BASE = 10 ** 15     # the trace's baseTimeNanoseconds
MAIN, AUTOGRAD = 11, 12          # the recorder's thread ids
CUPTI_MAIN, CUPTI_AUTOGRAD = 900, 901   # CUPTI's, in a device-only trace


def _span(name, parent, root, tid, a_us, b_us):
    return (name, parent, root, tid, BASE + a_us * 1000, BASE + b_us * 1000)


def _trace(ops):
    """A Chrome trace of (launch tid, launch ts, kernel start, end) in
    microseconds after BASE, each kernel matched to its launch."""
    events = []
    for corr, (tid, t, a, b) in enumerate(ops, 1):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                       "tid": tid, "ts": t, "dur": 1.0,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                       "tid": 7, "ts": a, "dur": b - a,
                       "args": {"correlation": corr}})
    return {"baseTimeNanoseconds": BASE, "traceEvents": events}


STEP = [_span("train.step", None, 0, MAIN, 0, 100),
        _span("train.d", 0, 0, MAIN, 10, 60),
        _span("train.d.backward", 1, 0, MAIN, 30, 60),
        _span("train.g", 0, 0, MAIN, 60, 95)]


def _ops(main, autograd):
    return [(main, 15, 20, 25),        # in train.d
            (autograd, 35, 40, 50),    # autograd's, in train.d.backward
            (main, 70, 72, 90),        # in train.g
            (main, 105, 106, 110)]     # outside the program


@pytest.mark.parametrize("tids", [(CUPTI_MAIN, CUPTI_AUTOGRAD),
                                  (MAIN, AUTOGRAD)], ids=["cupti", "system"])
def test_a_launch_on_autograds_thread_counts_to_the_phase_waiting(tids):
    """A kernel that autograd's thread launches while the unit's thread
    waits in train.d.backward counts there, and to the train.d phase,
    whether or not the trace names threads as the recorder does."""
    j = spans.join(_trace(_ops(*tids)), STEP)
    assert j["units"] == 1
    assert j["spans"]["train.d.backward"]["device_ms"] == pytest.approx(0.010)
    assert j["spans"]["train.d"]["device_ms"] == pytest.approx(0.005)
    assert j["phases"]["train.d"]["device_ms"] == pytest.approx(0.015)
    assert j["phases"]["train.step"]["device_ms"] == pytest.approx(0.033)
    assert j["outside"]["device_ms"] == pytest.approx(0.004)


def test_a_span_on_the_launching_thread_is_the_innermost():
    """Where the trace names the recorder's threads, a span that
    autograd's thread opens (a recomputed forward) takes its own launches,
    is no unit of its own, and leaves the phase to the unit's thread."""
    recompute = [_span("g.forward", None, 4, AUTOGRAD, 34, 45)]
    j = spans.join(_trace(_ops(MAIN, AUTOGRAD)), STEP + recompute)
    assert j["units"] == 1
    assert j["spans"]["g.forward"]["device_ms"] == pytest.approx(0.010)
    assert j["spans"]["train.d.backward"]["device_ms"] == 0.0
    assert j["phases"]["train.d"]["device_ms"] == pytest.approx(0.015)


def test_an_idle_gap_splits_over_the_spans_it_straddles():
    """Idle time from the first launch (15 us) to the last kernel's end
    (110 us), split at the span boundaries: the gap from 50 to 72 us gives
    10 us to train.d.backward and 12 to train.g."""
    j = spans.join(_trace(_ops(CUPTI_MAIN, CUPTI_AUTOGRAD)), STEP)
    idle = {name: row["idle_ms"] * 1e3 for name, row in j["spans"].items()}
    assert idle == pytest.approx({"train.step": 5.0, "train.d": 10.0,
                                  "train.d.backward": 20.0,
                                  "train.g": 17.0})
    assert j["outside"]["idle_ms"] * 1e3 == pytest.approx(6.0)
    assert j["phases"]["train.d"]["idle_ms"] * 1e3 == pytest.approx(30.0)


def test_the_table_adds_up_to_the_stretch():
    """Device ms by span plus outside make the stretch's busy time (two
    overlapping kernels counted once), idle ms its idle time, per unit;
    walls, self times and calls are per unit."""
    ops = _ops(CUPTI_MAIN, CUPTI_AUTOGRAD) + [(CUPTI_MAIN, 71, 80, 92)]
    two = STEP + [_span(s[0], None if s[1] is None else s[1] + 4, 4, MAIN,
                        *((t - BASE) / 1000 + 200 for t in s[4:6]))
                  for s in STEP]
    ops += [(t, ts + 200, a + 200, b + 200) for t, ts, a, b in ops[:3]]
    j = spans.join(_trace(ops), two)
    assert j["units"] == 2
    busy = 5 + 10 + 20 + 4 + 5 + 10 + 18   # k3 and k5 share 10 us
    device = sum(r["device_ms"] for r in j["spans"].values())
    assert (device + j["outside"]["device_ms"]) * 2e3 == pytest.approx(busy)
    idle = sum(r["idle_ms"] for r in j["spans"].values())
    window = 290 - 15
    assert (idle + j["outside"]["idle_ms"]) * 2e3 == \
        pytest.approx(window - busy)
    step = j["spans"]["train.step"]
    assert (step["calls"], step["wall_ms"]) == (1, pytest.approx(0.1))
    assert step["self_ms"] == pytest.approx(0.1 - 0.05 - 0.035)


@pytest.mark.card
def test_a_launch_lies_inside_its_span_on_the_card(card, tmp_path):
    """A device-only profile, as the benchmark's device stretch takes one:
    the matmuls launched inside a span count to it, and each launch lies
    inside it on the trace's clock.  Prints the distance from the span's
    start to its launch and from the launch's end to the span's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stylegan_torch.utils.profiling import recording, span
    x = torch.randn(2048, 2048, device=card)
    x @ x
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with recording() as rec:
        prof.start()
        for _ in range(5):
            with span("probe"):
                x @ x
            torch.cuda.synchronize()
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    j = spans.join(doc, rec.spans)
    assert j["units"] == 5 and j["outside"]["device_ms"] == 0.0
    assert j["spans"]["probe"]["device_ms"] > 0
    base = doc["baseTimeNanoseconds"]
    kernels = {e["args"]["correlation"] for e in doc["traceEvents"]
               if e.get("cat") == "kernel"}
    launches = [e for e in doc["traceEvents"]
                if e.get("cat") in spans.LAUNCH_CATS
                and e["args"].get("correlation") in kernels]
    assert len(launches) >= 5
    lead, tail = [], []
    for e in launches:
        t0 = base + e["ts"] * 1000
        t1 = t0 + e.get("dur", 0) * 1000
        s = next(s for s in rec.spans if s[4] <= t0 <= s[5])
        lead.append(t0 - s[4])
        tail.append(s[5] - t1)
    assert min(lead) >= 0 and min(tail) >= 0
    print(f"span start to launch {min(lead) / 1e3:.1f}-"
          f"{max(lead) / 1e3:.1f} us, launch end to span end "
          f"{min(tail) / 1e3:.1f}-{max(tail) / 1e3:.1f} us")
