"""The port's spans (stylegan_torch/utils/profiling.py): the shared no-op
without a recorder, nesting by thread, the phases of one train_on_batch
and of a generator forward, their clock against torch.profiler's, their
events in trace(logdir), and nothing of them in a torch.export
artifact."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.serving import (export_generator, load_exported,
                                    make_serving_fn)
from stylegan_torch.train import StyleGAN
from stylegan_torch.utils import profiling
from stylegan_torch.utils.profiling import recording, span, trace

RES = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _children(spans, parent):
    return [s[0] for s in spans if s[1] == parent]


def _index(spans, name):
    return next(i for i, s in enumerate(spans) if s[0] == name)


def test_without_a_recorder_span_is_one_shared_no_op(monkeypatch):
    """No recorder: every span is the same object, entered without reading
    the clock, and nothing is kept."""
    def no_clock():
        raise AssertionError("the clock was read")
    assert profiling._recorder is None
    monkeypatch.setattr(time, "time_ns", no_clock)
    first = span("a")
    with first, span("b"):
        pass
    assert span("c") is first
    with recording() as rec:
        pass
    assert rec.spans == [] and profiling._recorder is None


def test_spans_nest_by_thread():
    """Parents and roots by index, one stack a thread: a span that another
    thread opens while one is open here is a root of its own."""
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        with span("other"):
            with span("other.child"):
                pass
        done.set()

    t = threading.Thread(target=other)
    with recording() as rec:
        t.start()
        with span("root"):
            with span("child"):
                inside.set()
                done.wait()
                with span("grandchild"):
                    pass
        with span("second"):
            pass
    t.join()
    got = {s[0]: s[1:4] for s in rec.spans}
    ids = {s[0]: i for i, s in enumerate(rec.spans)}
    me, them = threading.get_native_id(), got["other"][2]
    assert them != me
    assert got["root"] == (None, ids["root"], me)
    assert got["child"] == (ids["root"], ids["root"], me)
    assert got["grandchild"] == (ids["child"], ids["root"], me)
    assert got["other"] == (None, ids["other"], them)
    assert got["other.child"] == (ids["other"], ids["other"], them)
    assert got["second"] == (None, ids["second"], me)
    assert all(s[4] <= s[5] for s in rec.spans)
    root, child = rec.spans[ids["root"]], rec.spans[ids["child"]]
    assert root[4] <= child[4] <= child[5] <= root[5]


def test_threads_at_once_record_every_span_once():
    """More threads than cores opening spans at once, switching as often as
    the interpreter allows: every span has a slot of its own, filled, its
    parent and root on its own thread."""
    n_threads, n_spans = 16, 200
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=60)
        for _ in range(n_spans):
            with span("outer"):
                with span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = rec.spans
    assert len(spans) == 2 * n_threads * n_spans and None not in spans
    for i, s in enumerate(spans):
        if s[0] == "outer":
            assert s[1] is None and s[2] == i
        else:
            outer = spans[s[1]]
            assert outer[0] == "outer" and s[2] == s[1]
            assert outer[3] == s[3] and outer[4] <= s[4] <= s[5] <= outer[5]
    assert len({s[3] for s in spans}) == n_threads


def _trainer(**kw):
    opt = {"learning_rate": 0.003, "beta_1": 0.0, "beta_2": 0.99,
           "eps": 1e-8}
    return StyleGAN(structure="linear", resolution=RES, num_channels=3,
                    latent_size=16, g_args={"latent_size": 16,
                                            "mapping_layers": 2},
                    d_args={}, g_opt_args=opt, d_opt_args=opt,
                    loss="logistic", use_ema=True, seed=0, device="cpu",
                    **kw)


@pytest.mark.parametrize("lazy", [False, True], ids=["r1", "lazy_r1"])
def test_one_update_gives_the_phase_spans_in_order(lazy):
    """train_on_batch's spans: train.step holds the input, D, G and EMA
    phases; D's and G's hold their backward and optimizer step.  The lazy
    trainer's R1 update (its first) with the shared G forward adds that
    forward and the separate R1 update."""
    kw = dict(r1_interval=2, r1_separate_reg=True, reuse_g_fwd=True) \
        if lazy else {}
    t = _trainer(**kw)
    images = np.random.RandomState(0).uniform(
        -1, 1, (2, RES, RES, 3)).astype(np.float32)
    with recording() as rec:
        t.train_on_batch(images, 1, 0.5)
    spans = rec.spans
    assert spans[0][0] == "train.step" and spans[0][1] is None
    assert sum(s[1] is None for s in spans) == 1
    assert all(s[2] == 0 for s in spans)
    want = (["train.input", "train.g_forward", "train.d", "train.reg"]
            if lazy else ["train.input", "train.d"]) + ["train.g",
                                                         "train.ema"]
    assert _children(spans, 0) == want
    d, g = _index(spans, "train.d"), _index(spans, "train.g")
    assert _children(spans, d)[-2:] == ["train.d.backward", "train.d.optim"]
    assert _children(spans, g)[-2:] == ["train.g.backward", "train.g.optim"]
    if lazy:
        reg = _index(spans, "train.reg")
        assert _children(spans, reg) == ["train.reg.backward",
                                         "train.reg.optim"]
        assert _children(spans, _index(spans, "train.g_forward")) == \
            ["g.forward"]
        assert "g.forward" not in _children(spans, g)
    else:
        assert _children(spans, d)[0] == "g.forward"
        assert _children(spans, g)[0] == "g.forward"


def small_cfg(res=16):
    layers = (res.bit_length() - 2) * 2
    return tcfg.GeneratorConfig(
        resolution=res, latent_size=32, dlatent_size=32, truncation_psi=-1.0,
        mapping=tcfg.MappingConfig(latent_size=32, dlatent_size=32,
                                   mapping_fmaps=32, mapping_layers=2,
                                   dlatent_broadcast=layers),
        synthesis=tcfg.SynthesisConfig(resolution=res, dlatent_size=32,
                                       fmap_base=128, fmap_max=32,
                                       blur_filter=(1, 2, 1),
                                       structure="linear"))


def _generator(cfg):
    gen = Generator(cfg, generator=torch.Generator().manual_seed(0))
    return gen.requires_grad_(False).eval()


@pytest.mark.parametrize("depth", [0, 2])
def test_a_forward_gives_its_mapping_synthesis_and_noise_spans(depth):
    """A forward alone: g.forward, root, holds g.mapping and g.synthesis;
    the synthesis holds one g.noise a layer, 2(depth + 1).  Through
    make_serving_fn the request is the root, z's copy its input, the
    images' hand-off to the host its last child."""
    cfg = small_cfg()
    gen = _generator(cfg)
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(1))
    with recording() as rec:
        gen(z, depth, 1.0, seed=3)
    spans = rec.spans
    assert spans[0][:2] == ("g.forward", None)
    assert _children(spans, 0) == ["g.mapping", "g.synthesis"]
    assert _children(spans, 2) == ["g.noise"] * (2 * (depth + 1))
    serve = make_serving_fn(cfg, gen, depth=depth, device="cpu")
    with recording() as rec:
        serve(z.numpy(), 3)
    spans = rec.spans
    assert spans[0][:2] == ("serve.request", None)
    assert _children(spans, 0) == ["serve.input", "g.forward",
                                   "serve.output"]


def test_a_span_holds_the_profiled_op_on_the_profilers_clock(tmp_path):
    """torch.profiler's Chrome trace lies on the host's realtime clock:
    an aten::mm at baseTimeNanoseconds + ts lies inside the span recorded
    around it (on time.time_ns())."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(64, 64)
    path = tmp_path / "trace.json"
    for _ in range(3):
        prof = profile(activities=[ProfilerActivity.CPU])
        with recording() as rec:
            prof.start()
            with span("mm"):
                torch.mm(a, a)
            prof.stop()
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        base = doc["baseTimeNanoseconds"]
        mm = next(e for e in doc["traceEvents"] if e.get("name") == "aten::mm")
        (_, _, _, _, t0, t1), = rec.spans
        assert t0 <= base + mm["ts"] * 1e3
        assert base + (mm["ts"] + mm["dur"]) * 1e3 <= t1


def test_trace_writes_the_spans_as_program_span_events(tmp_path):
    """trace(logdir) records the body's spans and writes them into its
    Chrome trace as complete events on the trace's own time base, over the
    ops they ran."""
    a = torch.randn(64, 64)
    with trace(str(tmp_path)):
        with span("outer"):
            with span("inner"):
                torch.mm(a, a)
    path, = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(got) == {"outer", "inner"}
    assert all(e["ph"] == "X" for e in got.values())
    assert got["inner"]["args"]["parent"] == got["outer"]["args"]["index"]
    mm = next(e for e in events if e.get("name") == "aten::mm")
    inner = got["inner"]
    assert inner["ts"] <= mm["ts"] + 1 and \
        mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"] + 1
    assert profiling._recorder is None


def test_export_under_a_recorder_records_nothing_of_the_graph():
    """export_generator while a recorder is installed: the same artifact
    outputs as without one, no span from the traced forward, and no node
    of the profiling module in the graph."""
    cfg = small_cfg()
    gen = _generator(cfg)
    plain = export_generator(cfg, gen, depth=2, batch_size=2)
    with recording() as rec:
        blob = export_generator(cfg, gen, depth=2, batch_size=2)
    assert rec.spans == []
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(2))
    served = load_exported(blob, device="cpu")
    assert torch.equal(served(z, 5), load_exported(plain, device="cpu")(z, 5))
    assert not any("profiling" in str(n.target) or "record_function" in
                   str(n.target) for n in served.exported.graph.nodes)
