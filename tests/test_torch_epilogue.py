"""The port's fused epilogue (stylegan_torch/ops/fused.py and
ops/kernels/epilogue.py) against the JAX package's: the Pallas kernel run in
TPU interpret mode, and the plain lax composition.  On the CPU the port's
dispatcher takes its plain version; the CUDA kernel itself is held to that
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

from stylegan_tpu.ops.fused import _reference_epilogue as jax_reference
from stylegan_tpu.ops.pallas.epilogue import pallas_epilogue
from stylegan_torch.ops import fused
from stylegan_torch.ops.kernels import epilogue as kern
from stylegan_torch.utils.profiling import counters

# (2, 4, 4, 512): widest C; (1, 128, 128, 8): four 4096-row Pallas tiles
SHAPES = [(2, 4, 4, 512), (2, 8, 8, 64), (2, 64, 64, 16), (1, 128, 128, 8)]
F32_TOL = dict(atol=1e-5, rtol=1e-4)


def count(name):
    """The epilogue's counter `name`."""
    return counters["epilogue." + name]


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    # a positive mean, as after a conv + bias, exercises the variance merge
    x = (rs.randn(b, h, w, c) + 0.5).astype(np.float32)
    nw = (0.5 * rs.randn(c)).astype(np.float32)
    noise = rs.randn(b, h, w, 1).astype(np.float32)
    style = (0.5 * rs.randn(b, 2 * c)).astype(np.float32)
    return x, nw, noise, style


def _bf16_ulp_bound(ref, ulps=4):
    # bfloat16 keeps 8 significant bits: one ulp at magnitude m is
    # 2**(floor(log2 m) - 7)
    m = float(np.max(np.abs(ref)))
    return ulps * 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_epilogue_matches_jax_f32(shape):
    ins = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(pallas_epilogue(*ins))
    want_ref = np.asarray(jax_reference(*ins))
    got = fused.fused_epilogue(*map(torch.from_numpy, ins)).numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, **F32_TOL)
    np.testing.assert_allclose(got, want_ref, **F32_TOL)


def test_epilogue_matches_jax_bf16():
    """bf16 activations, noise and style (as in a bf16 pipeline): the sides
    round the noisy lrelu at other places (the Pallas kernel computes y in
    f32, the plain compositions round x + w*n and the lrelu to bf16: two
    half-ulps of |y|, which the normalisation scales to the output's
    magnitude), and each rounds its output once, so the bar is 4 bf16 ulps
    at the output's magnitude."""
    x, nw, noise, style = _inputs((2, 8, 8, 64), seed=1)
    jb = jax.numpy.bfloat16
    jins = (x.astype(jb), nw, noise.astype(jb), style.astype(jb))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(pallas_epilogue(*jins)).astype(np.float32)
    want_ref = np.asarray(jax_reference(*jins)).astype(np.float32)
    tins = (torch.from_numpy(x).bfloat16(), torch.from_numpy(nw),
            torch.from_numpy(noise).bfloat16(),
            torch.from_numpy(style).bfloat16())
    got = fused.fused_epilogue(*tins)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (want_pallas, want_ref):
        err = np.max(np.abs(got - want))
        assert err <= _bf16_ulp_bound(want), (err, _bf16_ulp_bound(want))


def _jax_grads(ins, g):
    _, vjp = jax.vjp(jax_reference, *ins)
    return [np.asarray(t) for t in vjp(g)]


def _torch_grads(fn, ins, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    fn(*ts).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 16, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_epilogue_grads_match_jax(shape):
    ins = _inputs(shape, seed=2)
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = _jax_grads(ins, g)
    got = _torch_grads(fused.fused_epilogue, ins, g)
    for name, a, b in zip(("x", "noise_weight", "noise", "style"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_kernel_autograd_function_backward(monkeypatch):
    """The autograd.Function around the kernels: the forward hands its
    launch a (B, C, 2) statistics output, the backward hands its launch
    those statistics and the gradients autograd needs, and the gradients
    are the JAX custom VJP's.  The two launches are swapped for the plain
    forward and the plain VJP so the wiring runs on the CPU."""
    def forward(x, nw, noise, style, saved):
        assert saved.shape == (x.shape[0], x.shape[-1], 2)
        return fused._reference_epilogue(x, nw, noise, style)

    def backward(g, x, nw, noise, style, saved, needs):
        assert saved.shape == (x.shape[0], x.shape[-1], 2)
        grads = fused._reference_epilogue_vjp(x, nw, noise, style, g)
        return tuple(d if need else None for d, need in zip(grads, needs))
    monkeypatch.setattr(kern, "epilogue_forward", forward)
    monkeypatch.setattr(kern, "epilogue_backward", backward)
    shape = (2, 8, 8, 32)
    ins = _inputs(shape, seed=4)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = _jax_grads(ins, g)
    got = _torch_grads(kern.kernel_epilogue, ins, g)
    for name, a, b in zip(("x", "noise_weight", "noise", "style"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, nw, noise, style = map(torch.from_numpy, _inputs((1, 4, 4, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        kern.epilogue_forward(x, nw, noise, style)


def _bad_inputs():
    x, nw, noise, style = map(torch.from_numpy, _inputs((1, 4, 4, 16)))
    return {
        "bf16 style": (x, nw, noise, style.bfloat16()),
        "f64 noise": (x, nw, noise.double(), style),
        "bf16 noise_weight": (x, nw.bfloat16(), noise, style),
        "short style": (x, nw, noise, style[:, :16].contiguous()),
        "strided x": (x.permute(0, 2, 1, 3), nw, noise, style),
        "f16 x": (x.half(), nw, noise.half(), style),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_wrapper_refuses_wrong_dtype_or_layout(case):
    """The wrapper checks before it launches and never casts or copies: a
    wrong dtype, shape or layout raises (here before the device check)."""
    with pytest.raises(ValueError, match="must be"):
        kern.epilogue_forward(*_bad_inputs()[case])


class _StubLibrary:
    """Stands in for the kernel library: a fixed two-pass plan, and the
    launch recorded instead of run (returning `err`)."""

    def __init__(self, err=0):
        self.plans, self.forwards, self.err = [], [], err

    def sgt_epilogue_plan(self, is_bf16, b, rows, c, aligned, plan):
        self.plans.append((is_bf16, b, rows, c, aligned))
        plan.path, plan.launches = 2, 2
        plan.tickets_offset, plan.workspace_bytes = 4000, 4096
        return 0

    def sgt_epilogue_forward(self, *args):
        self.forwards.append(args)
        return self.err


def _stub(monkeypatch, err=0, stream=1234, capturing=False):
    stub = _StubLibrary(err)
    monkeypatch.setattr(kern, "_library", lambda: stub)
    monkeypatch.setattr(kern, "_stream", lambda device: stream)
    monkeypatch.setattr(kern, "_capturing", lambda: capturing)
    monkeypatch.setattr(kern, "_plans", {})
    monkeypatch.setattr(kern, "_workspaces", {})
    monkeypatch.setitem(counters, "epilogue.launches", 0)
    monkeypatch.setitem(counters, "epilogue.cuda_launches", 0)
    return stub


def test_kernel_wrapper_plans_once_and_makes_one_call(monkeypatch):
    """Each epilogue is one call into the library, handed the plan; the plan
    is made once per (dtype, shape, alignment), its zeroed workspace once per
    plan, device and stream, and both are reused; the counters count calls
    and CUDA launches."""
    stub = _stub(monkeypatch)
    x, nw, noise, style = map(torch.from_numpy, _inputs((2, 8, 8, 32)))
    for _ in range(3):
        kern._launch(x, nw, noise, style, torch.empty_like(x))
    assert stub.plans == [(0, 2, 64, 32, 1)]
    assert len(stub.forwards) == 3
    workspaces = {(a[5], a[6]) for a in stub.forwards}
    (ptr, nbytes), = workspaces
    ws, = kern._workspaces.values()
    plan, = kern._plans.values()
    assert (ptr, nbytes) == (ws.data_ptr(), 4096)
    assert bool((ws[4000:] == 0).all())
    assert all(a[0] == x.data_ptr() and a[7:11] == (0, 2, 64, 32)
               and a[11] is plan and a[-1] == 1234 for a in stub.forwards)
    assert (count("launches"), count("cuda_launches")) == (3, 6)
    # another shape makes its own plan and workspace; another stream its
    # own workspace, with the same plan
    x2, nw2, noise2, style2 = map(torch.from_numpy, _inputs((2, 4, 4, 32)))
    kern._launch(x2, nw2, noise2, style2, torch.empty_like(x2))
    monkeypatch.setattr(kern, "_stream", lambda device: 99)
    kern._launch(x, nw, noise, style, torch.empty_like(x))
    assert len(stub.plans) == 2 and len(kern._plans) == 2
    assert len(kern._workspaces) == 3


def test_kernel_wrapper_capture_takes_its_own_workspace(monkeypatch):
    """A call captured into a CUDA graph never shares the eager calls'
    workspace (whose tickets a replay on another stream would race on), and
    is not kept: the graph's pool owns it.  Its tickets start at zero."""
    stub = _stub(monkeypatch)
    x, nw, noise, style = map(torch.from_numpy, _inputs((2, 8, 8, 32)))
    kern._launch(x, nw, noise, style, torch.empty_like(x))
    eager, = kern._workspaces.values()
    make, seen = kern._workspace, []

    def recorded(plan, device):
        seen.append(make(plan, device))
        return seen[-1]
    monkeypatch.setattr(kern, "_workspace", recorded)
    monkeypatch.setattr(kern, "_capturing", lambda: True)
    for _ in range(2):
        kern._launch(x, nw, noise, style, torch.empty_like(x))
    assert len(seen) == 2
    assert all(bool((w[4000:] == 0).all()) and w.numel() == 4096
               for w in seen)
    captured = [a[5] for a in stub.forwards[1:]]
    assert eager.data_ptr() not in captured
    assert captured == [w.data_ptr() for w in seen]
    assert list(kern._workspaces.values()) == [eager]
    assert (count("launches"), count("cuda_launches")) == (3, 6)


def test_kernel_wrapper_failed_launch_drops_its_workspace(monkeypatch):
    """A launch that fails raises, counts nothing, and leaves no workspace
    whose tickets it may have left counting."""
    _stub(monkeypatch, err=700)
    x, nw, noise, style = map(torch.from_numpy, _inputs((2, 8, 8, 32)))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kern._launch(x, nw, noise, style, torch.empty_like(x))
    assert kern._workspaces == {} and len(kern._plans) == 1
    assert (count("launches"), count("cuda_launches")) == (0, 0)


def test_kernel_names_cover_both_paths():
    """chip_smoke.py counts each kernel's launches in a profiled forward,
    and reads its device time there, by these names."""
    src = kern.SOURCE.read_text()
    for name in kern.KERNEL_NAMES:
        assert f"{name}(" in src


def test_bytes_moved_counts_one_read_and_one_write():
    x = torch.empty((8, 1024, 1024, 16))
    assert kern.bytes_moved(x) == 4 * 8 * 1024 ** 2 * 33 + 4 * (16 + 2 * 8 * 16)
