"""The epilogue's backward without a card: the plain analytic VJP
(ops/fused.py::_reference_epilogue_vjp, the formula the CUDA backward
kernels compute) against autograd of the plain forward and against the JAX
package's VJP, in float32 at atol = rtol = 1e-4; and the wrapper around the
backward kernels (ops/kernels/epilogue.py) handing the kernel library the
right pointers, shapes, null outputs, plan and workspace, with the library
replaced by a stub.  The kernels themselves are held to autograd of the
plain version on the card by chip_smoke.py."""

import types

import numpy as np
import pytest
import torch

import jax

from stylegan_tpu.ops.fused import _reference_epilogue as jax_reference
from stylegan_torch.ops import fused
from stylegan_torch.ops.kernels import epilogue as kern

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("x", "noise_weight", "noise", "style")
SHAPES = [(2, 4, 4, 64), (2, 8, 8, 32), (1, 16, 16, 16), (3, 5, 7, 12)]


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    x = (rs.randn(b, h, w, c) + 0.5).astype(np.float32)
    nw = (0.5 * rs.randn(c)).astype(np.float32)
    noise = rs.randn(b, h, w, 1).astype(np.float32)
    style = (0.5 * rs.randn(b, 2 * c)).astype(np.float32)
    g = rs.randn(b, h, w, c).astype(np.float32)
    return (x, nw, noise, style), g


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vjp_matches_autograd_and_jax(shape):
    ins, g = _inputs(shape)
    _, vjp = jax.vjp(jax_reference, *ins)
    want_jax = [np.asarray(t) for t in vjp(g)]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    want_torch = torch.autograd.grad(fused._reference_epilogue(*leaves),
                                     leaves, torch.from_numpy(g))
    got = fused._reference_epilogue_vjp(*map(torch.from_numpy, ins),
                                        torch.from_numpy(g))
    for name, a, wt, wj in zip(NAMES, got, want_torch, want_jax):
        assert a.shape == wt.shape and a.dtype == wt.dtype, name
        np.testing.assert_allclose(a.numpy(), wt.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(a.numpy(), wj, err_msg=name, **TOL)


def test_vjp_slope_at_zero_is_one():
    """u = x + nw * n exactly 0 takes the slope 1, as leaky_relu's
    where(u >= 0) does.  In float64, with g from a seeded generator: the
    property is exact, and on this degenerate 2x2 plane float32 rounding
    of the two formulas' different sums reached the bar for some g."""
    dt = torch.float64
    x = torch.zeros(1, 2, 2, 4, dtype=dt)
    x[0, 0, 0] = -1.0
    nw, noise = torch.zeros(4, dtype=dt), torch.zeros(1, 2, 2, 1, dtype=dt)
    style = torch.zeros(1, 8, dtype=dt)
    g = torch.randn(1, 2, 2, 4, dtype=dt,
                    generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_(True) for t in (x, nw, noise, style)]
    want = torch.autograd.grad(fused._reference_epilogue(*leaves), leaves, g)
    got = fused._reference_epilogue_vjp(x, nw, noise, style, g)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_vjp_keeps_dtypes_and_computes_bf16_in_f32():
    (x, nw, noise, style), g = _inputs((2, 4, 4, 16), seed=1)
    tb = [torch.from_numpy(a) for a in (x, nw, noise, style)]
    tb[0], tb[2] = tb[0].bfloat16(), tb[2].bfloat16()
    gb = torch.from_numpy(g).bfloat16()
    got = fused._reference_epilogue_vjp(*tb, gb)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.float32]
    want = fused._reference_epilogue_vjp(*(t.float() for t in tb), gb.float())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0)


def test_autograd_function_on_the_cpu_takes_the_plain_versions():
    """On CPU tensors the differentiable epilogue runs the plain forward and
    the plain VJP (counted as plain calls), and gives autograd's gradients;
    no kernel is launched."""
    ins, g = _inputs((2, 8, 8, 16), seed=2)
    before = (fused.plain_calls, kern.launches, kern.backward_launches)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    fused.fused_epilogue(*leaves).backward(torch.from_numpy(g))
    assert fused.plain_calls == before[0] + 2
    assert (kern.launches, kern.backward_launches) == before[1:]
    ref = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y = fused.add_noise(ref[0], ref[1], ref[2])
    y = fused.style_modulate(fused.instance_norm(fused.leaky_relu(y)), ref[3])
    y.backward(torch.from_numpy(g))
    for name, a, b in zip(NAMES, leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5,
                                   msg=name)


class _StubLibrary:
    """Stands in for the kernel library: fixed forward and backward plans,
    launches recorded instead of run (returning `err`)."""

    def __init__(self, err=0):
        self.bwd_plans, self.backwards, self.forwards = [], [], []
        self.err = err
        self.bwd_path = 2

    def sgt_epilogue_plan(self, is_bf16, b, rows, c, aligned, plan):
        plan.path, plan.launches = 1, 1
        return 0

    def sgt_epilogue_forward(self, *args):
        self.forwards.append(args)
        return self.err

    def sgt_epilogue_bwd_plan(self, is_bf16, b, rows, c, aligned, want_dn,
                              plan):
        self.bwd_plans.append((is_bf16, b, rows, c, aligned, want_dn))
        plan.path = plan.launches = self.bwd_path
        plan.tickets_offset, plan.workspace_bytes = 96, 128
        return 0

    def sgt_epilogue_backward(self, *args):
        self.backwards.append(args)
        return self.err


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(kern, "_library", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda device: 55)
    monkeypatch.setattr(kern, "_capturing", lambda: False)
    for name in ("_plans", "_workspaces", "_bwd_plans", "_bwd_workspaces"):
        monkeypatch.setattr(kern, name, {})
    for name in ("backward_launches", "backward_cuda_launches",
                 "backward_g_copies"):
        monkeypatch.setattr(kern, name, 0)
    monkeypatch.setattr(kern, "launches", 0)
    monkeypatch.setattr(kern, "cuda_launches", 0)
    # CPU tensors stand in for CUDA ones past the wrapper's device check
    check = kern._check_inputs

    def check_but_device(*args, **kw):
        with pytest.raises(ValueError, match="CUDA"):
            check(*args, **kw)
    monkeypatch.setattr(kern, "_check_inputs", check_but_device)
    monkeypatch.setattr(kern, "_on_device", lambda device, fn, *a: fn(*a))
    return lib


@pytest.mark.parametrize("needs", [(True, True, False, True),
                                   (True, True, True, True),
                                   (False, False, False, True)],
                         ids=["train", "all", "style-only"])
def test_backward_wrapper_hands_the_library_its_arguments(stub, needs):
    """Outputs allocated only for the gradients asked for, null pointers for
    the others; the plan keyed by whether dnoise is wanted; one workspace
    per plan, device and stream with its tickets zeroed; one count per
    call."""
    ins, g = _inputs((2, 8, 8, 16))
    x, nw, noise, style = map(torch.from_numpy, ins)
    g, saved = torch.from_numpy(g), torch.zeros(2, 16, 2)
    calls = [kern.epilogue_backward(g, x, nw, noise, style, saved, needs)
             for _ in range(2)]
    grads = calls[-1]
    assert [d is not None for d in grads] == list(needs)
    for d, ref in zip(grads, (x, nw, noise, style)):
        if d is not None:
            assert d.shape == ref.shape and d.dtype == ref.dtype
    assert stub.bwd_plans == [(0, 2, 64, 16, 1, int(needs[2]))]
    assert len(stub.backwards) == 2 and kern.backward_launches == 2
    assert kern.backward_cuda_launches == 4
    ws, = kern._bwd_workspaces.values()
    assert bool((ws[96:] == 0).all()) and ws.numel() == 128
    for args, outs in zip(stub.backwards, calls):
        assert args[:6] == tuple(t.data_ptr() for t in
                                 (g, x, noise, nw, style, saved))
        assert args[6:10] == tuple(0 if d is None else d.data_ptr()
                                   for d in outs)
        assert args[10:12] == (ws.data_ptr(), 128)
        assert args[12:16] == (0, 2, 64, 16) and args[-1] == 55


def test_autograd_backward_hands_the_kernels_what_autograd_needs(stub):
    """_KernelEpilogue.backward with the forward's saved statistics (the
    card's branch): one backward launch with the gradient made contiguous,
    outputs for the inputs autograd needs and null pointers for the others
    (noise carries no gradient in a train step)."""
    ins, g = _inputs((2, 8, 8, 16), seed=3)
    x, nw, noise, style = map(torch.from_numpy, ins)
    saved = torch.zeros(2, 16, 2)
    g_nchw = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous()
    g_strided = g_nchw.permute(0, 2, 3, 1)      # NHWC values, NCHW storage
    assert not g_strided.is_contiguous()
    ctx = types.SimpleNamespace(
        saved_tensors=(x, nw, noise, style, saved),
        needs_input_grad=(True, True, False, True))
    with torch.no_grad():     # as autograd runs a backward without create_graph
        grads = kern._KernelEpilogue.backward(ctx, g_strided)
    assert [d is not None for d in grads] == [True, True, False, True]
    (args,) = stub.backwards
    assert args[8] == 0                          # no dnoise
    assert stub.bwd_plans[-1][-1] == 0           # planned without dnoise
    assert kern.backward_launches == 1
    # the copy of g is counted, and handed to the kernels as contiguous NHWC
    assert kern.backward_g_copies == 1
    assert args[0] != g_strided.data_ptr()
    with torch.no_grad():
        kern._KernelEpilogue.backward(ctx, g_strided.contiguous())
    assert kern.backward_g_copies == 1 and kern.backward_launches == 2


@pytest.mark.parametrize("path", [1, 2])
def test_backward_wrapper_counts_the_plans_cuda_launches(stub, path):
    """backward_launches counts calls, backward_cuda_launches the plan's
    launches: one on path 1, two on path 2."""
    stub.bwd_path = path
    ins, g = _inputs((2, 4, 4, 8), seed=6)
    x, nw, noise, style = map(torch.from_numpy, ins)
    g, saved = torch.from_numpy(g), torch.zeros(2, 8, 2)
    for _ in range(3):
        kern.epilogue_backward(g, x, nw, noise, style, saved)
    assert kern.backward_launches == 3
    assert kern.backward_cuda_launches == 3 * path
    assert kern.launches == kern.cuda_launches == 0


def test_kernel_backward_refuses_a_second_derivative(stub):
    """The backward kernels are once differentiable: a backward through
    them with create_graph=True raises instead of returning gradients with
    no graph behind them (whose second derivative would read as zero).
    Without create_graph the same call launches the backward once."""
    ins, _ = _inputs((2, 4, 4, 8), seed=4)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    leaves[2].requires_grad_(False)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(kern.kernel_epilogue(*leaves).sum(), leaves[0],
                            create_graph=True)
    assert kern.backward_launches == 0
    torch.autograd.grad(kern.kernel_epilogue(*leaves).sum(), leaves[0])
    assert kern.backward_launches == 1


def test_cpu_epilogue_differentiates_twice():
    """On the CPU the plain VJP is torch ops, so a create_graph backward
    through fused_epilogue differentiates again: gradgradcheck in float64."""
    ins, _ = _inputs((1, 3, 3, 2), seed=5)
    leaves = tuple(torch.from_numpy(a).double().requires_grad_(True)
                   for a in ins)
    assert torch.autograd.gradgradcheck(fused.fused_epilogue, leaves)


def test_backward_wrapper_failed_launch_raises_and_drops_workspace(stub):
    stub.err = 700
    (x, nw, noise, style), g = _inputs((1, 4, 4, 8))
    t = [torch.from_numpy(a) for a in (g, x, nw, noise, style)]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kern.epilogue_backward(*t, torch.zeros(1, 8, 2))
    assert kern._bwd_workspaces == {} and kern.backward_launches == 0
    assert kern.backward_cuda_launches == 0


def test_forward_hands_the_saved_stats_pointer(stub):
    """The forward passes the (mean, rstd) output where a gradient may be
    needed and a null pointer on the inference path."""
    (x, nw, noise, style), _ = _inputs((2, 4, 4, 8))
    x, nw, noise, style = map(torch.from_numpy, (x, nw, noise, style))
    saved = torch.empty(2, 8, 2)
    kern.epilogue_forward(x, nw, noise, style)
    kern.epilogue_forward(x, nw, noise, style, saved)
    assert [a[12] for a in stub.forwards] == [0, saved.data_ptr()]


def test_backward_wrapper_refuses_wrong_inputs():
    (x, nw, noise, style), g = _inputs((1, 4, 4, 8))
    t = dict(g=torch.from_numpy(g), x=torch.from_numpy(x),
             noise_weight=torch.from_numpy(nw), noise=torch.from_numpy(noise),
             style=torch.from_numpy(style), saved=torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kern.epilogue_backward(**t)
    bad = dict(t, g=t["g"].double())
    with pytest.raises(ValueError, match="g must be"):
        kern.epilogue_backward(**bad)
    bad = dict(t, saved=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="saved must be"):
        kern.epilogue_backward(**bad)


def test_backward_kernel_names_are_in_the_source():
    """chip_smoke.py reads the backward's device time by these names, of
    both paths, which share no substring with the forward's and are not
    substrings of one another."""
    src = kern.SOURCE.read_text()
    assert set(kern.BWD_KERNELS_BY_PATH) == {1, 2}
    assert kern.BWD_KERNEL_NAMES == sum(kern.BWD_KERNELS_BY_PATH.values(), ())
    for name in kern.BWD_KERNEL_NAMES:
        assert f"\n{name}(" in src     # a kernel's definition
        assert not any(f in name for f in kern.KERNEL_NAMES)
        assert not any(name in other for other in kern.BWD_KERNEL_NAMES
                       if other != name)


def test_bytes_moved_backward_counts_one_pass():
    """g, x and noise read once, dx written once, and the small vectors:
    noise_weight and its gradient, style and its gradient, the saved
    statistics."""
    x = torch.empty((2, 1024, 1024, 16))
    n = 2 * 1024 ** 2
    small = 4 * (2 * 16 + 4 * 2 * 16 + 2 * 2 * 16)
    assert kern.bytes_moved_backward(x) == 4 * (3 * n * 16 + n) + small
