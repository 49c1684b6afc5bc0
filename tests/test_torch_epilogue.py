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

# (2, 4, 4, 512): widest C; (1, 128, 128, 8): four 4096-row Pallas tiles
SHAPES = [(2, 4, 4, 512), (2, 8, 8, 64), (2, 64, 64, 16), (1, 128, 128, 8)]
F32_TOL = dict(atol=1e-5, rtol=1e-4)


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
    """The autograd.Function around the kernel: its backward differentiates
    the plain version, as the JAX custom VJP does.  The launch is swapped
    for the plain forward so the wiring runs on the CPU."""
    monkeypatch.setattr(kern, "epilogue_forward", fused._reference_epilogue)
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


def test_bytes_moved_counts_one_read_and_one_write():
    x = torch.empty((8, 1024, 1024, 16))
    assert kern.bytes_moved(x) == 4 * 8 * 1024 ** 2 * 33 + 4 * (16 + 2 * 8 * 16)
