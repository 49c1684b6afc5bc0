"""Each ported primitive and the equalized linear / conv ops of
stylegan_torch/ops against the JAX package on the CPU, in float32, outputs
and gradients (jax.vjp vs torch autograd with the same cotangent).

Outputs are held to 1e-5 abs / 1e-4 rel.  Gradients are held to 1e-4 rel
and 1e-5 abs times the largest gradient: a weight gradient sums over every
output position (2 x 128 x 128 for the fused upscale), so its rounding grows
with the gradient's scale."""

import math

import numpy as np
import pytest
import torch

import jax

from stylegan_tpu.ops import linear as jlin
from stylegan_tpu.ops import primitives as jp
from stylegan_torch.ops import linear as tlin
from stylegan_torch.ops import primitives as tp

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return (rs.randn(*shape) * scale + shift).astype(np.float32)


def _check(jfn, tfn, inputs, seed=0, tol=TOL):
    """Outputs and input gradients of jfn (JAX) and tfn (torch) agree."""
    want, vjp = jax.vjp(jfn, *inputs)
    want = np.asarray(want)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    got = tfn(*ts)
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    g = np.random.RandomState(seed + 100).randn(*want.shape).astype(np.float32)
    want_grads = vjp(g)
    got.backward(torch.from_numpy(g))
    for i, (t, w) in enumerate(zip(ts, want_grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            t.grad.numpy(), w, rtol=tol["rtol"],
            atol=tol["atol"] * max(1.0, float(np.max(np.abs(w)))),
            err_msg=f"grad of input {i}")


def test_pixel_norm():
    rs = np.random.RandomState(0)
    for shape in [(3, 32), (2, 4, 4, 16)]:
        _check(jp.pixel_norm, tp.pixel_norm, [_rand(rs, *shape)])


def test_leaky_relu():
    rs = np.random.RandomState(1)
    x = _rand(rs, 2, 5, 5, 8)
    x[0, 0, 0, :2] = 0.0          # the gradient at 0 takes the >= 0 branch
    _check(jp.leaky_relu, tp.leaky_relu, [x])


@pytest.mark.parametrize("factor,gain", [(2, 1.0), (2, 2.0), (4, 1.0)])
def test_upscale2d(factor, gain):
    rs = np.random.RandomState(2)
    _check(lambda x: jp.upscale2d(x, factor, gain),
           lambda x: tp.upscale2d(x, factor, gain), [_rand(rs, 2, 3, 5, 4)])


@pytest.mark.parametrize("taps", [(1, 2, 1), (1, 3, 3, 1), (1,)])
def test_make_blur_kernel(taps):
    np.testing.assert_allclose(tp.make_blur_kernel(taps).numpy(),
                               jp.make_blur_kernel(taps), rtol=1e-7)


@pytest.mark.parametrize("taps", [(1, 2, 1), (1, 4, 6, 4, 1)])
def test_blur2d(taps):
    rs = np.random.RandomState(3)
    jk, tk = jp.make_blur_kernel(taps), tp.make_blur_kernel(taps)
    _check(lambda x: jp.blur2d(x, jk), lambda x: tp.blur2d(x, tk),
           [_rand(rs, 2, 8, 8, 6)])


def test_instance_norm():
    rs = np.random.RandomState(4)
    _check(jp.instance_norm, tp.instance_norm,
           [_rand(rs, 2, 8, 8, 5, scale=3.0, shift=2.0)])


def test_instance_norm_bf16_keeps_dtype_and_f32_stats():
    x = torch.from_numpy(_rand(np.random.RandomState(5), 2, 16, 16, 4,
                               shift=4.0))
    got = tp.instance_norm(x.bfloat16())
    assert got.dtype == torch.bfloat16
    want = tp.instance_norm(x.bfloat16().float())
    assert float((got.float() - want).abs().max()) <= 2 * 2.0 ** -7 * 4


@pytest.mark.parametrize("cutoff", [0, 3, 8])
def test_truncate_dlatents(cutoff):
    rs = np.random.RandomState(6)
    avg = _rand(rs, 16)
    _check(lambda w: jp.truncate_dlatents(w, avg, 0.7, cutoff),
           lambda w: tp.truncate_dlatents(w, torch.from_numpy(avg), 0.7,
                                          cutoff),
           [_rand(rs, 3, 6, 16)])


def test_update_moving_average():
    rs = np.random.RandomState(7)
    _check(lambda a, n: jp.update_moving_average(a, n, 0.995),
           lambda a, n: tp.update_moving_average(a, n, 0.995),
           [_rand(rs, 16), _rand(rs, 16)])


def test_style_modulate():
    rs = np.random.RandomState(8)
    _check(jp.style_modulate, tp.style_modulate,
           [_rand(rs, 2, 4, 4, 8), _rand(rs, 2, 16)])


def test_add_noise():
    rs = np.random.RandomState(9)
    _check(jp.add_noise, tp.add_noise,
           [_rand(rs, 2, 4, 4, 8), _rand(rs, 8), _rand(rs, 2, 4, 4, 1)])


@pytest.mark.parametrize("use_wscale,lrmul,gain",
                         [(True, 0.01, math.sqrt(2)), (True, 1.0, 1.0),
                          (False, 1.0, math.sqrt(2))])
def test_linear_apply(use_wscale, lrmul, gain):
    rs = np.random.RandomState(10)
    x, w, b = _rand(rs, 3, 24), _rand(rs, 24, 40), _rand(rs, 40)
    kw = dict(gain=gain, use_wscale=use_wscale, lrmul=lrmul)
    _check(lambda x, w, b: jlin.linear_apply({"weight": w, "bias": b}, x,
                                             **kw),
           lambda x, w, b: tlin.linear_apply(x, w.T, b, **kw), [x, w, b])


CONV_CASES = {
    # name: (input HxW, in, out, k, upscale, blur)
    "same3x3": (8, 6, 5, 3, False, None),
    "to_rgb1x1": (8, 6, 3, 1, False, None),
    "up_nearest_32": (16, 6, 5, 3, True, (1, 2, 1)),      # output 32 < 128
    "up_nearest_noblur": (16, 6, 5, 3, True, None),
    "up_fused_128": (64, 4, 3, 3, True, (1, 2, 1)),       # output 128: fused
    "up_fused_noblur": (64, 4, 3, 3, True, None),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_apply(case):
    hw, cin, cout, k, upscale, taps = CONV_CASES[case]
    rs = np.random.RandomState(11)
    x, w, b = _rand(rs, 2, hw, hw, cin), _rand(rs, k, k, cin, cout), \
        _rand(rs, cout)
    jk = jp.make_blur_kernel(taps) if taps else None
    tk = tp.make_blur_kernel(taps) if taps else None
    gain = math.sqrt(2) if k == 3 else 1.0
    _check(lambda x, w, b: jlin.conv2d_apply(
               {"weight": w, "bias": b}, x, gain=gain, use_wscale=True,
               upscale=upscale, blur_kernel=jk),
           lambda x, w, b: tlin.conv2d_apply(
               x, w.permute(3, 2, 0, 1), b, gain=gain, use_wscale=True,
               upscale=upscale, blur_kernel=tk),
           [x, w, b])


def test_conv2d_apply_output_is_channels_last_storage():
    x = torch.randn(2, 16, 16, 6)
    y = tlin.conv2d_apply(x, torch.randn(5, 6, 3, 3), torch.zeros(5),
                          use_wscale=True)
    assert y.shape == (2, 16, 16, 5) and y.is_contiguous()
    assert tp.to_nchw(y).is_contiguous(memory_format=torch.channels_last)


def test_equalized_scales_match():
    for args in [(math.sqrt(2), 512, 0.01, True), (1.0, 27, 1.0, False)]:
        assert tlin.equalized_scales(*args) == jlin.equalized_scales(*args)


def test_precision_policy_sets_tf32_flags():
    from stylegan_torch.ops import precision
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32, precision.get_precision())
    try:
        precision.set_precision("default")
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        precision.set_precision("highest")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert precision.get_precision() == "highest"
        with pytest.raises(ValueError):
            precision.set_precision("high")
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        precision._PRECISION = before[2]
