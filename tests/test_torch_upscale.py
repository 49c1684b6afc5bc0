"""The fused upscale (stylegan_torch/ops/linear.py::_fused_upscale_conv) as a
sub-pixel convolution (`_subpixel_upscale_conv`, the form it takes where no
gradient is recorded): one stride-1 2x2 conv whose 4*O output channels are
the four output phases, then their interleave.  Held on the CPU to the
transposed conv it replaces (F.conv_transpose2d, stride 2, padding 1, the
4-tap-summed 4x4 kernel) in float64 (1e-12 of the output's scale) and
float32 (1e-5), its first-order gradients to the transposed form's in
float64, and to the JAX package's _fused_upscale_conv on the same weights
(atol 1e-5, rtol 1e-4: float32 sums in another order); at C in {1, 3, 16}
input channels and H in {64, 128}.  A depth-5 generator exported with
torch.export holds no transposed aten.convolution, and the replay probe's
dispatch mode finds every operator of a forward equal to itself when run
twice.  Under autograd the fused upscale takes the transposed conv
(`_transposed_upscale_conv`), which the sub-pixel form equals."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from stylegan_tpu.ops import linear as jlinear
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.ops.linear import (_fused_upscale_conv,
                                       _subpixel_upscale_conv,
                                       _transposed_upscale_conv)
from stylegan_torch.ops.primitives import to_nchw, to_nhwc
from stylegan_torch.serving import (export_generator, load_exported,
                                    make_serving_fn)
from stylegan_torch.tools.replay_probe import _TwiceMode

OUT = 8                          # output channels
SHAPES = [(c, h) for c in (1, 3, 16) for h in (64, 128)]
IDS = [f"C{c}-H{h}" for c, h in SHAPES]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, h, dtype, seed=0):
    """x (2, H, H+2, C) NHWC (not square, so that H and W cannot swap) and
    w (OUT, C, 3, 3), from numpy."""
    rs = np.random.RandomState(seed + 10 * c + h)
    x = torch.from_numpy(rs.randn(2, h, h + 2, c)).to(dtype).contiguous()
    w = torch.from_numpy(rs.randn(OUT, c, 3, 3) / (3 * c ** 0.5)).to(dtype)
    return x, w


def _transposed(x, w):
    """The form it replaces: F.conv_transpose2d on the 4-tap-summed kernel,
    laid out (in, out, kh, kw)."""
    wp = F.pad(w, (1, 1, 1, 1))
    w4 = (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:]
          + wp[:, :, 1:, :-1] + wp[:, :, :-1, :-1])
    return to_nhwc(F.conv_transpose2d(to_nchw(x), w4.transpose(0, 1), None,
                                      2, 1))


@pytest.mark.parametrize("c,h", SHAPES, ids=IDS)
def test_subpixel_equals_transposed_float64(c, h):
    x, w = _inputs(c, h, torch.float64)
    got, want = _subpixel_upscale_conv(x, w), _transposed(x, w)
    assert got.shape == (2, 2 * h, 2 * (h + 2), OUT) and got.is_contiguous()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("c,h", SHAPES, ids=IDS)
def test_subpixel_equals_transposed_float32(c, h):
    x, w = _inputs(c, h, torch.float32)
    torch.testing.assert_close(_subpixel_upscale_conv(x, w),
                               _transposed(x, w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c,h", SHAPES, ids=IDS)
def test_subpixel_matches_jax(c, h):
    """JAX's input-dilated form (HWIO weights) on the same numbers."""
    x, w = _inputs(c, h, torch.float32, seed=1)
    want = np.asarray(jlinear._fused_upscale_conv(
        jnp.asarray(x.numpy()), jnp.asarray(w.permute(2, 3, 1, 0).numpy())))
    np.testing.assert_allclose(_subpixel_upscale_conv(x, w).numpy(), want,
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("c,h", SHAPES, ids=IDS)
def test_subpixel_gradients_equal_transposed(c, h):
    """d/dx and d/dw of <y, g> through the sub-pixel form (its `conv`
    gradients: convolutions) and through autograd of the transposed conv,
    in float64."""
    x, w = _inputs(c, h, torch.float64, seed=2)
    g = torch.from_numpy(np.random.RandomState(h + c).randn(
        2, 2 * h, 2 * (h + 2), OUT))
    grads = []
    for fn in (_subpixel_upscale_conv, _transposed):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(xr, wr) * g).sum(), (xr, wr)))
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("c,h", SHAPES[:2], ids=IDS[:2])
def test_fused_upscale_takes_subpixel_without_grad(c, h):
    """No gradient to record: the sub-pixel form, bitwise; under autograd:
    the transposed conv, bitwise (and its gradient flows)."""
    x, w = _inputs(c, h, torch.float32, seed=3)
    with torch.no_grad():
        assert torch.equal(_fused_upscale_conv(x, w),
                           _subpixel_upscale_conv(x, w))
    xr = x.clone().requires_grad_(True)
    y = _fused_upscale_conv(xr, w)
    assert torch.equal(y.detach(), _transposed_upscale_conv(x, w))
    y.sum().backward()
    assert xr.grad is not None


def test_subpixel_copies_nothing_to_the_device():
    """Only slices, views and tensor ops: no index list or constant that a
    call on the card would copy from the host (a synchronizing copy, which
    the trainer's fetch=False steps must not make)."""
    x, w = _inputs(3, 64, torch.float32)
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))
    with Record(), torch.no_grad():
        _subpixel_upscale_conv(x, w)
    assert seen and not [f for f in seen if "index" in f or "lift" in f
                         or "_to_copy" in f]


def _depth5_generator():
    cfg = tcfg.GeneratorConfig(
        resolution=128, latent_size=16, dlatent_size=16, truncation_psi=-1.0,
        mapping=tcfg.MappingConfig(latent_size=16, dlatent_size=16,
                                   mapping_fmaps=16, mapping_layers=2,
                                   dlatent_broadcast=12),
        synthesis=tcfg.SynthesisConfig(resolution=128, dlatent_size=16,
                                       fmap_base=64, fmap_max=16,
                                       blur_filter=(1, 2, 1)))
    gen = Generator(cfg, generator=torch.Generator().manual_seed(0))
    return cfg, gen.requires_grad_(False)


def test_export_holds_no_transposed_convolution():
    """A depth-5 (128^2) export runs the fused upscale from 64^2: its
    no-grad graph holds only forward convolutions, the 2x2 sub-pixel one
    among them, and its output is the live generator's."""
    cfg, gen = _depth5_generator()
    serve = load_exported(export_generator(cfg, gen, depth=5, batch_size=2),
                          device="cpu")
    ops = [n for n in serve.exported.graph.nodes if n.op == "call_function"]
    aten = torch.ops.aten
    assert not [n for n in ops if n.target in (
        aten.conv_transpose2d.input, aten.conv_transpose1d.default,
        aten.conv_transpose3d.input)]
    assert not [n for n in ops if n.target is aten.convolution.default
                and n.args[6]]                      # args[6]: transposed
    convs = [n for n in ops if n.target is aten.conv2d.default]
    kernels = {tuple(n.args[1].meta["val"].shape[2:]) for n in convs}
    assert (2, 2) in kernels
    z = torch.from_numpy(np.random.RandomState(3).randn(2, 16)).float()
    out = serve(z, 4)
    assert out.shape == (2, 128, 128, 3)
    assert torch.equal(out, make_serving_fn(cfg, gen, depth=5,
                                            device="cpu")(z, 4))


def test_twice_mode_finds_a_cpu_forward_replayable():
    """The replay probe's dispatch mode runs each operator twice on the
    same inputs: on the CPU every one agrees with itself, the sub-pixel
    convolution included."""
    _, gen = _depth5_generator()
    mode = _TwiceMode()
    with mode, torch.inference_mode():
        gen(torch.zeros(2, 16), depth=5, alpha=1.0, seed=0)
    assert mode.ops > 100 and mode.differ == []
