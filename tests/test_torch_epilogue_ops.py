"""The epilogue kernels as torch.library ops (stylegan_torch/ops/kernels/
epilogue.py, ops/fused.py) on the CPU: each op's fake gives the real
outputs' shapes and dtypes and refuses what the launch refuses; the CPU
implementation of the inference op is the plain version, bitwise; a call
that needs no gradient goes through the op on the CPU too, so a traced
program holds its node.  The CUDA implementations launch the kernels,
which chip_smoke.py holds to the plain versions on the card."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from stylegan_torch.ops import fused
from stylegan_torch.ops.kernels import epilogue as kern

OPS = torch.ops.stylegan_torch
NEEDS = [[True, True, True, True], [True, True, False, True],
         [True, False, False, True], [False, False, False, True]]


def _inputs(shape, seed=0, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    x = torch.from_numpy((rs.randn(b, h, w, c) + 0.5).astype(np.float32))
    nw = torch.from_numpy((0.5 * rs.randn(c)).astype(np.float32))
    noise = torch.from_numpy(rs.randn(b, h, w, 1).astype(np.float32))
    style = torch.from_numpy((0.5 * rs.randn(b, 2 * c)).astype(np.float32))
    return x.to(dtype), nw, noise.to(dtype), style


def _bad_inputs():
    """What the kernels' launch refuses (test_torch_epilogue.py's cases)."""
    x, nw, noise, style = _inputs((1, 4, 4, 16))
    return {
        "bf16 style": (x, nw, noise, style.bfloat16()),
        "f64 noise": (x, nw, noise.double(), style),
        "bf16 noise_weight": (x, nw.bfloat16(), noise, style),
        "short style": (x, nw, noise, style[:, :16].contiguous()),
        "strided x": (x.permute(0, 2, 1, 3), nw, noise, style),
        "f16 x": (x.half(), nw, noise.half(), style),
        "3-d x": (x[0], nw, noise, style),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fakes_give_the_real_shapes(dtype):
    args = _inputs((2, 8, 8, 32), dtype=dtype)
    g = torch.randn(2, 8, 8, 32).to(dtype)
    with FakeTensorMode() as mode:
        fx, fnw, fn, fs = (mode.from_tensor(t) for t in args)
        out = OPS.epilogue(fx, fnw, fn, fs)
        assert (out.shape, out.dtype) == ((2, 8, 8, 32), dtype)
        out, saved = OPS.epilogue_train(fx, fnw, fn, fs)
        assert (out.shape, out.dtype) == ((2, 8, 8, 32), dtype)
        assert (saved.shape, saved.dtype) == ((2, 32, 2), torch.float32)
        fg = mode.from_tensor(g)
        for needs in NEEDS:
            grads = OPS.epilogue_backward(fg, fx, fnw, fn, fs, saved, needs)
            want = [t for t, need in zip(args, needs) if need]
            assert [(d.shape, d.dtype) for d in grads] == \
                [(t.shape, t.dtype) for t in want]


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_fakes_refuse_what_the_launch_refuses(case):
    """Each op's fake raises on the inputs _check_inputs refuses (before
    its device check), so a trace fails where the card would."""
    args = _bad_inputs()[case]
    with pytest.raises(ValueError, match="must be"):
        kern._check_inputs(*args)
    saved = torch.zeros(args[0].shape[0], args[0].shape[-1], 2)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in args]
        for op in (OPS.epilogue, OPS.epilogue_train):
            with pytest.raises(ValueError, match="must be"):
                op(*fake)
        with pytest.raises(ValueError, match="must be"):
            OPS.epilogue_backward(fake[0], *fake, mode.from_tensor(saved),
                                  [True] * 4)


def test_backward_fake_refuses_a_wrong_gradient_or_statistics():
    x, nw, noise, style = _inputs((2, 4, 4, 8))
    with FakeTensorMode() as mode:
        fx, fnw, fn, fs = (mode.from_tensor(t) for t in (x, nw, noise, style))
        saved = mode.from_tensor(torch.zeros(2, 8, 2))
        bad_g = mode.from_tensor(torch.zeros(2, 4, 4, 4))
        with pytest.raises(ValueError, match="g must be"):
            OPS.epilogue_backward(bad_g, fx, fnw, fn, fs, saved, [True] * 4)
        bad_saved = mode.from_tensor(torch.zeros(2, 8))
        with pytest.raises(ValueError, match="saved must be"):
            OPS.epilogue_backward(fx, fx, fnw, fn, fs, bad_saved, [True] * 4)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (1, 16, 16, 8),
                                   (3, 8, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cpu_op_is_the_plain_version_bitwise(shape):
    args = _inputs(shape, seed=sum(shape))
    before = fused.plain_calls
    got = OPS.epilogue(*args)
    assert fused.plain_calls == before + 1
    assert torch.equal(got, fused._reference_epilogue(*args))


def test_op_passes_torch_library_opcheck():
    """Schema, fake and CPU implementation agree (torch.library.opcheck:
    the fake against the real outputs, no aliasing, dispatch)."""
    torch.library.opcheck(OPS.epilogue.default, _inputs((2, 4, 4, 8)))


def test_inference_without_a_gradient_goes_through_the_op(monkeypatch):
    """fused_epilogue with nothing to record (no_grad, or no input that
    requires a gradient) calls the op; with a gradient to record it takes
    the create_graph-able plain autograd path, not the op."""
    calls = []
    real = fused.epilogue_op

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(fused, "epilogue_op", spy)
    args = _inputs((2, 4, 4, 8))
    fused.fused_epilogue(*args)
    with torch.no_grad():
        fused.fused_epilogue(args[0].requires_grad_(True), *args[1:])
    assert len(calls) == 2
    out = fused.fused_epilogue(*args)
    assert len(calls) == 2 and out.requires_grad


def test_traced_call_keeps_the_ops_node():
    """torch.export of a module calling fused_epilogue under no_grad holds
    one stylegan_torch::epilogue node and none of the plain composition."""
    class Epi(torch.nn.Module):
        def forward(self, x, nw, noise, style):
            return fused.fused_epilogue(x, nw, noise, style)
    with torch.no_grad():
        ep = torch.export.export(Epi(), _inputs((2, 4, 4, 8)))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets == [OPS.epilogue.default]
