"""StyleGAN2 config F on the port's serving path, held to the plain
reference (plainref/stylegan2.py) on seeded random weights at 32^2
(fmap_base 512, batch 2) on the CPU: the whole generator, each op alone
(the modulated conv with and without demodulation, the up-convolution and
its FIR, the up-convolution's op against the grouped transposed convolution,
the skip upsample, the epilogue against its equation, the up-layers'
epilogue against the FIR and the epilogue), the mapping's gain placement,
and one fault (a dropped demodulation) that the comparison catches.
Besides: the benchmark's copy of the reference and its frozen counts, the
published parameter count, the serving entry points, and the refusals of
what does not support StyleGAN2.

The tests marked ``card`` hold the CUDA kernels (the up-layers' epilogue,
the up-convolution) to their plain versions on an NVIDIA GPU and skip
without one.  The file imports no JAX, so they run
without tests/conftest.py:
``python -m pytest tests/test_torch_stylegan2.py -q -m card --noconftest``.
"""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from plainref import stylegan2 as plain
from stylegan_torch.config import get_default_cfg
from stylegan_torch.models import (Generator, GMapping, MappingConfig,
                                   generator_config_from_cfg)
from stylegan_torch.models import synthesis2
from stylegan_torch.ops import modconv
from stylegan_torch.utils.profiling import counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, FMAP_BASE, BATCH = 32, 512, 2
ARCH = {"resolution": RES, "latent_size": 512, "dlatent_size": 512,
        "mapping_layers": 8, "mapping_fmaps": 512, "mapping_lrmul": 0.01,
        "fmap_base": FMAP_BASE, "fmap_decay": 1.0, "fmap_max": 512,
        "num_channels": 3, "resample_filter": [1, 3, 3, 1]}
# the port's float32 parity bars at op level; the whole generator's images
# (17 layers deep at 1024^2, 7 here) at the same relative bar over their
# largest magnitude
ATOL, RTOL = 1e-5, 1e-4
# a kernel on the card against its plain version: the widest gap over the
# plain version's largest magnitude (chip_smoke.py's SG2_OP_TOL)
SG2_OP_TOL = 1e-5
FIR = [1, 3, 3, 1]


def _cfg(res=RES, fmap_base=FMAP_BASE, **gen):
    c = get_default_cfg()
    c.merge_from_other_cfg({"dataset": {"resolution": res}, "model": {
        "gen": {"architecture": "stylegan2", "fmap_base": fmap_base,
                "blur_filter": [1, 3, 3, 1], "mapping_layers": 8,
                "truncation_psi": -1.0, **gen}}})
    return c


def _weights(seed=1):
    """Every tensor of the layout drawn at its layer's scale (1/lrmul for
    the mapping, 1 for kernels and the constant, 0.2 for biases and noise
    strengths)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in plain.shapes(ARCH).items():
        if k.endswith("weight") and len(shape) >= 2:
            scale = 100.0 if k.startswith("g_mapping") else 1.0
        elif k.endswith("const"):
            scale = 1.0
        else:
            scale = 0.2
        out[k] = torch.randn(shape, generator=g) * scale
    return out


@pytest.fixture(scope="module")
def model():
    gen = Generator(generator_config_from_cfg(_cfg()))
    p = _weights()
    gen.load_state_dict(p, strict=True)
    return gen.eval(), p


@pytest.mark.parametrize("seed", [11, 2 ** 40 + 3])
def test_generator_matches_the_reference(model, seed):
    gen, p = model
    z = torch.randn(BATCH, 512, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = gen(z, depth=RES.bit_length() - 3, seed=seed).images
    ref = plain.generator(p, ARCH, z, seed)
    assert got.shape == (BATCH, RES, RES, 3)
    torch.testing.assert_close(got, ref, rtol=RTOL,
                               atol=ATOL * float(ref.abs().max()))


def test_state_dict_is_the_reference_layout(model):
    gen, _ = model
    got = {k: tuple(v.shape) for k, v in gen.state_dict().items()}
    assert got == plain.shapes(ARCH)


def test_config_f_has_the_published_parameter_count():
    c = get_default_cfg()
    c.merge_from_file(os.path.join(REPO, "configs", "torch",
                                   "sample_ffhq_1024_stylegan2.yaml"))
    gen_cfg = generator_config_from_cfg(c)
    assert gen_cfg.architecture == "stylegan2"
    assert gen_cfg.synthesis.fmap_base == 16384
    with torch.device("meta"):
        gen = Generator(gen_cfg)
    assert sum(t.numel() for t in gen.parameters()) == 30_370_060
    assert len(gen.g_synthesis.layers) == 17
    assert len(gen.g_synthesis.to_rgb) == 9


def _layer_inputs(seed, cin=64, cout=32, h=8):
    g = torch.Generator().manual_seed(seed)
    p = {"l.weight": torch.randn(cout, cin, 3, 3, generator=g),
         "l.affine.weight": torch.randn(cin, 512, generator=g),
         "l.affine.bias": torch.randn(cin, generator=g) * 0.2}
    x = torch.randn(BATCH, cin, h, h, generator=g)
    w = torch.randn(BATCH, 512, generator=g)
    return p, x, w


def _port_modconv(p, x, w, demodulate, up):
    from stylegan_torch.ops import EqualizedLinear
    affine = EqualizedLinear(512, x.shape[1], gain=1.0, use_wscale=True)
    affine.load_state_dict({"weight": p["l.affine.weight"],
                            "bias": p["l.affine.bias"]})
    s = modconv.modulation(affine, w)
    weight = p["l.weight"]
    d = modconv.demodulation(weight, s) if demodulate else None
    y = modconv.modulated_conv2d(x, modconv.modulate_weight(weight, s, d),
                                 up=up)
    return modconv._fir(y, modconv.fir_kernel(FIR)) if up else y


@pytest.mark.parametrize("cin,cout", [(64, 32), (16, 48)])
@pytest.mark.parametrize("up", [False, True], ids=["same", "up"])
@pytest.mark.parametrize("demodulate", [True, False],
                         ids=["demod", "no_demod"])
def test_modulated_conv_matches_the_reference(demodulate, up, cin, cout):
    p, x, w = _layer_inputs(3, cin, cout)
    got = _port_modconv(p, x, w, demodulate, up)
    ref = plain.modulated_conv(p, "l", x, w, demodulate=demodulate, up=up,
                               f=plain.fir([1, 3, 3, 1]))
    assert got.shape == ref.shape == (BATCH, cout) + ((16, 16) if up
                                                      else (8, 8))
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("up", [False, True], ids=["same", "up"])
def test_a_dropped_demodulation_fails_the_comparison(up):
    p, x, w = _layer_inputs(4)
    ref = plain.modulated_conv(p, "l", x, w, up=up,
                               f=plain.fir([1, 3, 3, 1]))
    got = _port_modconv(p, x, w, False, up)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def test_the_up_convolution_is_the_flipped_transposed_conv_and_fir():
    """The TF form written out: zeros inserted, the unflipped kernel
    correlated (the transposed conv of the flipped one), then the FIR.  The
    port splits it: the up-convolution (`modulated_conv2d` with `up`, the
    (2H+1)^2 plane) and the FIR inside the up-layers' epilogue
    (`layer_epilogue_up`, here with no noise and no bias)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 3, 5, 5, generator=g)
    k = torch.randn(4, 3, 3, 3, generator=g)
    fir = modconv.fir_kernel(FIR)
    y = modconv.modulated_conv2d(x, k[None], up=True)
    stuffed = torch.zeros(1, 3, 9, 9)
    stuffed[:, :, ::2, ::2] = x
    wide = F.conv2d(F.pad(stuffed, [2, 2, 2, 2]), k)
    assert y.shape == wide.shape == (1, 4, 11, 11)
    torch.testing.assert_close(y, wide, rtol=RTOL, atol=ATOL)
    ref = plain.upfirdn(wide, plain.fir(FIR) * 4, 1, 1, 1)
    torch.testing.assert_close(modconv._fir(y, fir), ref, rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():
        got = modconv.layer_epilogue_up(y, fir, torch.zeros(1, 1, 10, 10),
                                        torch.zeros(4), torch.zeros(()))
    torch.testing.assert_close(got, math.sqrt(2) * F.leaky_relu(ref, 0.2),
                               rtol=RTOL, atol=ATOL)


def _up_inputs(b, c, h, seed=0, device="cpu"):
    """An up-layer's epilogue inputs: y (b, c, 2h+1, 2h+1), the FIR, noise
    (b, 1, 2h, 2h), bias (c,), strength; drawn on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)
    return (draw(b, c, 2 * h + 1, 2 * h + 1),
            modconv.fir_kernel(FIR, device=device), draw(b, 1, 2 * h, 2 * h),
            draw(c), torch.tensor(-0.7, device=device))


@pytest.mark.parametrize("b,c,h", [(2, 16, 4), (1, 3, 2), (1, 7, 8),
                                   (3, 5, 1), (2, 1, 16)])
def test_epilogue_up_op_is_the_fir_then_the_epilogue(b, c, h):
    """The up-layers' op on the CPU is the plain composition, bitwise, and
    the equation written out, with no kernel launch counted; under
    autograd the wrapper is the plain composition and differentiable."""
    args = _up_inputs(b, c, h, seed=b * 100 + c)
    y, fir, noise, bias, st = args
    want = modconv._reference_epilogue2(modconv._fir(y, fir), noise, bias, st)
    before = dict(counters)
    with torch.no_grad():
        got = modconv.layer_epilogue_up(*args)
    assert got.shape == (b, c, 2 * h, 2 * h)
    assert torch.equal(got, want)
    assert torch.equal(torch.ops.stylegan_torch.epilogue2_up(*args), want)
    assert [counters[k] - before.get(k, 0) for k in (
        "epilogue2.launches", "epilogue2.up_launches",
        "epilogue2.cuda_launches")] == [1, 0, 0]
    v = plain.upfirdn(y, plain.fir(FIR) * 4, 1, 1, 1) + st * noise \
        + bias[None, :, None, None]
    torch.testing.assert_close(got, math.sqrt(2) * torch.where(v < 0, 0.2 * v,
                                                               v),
                               rtol=RTOL, atol=ATOL)
    yg = y.clone().requires_grad_(True)
    out = modconv.layer_epilogue_up(yg, fir, noise, bias, st)
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert yg.grad is not None and yg.grad.shape == y.shape


def test_epilogue_up_fake_gives_the_fir_shape():
    args = _up_inputs(2, 6, 8)
    with FakeTensorMode() as mode:
        out = torch.ops.stylegan_torch.epilogue2_up(
            *(mode.from_tensor(t) for t in args))
        assert (out.shape, out.dtype) == ((2, 6, 16, 16), torch.float32)
    meta = [t.to("meta") for t in args]
    assert torch.ops.stylegan_torch.epilogue2_up(*meta).shape == (2, 6, 16,
                                                                   16)


def test_epilogue_up_op_refuses_what_is_not_an_up_plane():
    from stylegan_torch.ops.kernels import epilogue2 as k2
    y, fir, noise, bias, st = _up_inputs(2, 4, 4)
    for bad in (y[..., :-1, :-1].contiguous(), y[..., :-1].contiguous(),
                y[..., :1, :1].contiguous(), y[..., :-2].contiguous()):
        with pytest.raises(ValueError, match="up-convolution"):
            k2.check_inputs_up(bad, fir, noise, bias, st)
        with pytest.raises(ValueError, match="up-convolution"):
            torch.ops.stylegan_torch.epilogue2_up(bad, fir, noise, bias, st)
    with pytest.raises(ValueError, match="noise"):
        k2.check_inputs_up(y, fir, noise[..., :-1, :-1].contiguous(), bias,
                           st)
    with pytest.raises(ValueError, match="fir"):
        k2.check_inputs_up(y, fir[:3], noise, bias, st)
    with pytest.raises(ValueError, match="y must be contiguous"):
        k2.check_inputs_up(y.transpose(2, 3), fir, noise, bias, st)
    with pytest.raises(ValueError, match="CUDA"):
        k2.epilogue2_up_forward(y, fir, noise, bias, st)


def _conv_up_inputs(b, cin, cout, h, w=None, seed=0, device="cpu",
                    dtype=torch.float32):
    """An up-convolution's x (b, cin, h, w) and per-sample kernels ww
    (b, cout, cin, 3, 3) at a demodulated layer's scale."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = h if w is None else w
    x = torch.randn((b, cin, h, w), generator=g, device=device)
    ww = torch.randn((b, cout, cin, 3, 3), generator=g, device=device)
    return x.to(dtype), (ww / (3 * math.sqrt(cin))).to(dtype)


def _transposed_conv_by_sample(x, ww):
    """Each sample's transposed convolution of its flipped kernel, stride 2."""
    return torch.cat([F.conv_transpose2d(x[i:i + 1], ww[i].flip(2, 3)
                                         .transpose(0, 1), stride=2)
                      for i in range(x.shape[0])])


@pytest.mark.parametrize("b,cin,cout,h,w", [
    (2, 16, 8, 4, 4), (3, 24, 40, 5, 5), (2, 72, 8, 7, 7), (1, 5, 3, 1, 1),
    (2, 9, 33, 6, 11)])
def test_up_convolution_op_is_the_grouped_transposed_conv(b, cin, cout, h, w):
    """The op's CPU path: the flipped per-sample kernels as one grouped
    transposed convolution, bitwise; each sample's transposed convolution
    in float64; no kernel launch counted."""
    x, ww = _conv_up_inputs(b, cin, cout, h, w, seed=cin + h)
    before = counters["modconv.up_launches"]
    with torch.no_grad():
        got = modconv.modulated_conv2d(x, ww, up=True)
    assert got.shape == (b, cout, 2 * h + 1, 2 * w + 1)
    wt = ww.flip(3, 4).transpose(1, 2).reshape(b * cin, cout, 3, 3)
    grouped = F.conv_transpose2d(x.reshape(1, b * cin, h, w), wt, stride=2,
                                 groups=b).reshape(got.shape)
    assert torch.equal(got, grouped)
    assert torch.equal(torch.ops.stylegan_torch.modconv_up(x, ww), grouped)
    torch.testing.assert_close(
        got.double(), _transposed_conv_by_sample(x.double(), ww.double()),
        rtol=RTOL, atol=ATOL)
    assert counters["modconv.up_launches"] == before


def test_up_convolution_fake_gives_the_transposed_shape():
    x, ww = _conv_up_inputs(2, 6, 5, 8, 3)
    with FakeTensorMode() as mode:
        out = torch.ops.stylegan_torch.modconv_up(mode.from_tensor(x),
                                                  mode.from_tensor(ww))
        assert (out.shape, out.dtype) == ((2, 5, 17, 7), torch.float32)
    assert torch.ops.stylegan_torch.modconv_up(
        x.to("meta"), ww.to("meta")).shape == (2, 5, 17, 7)


def test_up_convolution_refuses_what_the_kernel_does_not_take():
    from stylegan_torch.ops.kernels import modconv_up as mu
    x, ww = _conv_up_inputs(2, 4, 3, 5)
    bad = [((x.double(), ww), "x must be 4-D float32"),
           ((x, ww.double()), "ww must be 5-D float32"),
           ((x.transpose(2, 3), ww), "x must be contiguous"),
           ((x, ww.transpose(3, 4)), "ww must be contiguous"),
           ((x[:1].contiguous(), ww), "ww must be"),
           ((x, ww[:, :, :3].contiguous()), "ww must be"),
           ((x, ww[..., :2, :2].contiguous()), "ww must be"),
           ((x[0], ww), "x must be 4-D")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            mu.check_inputs(*args)
        with pytest.raises(ValueError, match=match):
            torch.ops.stylegan_torch.modconv_up(*args)
        with pytest.raises(ValueError, match=match):
            modconv.modulated_conv2d(*args, up=True)
    with pytest.raises(ValueError, match="CUDA"):
        mu.modconv_up_forward(x, ww)


def test_up_convolution_cpu_path_is_differentiable():
    """Under autograd on the CPU the wrapper is the plain version, with the
    gradients of the per-sample transposed convolutions."""
    x, ww = _conv_up_inputs(2, 6, 4, 5, seed=9)
    xa, wa = x.clone().requires_grad_(True), ww.clone().requires_grad_(True)
    xb, wb = x.clone().requires_grad_(True), ww.clone().requires_grad_(True)
    before = counters["modconv.up_launches"]
    got = modconv.modulated_conv2d(xa, wa, up=True)
    want = _transposed_conv_by_sample(xb, wb)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    (got * g).sum().backward()
    (want * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=RTOL, atol=ATOL)
    assert counters["modconv.up_launches"] == before


def test_a_forward_calls_the_up_convolution_op_at_each_up_layer(
        model, monkeypatch):
    """log2(res) - 2 up-convolutions a forward, each through the op, whose
    CPU kernel launches nothing."""
    gen, _ = model
    calls, op = [], modconv._up.modconv_up_op

    def counted(x, ww):
        calls.append((tuple(x.shape), tuple(ww.shape)))
        return op(x, ww)
    monkeypatch.setattr(modconv._up, "modconv_up_op", counted)
    before = counters["modconv.up_launches"]
    with torch.no_grad():
        gen(torch.randn(BATCH, 512), depth=3, seed=1)
    assert counters["modconv.up_launches"] == before
    log2 = RES.bit_length() - 1
    assert [x[-1] for x, _ in calls] == [2 ** k for k in range(2, log2)]
    assert all(w[0] == BATCH and w[3:] == (3, 3) for _, w in calls)


def test_the_export_calls_the_up_convolution_op(model):
    from stylegan_torch.serving import export_generator, load_exported
    gen, _ = model
    blob = export_generator(gen.cfg, gen, depth=3, batch_size=BATCH,
                            platforms=("cpu",))
    exported = load_exported(blob, device="cpu")
    targets = [n.target for n in exported.exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.stylegan_torch.modconv_up.default) == 3


def test_skip_upsample_matches_upfirdn():
    y = torch.randn(BATCH, 3, 8, 8, generator=torch.Generator()
                    .manual_seed(6))
    got = modconv.skip_upsample(y, modconv.fir_kernel([1, 3, 3, 1]))
    ref = plain.skip_upsample(y, plain.fir([1, 3, 3, 1]))
    assert got.shape == (BATCH, 3, 16, 16)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strength", [0.3, -1.7])
def test_epilogue_cpu_path_is_its_equation(strength):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(BATCH, 16, 8, 8, generator=g)
    noise = torch.randn(BATCH, 1, 8, 8, generator=g)
    bias = torch.randn(16, generator=g)
    st = torch.tensor(strength)
    before = dict(counters)
    got = modconv.layer_epilogue(x, noise, bias, st)
    v = x + strength * noise + bias[None, :, None, None]
    ref = math.sqrt(2) * torch.where(v < 0, 0.2 * v, v)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert counters["epilogue2.launches"] - before.get(
        "epilogue2.launches", 0) == 1
    assert counters["epilogue2.cuda_launches"] == before.get(
        "epilogue2.cuda_launches", 0)


def test_epilogue_op_checks_its_inputs():
    from stylegan_torch.ops.kernels import epilogue2 as k2
    x = torch.zeros(2, 4, 8, 8)
    with pytest.raises(ValueError, match="noise"):
        k2.check_inputs(x, torch.zeros(2, 8, 8, 1).permute(0, 3, 1, 2)[:1],
                        torch.zeros(4), torch.zeros(()))
    with pytest.raises(ValueError, match="CUDA"):
        k2.epilogue2_forward(x, torch.zeros(2, 1, 8, 8), torch.zeros(4),
                             torch.zeros(()))
    with pytest.raises(ValueError, match="x must be contiguous"):
        k2.check_inputs(x.contiguous(memory_format=torch.channels_last),
                        torch.zeros(2, 1, 8, 8), torch.zeros(4),
                        torch.zeros(()))


def test_mapping_places_the_gain_after_the_activation():
    """StyleGAN2's layer sqrt(2) * lrelu(y) against StyleGAN1's
    lrelu(sqrt(2) * y') on the same weights: equal where every bias is
    zero, not on a non-zero bias."""
    torch.manual_seed(8)
    cfgs = [MappingConfig(mapping_layers=2, gain_after_act=a)
            for a in (False, True)]
    one, two = GMapping(cfgs[0]), GMapping(cfgs[1])
    two.load_state_dict(one.state_dict())
    z = torch.randn(BATCH, 512)
    with torch.no_grad():
        torch.testing.assert_close(one(z), two(z), rtol=1e-5, atol=1e-6)
        for layer in list(one.map.values()) + list(two.map.values()):
            layer.bias.fill_(3.0)
        a, b = one(z), two(z)
    assert not torch.allclose(a, b, rtol=1e-3, atol=1e-3)
    p = {f"g_mapping.{k}": v for k, v in two.state_dict().items()}
    arch = dict(ARCH, mapping_layers=2)
    torch.testing.assert_close(b, plain.mapping(p, arch, z), rtol=RTOL,
                               atol=ATOL)


def test_counters_and_noise_layers(model, monkeypatch):
    """2 log2(res) - 3 layer epilogues a forward, log2(res) - 2 of them
    the up-layers' (17 and 8 at 1024^2); no kernel launch on the CPU."""
    gen, _ = model
    up_calls = []

    def counted(*args):
        up_calls.append(args[0].shape)
        return modconv.layer_epilogue_up(*args)
    monkeypatch.setattr(synthesis2, "layer_epilogue_up", counted)
    before = dict(counters)
    with torch.no_grad():
        gen(torch.randn(BATCH, 512), depth=3, seed=1)
    log2 = RES.bit_length() - 1
    assert [counters[k] - before.get(k, 0) for k in (
        "epilogue2.launches", "epilogue2.up_launches",
        "epilogue2.cuda_launches")] == [2 * log2 - 3, 0, 0]
    assert [s[-1] for s in up_calls] == [2 ** k + 1 for k in range(3, log2
                                                                   + 1)]
    from stylegan_torch.serving import _noise_layers
    assert _noise_layers(gen.cfg, 3) == len(gen.g_synthesis.layers) == 7
    assert [synthesis2.noise_resolution(i) for i in range(7)] == \
        [plain.noise_res(i) for i in range(7)] == [4, 8, 8, 16, 16, 32, 32]


def test_pinned_noise_is_the_seeded_draw(model):
    from stylegan_torch.models.synthesis import make_noise
    gen, _ = model
    z = torch.randn(BATCH, 512)
    noises = [make_noise(9, i, BATCH, synthesis2.noise_resolution(i), "cpu")
              for i in range(7)]
    with torch.no_grad():
        a = gen(z, depth=3, seed=9).images
        b = gen(z, depth=3, noises=noises).images
    assert torch.equal(a, b)


def test_serving_is_deterministic_and_exports(model):
    from stylegan_torch.serving import (export_generator, load_exported,
                                        make_serving_fn)
    gen, _ = model
    serve = make_serving_fn(gen.cfg, gen, depth=3, device="cpu")
    z = torch.randn(BATCH, 512)
    a, b, c = serve(z, 5), serve(z, 5), serve(z, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    blob = export_generator(gen.cfg, gen, depth=3, batch_size=BATCH,
                            platforms=("cpu",))
    exported = load_exported(blob, device="cpu")
    assert torch.equal(exported(z, 5), a)
    targets = [n.target for n in exported.exported.graph.nodes
               if n.op == "call_function"]
    ops = torch.ops.stylegan_torch
    assert (targets.count(ops.epilogue2.default),
            targets.count(ops.epilogue2_up.default)) == (4, 3)


def test_generate_samples_cli(tmp_path, model):
    from stylegan_torch.cli import generate_samples
    gen, p = model
    yaml = tmp_path / "sg2.yaml"
    yaml.write_text(
        "dataset: {resolution: 32}\n"
        "model:\n  gen: {architecture: 'stylegan2', fmap_base: 512, "
        "mapping_layers: 8, blur_filter: [1, 3, 3, 1], "
        "truncation_psi: -1.}\n")
    weights = tmp_path / "g.pth"
    torch.save(p, weights)
    out = tmp_path / "out"
    args = generate_samples.parse_arguments([
        "--config", str(yaml), "--generator_file", str(weights),
        "--num_samples", "2", "--output_dir", str(out), "--device", "cpu",
        "--seed", "3"])
    generate_samples.main(args)
    assert sorted(os.listdir(out)) == ["1.png", "2.png"]


def test_the_trainer_refuses_stylegan2():
    from stylegan_torch.train.trainer import StyleGAN
    g_args = {"architecture": "stylegan2", "fmap_base": 512,
              "blur_filter": [1, 3, 3, 1]}
    with pytest.raises(ValueError, match="trains architecture 'stylegan1' "
                       "only"):
        StyleGAN("fixed", 32, 3, 512, g_args, {}, {}, {}, loss="logistic",
                 device="cpu")


def test_spatial_export_and_serving_refuse_stylegan2(model):
    from stylegan_torch.parallel.mesh import Mesh
    from stylegan_torch.parallel.spatial import build_spatial_sample_fn
    from stylegan_torch.serving import export_generator
    gen, _ = model
    with pytest.raises(ValueError, match="does not support architecture "
                       "'stylegan2'"):
        export_generator(gen.cfg, gen, depth=3, batch_size=BATCH,
                         platforms=("cpu",), spatial_devices=2)
    with pytest.raises(ValueError, match="does not support architecture "
                       "'stylegan2'"):
        build_spatial_sample_fn(gen.cfg, gen, Mesh.__new__(Mesh), depth=3)


def test_unknown_architecture_and_wrong_filter_are_refused():
    with pytest.raises(ValueError, match="unknown architecture"):
        generator_config_from_cfg(_cfg(architecture="stylegan4"))
    with pytest.raises(ValueError, match="resample filter"):
        generator_config_from_cfg(_cfg(blur_filter=[1, 2, 1]))


def test_flops_equal_the_benchmark_counts():
    from gpubench import counts2
    from stylegan_torch.utils.flops import stylegan2_forward_flops
    config = json.loads(open(os.path.join(
        REPO, "gpubench", "configs", "stylegan2f-ffhq1024-f32.json")).read())
    arch = config["architecture"]
    assert stylegan2_forward_flops(1024) == counts2.serve_image(arch)
    for res, base in ((32, 512), (256, 4096), (1024, 16384)):
        a = dict(arch, resolution=res, fmap_base=base)
        assert stylegan2_forward_flops(res, fmap_base=base) == \
            counts2.serve_image(a)
    total, conv = counts2.serve_image(arch)
    assert round(total / 1e9, 2) == 150.67 and round(conv / 1e9, 2) == 150.66


def test_epilogue_bytes_equal_the_benchmark_counts():
    from gpubench import counts2
    from stylegan_torch.ops.kernels import epilogue2 as k2
    for b, h, c in ((8, 1024, 32), (8, 4, 512), (1, 64, 512)):
        x = torch.empty((b, c, h, h), device="meta")
        assert k2.bytes_moved(x) == counts2.epilogue2_bytes(b, h, h, c, 4)
    assert len(counts2.epilogue2_shapes(dict(ARCH, resolution=1024,
                                             fmap_base=16384))) == 17


def test_the_up_convolution_roofline_reads_the_kernels_of_the_trace(
        tmp_path):
    """The benchmark's `modconv_up_roofline.serve2`: its FLOPs are the
    kernel's own count at config F's 8 up-layers; it reads the summed
    `modconv_up_kernel*` kernels of the device stretch's trace against the
    stretch's images, and nothing where no such kernel ran (a tree without
    the kernel) or no trace was kept."""
    from gpubench import cells, counts2, drive
    from stylegan_torch.ops.kernels import modconv_up as mu
    cell = cells.load_cell("stylegan2f-ffhq1024-f32.serve2-b8")
    arch = cell.config["architecture"]
    reader = cells.module(cells.BENCH / "metrics"
                          / "modconv_up_roofline.serve2.py")
    per_image = reader.up_flops(arch)
    assert per_image == sum(
        mu.flops(torch.empty((1, cin, h, h), device="meta"),
                 torch.empty((1, cout, cin, 3, 3), device="meta"))
        for h, cin, cout in UP_CONVS_1024)
    assert round(per_image / 1e9, 2) == 45.07

    def kernel(name, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": dur}
    events = [kernel("void modconv_up_kernel<3>(float const*)", 4000.0),
              kernel("void modconv_up_kernel<1>(float const*)", 1000.0),
              kernel("stylegan_torch::modconv_up", 9000.0, "cpu_op"),
              kernel("sm80_xmma_fprop_implicit_gemm_f32", 7000.0)]
    path = tmp_path / "cell.device.json"
    path.write_text(json.dumps({"traceEvents": events}))
    run = drive.Run(entry="serve", config=cell.config,
                    unit_flops=[tuple(8 * f for f in
                                      counts2.serve_image(arch))] * 6,
                    trace={"traced": (2, 6), "units": 2},
                    peaks={"float32": 67e12})
    run.span_trace = path
    want = 100.0 * 2 * 8 * per_image / 5e-3 / 67e12
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    path.write_text(json.dumps({"traceEvents": events[2:]}))
    assert reader.read(run) is None
    run.span_trace = tmp_path / "absent.json"
    assert reader.read(run) is None


def test_the_benchmark_copy_of_the_reference_is_plainref(model):
    from gpubench.reference import nets2
    _, p = model
    assert nets2.shapes(ARCH) == plain.shapes(ARCH)
    z = torch.randn(BATCH, 512, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        a = nets2.generator(p, ARCH, z, 4)
        b = plain.generator(p, ARCH, z, 4)
    assert torch.equal(a, b)
    assert nets2.draw_noises(4, ARCH, 1, "cpu")[3].shape == (1, 1, 16, 16)



@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (output side, channels) of the 8 up-layers of a config F 1024^2 forward
UP_LAYERS_1024 = [(8, 512), (16, 512), (32, 512), (64, 512), (128, 256),
                  (256, 128), (512, 64), (1024, 32)]
# (b, c, h) of (b, c, 2h+1, 2h+1) planes off the main path, each with an
# output side not a multiple of 4 (scalar stores): fewer planes than a
# block's group, one column tile, two column tiles, a single 2x2 output
UP_RAGGED = [(3, 5, 3), (2, 3, 33), (1, 2, 65), (1, 1, 1)]


def _held_to_the_plain_version(args):
    """The kernel's output twice (bitwise equal) against the plain version
    in float64: the widest gap over the plain version's largest
    magnitude."""
    from stylegan_torch.ops.kernels import epilogue2 as k2
    names = ("epilogue2.up_launches", "epilogue2.cuda_launches")
    before = [counters[k] for k in names]
    out = k2.epilogue2_up_forward(*args)
    again = k2.epilogue2_up_forward(*args)
    torch.cuda.synchronize()
    assert [counters[k] - n for k, n in zip(names, before)] == [2, 2]
    assert torch.equal(out, again)
    ref = modconv._reference_epilogue2_up(*(t.double() for t in args))
    return float((out.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("batch", [8, 1])
def test_on_the_card_the_up_kernel_is_its_plain_version(card, batch):
    """At the 8 up-layer planes of a 1024^2 forward: bitwise repeatable,
    within SG2_OP_TOL of the FIR and the epilogue in float64."""
    for side, c in UP_LAYERS_1024:
        gap = _held_to_the_plain_version(
            _up_inputs(batch, c, side // 2, seed=side, device=card))
        assert gap <= SG2_OP_TOL, (side, c, gap)


@pytest.mark.card
@pytest.mark.parametrize("b,c,h", UP_RAGGED)
def test_on_the_card_the_up_kernel_takes_ragged_planes(card, b, c, h):
    gap = _held_to_the_plain_version(
        _up_inputs(b, c, h, seed=h, device=card))
    assert gap <= SG2_OP_TOL


# (input side, cin, cout) of the 8 up-convolutions of a config F 1024^2
# forward
UP_CONVS_1024 = [(4, 512, 512), (8, 512, 512), (16, 512, 512),
                 (32, 512, 512), (64, 512, 256), (128, 256, 128),
                 (256, 128, 64), (512, 64, 32)]
# (b, cin, cout, h, w) off the main path: cin, cout and the planes not
# multiples of the kernel's tiles, a single pixel, non-square planes
UP_CONVS_RAGGED = [(3, 24, 40, 5, 5), (2, 72, 8, 7, 7), (1, 5, 3, 1, 1),
                   (2, 9, 33, 16, 17), (1, 4, 3, 31, 33), (1, 3, 70, 2, 9)]


def _up_conv_held_to_the_plain_version(x, ww):
    """The kernel's output twice (bitwise equal, two launches counted)
    against the plain version in float64: the widest gap over the plain
    version's largest magnitude."""
    from stylegan_torch.ops.kernels import modconv_up as mu
    before = counters["modconv.up_launches"]
    out = mu.modconv_up_forward(x, ww)
    again = mu.modconv_up_forward(x, ww)
    torch.cuda.synchronize()
    assert counters["modconv.up_launches"] - before == 2
    assert torch.equal(out, again)
    ref = mu._reference_modconv_up(x.double(), ww.double())
    return float((out.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("batch", [8, 1])
def test_on_the_card_the_up_convolution_is_its_plain_version(card, batch):
    """At the 8 up-convolutions of a 1024^2 forward: bitwise repeatable,
    within SG2_OP_TOL of the grouped transposed convolution in float64."""
    for h, cin, cout in UP_CONVS_1024:
        x, ww = _conv_up_inputs(batch, cin, cout, h, seed=h, device=card)
        gap = _up_conv_held_to_the_plain_version(x, ww)
        assert gap <= SG2_OP_TOL, (h, cin, cout, gap)


@pytest.mark.card
@pytest.mark.parametrize("b,cin,cout,h,w", UP_CONVS_RAGGED)
def test_on_the_card_the_up_convolution_takes_ragged_shapes(card, b, cin,
                                                            cout, h, w):
    x, ww = _conv_up_inputs(b, cin, cout, h, w, seed=cin, device=card)
    assert _up_conv_held_to_the_plain_version(x, ww) <= SG2_OP_TOL


@pytest.mark.card
def test_on_the_card_the_up_convolution_refuses_autograd(card):
    x, ww = _conv_up_inputs(1, 4, 3, 5, device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        modconv.modulated_conv2d(x, ww.requires_grad_(True), up=True)
