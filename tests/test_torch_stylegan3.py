"""StyleGAN3-T on the port's serving path, held to the plain reference
(plainref/stylegan3.py) on seeded random weights at 64^2 (channel_base
2048, channel_max 64, the published schedule's formulas, batch 2) on the
CPU: the whole generator, the Fourier-feature input, one layer of each
(up, down) kind, the per-sample kernels, the filtered leaky ReLU's CPU op
against the reference's chain at each factor pair and at negative padding,
and the filter design against scipy's.  Two faults (the padding shifted by
a sample, the down filter's taps reversed) fail the comparison.  Besides:
the published layer table and parameter count, the benchmark's copy of the
reference and its frozen counts and readers, the serving entry points and
the refusals of what does not support StyleGAN3.

The tests marked ``card`` hold the filtered leaky ReLU kernel to its plain
version in float64 on an NVIDIA GPU and skip without one.  The file
imports no JAX, so they run without tests/conftest.py:
``python -m pytest tests/test_torch_stylegan3.py -q -m card --noconftest``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from plainref import stylegan3 as plain
from stylegan_torch.config import get_default_cfg
from stylegan_torch.models import Generator, generator_config_from_cfg
from stylegan_torch.models import synthesis3
from stylegan_torch.models.configs import SYNTHESIS3_KEYS
from stylegan_torch.ops import modconv
from stylegan_torch.ops.kernels import filtered_lrelu as fl
from stylegan_torch.utils.profiling import counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, BASE, CMAX, BATCH = 64, 2048, 64, 2
# the reference's StyleGAN3-T arguments, at this test's widths
SYNTH = {"channel_base": BASE, "channel_max": CMAX, "conv_kernel": 3,
         "num_layers": 14, "num_critical": 2, "margin_size": 10,
         "first_cutoff": 2.0, "first_stopband": 2 ** 2.1,
         "last_stopband_rel": 2 ** 0.3, "filter_size": 6,
         "lrelu_upsampling": 2, "output_scale": 0.25, "conv_clamp": 256.0}
ARCH = {"resolution": RES, "latent_size": 512, "dlatent_size": 512,
        "mapping_layers": 2, "mapping_lrmul": 0.01, "num_channels": 3,
        **SYNTH}
# the port's float32 parity bars at op level; the whole generator's images
# at the same relative bar over their largest magnitude
ATOL, RTOL = 1e-5, 1e-4
# the kernel on the card against its plain version in float64: the widest
# gap over the plain version's largest magnitude (chip_smoke.py's)
SG3_OP_TOL = 1e-5
DEPTH = RES.bit_length() - 3


def _cfg(res=RES, **gen):
    c = get_default_cfg()
    c.merge_from_other_cfg({"dataset": {"resolution": res}, "model": {
        "gen": {"architecture": "stylegan3", "mapping_layers": 2,
                "truncation_psi": -1.0, "channel_base": BASE,
                "channel_max": CMAX, **gen}}})
    return c


def _weights(gen, seed=1):
    """The port's init, with what it starts at zero or one drawn: the
    input's transform affine (so that each sample rotates and translates),
    the biases, and each layer's magnitude_ema in [0.5, 2)."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: v.clone() for k, v in gen.state_dict().items()}
    for k, v in sd.items():
        if k.endswith("input.affine.weight"):
            v.copy_(torch.randn(v.shape, generator=g) * 0.2)
        elif k.endswith("affine.bias") and "input" not in k:
            v.add_(torch.randn(v.shape, generator=g) * 0.2)
        elif k.endswith(".bias") and "affine" not in k:
            v.copy_(torch.randn(v.shape, generator=g) * 0.2)
        elif k.endswith("magnitude_ema"):
            v.copy_(0.5 + 1.5 * torch.rand((), generator=g))
    return sd


@pytest.fixture(scope="module")
def model():
    gen = Generator(generator_config_from_cfg(_cfg()),
                    generator=torch.Generator().manual_seed(0))
    p = _weights(gen)
    gen.load_state_dict(p, strict=True)
    return gen.eval(), p


def _z(seed, b=BATCH):
    return torch.randn(b, 512, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("zseed", [2, 2 ** 40 + 3])
def test_generator_matches_the_reference(model, zseed):
    gen, p = model
    z = _z(zseed)
    with torch.no_grad():
        got = gen(z, depth=DEPTH, seed=zseed).images
    ref = plain.generator(p, ARCH, z)
    assert got.shape == (BATCH, RES, RES, 3)
    torch.testing.assert_close(got, ref, rtol=RTOL,
                               atol=ATOL * float(ref.abs().max()))


def test_state_dict_is_the_reference_layout(model):
    gen, _ = model
    got = {k: tuple(v.shape) for k, v in gen.state_dict().items()}
    assert got == plain.shapes(ARCH)


# the published network's layers (arXiv:2106.12423's stylegan3-t at 1024^2):
# output side, output channels, up, down, up taps
PUBLISHED = [(36, 512, 2, 2, 12), (36, 512, 2, 2, 12), (52, 512, 4, 2, 24),
             (52, 512, 2, 2, 12), (84, 512, 4, 2, 24), (148, 512, 4, 2, 24),
             (148, 512, 2, 2, 12), (276, 323, 4, 2, 24),
             (276, 203, 2, 2, 12), (532, 128, 4, 2, 24),
             (1044, 81, 4, 2, 24), (1044, 51, 2, 2, 12),
             (1044, 32, 2, 2, 12), (1024, 32, 2, 2, 12), (1024, 3, 1, 1, 1)]


def test_the_yaml_gives_the_published_layer_table():
    c = get_default_cfg()
    c.merge_from_file(os.path.join(REPO, "configs", "torch",
                                   "sample_ffhq_1024_stylegan3t.yaml"))
    gen_cfg = generator_config_from_cfg(c)
    assert gen_cfg.architecture == "stylegan3"
    assert gen_cfg.mapping.dlatent_broadcast == 16
    inp, specs = synthesis3.schedule(gen_cfg.synthesis)
    assert (inp.channels, inp.size, inp.sampling_rate) == (512, 36, 16.0)
    got = [(s.out_size, s.out_channels, s.up, s.down,
            1 if s.up_filter is None else len(s.up_filter)) for s in specs]
    assert got == PUBLISHED
    assert all(s.down_filter is None if s.is_torgb
               else len(s.down_filter) == 12 for s in specs)
    assert [(s.pad_lo, s.pad_hi) for s in specs] == \
        [(9, 8), (9, 8), (-6, -9), (9, 8), (-6, -9), (-6, -9), (9, 8),
         (-6, -9), (9, 8), (-6, -9), (-6, -9), (9, 8), (9, 8), (-11, -12),
         (0, 0)]
    with torch.device("meta"):
        gen = Generator(gen_cfg)
    assert sum(t.numel() for t in gen.parameters()) == 22_313_167
    _, layers = plain.schedule(dict(ARCH, resolution=1024,
                                    channel_base=32768, channel_max=512))
    assert [(lay["out_size"], lay["cout"], lay["up"], lay["down"],
             1 if lay["fu"] is None else lay["fu"].numel())
            for lay in layers] == PUBLISHED


@pytest.mark.parametrize("layer", range(15))
def test_filter_design_equals_scipys(layer):
    """The numpy design (the port's and the reference's) against
    scipy.signal.firwin at the published network's filters."""
    signal = pytest.importorskip("scipy.signal")
    cfg = generator_config_from_cfg(_cfg(res=1024, channel_base=32768,
                                         channel_max=512)).synthesis
    n, res = SYNTH["num_layers"], cfg.resolution
    e = np.minimum(np.arange(n + 1) / (n - SYNTH["num_critical"]), 1)
    first, first_stop = SYNTH["first_cutoff"], SYNTH["first_stopband"]
    cut = first * (res / 2 / first) ** e
    stop = first_stop * (res / 2 * SYNTH["last_stopband_rel"]
                         / first_stop) ** e
    rate = np.exp2(np.ceil(np.log2(np.minimum(stop * 2, res))))
    hw = np.maximum(stop, rate / 2) - cut
    spec = synthesis3.schedule(cfg)[1][layer]
    _, layers = plain.schedule(dict(ARCH, resolution=1024,
                                    channel_base=32768, channel_max=512))
    p = max(layer - 1, 0)
    tmp = max(rate[p], rate[layer]) * (1 if spec.is_torgb else 2)
    for f, ref_f, taps, i in ((spec.up_filter, layers[layer]["fu"],
                               6 * spec.up, p),
                              (spec.down_filter, layers[layer]["fd"],
                               6 * spec.down, layer)):
        if spec.is_torgb:
            assert f is None and ref_f is None
            continue
        want = signal.firwin(numtaps=taps, cutoff=cut[i], width=hw[i] * 2,
                             fs=tmp)
        np.testing.assert_allclose(f, want, rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(ref_f.numpy(), want.astype(np.float32))


def test_the_input_matches_the_reference(model):
    gen, p = model
    w = torch.randn(BATCH, 512, generator=torch.Generator().manual_seed(4))
    spec, _ = plain.schedule(ARCH)
    with torch.no_grad():
        got = gen.g_synthesis.input(w)
    ref = plain.synthesis_input(p, ARCH, w, spec)
    assert got.shape == (BATCH, 64, 36, 36) and got.is_contiguous()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    # every sample its own rotation and translation
    assert not torch.allclose(got[0], got[1], atol=1e-2)


def _layer_kind(kind):
    """The first layer of the small network whose (up, down) is `kind`."""
    specs = synthesis3.schedule(generator_config_from_cfg(_cfg()).synthesis)[1]
    return next(i for i, s in enumerate(specs) if (s.up, s.down) == kind)


@pytest.mark.parametrize("kind", [(2, 2), (4, 2), (1, 1)],
                         ids=["up2_down2", "up4_down2", "torgb"])
def test_a_layer_of_each_kind_matches_the_reference(model, kind):
    gen, p = model
    i = _layer_kind(kind)
    m = gen.g_synthesis.layers[i]
    g = torch.Generator().manual_seed(10 + i)
    x = torch.randn(BATCH, m.spec.in_channels, m.spec.in_size,
                    m.spec.in_size, generator=g)
    w = torch.randn(BATCH, 512, generator=g)
    with torch.no_grad():
        got = m(x, m.kernels(w))
    _, layers = plain.schedule(ARCH)
    ref = plain.synthesis_layer(p, ARCH, i, layers[i], x, w)
    assert got.shape == (BATCH, m.spec.out_channels, m.spec.out_size,
                         m.spec.out_size)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("demodulate", [True, False],
                         ids=["demod", "torgb"])
def test_the_per_sample_kernels_are_the_published_form(demodulate):
    """`modulate_weight3` with `modulated_conv2d(padding=k - 1)` against
    the published modulated_conv2d (the full sum of squares)."""
    g = torch.Generator().manual_seed(6)
    w = torch.randn(24, 16, 3, 3, generator=g)
    s = torch.randn(BATCH, 16, generator=g) + 1
    gain = torch.tensor(0.7)
    x = torch.randn(BATCH, 16, 9, 9, generator=g)
    ww = modconv.modulate_weight3(w, s, gain, demodulate=demodulate)
    got = modconv.modulated_conv2d(x, ww, padding=2)
    ref = plain.modulated_conv2d(x, w, s, demodulate=demodulate, padding=2,
                                 input_gain=gain)
    assert got.shape == (BATCH, 24, 11, 11)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def _flrelu_inputs(b, c, h, up, seed, symmetric=False, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, c, h, h + 3, generator=g, device=device)
    if symmetric:
        fu = torch.rand(3 * up, generator=g, device=device)
        fd = torch.rand(6, generator=g, device=device)
        fu, fd = torch.cat([fu, fu.flip(0)]), torch.cat([fd, fd.flip(0)])
    else:
        fu = torch.rand(6 * up, generator=g, device=device)
        fd = torch.rand(12, generator=g, device=device)
    return x, fu / fu.sum(), fd / fd.sum(), \
        torch.randn(c, generator=g, device=device)


# (b, c, h, up, pad_lo, pad_hi): each factor pair of the network, its
# paddings (the negative ones crop), and off the path
FLRELU_CASES = [(2, 3, 13, 2, 9, 8), (1, 5, 20, 4, -6, -9),
                (3, 2, 30, 2, -11, -12), (1, 1, 9, 4, 20, 1),
                (2, 4, 16, 2, 0, 0), (1, 3, 11, 4, 3, -2)]


@pytest.mark.parametrize("b,c,h,up,lo,hi", FLRELU_CASES)
def test_the_filtered_lrelu_op_is_the_reference_chain(b, c, h, up, lo, hi):
    """The op's CPU implementation and the wrapper against the reference's
    bias, upfirdn2d, bias_act, upfirdn2d on asymmetric filters, with the
    wrapper's call counted and no kernel launched."""
    x, fu, fd, bias = _flrelu_inputs(b, c, h, up, seed=h)
    ref = plain.filtered_lrelu(x, fu, fd, bias, up, 2, (lo, hi), 1.3, 0.15,
                               2.0)
    got = torch.ops.stylegan_torch.filtered_lrelu(x, fu, fd, bias, up, 2, lo,
                                                  hi, 1.3, 0.15, 2.0)
    assert got.shape == ref.shape == (b, c, fl.output_size(
        h, up, 2, lo, hi, 6 * up, 12), fl.output_size(h + 3, up, 2, lo, hi,
                                                       6 * up, 12))
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    names = ("filtered_lrelu.launches", "filtered_lrelu.cuda_launches")
    before = [counters[k] for k in names]
    with torch.no_grad():
        wrapped = fl.filtered_lrelu(x, fu, fd, bias, up=up, down=2,
                                    padding=(lo, hi), gain=1.3, slope=0.15,
                                    clamp=2.0)
    assert torch.equal(wrapped, got)
    assert [counters[k] - n for k, n in zip(names, before)] == [1, 0]


def test_a_shifted_padding_fails_the_comparison():
    x, fu, fd, bias = _flrelu_inputs(2, 3, 16, 2, seed=3, symmetric=True)
    ref = plain.filtered_lrelu(x, fu, fd, bias, 2, 2, (9, 8), 1.4, 0.2, 256.)
    got = torch.ops.stylegan_torch.filtered_lrelu(x, fu, fd, bias, 2, 2, 10,
                                                  7, 1.4, 0.2, 256.)
    assert got.shape == ref.shape
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def test_reversed_down_taps_fail_the_comparison():
    x, fu, fd, bias = _flrelu_inputs(2, 3, 16, 4, seed=5)
    ref = plain.filtered_lrelu(x, fu, fd, bias, 4, 2, (-6, -9), 1.4, 0.2,
                               256.)
    got = torch.ops.stylegan_torch.filtered_lrelu(
        x, fu, fd.flip(0).contiguous(), bias, 4, 2, -6, -9, 1.4, 0.2, 256.)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def test_the_op_checks_its_inputs_and_has_a_fake():
    x, fu, fd, bias = _flrelu_inputs(2, 3, 16, 2, seed=7)
    with FakeTensorMode() as mode:
        out = torch.ops.stylegan_torch.filtered_lrelu(
            *(mode.from_tensor(t) for t in (x, fu, fd, bias)), 2, 2, 9, 8,
            1.4, 0.2, 256.)
        assert out.shape == (2, 3, 14, 17)
    for bad in ((x, fu, fd, bias, 3, 2), (x, fu, fd, bias, 2, 1),
                (x, fu[:-1], fd, bias, 2, 2), (x, fu, fd, bias[:-1], 2, 2),
                (x.double(), fu, fd, bias, 2, 2)):
        with pytest.raises(ValueError):
            fl.check_inputs(*bad, 9, 8)


def test_the_cpu_path_is_differentiable():
    x, fu, fd, bias = _flrelu_inputs(1, 2, 12, 2, seed=8)
    xg = x.clone().requires_grad_(True)
    out = fl.filtered_lrelu(xg, fu, fd, bias, up=2, down=2, padding=(9, 8),
                            gain=1.4, slope=0.2, clamp=256.)
    out.sum().backward()
    assert xg.grad is not None and xg.grad.shape == x.shape


def test_counters_and_no_noise(model):
    """15 layers a forward call the wrapper, 14 of them with filters; no
    kernel launch on the CPU; StyleGAN3 draws no noise, so the seed does
    not change the images."""
    gen, _ = model
    names = ("filtered_lrelu.launches", "filtered_lrelu.cuda_launches")
    before = [counters[k] for k in names]
    z = _z(3)
    with torch.no_grad():
        a = gen(z, depth=DEPTH, seed=1).images
        b = gen(z, depth=DEPTH, seed=2).images
    assert [counters[k] - n for k, n in zip(names, before)] == [30, 0]
    assert torch.equal(a, b)
    from stylegan_torch.serving import _noise_layers
    assert _noise_layers(gen.cfg, DEPTH) == 0


def test_serving_is_deterministic_and_exports(model):
    from stylegan_torch.serving import (export_generator, load_exported,
                                        make_serving_fn)
    gen, _ = model
    serve = make_serving_fn(gen.cfg, gen, depth=DEPTH, device="cpu")
    z = _z(5)
    a, b = serve(z, 5), serve(z, 6)
    assert torch.equal(a, b) and a.shape == (BATCH, RES, RES, 3)
    blob = export_generator(gen.cfg, gen, depth=DEPTH, batch_size=BATCH,
                            platforms=("cpu",))
    exported = load_exported(blob, device="cpu")
    assert torch.equal(exported(z, 5), a)
    targets = [n.target for n in exported.exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.stylegan_torch.filtered_lrelu.default) \
        == 14
    with pytest.raises(ValueError, match="full resolution only"):
        gen(z, depth=DEPTH - 1)


def test_generate_samples_cli(tmp_path, model):
    from stylegan_torch.cli import generate_samples
    _, p = model
    yaml = tmp_path / "sg3.yaml"
    yaml.write_text(
        f"dataset: {{resolution: {RES}}}\n"
        "model:\n  gen: {architecture: 'stylegan3', mapping_layers: 2, "
        f"channel_base: {BASE}, channel_max: {CMAX}, "
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


def test_the_trainer_refuses_stylegan3():
    from stylegan_torch.train.trainer import StyleGAN
    g_args = {"architecture": "stylegan3", "channel_base": BASE,
              "channel_max": CMAX, "mapping_layers": 2}
    with pytest.raises(ValueError, match="trains architecture 'stylegan1' "
                       "only, got 'stylegan3'"):
        StyleGAN("fixed", RES, 3, 512, g_args, {}, {}, {}, loss="logistic",
                 device="cpu")


def test_spatial_export_and_serving_refuse_stylegan3(model):
    from stylegan_torch.parallel.mesh import Mesh
    from stylegan_torch.parallel.spatial import build_spatial_sample_fn
    from stylegan_torch.serving import export_generator
    gen, _ = model
    with pytest.raises(ValueError, match="does not support architecture "
                       "'stylegan3'"):
        export_generator(gen.cfg, gen, depth=DEPTH, batch_size=BATCH,
                         platforms=("cpu",), spatial_devices=2)
    with pytest.raises(ValueError, match="does not support architecture "
                       "'stylegan3'"):
        build_spatial_sample_fn(gen.cfg, gen, Mesh.__new__(Mesh),
                                depth=DEPTH)
    conditional = _cfg()
    conditional.merge_from_other_cfg({"conditional": True, "n_classes": 4})
    with pytest.raises(ValueError, match="no conditional"):
        generator_config_from_cfg(conditional)


# -- the benchmark's pieces ------------------------------------------------

def _config():
    return json.loads(open(os.path.join(
        REPO, "gpubench", "configs", "stylegan3t-ffhq1024-f32.json")).read())


def test_the_benchmark_copy_of_the_reference_is_plainref(model):
    from gpubench.reference import nets3
    _, p = model
    assert nets3.shapes(ARCH) == plain.shapes(ARCH)
    z = _z(12)
    with torch.no_grad(), plain.full_float32():
        a = nets3.generator(p, ARCH, z)
    assert torch.equal(a, plain.generator(p, ARCH, z))
    arch = _config()["architecture"]
    assert nets3.shapes(arch) == {
        k: tuple(v) for k, v in plain.shapes(arch).items()}


def test_the_benchmark_config_is_the_yaml():
    c = get_default_cfg()
    c.merge_from_other_cfg(_config()["overlay"])
    mine = generator_config_from_cfg(c)
    y = get_default_cfg()
    y.merge_from_file(os.path.join(REPO, "configs", "torch",
                                   "sample_ffhq_1024_stylegan3t.yaml"))
    assert mine == generator_config_from_cfg(y)
    arch = _config()["architecture"]
    assert {k: getattr(mine.synthesis, k) for k in SYNTHESIS3_KEYS} == \
        {k: arch[k] for k in SYNTHESIS3_KEYS} == \
        {"channel_base": 32768, "channel_max": 512}
    fixed = {k: getattr(synthesis3, k.upper()) for k in SYNTH
             if k not in SYNTHESIS3_KEYS}
    assert fixed == {k: arch[k] for k in fixed} == \
        {k: SYNTH[k] for k in fixed}
    assert arch["num_ws"] == mine.synthesis.num_ws == 16


def test_the_benchmark_counts_equal_the_programs():
    """counts3's filtered calls equal the kernel module's own FLOPs and
    bytes at the 14 filtered layers of a batch-8 1024^2 forward, and its
    convolution FLOPs the published widths' 570.45 GFLOP an image."""
    from gpubench import counts3
    arch = _config()["architecture"]
    cfg = generator_config_from_cfg(_cfg(res=1024, channel_base=32768,
                                         channel_max=512)).synthesis
    specs = [s for s in synthesis3.schedule(cfg)[1] if not s.is_torgb]
    calls = counts3.filtered_lrelu_calls(arch, 8)
    assert len(calls) == len(specs) == 14
    for (f, b), s in zip(calls, specs):
        x = torch.empty((8, s.out_channels, s.in_size + 2, s.in_size + 2),
                        device="meta")
        assert f == fl.flops(x, s.up, s.down, s.pad_lo, s.pad_hi,
                             len(s.up_filter), len(s.down_filter))
        assert b == fl.bytes_moved(x, s.out_size, s.out_size)
    total, conv = counts3.serve_image(arch)
    assert round(conv / 1e9, 2) == 570.45 and round(total / 1e9, 2) == 571.13
    one = counts3.filtered_lrelu_calls(arch, 1)
    assert round(sum(f for f, _ in one) / 1e9, 2) == 44.63
    assert round(sum(b for _, b in one) / 1e9, 3) == 2.084


def test_the_roofline_reads_the_kernels_of_the_trace(tmp_path):
    """`filtered_lrelu_roofline.serve3`: the bound of the forward's filtered
    calls at the stretch's batch over the summed `filtered_lrelu_kernel*`
    kernels of the device stretch's trace; nothing where no such kernel ran
    (a tree without the kernel) or no trace was kept."""
    from gpubench import cells, counts3, drive
    cell = cells.load_cell("stylegan3t-ffhq1024-f32.serve3-b8")
    arch = cell.config["architecture"]
    reader = cells.module(cells.BENCH / "metrics"
                          / "filtered_lrelu_roofline.serve3.py")

    def kernel(name, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": dur}
    events = [kernel("void (anonymous namespace)::filtered_lrelu_kernel<2>"
                     "(float const*)", 20000.0),
              kernel("void (anonymous namespace)::filtered_lrelu_kernel<4>"
                     "(float const*)", 10000.0),
              kernel("stylegan_torch::filtered_lrelu", 9000.0, "cpu_op"),
              kernel("sm80_xmma_fprop_implicit_gemm_f32", 7000.0)]
    path = tmp_path / "cell.device.json"
    path.write_text(json.dumps({"traceEvents": events}))
    run = drive.Run(entry="serve", config=cell.config,
                    unit_flops=[tuple(8 * f for f in
                                      counts3.serve_image(arch))] * 6,
                    trace={"traced": (2, 6), "units": 2},
                    peaks={"float32": 67e12, "hbm": 3.35e12})
    run.span_trace = path
    bound = sum(max(f / 67e12, b / 3.35e12)
                for f, b in counts3.filtered_lrelu_calls(arch, 8))
    assert reader.read(run) == pytest.approx(100.0 * 2 * bound / 30e-3,
                                             rel=1e-12)
    path.write_text(json.dumps({"traceEvents": events[2:]}))
    assert reader.read(run) is None
    run.span_trace = tmp_path / "absent.json"
    assert reader.read(run) is None


def test_the_modulation_reader_reads_the_stylegan3_forward(tmp_path, model):
    """`modulate_ms.serve2`, the reader this cell shares with StyleGAN2's:
    the port's StyleGAN3 forward records one `g.modulate` span a request,
    a device op launched inside it counts to it, one launched after it
    does not; nothing without the spans or the trace."""
    from gpubench import cells, drive
    from stylegan_torch.utils.profiling import recording, span
    gen, _ = model
    cell = cells.load_cell("stylegan3t-ffhq1024-f32.serve3-b8")
    reader = cells.module(cells.BENCH / "metrics" / "modulate_ms.serve2.py")
    with recording() as rec, torch.no_grad():
        with span("serve.request"):
            gen(_z(2), depth=DEPTH)
    mod = [sp for sp in rec.spans if sp[0] == "g.modulate"]
    assert len(mod) == 1
    base, (a, b) = mod[0][4] - 10 ** 6, mod[0][4:6]

    def launched(corr, t_ns, dur_ns):
        """A launch at `t_ns` (on CUPTI's thread id, as a device-only trace
        names it) and its kernel, `dur_ns` long, starting there."""
        ts, args = (t_ns - base) / 1e3, {"correlation": corr}
        return [{"ph": "X", "cat": "cuda_runtime", "name": "launch",
                 "tid": 900, "ts": ts, "dur": 0.5, "args": args},
                {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7,
                 "ts": ts, "dur": dur_ns / 1e3, "args": args}]
    inside = (b - a) // 2
    doc = {"baseTimeNanoseconds": base,
           "traceEvents": launched(1, a + inside // 4, inside)
           + launched(2, b + inside, 5000)}
    path = tmp_path / "cell.device.json"
    path.write_text(json.dumps(doc))
    run = drive.Run(entry="serve", config=cell.config, unit_flops=[],
                    trace={"traced": (0, 1), "units": 1}, peaks={})
    run.span_record, run.span_trace = rec.spans, path
    assert reader.read(run) == pytest.approx(inside / 1e6, rel=1e-9)
    run.span_record = []
    assert reader.read(run) is None
    run.span_record, run.span_trace = rec.spans, tmp_path / "absent.json"
    assert reader.read(run) is None


# -- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _published_specs():
    cfg = generator_config_from_cfg(_cfg(res=1024, channel_base=32768,
                                         channel_max=512)).synthesis
    return [s for s in synthesis3.schedule(cfg)[1] if not s.is_torgb]


def _held_to_float64(args):
    """The kernel's output twice (bitwise equal, two launches counted)
    against the plain version in float64, a sample at a time: the widest
    gap over the plain version's largest magnitude."""
    before = counters["filtered_lrelu.cuda_launches"]
    out = fl.filtered_lrelu_forward(*args)
    again = fl.filtered_lrelu_forward(*args)
    torch.cuda.synchronize()
    assert counters["filtered_lrelu.cuda_launches"] - before == 2
    assert torch.equal(out, again)
    gap = scale = 0.0
    for i in range(out.shape[0]):
        ref = fl._reference_filtered_lrelu(
            args[0][i:i + 1].double(), *(a.double() for a in args[1:4]),
            *args[4:])
        gap = max(gap, float((out[i:i + 1].double() - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    return gap / scale


@pytest.mark.card
@pytest.mark.parametrize("batch", [8, 1])
def test_on_the_card_the_kernel_is_its_plain_version(card, batch):
    """At the 14 filtered layers of a 1024^2 forward: bitwise repeatable,
    within SG3_OP_TOL of the plain chain in float64."""
    g = torch.Generator(device=card).manual_seed(batch)
    for s in _published_specs():
        x = torch.randn((batch, s.out_channels, s.in_size + 2,
                         s.in_size + 2), generator=g, device=card)
        args = (x, torch.as_tensor(s.up_filter, dtype=torch.float32,
                                   device=card),
                torch.as_tensor(s.down_filter, dtype=torch.float32,
                                device=card),
                torch.randn((s.out_channels,), generator=g, device=card),
                s.up, s.down, s.pad_lo, s.pad_hi, 2 ** 0.5, 0.2, 256.0)
        gap = _held_to_float64(args)
        assert gap <= SG3_OP_TOL, (s.out_size, s.out_channels, gap)


@pytest.mark.card
@pytest.mark.parametrize("b,c,h,up,lo,hi", FLRELU_CASES)
def test_on_the_card_the_kernel_takes_ragged_shapes(card, b, c, h, up, lo,
                                                    hi):
    """Each factor pair, negative and uneven paddings, non-square planes,
    asymmetric filters (which a flipped tap order would fail), a clamp that
    bites."""
    x, fu, fd, bias = _flrelu_inputs(b, c, h, up, seed=h, device=card)
    assert _held_to_float64((x, fu, fd, bias, up, 2, lo, hi, 1.3, 0.15,
                             2.0)) <= SG3_OP_TOL


@pytest.mark.card
def test_on_the_card_the_kernel_refuses_autograd(card):
    x, fu, fd, bias = _flrelu_inputs(1, 2, 12, 2, seed=8, device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        fl.filtered_lrelu(x.requires_grad_(True), fu, fd, bias, up=2,
                          down=2, padding=(9, 8), gain=1.4, slope=0.2,
                          clamp=256.)
