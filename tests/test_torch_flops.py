"""The port's analytic FLOP accounting (stylegan_torch/utils/flops.py)
against the JAX package's (stylegan_tpu/utils/flops.py): every count equal,
as integers; NVIDIA's peak table; and, in place of the JAX test's XLA
cost-analysis cross-check, torch's own FlopCounterMode over the port's
generator forward."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stylegan_tpu.utils import flops as jflops
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.utils import flops as tflops

RESOLUTIONS = [8, 16, 32, 64, 128, 256, 512, 1024]
ARCHES = {
    "default": {},
    "narrow": dict(latent_size=256, dlatent_size=256, mapping_layers=4,
                   mapping_fmaps=128, fmap_base=2048, fmap_max=256),
    "decay": dict(fmap_base=4096, fmap_decay=0.5, fmap_max=128,
                  num_channels=1),
}
D_KEYS = ("num_channels", "fmap_base", "fmap_decay", "fmap_max")


@pytest.mark.parametrize("arch", list(ARCHES))
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_counts_equal_jax(res, arch):
    kw = ARCHES[arch]
    dkw = {k: v for k, v in kw.items() if k in D_KEYS}
    assert tflops.generator_forward_flops(res, **kw) == \
        jflops.generator_forward_flops(res, **kw)
    assert tflops.discriminator_forward_flops(res, **dkw) == \
        jflops.discriminator_forward_flops(res, **dkw)
    for loss, r1 in (("logistic", True), ("logistic", False),
                     ("relativistic-hinge", True), ("hinge", True)):
        assert tflops.train_step_flops(res, loss=loss, with_r1=r1, **kw) == \
            jflops.train_step_flops(res, loss=loss, with_r1=r1, **kw)
    for interval in (1, 4, 16):
        assert tflops.lazy_r1_amortized_flops(res, interval, **kw) == \
            jflops.lazy_r1_amortized_flops(res, interval, **kw)
    nf_kw = {k: v for k, v in dkw.items() if k != "num_channels"}
    assert [tflops._nf(s, **nf_kw) for s in range(1, 11)] == \
        [jflops._nf(s, **nf_kw) for s in range(1, 11)]
    assert tflops._FUSE_THRESHOLD == jflops._FUSE_THRESHOLD


def test_generator_1024_is_the_jax_figure():
    assert tflops.generator_forward_flops(1024) == pytest.approx(64.47e9,
                                                                 rel=0.01)


@pytest.mark.parametrize("args", [(177.69, 64.47e9, 67.0),
                                  (9.41, 1160.45e9, 51.0),
                                  (100.0, 50e9, None), (0.0, 1e9, 989.4)])
def test_mfu_fields_equal_jax(args):
    assert tflops.mfu_fields(*args) == jflops.mfu_fields(*args)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (67.0, 494.7, 989.4)),
    ("NVIDIA H100 SXM5 80GB", (67.0, 494.7, 989.4)),
    ("NVIDIA H100 PCIe", (51.0, 378.0, 756.0)),
    ("NVIDIA A100-SXM4-80GB", (None, None, None)),
    ("NVIDIA H100 NVL", (None, None, None)),
])
def test_peak_table(name, peaks):
    for precision, want in zip(tflops.PRECISIONS, peaks):
        assert tflops.peak_tflops_for(name, precision) == want


def test_peak_table_refuses_an_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        tflops.peak_tflops_for("NVIDIA H100 80GB HBM3", "fp8")


def test_device_peak_reads_the_cards_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 PCIe")
    assert tflops.device_peak_tflops() == 51.0
    assert tflops.device_peak_tflops(0, "bfloat16") == 756.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tflops.device_peak_tflops() is None


@pytest.mark.parametrize("res,fmap_base,fmap_max", [
    (64, 256, 64), (64, 512, 32), (256, 256, 64), (256, 1024, 128)])
def test_generator_forward_matches_flop_counter(res, fmap_base, fmap_max):
    """torch's FlopCounterMode over the port's generator forward (float32,
    eval, full depth: 64^2 all below the fused-resample threshold, 256^2
    with fused upscale at 128^2 and 256^2) against generator_forward_flops
    with the same widths.  The counter counts matrix products and
    convolutions only, which is the analytic convention, so the bar is the
    JAX test's 0.85-1.45 tightened to what it gives: equality (measured
    ratio 1.0 at all four).  Without a gradient the fused upscale runs as a
    sub-pixel conv (ops/linear.py), which computes the transposed conv's
    sums over an (H+1) x (W+1) grid of 2x2 windows: its 32*I*O*(H+W+1)
    FLOPs over the analytic count's 32*I*O*H*W at an H x W input are added
    to the analytic count, exactly."""
    n_layers = (res.bit_length() - 2) * 2
    cfg = tcfg.GeneratorConfig(
        resolution=res, latent_size=64, dlatent_size=64, truncation_psi=-1.0,
        mapping=tcfg.MappingConfig(latent_size=64, dlatent_size=64,
                                   mapping_fmaps=64, mapping_layers=8,
                                   dlatent_broadcast=n_layers),
        synthesis=tcfg.SynthesisConfig(resolution=res, dlatent_size=64,
                                       fmap_base=fmap_base, fmap_max=fmap_max,
                                       blur_filter=(1, 2, 1),
                                       structure="linear"))
    gen = Generator(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        gen(torch.zeros(1, 64), depth=cfg.synthesis.depth - 1, alpha=1.0,
            seed=0)
    analytic = tflops.generator_forward_flops(
        res, latent_size=64, dlatent_size=64, mapping_layers=8,
        mapping_fmaps=64, fmap_base=fmap_base, fmap_max=fmap_max)
    for i, block in enumerate(gen.g_synthesis.blocks):
        h = 2 ** (i + 2)                      # the block's input side
        if 2 * h >= 128:                      # the fused upscale
            o, c = block.conv0_up.weight.shape[:2]
            analytic += 32 * c * o * (2 * h + 1)
    assert counter.get_total_flops() / analytic == 1.0, (
        counter.get_total_flops(), analytic)
