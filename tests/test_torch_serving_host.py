"""make_serving_fn's hand-off of a request's images to the host
(stylegan_torch/serving.py): on the CPU the forward's images as they are,
with no page-locked copy counted; on the card (marker ``card``) a
page-locked host tensor with the device forward's shape, dtype and
strides, bitwise equal to the forward's images copied to the host, whose
block the caching host allocator reuses once a result is dropped.

Imports no JAX, so that the card's test runs without it:
``python -m pytest tests/test_torch_serving_host.py -q -m card --noconftest``.
"""

import numpy as np
import pytest
import torch

from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.serving import make_serving_fn
from stylegan_torch.utils.profiling import counters

RES = 32
DEPTH = RES.bit_length() - 3
REQUESTS = 20
COUNTS = ("serve.host_copies", "serve.host_allocs")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cfg(fmap_base: int, fmap_max: int):
    return tcfg.GeneratorConfig(
        resolution=RES, truncation_psi=-1.0,
        mapping=tcfg.MappingConfig(mapping_layers=2,
                                   dlatent_broadcast=2 * (DEPTH + 1)),
        synthesis=tcfg.SynthesisConfig(resolution=RES, fmap_base=fmap_base,
                                       fmap_max=fmap_max,
                                       blur_filter=(1, 2, 1)))


def _generator(cfg):
    """Seeded weights, noise weights made non-zero so that the request's
    seed feeds the images (they init to zero)."""
    gen = Generator(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(1))
    return gen.requires_grad_(False)


def _z(batch, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(batch, 512)
                            .astype(np.float32))


def _counts():
    return {k: counters[k] for k in COUNTS}


@pytest.mark.parametrize("train_quirks", [False, True])
def test_on_the_cpu_serve_returns_the_forwards_images(train_quirks):
    """device='cpu': the images the forward gives, on the CPU, with its
    strides; no page-locked copy is counted."""
    gen = _generator(_cfg(fmap_base=128, fmap_max=32))
    serve = make_serving_fn(gen.cfg, gen, depth=DEPTH,
                            train_quirks=train_quirks, device="cpu")
    z = _z(2, 1)
    before = _counts()
    got = serve(z, 5)
    assert _counts() == before
    with torch.inference_mode():
        want = gen(z, depth=DEPTH, alpha=1.0, seed=5,
                   train=train_quirks).images
    assert got.device == torch.device("cpu")
    assert (got.shape, got.dtype, got.stride()) == \
        (want.shape, want.dtype, want.stride())
    assert torch.equal(got, want)


@pytest.mark.card
def test_on_the_card_serve_returns_page_locked_images_and_reuses_blocks(card):
    """On CUDA at published widths: serve's result is page-locked host
    memory with the device forward's shape, dtype and strides, bitwise the
    forward's images copied to the host; a request served twice is bitwise
    equal; over REQUESTS requests whose results are dropped every copy is
    counted and no page-locked block is created."""
    gen = _generator(_cfg(fmap_base=8192, fmap_max=512))
    serve = make_serving_fn(gen.cfg, gen, depth=DEPTH, device=card)
    z = _z(8, 1)
    before = _counts()
    got = serve(z, 5)
    assert _counts()["serve.host_copies"] == before["serve.host_copies"] + 1
    with torch.inference_mode():
        want = gen(z.to(card), depth=DEPTH, alpha=1.0, seed=5).images
    assert got.device == torch.device("cpu") and got.is_pinned()
    assert (got.shape, got.dtype, got.stride()) == \
        (want.shape, want.dtype, want.stride())
    assert torch.equal(got, want.cpu())
    assert torch.equal(serve(z, 5), got)
    del got, want
    before = _counts()
    for i in range(REQUESTS):
        serve(_z(8, 2 + i), i)
    after = _counts()
    assert after["serve.host_copies"] - before["serve.host_copies"] == \
        REQUESTS
    assert after["serve.host_allocs"] == before["serve.host_allocs"]
