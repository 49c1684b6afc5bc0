"""The port's bf16 activation path, mirroring tests/test_bf16.py on the CPU.

Op level: the port's pixel_norm, instance_norm and minibatch_stddev keep
their statistics in float32, so on a bf16 input they track the float32 op
on the same (bf16-quantized) input to output rounding (test_bf16.py's
bars), and they agree with the JAX package's bf16 op on that input to one
bf16 rounding step (2^-7 relative, with an absolute floor of 2^-7 of the
output's scale for values near 0).

Generator level (test_bf16.py's 128^2 configuration: latent 512, 4 mapping
layers, linear structure, full width): the port's bf16 forward drifts from
its float32 forward on the same z and pinned noise within JAX's bars (mean
|diff| < 0.02 and max |diff| < 0.25 of the float32 image's span), and
against the JAX package's bf16 forward on the same weights, z and noise
its mean |diff| is no larger than JAX's own bf16-vs-float32 mean drift and
its max under 0.25 of the span.  The 1024^2 drift is marked slow, as JAX
marks it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu.models import (GeneratorConfig, MappingConfig,
                                 SynthesisConfig, generator_apply,
                                 generator_init)
from stylegan_tpu.ops import instance_norm as j_instance_norm
from stylegan_tpu.ops import minibatch_stddev as j_minibatch_stddev
from stylegan_tpu.ops import pixel_norm as j_pixel_norm
from stylegan_torch.convert import (flatten_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.ops import instance_norm, minibatch_stddev, pixel_norm

ULP = 2.0 ** -7                  # one bf16 rounding step, relative


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """The 128^2 networks are 512 channels wide: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / (np.abs(b) + 1e-3)


def _bf16(x):
    """The same bf16 values on both sides: a torch tensor and a JAX array."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _hold_to_jax(got, want):
    """got (torch bf16) within one bf16 rounding step of want (JAX bf16)."""
    a = got.float().numpy()
    b = np.asarray(want.astype(jnp.float32))
    floor = ULP * float(np.abs(b).max())
    assert np.all(np.abs(a - b) <= ULP * np.abs(b) + floor), \
        float(np.abs(a - b).max())


def test_instance_norm_large_spatial():
    rs = np.random.RandomState(0)
    x = (rs.randn(1, 256, 256, 8) * 3 + 50).astype(np.float32)
    xb, jb = _bf16(x)
    ref = instance_norm(xb.float())
    got = instance_norm(xb)
    assert got.dtype == torch.bfloat16
    err = _rel_err(got.float(), ref)
    assert np.mean(err) < 1e-2 and np.max(err) < 0.2, \
        (np.mean(err), np.max(err))
    _hold_to_jax(got, j_instance_norm(jb))


def test_pixel_norm_bf16():
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 16, 16, 512) + 5).astype(np.float32)
    xb, jb = _bf16(x)
    ref = pixel_norm(xb.float())
    got = pixel_norm(xb)
    assert got.dtype == torch.bfloat16
    assert np.mean(_rel_err(got.float(), ref)) < 1e-2
    _hold_to_jax(got, j_pixel_norm(jb))


def test_minibatch_stddev_bf16():
    rs = np.random.RandomState(2)
    x = (rs.randn(8, 64, 64, 16) + 10).astype(np.float32)
    xb, jb = _bf16(x)
    ref = minibatch_stddev(xb.float())[..., -1]
    out = minibatch_stddev(xb)
    assert out.dtype == torch.bfloat16
    got = out.float()[..., -1]
    # a global statistic: the float32 one to bf16 output precision
    assert np.mean(_rel_err(got, ref)) < 1e-2
    _hold_to_jax(out, j_minibatch_stddev(jb))


def _configs(res):
    def build(m):
        return m.GeneratorConfig(
            resolution=res,
            mapping=m.MappingConfig(
                latent_size=512, dlatent_broadcast=(int(np.log2(res)) - 1) * 2,
                mapping_layers=4),
            synthesis=m.SynthesisConfig(resolution=res, blur_filter=(1, 2, 1),
                                        structure="linear"))
    return build(tcfg), build(
        type("jcfg", (), {"GeneratorConfig": GeneratorConfig,
                          "MappingConfig": MappingConfig,
                          "SynthesisConfig": SynthesisConfig}))


def _drifts(res, batch, depth, with_jax=True):
    """The port's (and JAX's) bf16 and float32 forwards of test_bf16.py's
    weights and z (JAX's init, keys 0 and 1), with pinned noise maps."""
    tc, jc = _configs(res)
    params = generator_init(jax.random.PRNGKey(0), jc)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (batch, 512),
                                   jnp.float32))
    rs = np.random.RandomState(3)
    noises = [rs.randn(batch, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2), 1)
              .astype(np.float32) for i in range(2 * (depth + 1))]
    gen = Generator(tc)
    gen.load_state_dict(generator_state_dict_from_jax_params(flat),
                        strict=True)
    gen.requires_grad_(False)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.inference_mode():
            img = gen(torch.from_numpy(z).to(dtype), depth=depth, alpha=1.0,
                      noises=[torch.from_numpy(n).to(dtype)
                              for n in noises]).images
        assert img.dtype == dtype
        out[("port", dtype)] = img.float().numpy()
    if with_jax:
        for dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
            img = generator_apply(jc, params, jnp.asarray(z, jdt),
                                  depth=depth, alpha=1.0,
                                  noises=[jnp.asarray(n, jdt)
                                          for n in noises]).images
            assert img.dtype == jdt
            out[("jax", dtype)] = np.asarray(img, np.float32)
    return out


def _check_drift(out):
    ref = out[("port", torch.float32)]
    span = ref.max() - ref.min()
    d = np.abs(out[("port", torch.bfloat16)] - ref)
    # images span roughly [-1, 1]: the bf16 drift stays at the few-percent
    # level through every conv and epilogue layer
    assert d.mean() < 0.02 * span, (d.mean(), span)
    assert d.max() < 0.25 * span, (d.max(), span)
    return span


class TestGeneratorDrift:
    @pytest.fixture(scope="class")
    def out128(self):
        return _drifts(128, batch=2, depth=5)

    def test_drift_128(self, out128):
        _check_drift(out128)

    def test_bf16_matches_jax_bf16_128(self, out128):
        span = _check_drift(out128)
        jax_drift = np.abs(out128[("jax", torch.bfloat16)]
                           - out128[("jax", torch.float32)]).mean()
        d = np.abs(out128[("port", torch.bfloat16)]
                   - out128[("jax", torch.bfloat16)])
        assert d.mean() <= jax_drift, (d.mean(), jax_drift)
        assert d.max() < 0.25 * span, (d.max(), span)

    def test_float32_matches_jax_128(self, out128):
        """The float32 forwards agree (the bf16 comparison's baseline)."""
        np.testing.assert_allclose(out128[("port", torch.float32)],
                                   out128[("jax", torch.float32)],
                                   atol=1e-4, rtol=1e-4)

    @pytest.mark.slow
    def test_drift_1024(self):
        _check_drift(_drifts(1024, batch=1, depth=8, with_jax=False))
