"""The port's mapping, synthesis and generator against the JAX package on the
CPU, in float32 at 1e-4: the same weights (JAX init, converted through the
weight bridge) and the same inputs, with noise pinned through `noises=` and,
in train mode, the style-mixing draws pinned to JAX's own.

Configuration: 128^2, fmap_base 256, fmap_max 32, latent/dlatent 32,
2 mapping layers, batch 2, blur (1, 2, 1)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import generator_apply, generator_init
from stylegan_tpu.models.mapping import mapping_apply
from stylegan_tpu.models.synthesis import synthesis_apply
from stylegan_torch import resolve_device
from stylegan_torch.convert import (flatten_params,
                                    generator_state_dict_from_jax_params)
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.models.synthesis import (layer_resolution, make_noise,
                                             stream_seed)
from stylegan_torch.serving import make_serving_fn

RES, BATCH, LATENT = 128, 2, 32
TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(structure="linear", conditional=False, truncation_psi=-1.0):
    """The same configuration as (JAX GeneratorConfig, port GeneratorConfig)."""
    n_layers = (RES.bit_length() - 2) * 2
    lat = LATENT * (2 if conditional else 1)

    def build(m):
        return m.GeneratorConfig(
            resolution=RES, latent_size=LATENT, dlatent_size=LATENT,
            conditional=conditional, n_classes=3 if conditional else 0,
            truncation_psi=truncation_psi,
            mapping=m.MappingConfig(latent_size=lat, dlatent_size=LATENT,
                                    mapping_fmaps=LATENT, mapping_layers=2,
                                    dlatent_broadcast=n_layers),
            synthesis=m.SynthesisConfig(resolution=RES, dlatent_size=LATENT,
                                        fmap_base=256, fmap_max=32,
                                        blur_filter=(1, 2, 1),
                                        structure=structure))
    return build(jcfg), build(tcfg)


def _models(jc, tc, seed=0):
    """JAX params (noise weights and the W average made non-zero, so the
    noise term is exercised) and the port's Generator holding the same."""
    params = generator_init(jax.random.PRNGKey(seed), jc)
    flat = flatten_params(params)
    rs = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith("noise.weight") or k.endswith("avg_latent"):
            flat[k] = (0.5 * rs.randn(*v.shape)).astype(np.float32)
    params = unflatten_like(params, flat, partial=False)
    gen = Generator(tc)
    gen.load_state_dict(generator_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params, gen


def _noises(seed=1):
    rs = np.random.RandomState(seed)
    n_layers = (RES.bit_length() - 2) * 2
    return [rs.randn(BATCH, layer_resolution(i), layer_resolution(i), 1)
            .astype(np.float32) for i in range(n_layers)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def linear_models():
    jc, tc = _configs("linear")
    return jc, tc, *_models(jc, tc)


def test_mapping_matches_jax(linear_models):
    jc, tc, params, gen = linear_models
    z = np.random.RandomState(2).randn(BATCH, LATENT).astype(np.float32)
    want = np.asarray(mapping_apply(jc.mapping, params["g_mapping"], z))
    with torch.no_grad():
        got = gen.g_mapping(torch.from_numpy(z)).numpy()
    assert got.shape == (BATCH, jc.num_layers, LATENT)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("depth,alpha", [(0, 1.0), (2, 0.3), (2, 1.0),
                                         (5, 0.3), (5, 1.0)])
def test_synthesis_linear_matches_jax(linear_models, depth, alpha):
    """alpha 0.3 arrives traced (a jax / torch scalar): the residual blend
    runs; a static 1.0 skips the residual branch on both sides."""
    jc, tc, params, gen = linear_models
    w = np.random.RandomState(3).randn(BATCH, jc.num_layers, LATENT) \
        .astype(np.float32)
    noises = _noises()
    j_alpha = jnp.float32(alpha) if alpha != 1.0 else 1.0
    t_alpha = torch.tensor(alpha) if alpha != 1.0 else 1.0
    want = np.asarray(synthesis_apply(jc.synthesis, params["g_synthesis"], w,
                                      depth=depth, alpha=j_alpha,
                                      noises=noises))
    with torch.no_grad():
        got = gen.g_synthesis(torch.from_numpy(w), depth=depth, alpha=t_alpha,
                              noises=_t(noises)).numpy()
    res = 2 ** (depth + 2)
    assert got.shape == (BATCH, res, res, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_synthesis_fixed_matches_jax():
    jc, tc = _configs("fixed")
    params, gen = _models(jc, tc, seed=4)
    w = np.random.RandomState(5).randn(BATCH, jc.num_layers, LATENT) \
        .astype(np.float32)
    noises = _noises(6)
    want = np.asarray(synthesis_apply(jc.synthesis, params["g_synthesis"], w,
                                      depth=5, noises=noises))
    with torch.no_grad():
        got = gen.g_synthesis(torch.from_numpy(w), depth=5,
                              noises=_t(noises)).numpy()
    assert got.shape == (BATCH, RES, RES, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_generator_eval_matches_jax(linear_models):
    jc, tc, params, gen = linear_models
    z = np.random.RandomState(7).randn(BATCH, LATENT).astype(np.float32)
    noises = _noises(8)
    want = generator_apply(jc, params, z, depth=5, alpha=1.0, noises=noises)
    with torch.no_grad():
        got = gen(torch.from_numpy(z), depth=5, alpha=1.0, noises=_t(noises))
    np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images),
                               **TOL)
    assert got.avg_latent is None and want.avg_latent is None


def _jax_mixing(key, shape, depth, prob):
    """The style-mixing draws jax generator_apply makes from `key`."""
    _, k_mix_z, k_mix_p, k_cut = jax.random.split(key, 4)
    latents2 = np.array(jax.random.normal(k_mix_z, shape))
    cur = 2 * (depth + 1)
    cutoff = int(jax.random.randint(jax.random.fold_in(k_cut, 0), (), 1,
                                    cur + 1))
    do_mix = bool(jax.random.uniform(k_mix_p, ()) < prob)
    return latents2, (cutoff if do_mix else cur)


@pytest.mark.parametrize("conditional", [False, True],
                         ids=["unconditional", "conditional"])
def test_generator_train_mode_matches_jax(conditional):
    """Train mode: W-average update from dlatents[0, 0], the style-mixing
    splice at JAX's own cutoff, truncation in the training branch, and (when
    conditional) the label embedding."""
    jc, tc = _configs("linear", conditional=conditional, truncation_psi=0.7)
    params, gen = _models(jc, tc, seed=9)
    depth = 3
    z = np.random.RandomState(10).randn(BATCH, LATENT).astype(np.float32)
    labels = np.array([2, 0]) if conditional else None
    mix_shape = (BATCH, LATENT * (2 if conditional else 1))
    # a key whose coin says "mix" below the layers in use
    for s in range(100):
        key = jax.random.PRNGKey(s)
        latents2, cutoff = _jax_mixing(key, mix_shape, depth,
                                       jc.style_mixing_prob)
        if cutoff < 2 * (depth + 1):
            break
    noises = _noises(11)
    want = generator_apply(jc, params, z, depth=depth,
                           alpha=jnp.float32(0.3), rng=key, train=True,
                           labels=labels, noises=noises)
    with torch.no_grad():
        got = gen(torch.from_numpy(z), depth=depth, alpha=torch.tensor(0.3),
                  train=True, labels=None if labels is None
                  else torch.from_numpy(labels), noises=_t(noises),
                  mixing=(torch.from_numpy(latents2), cutoff))
    np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images),
                               **TOL)
    np.testing.assert_allclose(got.avg_latent.numpy(),
                               np.asarray(want.avg_latent), **TOL)
    # train mode leaves the buffer to the caller, as JAX does
    assert not torch.equal(gen.truncation.avg_latent, got.avg_latent)


def test_generator_draws_are_seeded_and_keyed_by_layer():
    jc, tc = _configs("linear", truncation_psi=0.7)
    gen = Generator(tc, generator=torch.Generator().manual_seed(0))
    z = torch.randn(BATCH, LATENT, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = gen(z, depth=3, seed=5, train=True).images
        b = gen(z, depth=3, seed=5, train=True).images
        c = gen(z, depth=3, seed=6, train=True).images
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a layer's noise depends on (seed, layer index) only
    n = make_noise(5, 4, BATCH, 16, "cpu")
    assert torch.equal(n, make_noise(5, 4, BATCH, 16, "cpu"))
    assert not torch.equal(n, make_noise(5, 5, BATCH, 16, "cpu"))
    assert stream_seed(5, 0, 4) != stream_seed(5, 1)


def test_serving_fn_is_deterministic_and_matches_generator(linear_models):
    jc, tc, params, gen = linear_models
    serve = make_serving_fn(tc, gen, depth=4, device="cpu")
    z = np.random.RandomState(12).randn(BATCH, LATENT).astype(np.float32)
    a, b = serve(z, 3), serve(z, 3)
    assert a.shape == (BATCH, 64, 64, 3) and torch.equal(a, b)
    assert not torch.equal(a, serve(z, 4))
    with torch.no_grad():
        want = gen(torch.from_numpy(z), depth=4, alpha=1.0, seed=3).images
    assert torch.equal(a, want)


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_fn_refuses_missing_cuda(monkeypatch, linear_models):
    """Serving defaults to CUDA: with no device asked for and no CUDA it
    raises instead of serving on the CPU."""
    _, tc, _, gen = linear_models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serving_fn(tc, gen, depth=4)
    assert next(gen.parameters()).device.type == "cpu"


def test_port_config_dataclass_defaults_match_jax():
    """Every field and default of the port's dataclasses equals the JAX
    one's; the JAX-only fields are its TPU execution-layout knobs."""
    layout_only = {"packed", "fold_blur", "remat"}
    for name in ("MappingConfig", "SynthesisConfig", "GeneratorConfig"):
        j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
        jf = {f.name for f in dataclasses.fields(j)}
        tf = {f.name for f in dataclasses.fields(t)}
        assert tf <= jf and jf - tf <= layout_only
        for f in tf - {"mapping", "synthesis"}:
            assert getattr(t, f) == getattr(j, f), (name, f)
