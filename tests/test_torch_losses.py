"""The port's losses (stylegan_torch/losses.py) against the JAX package's on
the CPU: every registry entry's value, its D loss's gradients w.r.t. D's
parameters and its G loss's gradient w.r.t. the fake images (what flows
into G), in float32 at atol = rtol = 1e-4; the same D weights (JAX init,
converted through the bridge) and the same numpy images.  wgan-gp's
interpolation draws are pinned: the port takes the eps that JAX draws.

Configuration: a 16^2 discriminator (fmap_base 128, fmap_max 32) at depth 2,
alpha 0.5, batch 4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu import losses as jl
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_apply, discriminator_init
from stylegan_torch import losses as tl
from stylegan_torch.convert import discriminator_state_dict_from_jax_params
from stylegan_torch.models import Discriminator
from stylegan_torch.models import configs as tcfg

RES, DEPTH, BATCH, ALPHA = 16, 2, 4, 0.5
TOL = dict(atol=1e-4, rtol=1e-4)
LABELS = np.array([1, 0, 2, 1])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many tiny ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(conditional):
    kw = dict(resolution=RES, fmap_base=128, fmap_max=32,
              blur_filter=(1, 2, 1), conditional=conditional,
              n_classes=3 if conditional else 0)
    jc, tc = jcfg.DiscriminatorConfig(**kw), tcfg.DiscriminatorConfig(**kw)
    params = discriminator_init(jax.random.PRNGKey(1), jc)
    dis = Discriminator(tc)
    dis.load_state_dict(discriminator_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jc, params, dis


@pytest.fixture(scope="module")
def models():
    return {c: _models(c) for c in (False, True)}


def _images(seed):
    return np.random.RandomState(seed).randn(BATCH, RES, RES, 3) \
        .astype(np.float32)


def _jax_dis_fn(jc, params, conditional):
    labels = LABELS if conditional else None
    return lambda imgs: discriminator_apply(
        jc, params, imgs, depth=DEPTH, alpha=jnp.float32(ALPHA),
        labels=labels)


def _torch_dis_fn(dis, conditional):
    labels = torch.from_numpy(LABELS) if conditional else None
    return lambda imgs: dis(imgs, DEPTH, torch.tensor(ALPHA), labels)


def _gp_eps(key):
    # the interpolation eps jax's gradient_penalty draws from `key`
    return np.array(jax.random.uniform(key, (BATCH, 1, 1, 1), jnp.float32))


def _compare_d_grads(dis, jax_grads):
    want = discriminator_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, p in dis.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), err_msg=name,
                                   **TOL)


ENTRIES = [(name, name.startswith("conditional"))
           for name in jl.LOSSES]


@pytest.mark.parametrize("name,conditional", ENTRIES,
                         ids=[n for n, _ in ENTRIES])
def test_dis_loss_value_and_grads_match_jax(models, name, conditional):
    jc, params, dis = models[conditional]
    reals, fakes = _images(2), _images(3)
    jdis, tdis = jl.get_loss(name, conditional)[0], \
        tl.get_loss(name, conditional)[0]
    jkw, tkw = {}, {}
    if name == "wgan-gp":
        key = jax.random.PRNGKey(7)
        jkw = {"key": key}
        tkw = {"eps": torch.from_numpy(_gp_eps(key))}

    def jloss(p):
        return jdis(_jax_dis_fn(jc, p, conditional), reals, fakes, **jkw)
    want, jgrads = jax.value_and_grad(jloss)(params)
    dis.zero_grad(set_to_none=True)
    got = tdis(_torch_dis_fn(dis, conditional), torch.from_numpy(reals),
               torch.from_numpy(fakes), **tkw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _compare_d_grads(dis, jgrads)


@pytest.mark.parametrize("name,conditional", ENTRIES,
                         ids=[n for n, _ in ENTRIES])
def test_gen_loss_value_and_fake_grads_match_jax(models, name, conditional):
    jc, params, dis = models[conditional]
    reals, fakes = _images(4), _images(5)
    jgen, tgen = jl.get_loss(name, conditional)[1], \
        tl.get_loss(name, conditional)[1]
    want, jg = jax.value_and_grad(
        lambda f: jgen(_jax_dis_fn(jc, params, conditional), reals, f))(fakes)
    ft = torch.from_numpy(fakes).requires_grad_(True)
    got = tgen(_torch_dis_fn(dis, conditional), torch.from_numpy(reals), ft)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jg), **TOL)


def test_r1_penalty_matches_jax(models):
    """Summed over the batch, as the reference; its D gradients run through
    the input gradient (a double backward)."""
    jc, params, dis = models[False]
    reals = _images(6)
    want, jgrads = jax.value_and_grad(
        lambda p: jl.r1_penalty(_jax_dis_fn(jc, p, False), reals))(params)
    dis.zero_grad(set_to_none=True)
    got = tl.r1_penalty(_torch_dis_fn(dis, False), torch.from_numpy(reals))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _compare_d_grads(dis, jgrads)
    # the sum, not the mean: twice the batch, twice the penalty
    both = torch.from_numpy(np.concatenate([reals, reals]))
    dfn = _torch_dis_fn(dis, False)
    pen2 = tl.r1_penalty(lambda x: torch.cat([dfn(x[:BATCH]),
                                              dfn(x[BATCH:])]), both)
    np.testing.assert_allclose(pen2.item(), 2 * got.item(), rtol=1e-5)


def test_gradient_penalty_draws_from_its_generator(models):
    _, _, dis = models[False]
    reals, fakes = map(torch.from_numpy, (_images(8), _images(9)))
    fn = _torch_dis_fn(dis, False)
    pen = lambda s: tl.gradient_penalty(
        fn, reals, fakes, generator=torch.Generator().manual_seed(s)).item()
    assert pen(0) == pen(0) != pen(1)
    eps = torch.rand((BATCH, 1, 1, 1), generator=torch.Generator()
                     .manual_seed(0))
    assert tl.gradient_penalty(fn, reals, fakes, eps=eps).item() == pen(0)
    with pytest.raises(ValueError, match="wgan-gp"):
        tl.wgan_gp_dis_loss(fn, reals, fakes)


@pytest.mark.parametrize("name", ["relativistic-hinge", "hinge",
                                  "standard-gan", "wgan"])
def test_score_pair_equals_two_passes(models, name):
    """A dis_fn with score_pair (one batch-2B pass, stddev groups chunked
    per half) gives the two separate passes' loss and gradients."""
    _, _, dis = models[False]
    reals, fakes = map(torch.from_numpy, (_images(10), _images(11)))
    plain = _torch_dis_fn(dis, False)

    def fused(imgs):
        return plain(imgs)
    fused.score_pair = lambda r, f: tuple(
        dis(torch.cat([r, f]), DEPTH, torch.tensor(ALPHA),
            mbstd_chunks=2).split(BATCH))
    results = []
    for fn in (plain, fused):
        dis.zero_grad(set_to_none=True)
        loss = tl.get_loss(name)[0](fn, reals, fakes)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in
                                      dis.named_parameters()
                                      if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-5, atol=1e-6)
    assert g0.keys() == g1.keys()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-4, atol=1e-5)


def test_registry_matches_jax():
    assert set(tl.LOSSES) == set(jl.LOSSES)
    assert tl.NEEDS_KEY == jl.NEEDS_KEY
    assert tuple(tl.LOGISTIC_LIKE) == tuple(jl.LOGISTIC_LIKE)
    for name in jl.LOSSES:
        conditional = name.startswith("conditional")
        assert tl.get_loss(name.upper(), conditional) is tl.LOSSES[name]
        with pytest.raises(ValueError):
            tl.get_loss(name, not conditional)
