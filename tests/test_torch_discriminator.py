"""The port's discriminator half (stylegan_torch/ops primitives and downscale
convolutions, models/discriminator.py, models/ema.py and the weight bridge's
discriminator files) against the JAX package on the CPU, in float32 at
atol = rtol = 1e-4 (1e-5 for the primitives): the same weights (JAX init,
converted through the bridge) and the same numpy inputs.

Configuration: 32^2, fmap_base 128, fmap_max 32 (nf(1) == nf(2), as every
real configuration has), batch 4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu.config import get_default_cfg as jax_default_cfg
from stylegan_tpu.convert.torch_params import \
    discriminator_state_dict_from_params
from stylegan_tpu.io.checkpoint import load_params_into, save_params
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import discriminator_apply, discriminator_init
from stylegan_tpu.models.ema import ema_update as jax_ema_update
from stylegan_tpu.ops import linear as jlinear
from stylegan_tpu.ops import primitives as jprim
from stylegan_torch.config import get_default_cfg
from stylegan_torch.convert import (discriminator_state_dict_from_jax_params,
                                    flatten_params, load_discriminator_file,
                                    save_discriminator_file)
from stylegan_torch.models import (Discriminator, Generator,
                                   discriminator_config_from_cfg, ema_update)
from stylegan_torch.models import configs as tcfg
from stylegan_torch.ops import linear as tlinear
from stylegan_torch.ops import primitives as tprim

RES, BATCH = 32, 4
TOL = dict(atol=1e-4, rtol=1e-4)
OP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of tiny ops (gradgradcheck above all): one intra-op thread,
    so that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(structure="linear", conditional=False, **kw):
    def build(m):
        return m.DiscriminatorConfig(
            resolution=RES, fmap_base=128, fmap_max=32, blur_filter=(1, 2, 1),
            structure=structure, conditional=conditional,
            n_classes=3 if conditional else 0, **kw)
    return build(jcfg), build(tcfg)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _models(jc, tc, seed=0):
    params = discriminator_init(jax.random.PRNGKey(seed), jc)
    dis = Discriminator(tc)
    dis.load_state_dict(discriminator_state_dict_from_jax_params(
        _np_tree(params)), strict=True)
    return params, dis


def _images(res, seed, channels=3):
    return np.random.RandomState(seed).randn(BATCH, res, res, channels) \
        .astype(np.float32)


# ------------------------------------------------------------ primitives --

@pytest.mark.parametrize("factor", [1, 2, 4])
def test_avg_pool_and_downscale_match_jax(factor):
    x = _images(16, 1, 8)
    np.testing.assert_allclose(
        tprim.avg_pool2d(torch.from_numpy(x), factor).numpy(),
        np.asarray(jprim.avg_pool2d(x, factor)), **OP_TOL)
    for gain in (1.0, 2.0):
        np.testing.assert_allclose(
            tprim.downscale2d(torch.from_numpy(x), factor, gain).numpy(),
            np.asarray(jprim.downscale2d(x, factor, gain)), **OP_TOL)


@pytest.mark.parametrize("batch,group,f,chunks",
                         [(4, 1, 1, 1), (4, 2, 1, 1), (6, 3, 1, 1),
                          (4, 4, 1, 1), (8, 4, 2, 1), (2, 4, 1, 1),
                          (8, 4, 1, 2), (8, 2, 2, 2)])
def test_minibatch_stddev_matches_jax(batch, group, f, chunks):
    """Strided groups of min(group, B), f features, chunked scopes."""
    x = np.random.RandomState(2).randn(batch, 4, 4, 8).astype(np.float32)
    want = np.asarray(jprim.minibatch_stddev(x, group, f, chunks=chunks))
    got = tprim.minibatch_stddev(torch.from_numpy(x), group, f,
                                 chunks=chunks).numpy()
    assert got.shape == (batch, 4, 4, 8 + f)
    np.testing.assert_allclose(got, want, **OP_TOL)


def test_minibatch_stddev_groups_are_strided():
    """Group s holds batch indices {s, s + B/g, ...}: changing sample 0
    changes the statistic of samples 0 and 2 (B = 4, g = 2), not 1 and 3."""
    x = torch.randn(4, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    y = x.clone()
    y[0] += 1.0
    a = tprim.minibatch_stddev(x, 2)[..., -1]
    b = tprim.minibatch_stddev(y, 2)[..., -1]
    changed = [not torch.equal(a[i], b[i]) for i in range(4)]
    assert changed == [True, False, True, False]


def test_minibatch_stddev_keeps_bf16_and_refuses_axis_name():
    x = torch.randn(4, 4, 4, 8).bfloat16()
    assert tprim.minibatch_stddev(x, 4).dtype == torch.bfloat16
    # the port names the group by its Mesh, not by a JAX axis name
    with pytest.raises(TypeError, match="Mesh"):
        tprim.minibatch_stddev(x, 4, axis_name="data")


@pytest.mark.parametrize("taps", [(1, 2, 1), (1, 3, 3, 1, 2)],
                         ids=["121", "odd5"])
def test_blur_gradients_of_every_order_match_the_grouped_conv(taps):
    """blur2d is a linear map whose gradient is the same blur with the
    flipped kernel: first and second order gradients (R1's double backward)
    equal autograd of the grouped convolution, in float64; the JAX blur
    gives the same forward."""
    k = torch.from_numpy(jprim.make_blur_kernel(taps)).double()
    x = torch.randn(2, 9, 7, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(
        tprim.blur2d(x.float(), k.float()).numpy(),
        np.asarray(jprim.blur2d(x.float().numpy(), k.float().numpy())),
        **OP_TOL)
    grads = []
    for fn in (lambda t: tprim.blur2d(t, k),
               lambda t: tprim._depthwise(t, k)):
        xi = x.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad(torch.tanh(fn(xi)).pow(3).sum(), xi,
                                    create_graph=True)
        (g2,) = torch.autograd.grad(g1.square().sum(), xi)
        grads.append((g1.detach(), g2))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradgradcheck(
        lambda t: tprim.blur2d(t, k), (x[:1, :4, :4, :2].clone()
                                       .requires_grad_(True),))


def test_blur_refuses_an_even_kernel():
    """SAME padding and the flipped-kernel gradient hold for odd kernels
    only; an even one raises instead of taking another path."""
    with pytest.raises(ValueError, match="odd"):
        tprim.blur2d(torch.zeros(1, 4, 4, 2),
                     tprim.make_blur_kernel((1, 3, 3, 1)))


@pytest.mark.parametrize("shapes", [
    ((2, 3, 8, 8), (4, 3, 3, 3), 1, 1, False),    # 3x3 same
    ((2, 3, 8, 8), (4, 3, 1, 1), 1, 0, False),    # from_rgb 1x1
    ((2, 3, 8, 8), (4, 3, 4, 4), 2, 1, False),    # fused downscale
    ((2, 3, 7, 7), (4, 3, 4, 4), 2, 1, False),    # odd: output padding
    ((2, 3, 5, 5), (3, 4, 4, 4), 2, 1, True)],    # fused upscale
    ids=["same", "1x1", "down", "down-odd", "up"])
def test_conv_gradients_of_every_order_match_autograd(shapes):
    """linear.conv equals F.conv2d / F.conv_transpose2d, and so do its first
    and second order gradients (an R1-style double backward down to the
    weights), in float64."""
    x_shape, w_shape, stride, padding, transpose = shapes
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(x_shape, dtype=torch.float64, generator=gen)
    w = torch.randn(w_shape, dtype=torch.float64, generator=gen)
    plain = torch.nn.functional.conv_transpose2d if transpose \
        else torch.nn.functional.conv2d
    results = []
    for fn in (lambda a, b: tlinear.conv(a, b, stride, padding, transpose),
               lambda a, b: plain(a, b, None, stride, padding)):
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xi, wi)
        (gx,) = torch.autograd.grad(torch.tanh(y).pow(2).sum(), xi,
                                    create_graph=True)
        gw, gx2 = torch.autograd.grad(gx.square().sum(), (wi, xi))
        results.append((y.detach(), gx.detach(), gw, gx2))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    assert torch.autograd.gradgradcheck(
        lambda a, b: tlinear.conv(a, b, stride, padding, transpose),
        (x.requires_grad_(True), w.requires_grad_(True)))


@pytest.mark.parametrize("res", [8, 64, 128, 256],
                         ids=lambda r: f"{r}x{r}")
@pytest.mark.parametrize("blur", [False, True], ids=["plain", "pre_blur"])
def test_downscale_conv_matches_jax(res, blur):
    """Below 128 the conv, the 2x2 pool, then the bias; from 128 the fused
    stride-2 conv on the 4-tap averaged kernel; with the D path's pre-conv
    blur or without."""
    rs = np.random.RandomState(res)
    x = rs.randn(2, res, res, 4).astype(np.float32)
    params = {"weight": rs.randn(3, 3, 4, 6).astype(np.float32),
              "bias": rs.randn(6).astype(np.float32)}
    k = jprim.make_blur_kernel((1, 2, 1))
    want = np.asarray(jlinear.conv2d_apply(
        params, x, use_wscale=True, downscale=True,
        pre_blur_kernel=k if blur else None))
    got = tlinear.conv2d_apply(
        torch.from_numpy(x),
        torch.from_numpy(params["weight"].transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(params["bias"]), use_wscale=True, downscale=True,
        pre_blur_kernel=tprim.make_blur_kernel((1, 2, 1)) if blur else None)
    assert tuple(got.shape) == (2, res // 2, res // 2, 6)
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


# ---------------------------------------------------------- discriminator --

@pytest.fixture(scope="module")
def linear_models():
    jc, tc = _cfgs("linear")
    return jc, tc, *_models(jc, tc)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_discriminator_linear_matches_jax(linear_models, depth, alpha):
    jc, tc, params, dis = linear_models
    res = 2 ** (depth + 2)
    x = _images(res, 10 + depth)
    want = np.asarray(discriminator_apply(jc, params, x, depth=depth,
                                          alpha=jnp.float32(alpha)))
    with torch.no_grad():
        got = dis(torch.from_numpy(x), depth, torch.tensor(alpha)).numpy()
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_discriminator_fixed_matches_jax():
    jc, tc = _cfgs("fixed")
    params, dis = _models(jc, tc, seed=3)
    x = _images(RES, 4)
    want = np.asarray(discriminator_apply(jc, params, x, depth=3))
    with torch.no_grad():
        got = dis(torch.from_numpy(x), 3).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("structure,depth", [("linear", 0), ("linear", 2),
                                             ("fixed", 3)])
def test_discriminator_conditional_matches_jax(structure, depth):
    """Label planes: the embedding of each label reshaped channel-major to
    the image's resolution and concatenated."""
    jc, tc = _cfgs(structure, conditional=True)
    params, dis = _models(jc, tc, seed=5)
    res = 2 ** (depth + 2)
    x = _images(res, 6)
    labels = np.array([2, 0, 1, 2])
    want = np.asarray(discriminator_apply(jc, params, x, depth=depth,
                                          alpha=jnp.float32(0.5),
                                          labels=labels))
    with torch.no_grad():
        got = dis(torch.from_numpy(x), depth, torch.tensor(0.5),
                  labels=torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_discriminator_grads_match_jax(linear_models):
    """Parameter and input gradients of the summed scores."""
    jc, tc, params, dis = linear_models
    x = _images(16, 7)

    def score(p, imgs):
        return jnp.sum(discriminator_apply(jc, p, imgs, depth=2,
                                           alpha=jnp.float32(0.5)))
    g_params, g_x = jax.grad(score, argnums=(0, 1))(params, x)
    want = discriminator_state_dict_from_jax_params(_np_tree(g_params))
    xt = torch.from_numpy(x).requires_grad_(True)
    dis.zero_grad(set_to_none=True)
    dis(xt, 2, torch.tensor(0.5)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **TOL)
    for name, p in dis.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), err_msg=name,
                                   **TOL)


def test_discriminator_remat_gives_the_same_grads(linear_models):
    """remat recomputes each block in the backward pass (checkpointing),
    R1's double backward included: the same gradients."""
    _, tc, params, dis = linear_models
    re = Discriminator(dataclasses.replace(tc, remat=True))
    re.load_state_dict(dis.state_dict())
    x = torch.from_numpy(_images(16, 8))
    grads = []
    for d in (dis, re):
        d.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(d(xi, 2, 0.5).sum(), xi,
                                    create_graph=True)
        gx.square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in d.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-6)


def test_discriminator_config_matches_jax():
    """The dataclass's fields and defaults equal the JAX one's but for its
    TPU layout knobs; from_cfg reads the same keys (and ops.remat)."""
    j, t = jcfg.DiscriminatorConfig(), tcfg.DiscriminatorConfig()
    jf = {f.name for f in dataclasses.fields(j)}
    tf = {f.name for f in dataclasses.fields(t)}
    assert jf - tf == {"packed", "fold_blur"} and tf <= jf
    for f in tf:
        assert getattr(t, f) == getattr(j, f), f
    for conditional in (False, True):
        jc, tc = jax_default_cfg(), get_default_cfg()
        for c in (jc, tc):
            c.merge_from_list(["dataset.resolution", 64, "conditional",
                               conditional, "n_classes", 5, "ops.remat",
                               True])
        from stylegan_tpu.models.configs import \
            discriminator_config_from_cfg as jax_from_cfg
        want = jax_from_cfg(jc)
        got = discriminator_config_from_cfg(tc)
        for f in tf:
            assert getattr(got, f) == getattr(want, f), f


# -------------------------------------------------------------------- EMA --

def test_ema_matches_jax_and_skips_the_w_average():
    gcfg = tcfg.GeneratorConfig(
        resolution=16, latent_size=8, dlatent_size=8,
        mapping=tcfg.MappingConfig(latent_size=8, dlatent_size=8,
                                   mapping_fmaps=8, mapping_layers=2,
                                   dlatent_broadcast=6),
        synthesis=tcfg.SynthesisConfig(resolution=16, dlatent_size=8,
                                       fmap_base=32, fmap_max=8))
    gen = Generator(gcfg, generator=torch.Generator().manual_seed(0))
    shadow = Generator(gcfg, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        gen.truncation.avg_latent.fill_(3.0)
        shadow.truncation.avg_latent.fill_(1.0)
    flat = lambda m: {k: v.numpy().copy() for k, v in m.state_dict().items()}

    def nested(d):      # the JAX package's tree: the buffer under its key
        tree = {}
        for k, v in d.items():
            *path, leaf = k.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
        return tree
    want = flatten_params(_np_tree(jax_ema_update(
        nested(flat(shadow)), nested(flat(gen)), 0.9)))
    ema_update(shadow, gen, 0.9)
    got = flat(shadow)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert float(shadow.truncation.avg_latent[0]) == 1.0
    ema_update(shadow, gen, 0.0)   # beta 0 copies the parameters
    for (n, p), q in zip(shadow.named_parameters(), gen.parameters()):
        assert torch.equal(p, q), n


# ------------------------------------------------------------ weight files --

@pytest.mark.parametrize("conditional", [False, True],
                         ids=["unconditional", "conditional"])
def test_discriminator_pth_and_npz_round_trips(tmp_path, conditional):
    """A reference-style .pth (blocks.{i}.blur.kernel buffers and all) and
    the JAX package's .npz load into the port, strict; the port's files load
    back into the JAX package; D scores agree throughout.  The embeddings
    keep their (n_classes, dim) layout."""
    jc, tc = _cfgs("linear", conditional=conditional)
    params = discriminator_init(jax.random.PRNGKey(9), jc)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          discriminator_state_dict_from_params(_np_tree(params)).items()}
    assert any(k.endswith(".blur.kernel") for k in sd)
    pth = str(tmp_path / "ref.pth")
    torch.save(sd, pth)
    npz = str(tmp_path / "jax.npz")
    save_params(npz, params)
    x = _images(16, 11)
    labels = np.array([0, 1, 2, 1]) if conditional else None
    tl = None if labels is None else torch.from_numpy(labels)
    want = np.asarray(discriminator_apply(jc, params, x, depth=2,
                                          alpha=jnp.float32(0.5),
                                          labels=labels))
    for path in (pth, npz):
        dis = load_discriminator_file(Discriminator(tc), path)
        if conditional:
            assert tuple(dis.embeddings[0].weight.shape) == (3, 3 * RES * RES)
            np.testing.assert_array_equal(
                dis.embeddings[0].weight.detach().numpy(),
                np.asarray(params["embeddings"][0]["weight"]))
        with torch.no_grad():
            got = dis(torch.from_numpy(x), 2, torch.tensor(0.5), tl).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    # the port's own files: .npz into the JAX package, .pth with the buffers
    out_npz, out_pth = str(tmp_path / "out.npz"), str(tmp_path / "out.pth")
    save_discriminator_file(dis, out_npz)
    save_discriminator_file(dis, out_pth)
    back, _ = load_params_into(params, out_npz, partial=False)
    want_flat = flatten_params(_np_tree(params))
    back_flat = flatten_params(_np_tree(back))
    assert set(back_flat) == set(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(back_flat[k], v, err_msg=k)
    written = torch.load(out_pth, weights_only=True)
    assert set(written) == set(sd)
    for k in sd:
        torch.testing.assert_close(written[k], sd[k], rtol=0, atol=0)
