"""The port's torch.export serving (stylegan_torch/serving.py:
export_generator / load_exported, and python -m
stylegan_torch.cli.export_generator) on the CPU, mirroring
tests/test_serving.py at its tiny configuration: the round trip bitwise
against make_serving_fn, seed determinism, the conditional and
train-quirks signatures, shape and option checks, the epilogue op's nodes
in the graph, and the program against the JAX package's generator_apply
on JAX's own noise maps (1e-5, float32 on both sides: the same bar as
tests/test_torch_generator.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu.io.checkpoint import unflatten_like
from stylegan_tpu.models import configs as jcfg
from stylegan_tpu.models import generator_apply, generator_init
from stylegan_torch.convert import (flatten_params,
                                    generator_state_dict_from_jax_params,
                                    save_generator_file)
from stylegan_torch.models import Generator
from stylegan_torch.models import configs as tcfg
from stylegan_torch.models.synthesis import layer_resolution
from stylegan_torch.serving import (export_generator, load_exported,
                                    make_serving_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
N_LAYERS = (RES.bit_length() - 2) * 2
DEPTH = RES.bit_length() - 3
FORWARD_OP = torch.ops.stylegan_torch.epilogue.default


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(m=tcfg, conditional=False, n_classes=0, truncation_psi=-1.0):
    lat = 32 + (32 if conditional else 0)
    return m.GeneratorConfig(
        resolution=RES, latent_size=32, dlatent_size=32,
        conditional=conditional, n_classes=n_classes,
        truncation_psi=truncation_psi,
        mapping=m.MappingConfig(latent_size=lat, dlatent_size=32,
                                mapping_fmaps=32, mapping_layers=2,
                                dlatent_broadcast=N_LAYERS),
        synthesis=m.SynthesisConfig(resolution=RES, dlatent_size=32,
                                    fmap_base=128, fmap_max=32,
                                    blur_filter=(1, 2, 1), structure="linear"))


def _generator(cfg, seed=0):
    """Seeded weights, noise weights made non-zero so that the seed feeds
    the output (they init to zero)."""
    gen = Generator(cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(
                    seed + 1))
    return gen.requires_grad_(False)


def _z(batch, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(batch, 32)
                            .astype(np.float32))


def _op_nodes(serve):
    return [n for n in serve.exported.graph.nodes
            if n.op == "call_function" and n.target is FORWARD_OP]


def test_export_roundtrip_exact(tmp_path):
    cfg = small_cfg()
    gen = _generator(cfg)
    blob = export_generator(cfg, gen, depth=DEPTH, batch_size=3)
    assert isinstance(blob, bytes) and len(blob) > 1000
    path = tmp_path / "gen.pt2"
    path.write_bytes(blob)
    want = make_serving_fn(cfg, gen, depth=DEPTH, device="cpu")(_z(3, 1), 11)
    for src in (blob, str(path)):
        serve = load_exported(src, device="cpu")
        got = serve(_z(3, 1), 11)
        assert got.shape == (3, RES, RES, 3)
        assert torch.equal(got, want)
    os.remove(path)


def test_export_graph_holds_the_epilogue_op():
    """One stylegan_torch::epilogue node per synthesis layer (two per
    stage), nothing of the plain composition's instance norm; the CPU op
    runs the plain version, counted once per layer and request."""
    from stylegan_torch.ops import fused
    cfg = small_cfg()
    serve = load_exported(export_generator(cfg, _generator(cfg), depth=DEPTH,
                                           batch_size=2), device="cpu")
    assert len(_op_nodes(serve)) == N_LAYERS
    before = fused.plain_calls
    serve(_z(2, 0), 1)
    assert fused.plain_calls - before == N_LAYERS


def test_export_seed_determinism():
    cfg = small_cfg()
    serve = load_exported(export_generator(cfg, _generator(cfg), depth=DEPTH,
                                           batch_size=2), device="cpu")
    z = _z(2, 2)
    a, b, c = serve(z, 5), serve(z, 5), serve(z, 6)
    assert torch.equal(a, b)                  # replayable
    assert (a - c).abs().max() > 0            # seed actually feeds the noise


def test_export_conditional_signature():
    cfg = small_cfg(conditional=True, n_classes=4)
    gen = _generator(cfg, seed=3)
    serve = load_exported(export_generator(cfg, gen, depth=DEPTH,
                                           batch_size=2), device="cpu")
    z = _z(2, 4)
    la = serve(z, 1, torch.tensor([0, 1]))
    lb = serve(z, 1, torch.tensor([2, 3]))
    assert la.shape == (2, RES, RES, 3)
    assert (la - lb).abs().max() > 0          # labels condition the output
    live = make_serving_fn(cfg, gen, depth=DEPTH, device="cpu")
    assert torch.equal(la, live(z, 1, torch.tensor([0, 1])))
    with pytest.raises(TypeError):            # wrong arity is rejected
        serve(z, 1)


def test_export_train_quirks_signature():
    """Train-mode sampling (style mixing with its draws as inputs, the W
    average's update and the truncation lerp): bitwise make_serving_fn's
    train_quirks path; the seed picks the mixing draws too."""
    cfg = small_cfg(truncation_psi=0.7)
    gen = _generator(cfg, seed=5)
    with torch.no_grad():
        gen.truncation.avg_latent.normal_(
            generator=torch.Generator().manual_seed(9))
    serve = load_exported(export_generator(cfg, gen, depth=DEPTH,
                                           batch_size=2, train_quirks=True),
                          device="cpu")
    names = [s.arg.name for s in serve.exported.graph_signature.input_specs
             if s.kind.name == "USER_INPUT"]
    assert "latents2" in names and "cutoff" in names
    live = make_serving_fn(cfg, gen, depth=DEPTH, train_quirks=True,
                           device="cpu")
    eval_serve = make_serving_fn(cfg, gen, depth=DEPTH, device="cpu")
    z = _z(2, 6)
    for seed in (0, 1, 2, 3):
        got = serve(z, seed)
        assert torch.equal(got, live(z, seed))
        assert (got - eval_serve(z, seed)).abs().max() > 0


def test_exported_wrong_shape_rejected():
    cfg = small_cfg()
    serve = load_exported(export_generator(cfg, _generator(cfg), depth=DEPTH,
                                           batch_size=2), device="cpu")
    with pytest.raises(Exception):
        serve(_z(4, 5), 0)                    # batch 4 != 2
    with pytest.raises(Exception):
        serve(torch.zeros(2, 16), 0)          # latent 16 != 32


@pytest.mark.parametrize("kw,err", [
    (dict(spatial_devices=2), NotImplementedError),
    (dict(platforms=("tpu", "cpu")), ValueError),
    (dict(platforms=("rocm",)), ValueError),
], ids=["spatial", "tpu", "unknown"])
def test_export_refuses_what_it_cannot_make(kw, err):
    cfg = small_cfg()
    with pytest.raises(err, match="parallel|JAX package|unknown"):
        export_generator(cfg, _generator(cfg), depth=DEPTH, batch_size=2,
                         **kw)


def test_load_refuses_a_platform_not_exported():
    cfg = small_cfg()
    blob = export_generator(cfg, _generator(cfg), depth=DEPTH, batch_size=2,
                            platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for"):
        load_exported(blob, device="cpu")


def test_exported_program_matches_jax_generator_apply():
    """The program, fed JAX's noise maps, against generator_apply(...,
    noises=) on the same weights: float32, 1e-5."""
    jc, tc = small_cfg(jcfg), small_cfg(tcfg)
    params = generator_init(jax.random.PRNGKey(0), jc)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("noise.weight"):
            flat[k] = (0.5 * rs.randn(*v.shape)).astype(np.float32)
    params = unflatten_like(params, flat, partial=False)
    gen = Generator(tc)
    gen.load_state_dict(generator_state_dict_from_jax_params(flat),
                        strict=True)
    serve = load_exported(export_generator(tc, gen.requires_grad_(False),
                                           depth=DEPTH, batch_size=2),
                          device="cpu")
    z = rs.randn(2, 32).astype(np.float32)
    noises = [rs.randn(2, layer_resolution(i), layer_resolution(i), 1)
              .astype(np.float32) for i in range(N_LAYERS)]
    want = np.asarray(generator_apply(jc, params, jnp.asarray(z), depth=DEPTH,
                                      alpha=1.0, noises=noises).images)
    with torch.inference_mode():
        got = serve.exported.module()(torch.from_numpy(z),
                                      [torch.from_numpy(n) for n in noises])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_artifact_loads_with_only_serving_imported(tmp_path):
    """A process that imports stylegan_torch.serving alone (no model code)
    loads the artifact and serves a request."""
    cfg = small_cfg()
    gen = _generator(cfg)
    path = tmp_path / "gen.pt2"
    path.write_bytes(export_generator(cfg, gen, depth=DEPTH, batch_size=2))
    want = make_serving_fn(cfg, gen, depth=DEPTH, device="cpu")(_z(2, 3), 4)
    np.save(tmp_path / "z.npy", _z(2, 3).numpy())
    code = (
        "import sys, numpy as np\n"
        "from stylegan_torch.serving import load_exported\n"
        f"serve = load_exported({str(path)!r}, device='cpu')\n"
        f"out = serve(np.load({str(tmp_path / 'z.npy')!r}), 4)\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('stylegan_torch.models')))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  want.numpy())
    for name in ("gen.pt2", "z.npy", "out.npy"):
        os.remove(tmp_path / name)


def test_export_cli_check_on_cpu(tmp_path):
    """python -m stylegan_torch.cli.export_generator --check --device cpu on
    a toy yaml: the artifact reloads and matches make_serving_fn bitwise."""
    cfg_path = tmp_path / "toy.yaml"
    cfg_path.write_text(f"""
structure: 'linear'
model:
  gen:
    mapping_layers: 2
    truncation_psi: 0.7
dataset:
  resolution: {RES}
""")
    from stylegan_torch.config import get_default_cfg
    from stylegan_torch.models import generator_config_from_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(str(cfg_path))
    gen = _generator(generator_config_from_cfg(cfg))
    npz = tmp_path / "gen.npz"
    save_generator_file(gen, str(npz))
    out = tmp_path / "gen.pt2"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    for extra in ([], ["--train_quirks"]):
        r = subprocess.run(
            [sys.executable, "-m", "stylegan_torch.cli.export_generator",
             "--config", str(cfg_path), "--generator_file", str(npz),
             "--output", str(out), "--batch", "2", "--check",
             "--device", "cpu"] + extra,
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
        assert "Check OK" in r.stdout and out.stat().st_size > 1000
    for path in (npz, out, cfg_path):
        os.remove(path)
