"""The port's evidence tools (stylegan_torch/tools/) against the JAX
package's root tools/ and its committed runs, on the CPU.

* The numpy helpers (structured_batch, class_batch, downsample_np,
  draw_batch, save_grid's PNG) are bitwise the JAX tools' own, imported
  from tools/ with tools/ itself on sys.path, as running the scripts puts
  it; make_synthetic_dataset writes byte-equal PNG files.
* The progressive tool's eval schedule for its default arguments is the 36
  records of docs/progressive_run/metrics.jsonl; its SWD on JAX's draws is
  within 1e-5 relative of stylegan_tpu's; a tiny run (16^2, 3 depths,
  batch 4, resume_k 3) is replayed in a fresh process bit for bit, and a
  sidecar whose z stream state is left out (the seed's fresh stream in its
  place) makes the replay differ and exit 1.
* The conditional and quality tools at a tiny size write the JAX runs'
  summary.json and history keys; a train step and an eval make the
  epilogue calls that chip_smoke.py's phase 13 counts on the card.
* The kernels' plans (epilogue_plan.h, compiled with the host compiler) at
  the planes the tools' schedules give them, as chip_smoke.py's phase 13
  lists them.
* measure_latency's function at a tiny configuration; the fidelity gate on
  a synthetic official pickle: its .npz bitwise the JAX package's
  conversion, FID a float, PPL skipped, a mismatched --res exits non-zero.

Sizes: the default networks (512 channels) at 4^2 to 16^2.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_tpu.convert import generator_state_dict_from_params
from stylegan_tpu.convert import tf_pickle as jtf
from stylegan_tpu.io.checkpoint import load_params
from stylegan_tpu.metrics import swd as jswd
from stylegan_tpu.models import GeneratorConfig as JaxGeneratorConfig
from stylegan_tpu.models import MappingConfig as JaxMappingConfig
from stylegan_tpu.models import SynthesisConfig as JaxSynthesisConfig
from stylegan_tpu.models import generator_init
from stylegan_torch.convert import flat_from_state_dict
from stylegan_torch.models import Generator
from stylegan_torch.ops import fused
from stylegan_torch.tools import (fidelity_gate, make_synthetic_dataset,
                                  measure_latency, train_conditional_run,
                                  train_progressive_run, train_quality_run)
from test_tf_convert import build_fake_pickle
from test_torch_epilogue_plan import (bwd_plan, check_bwd_plan, check_plan,
                                      plan, plan_lib)  # noqa: F401
from test_torch_metrics import _jax_swd_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
DOCS = os.path.join(REPO, "docs")


def _jax_tool(name):
    """A JAX tool module as its script sees the others: tools/ on sys.path
    (train_progressive_run does `from train_quality_run import ...`)."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return importlib.import_module(name)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Checkpoints and weights take tens of MB: gone once read."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return env


# --------------------------------------------------------------------------
# numpy helpers, bitwise the JAX tools'

@pytest.mark.parametrize("res", [8, 16])
def test_structured_batch_is_the_jax_tools(res):
    jq = _jax_tool("train_quality_run")
    got = train_quality_run.structured_batch(np.random.RandomState(5), 3, res)
    want = jq.structured_batch(np.random.RandomState(5), 3, res)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("cls", range(train_conditional_run.N_CLASSES))
def test_class_batch_is_the_jax_tools(cls):
    jc = _jax_tool("train_conditional_run")
    assert jc.N_CLASSES == train_conditional_run.N_CLASSES
    got = train_conditional_run.class_batch(np.random.RandomState(3), 2, 16,
                                            cls)
    want = jc.class_batch(np.random.RandomState(3), 2, 16, cls)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_downsample_np_is_the_jax_tools(factor):
    jp = _jax_tool("train_progressive_run")
    x = np.random.RandomState(0).randn(3, 16, 16, 3).astype(np.float32)
    got = train_progressive_run.downsample_np(x, factor)
    want = jp.downsample_np(x, factor)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_draw_batch_is_the_jax_tools():
    jp = _jax_tool("train_progressive_run")
    pool = train_quality_run.structured_batch(np.random.RandomState(1), 8, 8)
    rs_a, rs_b = np.random.RandomState(2), np.random.RandomState(2)
    for _ in range(3):
        got = train_progressive_run.draw_batch(pool, rs_a, 5)
        want = jp.draw_batch(pool, rs_b, 5)
        assert np.array_equal(got, want)
    assert rs_a.randint(1 << 30) == rs_b.randint(1 << 30)


@pytest.mark.parametrize("cols", [6, 4])
def test_save_grid_png_is_the_jax_tools(tmp_path, cols):
    jq = _jax_tool("train_quality_run")
    imgs = np.random.RandomState(4).uniform(-1.2, 1.2, (7, 8, 8, 3)).astype(
        np.float32)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    train_quality_run.save_grid(a, imgs, cols=cols)
    jq.save_grid(b, imgs, cols=cols)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_make_synthetic_dataset_writes_the_jax_tools_files(tmp_path,
                                                           monkeypatch):
    jm = _jax_tool("make_synthetic_dataset")
    port, want = tmp_path / "port", tmp_path / "jax"
    make_synthetic_dataset.main(["--out", str(port), "--n", "4", "--res",
                                 "16", "--chunk", "3"])
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", "--out",
                                      str(want), "--n", "4", "--res", "16",
                                      "--chunk", "3"])
    jm.main()
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(port)) == [f"{i:06d}.png"
                                                 for i in range(4)]
    for n in names:
        assert (port / n).read_bytes() == (want / n).read_bytes(), n


# --------------------------------------------------------------------------
# the progressive tool: schedule, eval SWD, bitwise fresh-process resume

def test_eval_schedule_is_the_jax_runs():
    args = train_progressive_run.parse_arguments([])
    with open(os.path.join(DOCS, "progressive_run", "metrics.jsonl")) as f:
        want = [json.loads(line) for line in f]
    got = train_progressive_run.eval_schedule(
        [int(s) for s in args.steps_per_depth.split(",")], args.fade_pct,
        args.resume_k)
    assert len(want) == 36
    assert got == [(r["step"], r["depth"], r["local_step"], r["alpha"])
                   for r in want]


def test_fade_alpha_is_the_jax_tools():
    """The JAX tool's fade_alpha is a closure over its arguments: the same
    ramp, read off its committed run (alpha 0.5 at a quarter of a depth
    whose fade ends at the half)."""
    f = train_progressive_run.fade_alpha
    assert f(0, 1, 800, 50.0) == 1.0
    assert f(1, 200, 800, 50.0) == 0.5
    assert f(3, 800, 1600, 50.0) == 1.0 == f(3, 900, 1600, 50.0)
    assert f(2, 1, 2, 0.0) == 1.0


@pytest.mark.parametrize("res", [16, 32])
def test_eval_swd_with_jax_draws_matches_jax(res):
    rs = np.random.RandomState(res)
    reals = train_quality_run.structured_batch(rs, 8, res)
    fakes = np.tanh(rs.randn(8, res, res, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4321)
    want = jswd.sliced_wasserstein_distance(jnp.asarray(reals),
                                            jnp.asarray(fakes), key=key)
    shapes = [p.shape for p in jswd.laplacian_pyramid(
        jnp.asarray(reals), max(1, int(np.log2(res)) - 2))]
    draws = _jax_swd_draws(key, shapes, 2048, 128)
    got = train_quality_run.eval_swd_levels(torch.from_numpy(reals),
                                            torch.from_numpy(fakes),
                                            draws=draws)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    rounded = train_quality_run.swd_x1e3(torch.from_numpy(reals),
                                         torch.from_numpy(fakes))
    assert rounded.keys() == want.keys()


PROG = ["--res", "16", "--steps_per_depth", "2,2,4", "--batches", "4,4,4",
        "--resume_k", "3", "--pool", "64", "--device", "cpu"]


def _verify(out):
    return subprocess.run(
        [sys.executable, "-m", "stylegan_torch.tools.train_progressive_run",
         *PROG, "--out", out, "--verify_resume"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def progressive(tmp_path_factory):
    out = tmp_path_factory.mktemp("progressive")
    summary = train_progressive_run.main([*PROG, "--out", str(out)])
    yield str(out), summary
    shutil.rmtree(out, ignore_errors=True)


def test_progressive_run_outputs(progressive):
    out, summary = progressive
    with open(os.path.join(DOCS, "progressive_run", "summary.json")) as f:
        want = json.load(f)
    with open(os.path.join(out, "summary.json")) as f:
        got = json.load(f)
    assert got.keys() == want.keys()
    assert got["history"][0].keys() == want["history"][0].keys()
    assert summary["depths_completed"] == 3 and summary["total_steps"] == 8
    assert summary["aborted"] is None
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs == got["history"]
    assert [(r["step"], r["depth"], r["local_step"], r["alpha"])
            for r in recs] == train_progressive_run.eval_schedule(
                [2, 2, 4], 50.0, 3)
    assert all(np.isfinite(r["swd_x1e3"]["avg"]) for r in recs)
    for name in ("boundary_ckpt.npz", "boundary_rng.npz",
                 "resume_expected.json", "grid_d0_000000.png",
                 "grid_d2_000004.png"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "resume_expected.json")) as f:
        expected = json.load(f)
    assert expected["depth"] == 2 and len(expected["losses"]) == 3


def test_progressive_resume_is_bitwise_in_a_fresh_process(progressive):
    out, _ = progressive
    r = _verify(out)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line == {"steps_replayed": 3, "max_abs_diff": 0.0,
                    "bit_identical": True}
    with open(os.path.join(out, "resume_check.json")) as f:
        check = json.load(f)
    assert check["bit_identical"] is True
    assert check["expected"] == check["replayed"]
    assert check["deterministic"] == "cudnn.deterministic"
    assert check["device"] == "cpu"


def test_progressive_resume_without_the_z_stream_fails(progressive,
                                                       tmp_path):
    """The check checks: the same sidecar with the z stream's state left
    out (the seed's fresh stream in its place) replays other z and exits
    1."""
    out, _ = progressive
    copy = str(tmp_path / "copy")
    shutil.copytree(out, copy)
    path = os.path.join(copy, "boundary_rng.npz")
    side = dict(np.load(path))
    fresh = torch.Generator().manual_seed(0).get_state().numpy()
    assert not np.array_equal(side["z_state"], fresh)
    side["z_state"] = fresh
    np.savez(path, **side)
    r = _verify(copy)
    assert r.returncode == 1, f"{r.stdout}\n{r.stderr}"
    with open(os.path.join(copy, "resume_check.json")) as f:
        check = json.load(f)
    assert check["bit_identical"] is False and check["max_abs_diff"] > 0


# --------------------------------------------------------------------------
# the conditional and quality tools

def _keys_of(path):
    with open(path) as f:
        d = json.load(f)
    return set(d), set(d["history"][0])


def test_conditional_run_keys_are_the_jax_runs(tmp_path):
    out = str(tmp_path / "cond")
    summary = train_conditional_run.main(
        ["--res", "8", "--steps", "2", "--eval_every", "1", "--batch", "4",
         "--pool_per_class", "4", "--out", out, "--device", "cpu"])
    assert _keys_of(os.path.join(out, "summary.json")) == _keys_of(
        os.path.join(DOCS, "conditional_run", "summary.json"))
    assert summary["steps_completed"] == 2
    assert isinstance(summary["conditioning_separates"], bool)
    for k in range(4):
        for name in (f"reals_c{k}.png", f"grid_c{k}_000000.png",
                     f"grid_c{k}_000002.png"):
            assert os.path.exists(os.path.join(out, name)), name


def test_quality_run_keys_are_the_jax_runs(tmp_path):
    out = str(tmp_path / "qual")
    summary = train_quality_run.main(
        ["--res", "8", "--steps", "2", "--eval_every", "1", "--grid_every",
         "2", "--batch", "4", "--out", out, "--device", "cpu"])
    assert _keys_of(os.path.join(out, "summary.json")) == _keys_of(
        os.path.join(DOCS, "quality_run", "summary.json"))
    assert summary["steps_completed"] == 2
    assert np.isfinite(summary["swd_avg_last"])
    for name in ("reals.png", "grid_000000.png", "grid_000002.png"):
        assert os.path.exists(os.path.join(out, name)), name


@pytest.mark.parametrize("conditional", [False, True],
                         ids=["unconditional", "conditional"])
def test_step_and_eval_epilogue_calls(conditional):
    """One train step at depth d makes 2(d+1) forward and 2(d+1) backward
    epilogue calls (one G forward per update, the G backward), an eval
    8 x 2(d+1) forward calls: the counts phase 13 holds the card to."""
    if conditional:
        trainer = train_quality_run.build_trainer(
            8, 0, "cpu", conditional=True, n_classes=4,
            loss="conditional-loss", r1_interval=1, fuse_scores=False,
            reuse_g_fwd=False)
    else:
        trainer = train_quality_run.build_trainer(8, 0, "cpu")
    depth = trainer.depth - 1
    reals = train_quality_run.structured_batch(np.random.RandomState(0), 2, 8)
    labels = np.array([0, 3], np.int64) if conditional else None
    fused.plain_calls = 0
    trainer.train_on_batch(reals, depth, 1.0, labels=labels)
    per_forward = 2 * (depth + 1)
    # on the CPU a call of the plain forward and of its VJP count one each;
    # the conditional trainer runs G's forward once for D, once for G
    assert fused.plain_calls == (3 if conditional else 2) * per_forward
    fused.plain_calls = 0
    z = train_quality_run.eval_latents(trainer)
    avg = trainer.state.g_shadow.truncation.avg_latent.clone()
    fakes = train_quality_run.sample_shadow(trainer, depth, z,
                                            label=1 if conditional else None)
    assert fused.plain_calls == 8 * per_forward
    assert tuple(fakes.shape) == (256, 8, 8, 3)
    assert torch.equal(avg, trainer.state.g_shadow.truncation.avg_latent)


# --------------------------------------------------------------------------
# the kernels' plans at the tools' planes

# (batch, resolution, channels): the 128^2 progressive schedule's depths and
# the 64^2 conditional run's at batch 32 (chip_smoke.py's EVIDENCE_PLANES)
EVIDENCE_PLANES = [(128, 4, 512), (128, 8, 512), (128, 16, 512),
                   (64, 32, 512), (32, 64, 256), (16, 128, 128),
                   (32, 4, 512), (32, 8, 512), (32, 16, 512), (32, 32, 512)]


@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,res,c", EVIDENCE_PLANES,
                         ids=[f"{b}x{r}x{r}x{c}" for b, r, c in
                              EVIDENCE_PLANES])
def test_plans_at_the_tools_planes(plan_lib, b, res, c, bf16):
    """Forward and train-step backward plans cover every row and channel
    once and fit the card's shared memory at the tools' batches (up to 128,
    where the main path's are 1, 2 and 8)."""
    p = plan(plan_lib, bf16, b, res * res, c)
    check_plan(p, b, res * res, c, bf16, 1)
    q = bwd_plan(plan_lib, bf16, b, res * res, c)
    check_bwd_plan(q, b, res * res, c, bf16, 1, 0)


# --------------------------------------------------------------------------
# measure_latency and the fidelity gate

def test_measure_latency_runs_on_the_cpu():
    from stylegan_torch.models import SynthesisConfig
    cfg = measure_latency.flagship_config(8)
    assert cfg.truncation_psi == 0.7 and cfg.mapping.mapping_layers == 8
    assert cfg.mapping.dlatent_broadcast == 4
    assert cfg.synthesis.blur_filter == (1, 2, 1)
    full = measure_latency.flagship_config()
    assert full.resolution == 1024 and full.mapping.dlatent_broadcast == 18
    assert isinstance(full.synthesis, SynthesisConfig)
    lines = []
    res = measure_latency.measure(cfg, torch.device("cpu"), batches=(1, 2),
                                  iters=2, trials=2, log=lines.append)
    assert set(res) == {1, 2} and len(lines) == 2
    for b, r in res.items():
        assert set(r) == {"latency_ms_raw", "imgs_per_sec_raw"}
        assert r["latency_ms_raw"] > 0
        assert abs(r["imgs_per_sec_raw"] - b / r["latency_ms_raw"] * 1e3) \
            <= 1e-6 * r["imgs_per_sec_raw"]


GATE_RES = 16


@pytest.fixture(scope="module")
def gate_assets(tmp_path_factory):
    from PIL import Image

    from stylegan_torch.metrics import inception_v3_init
    tmp = tmp_path_factory.mktemp("gate")
    cfg = JaxGeneratorConfig(
        resolution=GATE_RES,
        mapping=JaxMappingConfig(latent_size=512, mapping_layers=2,
                                 dlatent_broadcast=6),
        synthesis=JaxSynthesisConfig(resolution=GATE_RES,
                                     blur_filter=(1, 2, 1),
                                     structure="linear"))
    params = generator_init(jax.random.PRNGKey(0), cfg)
    pkl = build_fake_pickle(tmp, params, 2)
    inception = str(tmp / "inception.npz")
    np.savez(inception, **inception_v3_init(1))
    img_dir = tmp / "reals"
    os.makedirs(img_dir)
    rs = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rs.randint(0, 255, (GATE_RES, GATE_RES, 3),
                                   dtype=np.uint8)).save(img_dir / f"{i}.png")
    yield tmp, pkl, inception, str(img_dir), cfg
    shutil.rmtree(tmp, ignore_errors=True)


def _gate(args):
    with pytest.raises(SystemExit) as e:
        fidelity_gate.main(args)
    return e.value.code


def test_gate_on_a_synthetic_pickle(gate_assets, capsys):
    tmp, pkl, inception, img_dir, cfg = gate_assets
    out = str(tmp / "gate_out")
    code = _gate(["--pickle", pkl, "--res", str(GATE_RES),
                  "--mapping_layers", "2", "--images", img_dir,
                  "--inception", inception, "--out", out, "--num_samples",
                  "4", "--batch", "2", "--skip_golden", "--device", "cpu"])
    assert code == 0
    with open(os.path.join(out, "gate.json")) as f:
        gate = json.load(f)
    assert gate["pass"] is True and gate["failures"] == []
    assert gate["stages"]["convert"]["ok"] is True
    assert gate["stages"]["golden"] == {"ok": None,
                                        "skipped": "--skip_golden"}
    assert isinstance(gate["stages"]["fid"]["fid"], float)
    assert gate["stages"]["ppl"]["ok"] is None
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["pass"] is True
    # the converted .npz: every tensor the pickle holds bitwise the JAX
    # package's conversion of it
    flat, meta = load_params(gate["stages"]["convert"]["converted_npz"])
    assert meta == {"source": os.path.basename(pkl)}
    want = jtf.import_official_generator(
        pkl, generator_init(jax.random.PRNGKey(0), cfg), 2,
        report=lambda m: None)
    want_sd = generator_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, want))
    nets = jtf.load_tf_networks(pkl)
    translated = set(jtf.tf_vars_to_state_dict(
        jtf.collect_variables(nets[2]), 2))
    gen = Generator(fidelity_gate.gate_config(GATE_RES, 2))
    gen.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in want_sd.items()})
    want_flat = flat_from_state_dict(gen.state_dict())
    assert set(flat) == set(want_flat)
    checked = 0
    for path, v in flat.items():
        key = path.replace(".noise.weight", ".top_epi.noise.weight")
        if key in translated:
            assert np.array_equal(v, want_flat[path]), path
            checked += 1
    assert checked == len(translated & set(want_sd)) > 20


def test_gate_fails_on_a_mismatched_res(gate_assets, tmp_path):
    _, pkl, _, _, _ = gate_assets
    out = str(tmp_path / "gate_bad")
    code = _gate(["--pickle", pkl, "--res", "32", "--mapping_layers", "2",
                  "--out", out, "--skip_golden", "--device", "cpu"])
    assert code not in (0, None)
    with open(os.path.join(out, "gate.json")) as f:
        gate = json.load(f)
    assert gate["pass"] is False
    assert gate["stages"]["convert"]["ok"] is False


def test_gate_skips_golden_without_the_reference(gate_assets, tmp_path):
    _, pkl, _, _, _ = gate_assets
    out = str(tmp_path / "gate_noref")
    code = _gate(["--pickle", pkl, "--res", str(GATE_RES),
                  "--mapping_layers", "2", "--out", out, "--reference",
                  str(tmp_path / "absent"), "--device", "cpu"])
    assert code == 0
    with open(os.path.join(out, "gate.json")) as f:
        gate = json.load(f)
    assert gate["stages"]["golden"]["ok"] is None
    assert "reference not found" in gate["stages"]["golden"]["skipped"]


@pytest.mark.parametrize("tool,argv", [
    (train_quality_run, []),
    (train_progressive_run, []),
    (train_conditional_run, []),
    (measure_latency, []),
    (fidelity_gate, ["--pickle", "absent.pkl"]),
], ids=["quality", "progressive", "conditional", "latency", "gate"])
def test_tools_refuse_missing_cuda(tool, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
