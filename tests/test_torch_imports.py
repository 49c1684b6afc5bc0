"""The port imports nothing of JAX or of the JAX package: an AST scan of its
sources and of chip_smoke.py, and a subprocess that imports every port
module and compares sys.modules before and after.  The JAX system's root
tools/ (as a package, or by the bare module names its scripts import each
other by) and bench.py count as the JAX package."""

import ast
import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = tuple(sorted(
    os.path.basename(p)[:-3]
    for p in glob.glob(os.path.join(REPO, "tools", "*.py"))))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "stylegan_tpu", "tools",
             "bench") + JAX_TOOLS
SOURCES = sorted(glob.glob(os.path.join(REPO, "stylegan_torch", "**", "*.py"),
                           recursive=True)) + [os.path.join(REPO,
                                                            "chip_smoke.py")]


def _modules():
    for path in SOURCES[:-1]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    assert len(SOURCES) > 15
    bad = []
    for path in SOURCES:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imported_names(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"forbidden = {FORBIDDEN!r}\n"
        "def hits():\n"
        "    return {m for m in sys.modules if m.split('.')[0] in forbidden}\n"
        "before = hits()\n"
        f"for m in {sorted(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(hits() - before))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_parallel_package_and_rank_bodies_import_no_jax():
    """stylegan_torch/parallel/ is in the scan above, and the rank bodies
    that tests/test_torch_parallel.py spawns import neither JAX nor the
    JAX package (a rank imports torch and the port only)."""
    for name in ("__init__", "mesh", "distributed"):
        assert os.path.join(REPO, "stylegan_torch", "parallel",
                            f"{name}.py") in SOURCES
    worker = os.path.join(REPO, "tests", "torch_parallel_worker.py")
    with open(worker) as f:
        names = list(_imported_names(ast.parse(f.read(), worker)))
    assert "stylegan_torch.parallel" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_spatial_modules_and_rank_bodies_import_no_jax():
    """The spatial path's modules are in the scan above, and the rank
    bodies that tests/test_torch_spatial.py spawns import neither JAX nor
    the JAX package."""
    for name in ("spatial", "halo"):
        assert os.path.join(REPO, "stylegan_torch", "parallel",
                            f"{name}.py") in SOURCES
    worker = os.path.join(REPO, "tests", "torch_spatial_worker.py")
    with open(worker) as f:
        names = list(_imported_names(ast.parse(f.read(), worker)))
    assert "stylegan_torch.parallel" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_port_tools_are_scanned_and_import_no_jax():
    """stylegan_torch/tools/ (the evidence tools among them) is in the scan
    above, FORBIDDEN names the JAX system's tools, and importing each port
    tool in a fresh process loads neither them nor JAX."""
    assert {"train_quality_run", "train_progressive_run",
            "train_conditional_run", "make_synthetic_dataset",
            "measure_latency", "fidelity_gate"} <= set(JAX_TOOLS)
    tools = sorted(glob.glob(os.path.join(REPO, "stylegan_torch", "tools",
                                          "*.py")))
    assert len(tools) >= 10 and set(tools) <= set(SOURCES)
    names = [f"stylegan_torch.tools.{os.path.basename(p)[:-3]}"
             for p in tools if not p.endswith("__init__.py")]
    code = (
        "import sys, importlib\n"
        f"forbidden = {FORBIDDEN!r}\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in forbidden))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout
