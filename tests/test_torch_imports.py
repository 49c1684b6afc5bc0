"""The port imports nothing of JAX or of the JAX package: an AST scan of its
sources and of chip_smoke.py, and a subprocess that imports every port
module and compares sys.modules before and after."""

import ast
import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "stylegan_tpu")
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
