"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program."""

import ast
import subprocess
import sys

from gpubench.conftest import BENCH
from gpubench.run import BANNED

PROGRAM = "stylegan_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_names_jax():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(BANNED), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert PROGRAM not in names and not names & set(BANNED), path


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, runpy, glob\n"
        "import gpubench.run, gpubench.drive, gpubench.control, "
        "gpubench.program, gpubench.trace\n"
        "from gpubench import cells\n"
        "for p in sorted(glob.glob('gpubench/metrics/*.py')):\n"
        "    cells.reader(p.split('/')[-1][:-3])\n"
        "for p in sorted(glob.glob('gpubench/traffic/*.py')):\n"
        "    cells.kind(p.split('/')[-1][:-3])\n"
        "import stylegan_torch.serving, stylegan_torch.cli.train\n"
        "print(gpubench.run.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
