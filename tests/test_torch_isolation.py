"""The port stands alone: no module of ``src/repro_torch`` (its lint
fixtures included), nor ``chip_smoke.py`` or the port's examples, imports
JAX or the JAX package, and every source but the fixtures (each of which
breaks a rule on purpose) passes the JAX package's lint gate and the
port's own (``repro_torch.analysis.lint``)."""
import ast
import os
import subprocess
import sys

import pytest

from repro.analysis import lint
from repro_torch.analysis import lint as port_lint
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _sources(include_fixtures=True):
    for dirpath, _, files in os.walk(PKG):
        if not include_fixtures and "fixtures" in dirpath.split(os.sep):
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for name in ("torch_quickstart", "torch_serve_retrieval",
                 "torch_serve_stream", "torch_train_lm_small",
                 "torch_calibration_sweep"):
        yield os.path.join(ROOT, "examples", f"{name}.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", sorted(_sources(include_fixtures=False)),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_passes_the_lint_gate(path):
    active = [v.render() for v in lint.lint_file(path) if not v.suppressed]
    assert not active, active
    active = [v.render() for v in port_lint.lint_file(path)
              if not v.suppressed]
    assert not active, active
