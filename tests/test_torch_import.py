"""The PyTorch port stands alone: importing ``repro_torch`` (every
submodule), ``chip_smoke``, ``chip_ab`` and the port's scripts (the four
``examples/*_torch.py``, ``experiments/hillclimb_torch.py``,
``tools/trace_report_torch.py``, ``tools/lint_torch/engine_lint.py``)
pulls in neither JAX nor the ``repro`` package, and no source of any of
them imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = (sorted((ROOT / "examples").glob("*_torch.py"))
           + [ROOT / "experiments" / "hillclimb_torch.py",
              ROOT / "tools" / "trace_report_torch.py",
              ROOT / "tools" / "lint_torch" / "engine_lint.py"])
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_ab.py", *SCRIPTS]

_CHECK = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_import_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    assert len(SCRIPTS) == 7 and all(p.exists() for p in SCRIPTS)
    out = subprocess.run([sys.executable, "-c", _CHECK,
                          str(ROOT / "chip_smoke.py"), *map(str, SCRIPTS)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", out.stdout


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax_or_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
