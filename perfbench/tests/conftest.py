"""The benchmark's own tests: the harness on the CPU at a tiny size (the
kernel wrappers run their plain versions), and, marked ``cuda``, on the
card. Run from the repository's root:

    python -m pytest -q perfbench/tests
"""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (HERE, ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
