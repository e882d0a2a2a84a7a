"""EL002 — tracer fast-path guards, over the port.

The contract is the reference's (``tools/lint/rules/el002_tracer.py``):
with ``tracer=None`` the port's engine is bit-identical to the untraced
one, so every tracer attribute use sits inside an ``is not None`` guard.
Only the scope changes: the port's serving/ + core/, minus its
``serving/trace.py``.
"""
from __future__ import annotations

from tools.lint.framework import in_scope
from tools.lint.rules.el002_tracer import TracerGuardRule

SCOPE = ("src/repro_torch/serving/", "src/repro_torch/core/")
EXCLUDE = ("src/repro_torch/serving/trace.py",)


class PortTracerGuardRule(TracerGuardRule):
    def applies(self, relpath: str) -> bool:
        return in_scope(relpath, SCOPE, exclude=EXCLUDE)
