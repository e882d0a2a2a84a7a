"""EL006 — hook hygiene, over the port.

The contract is the reference's (``tools/lint/rules/el006_hooks.py``):
every ``X.on_event = hook`` wiring sits in a ``try`` whose ``finally``
sets ``X.on_event = None``. Scope: all of ``src/repro_torch/``.
"""
from __future__ import annotations

from tools.lint.framework import in_scope
from tools.lint.rules.el006_hooks import HookHygieneRule

SCOPE = ("src/repro_torch/",)


class PortHookHygieneRule(HookHygieneRule):
    def applies(self, relpath: str) -> bool:
        return in_scope(relpath, SCOPE)
