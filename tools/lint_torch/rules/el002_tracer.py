"""EL002 — tracer fast-path guards, over the port.

The contract is the reference's (``tools/lint/rules/el002_tracer.py``):
with ``tracer=None`` the port's engine is bit-identical to the untraced
one, so every tracer attribute use sits inside an ``is not None`` guard.
The scope is the port's serving/ + core/, minus its
``serving/trace.py``.

The port adds one record the reference does not have, the wall spans
(``EngineTracer(wall_spans=True)``): off by default, reached as a
tracer's ``.wall_spans`` or through the module handle ``spans.wall``.
Any ``X.wall_spans`` or ``X.wall`` expression is held to the same guard
as ``X.tracer``, and so is a name bound from one, also through a
conditional (``sp = tr.wall_spans if tr is not None else None``).
"""
from __future__ import annotations

import ast

from tools.lint.framework import dotted, in_scope
from tools.lint.rules.el002_tracer import TracerGuardRule, _FunctionChecker

SCOPE = ("src/repro_torch/serving/", "src/repro_torch/core/")
EXCLUDE = ("src/repro_torch/serving/trace.py",)
SPAN_ATTRS = ("tracer", "wall_spans", "wall")


class _PortChecker(_FunctionChecker):
    def key(self, node: ast.expr):
        if isinstance(node, ast.Name) and node.id in self.aliases:
            return ("name", node.id)
        if isinstance(node, ast.Attribute) and node.attr in SPAN_ATTRS:
            d = dotted(node)
            if d is not None:
                return ("attr", d)
        return None

    def visit_stmt(self, stmt: ast.stmt, guarded: frozenset) -> frozenset:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def checks with this class too (the reference
            # builds its own checker there)
            sub = _PortChecker(self.rule, self.src, self.aliases)
            sub.visit_stmts(stmt.body, frozenset())
            self.violations.extend(sub.violations)
            return guarded
        out = super().visit_stmt(stmt, guarded)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.IfExp) \
                and (self.key(stmt.value.body) is not None
                     or self.key(stmt.value.orelse) is not None):
            self.aliases.add(stmt.targets[0].id)
        return out


class PortTracerGuardRule(TracerGuardRule):
    def applies(self, relpath: str) -> bool:
        return in_scope(relpath, SCOPE, exclude=EXCLUDE)

    def check(self, src):
        return _PortChecker(self, src, aliases=set()).run(src.tree.body)
