"""EL001 — virtual-clock purity, over the port.

The reference rule's calls (``time.perf_counter()``, ``datetime.now()``,
stdlib ``random``, numpy's global RNG, unseeded ``default_rng()``) are
flagged over the port's serving/ and core/, and two ways the port can
reach the same ambient sources without spelling such a call:

* the wall clock through a binding: the ``time`` module, or one of its
  clock functions, used as a value (``timer = time``,
  ``clock = time.perf_counter``), and ``.perf_counter()`` /
  ``.monotonic()`` / ``.time()`` (or the direct call) on a name bound
  from one (``self._timer = timer if timer is not None else time`` makes
  every ``self._timer.perf_counter()`` a wall-clock read);
* torch's global RNG, the counterpart of numpy's: ``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial`` and the in-place ``.uniform_`` / ``.normal_`` /
  ``.random_`` / ``.exponential_`` / ``.bernoulli_`` without a
  ``generator=``, and ``torch.manual_seed`` / ``torch.seed``.

Bindings are tracked by dotted name across the file (an attribute set in
``__init__`` is read in other methods), whether or not the binding site
itself carries a pragma. The sanctioned sites are the engine's
``_timed`` measurement and its default timer, with ``# el: allow[clock]``.
"""
from __future__ import annotations

import ast

from tools.lint.framework import (
    ImportMap, SourceFile, Violation, dotted, in_scope)
from tools.lint.rules.el001_clock import BANNED_CALLS, ClockPurityRule

SCOPE = ("src/repro_torch/serving/", "src/repro_torch/core/")

# the time module and its clock functions, as values
CLOCK_VALUES = frozenset(
    {"time"} | {k for k in BANNED_CALLS if k.startswith("time.")})
# the methods that read a clock bound from one of CLOCK_VALUES
CLOCK_METHODS = frozenset(k.split(".", 1)[1] for k in CLOCK_VALUES
                          if k != "time")
# torch's global-RNG draws: flagged unless given a generator=
TORCH_RNG_CALLS = frozenset(
    f"torch.{n}" for n in ("rand", "randn", "randint", "randperm",
                           "normal", "bernoulli", "multinomial"))
TORCH_RNG_INPLACE = frozenset(
    {"uniform_", "normal_", "random_", "exponential_", "bernoulli_"})
# reseeding torch's global RNG: always flagged
TORCH_SEEDING = frozenset({"torch.manual_seed", "torch.seed"})


def _parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    return {child: node for node in ast.walk(tree)
            for child in ast.iter_child_nodes(node)}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


class PortClockPurityRule(ClockPurityRule):
    description = ("no wall-clock or ambient-RNG reads in the port's "
                   "serving/core: the reference's calls, the time module "
                   "or a clock bound as a value, torch's global RNG")

    def applies(self, relpath: str) -> bool:
        return in_scope(relpath, SCOPE)

    @staticmethod
    def clock_values(tree: ast.Module,
                     imports: ImportMap) -> list[tuple[ast.expr, str]]:
        """Every use of the time module or a clock function as a value
        (not the callee of a call, which the reference rule checks, and
        not the root of a longer attribute chain such as ``time.sleep``)."""
        parents = _parents(tree)
        out: list[tuple[ast.expr, str]] = []
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Name, ast.Attribute)) \
                    or not isinstance(node.ctx, ast.Load):
                continue
            target = imports.resolve(node)
            if target not in CLOCK_VALUES:
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and parent.value is node:
                continue
            if isinstance(parent, ast.Call) and parent.func is node:
                continue
            out.append((node, target))
        return out

    def check(self, src: SourceFile) -> list[Violation]:
        out = super().check(src)
        imports = ImportMap(src.tree)

        def add(node: ast.AST, msg: str) -> None:
            v = self.report(src, node, msg)
            if v is not None:
                out.append(v)

        values = self.clock_values(src.tree, imports)
        for node, target in values:
            add(node, f"wall clock `{target}` used as a value — whatever "
                      f"is bound from it reads wall time (pragma a "
                      f"measurement site with `# el: allow[clock]`)")
        # names bound from an expression holding such a value
        value_nodes = {id(n) for n, _ in values}
        bound: set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            if any(id(sub) in value_nodes for sub in ast.walk(node.value)):
                bound.update(d for d in map(dotted, targets) if d)

        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if bound:
                if isinstance(func, ast.Attribute) \
                        and func.attr in CLOCK_METHODS \
                        and dotted(func.value) in bound:
                    add(node, f"wall-clock read `{dotted(func)}()` — "
                              f"`{dotted(func.value)}` is bound from the "
                              f"time module; engine time is virtual")
                    continue
                if dotted(func) in bound:
                    add(node, f"wall-clock read `{dotted(func)}()` — bound "
                              f"from the time module; engine time is "
                              f"virtual")
                    continue
            target = imports.resolve(func)
            if target in TORCH_SEEDING:
                add(node, f"`{target}()` reseeds torch's global RNG — "
                          f"seed a dedicated `torch.Generator` instead")
            elif target in TORCH_RNG_CALLS and not _has_generator(node):
                add(node, f"torch global-state RNG `{target}()` — pass "
                          f"`generator=` a seeded `torch.Generator`")
            elif isinstance(func, ast.Attribute) \
                    and func.attr in TORCH_RNG_INPLACE \
                    and not _has_generator(node):
                add(node, f"in-place draw `.{func.attr}()` from torch's "
                          f"global RNG — pass `generator=` a seeded "
                          f"`torch.Generator`")
        return out
