"""EL004 — host syncs in the port's step loop and step modules.

Two scopes, one pragma tag (``host-sync``):

* The engine (``serving/engine.py``), with the reference rule's taint:
  names bound from the *first* element of a ``self._timed(...)`` unpack
  are device values (``(next_toks, self.cache), dt = self._timed(...)``
  taints ``next_toks`` and ``self.cache``; ``dt`` is a host float).
  Forcing one to the host is flagged: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")`` / ``.to(device="cpu")`` (a
  chain such as ``x.cpu().numpy()`` once, at its first sync),
  ``float/int/bool(x)`` and ``np.asarray/np.array(x)``, where ``x`` may
  be indexed or reached through method calls (``out[0]``,
  ``out.sum()``). ``torch.cuda.synchronize`` is flagged anywhere in the
  engine. The output-token stream, the router scores and ``_timed``'s own
  measurement carry ``# el: allow[host-sync]`` with a reason.
* The step modules (``models/``, ``core/lora.py``, ``kernels/ops.py`` and
  the four kernel wrappers), with no taint: they run inside every step,
  eagerly, where the reference's run under ``jax.jit`` and cannot sync.
  Any ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``.nonzero()``, ``.unique()``, ``.masked_select()``,
  ``torch.cuda.synchronize``, ``torch.nonzero``, ``torch.unique`` or
  ``torch.masked_select`` there is flagged.

``serving/kvpool.py`` and ``serving/prefix_cache.py`` stay out: their
allocators run on numpy, whose ``.item()`` / ``.tolist()`` a syntax rule
cannot tell from torch's.
"""
from __future__ import annotations

import ast

from tools.lint.framework import (
    ImportMap, Rule, SourceFile, Violation, dotted, in_scope)

ENGINE = "src/repro_torch/serving/engine.py"
STEP_MODULES = ("src/repro_torch/models/",)
STEP_FILES = tuple(f"src/repro_torch/{p}.py" for p in (
    "core/lora", "kernels/ops", "kernels/sgmv", "kernels/paged_gather",
    "kernels/decode_attention", "kernels/flash_prefill"))

# methods that copy a tensor to the host (and wait for the device)
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# methods whose output shape depends on the data: the host waits for it
DATA_SHAPED_METHODS = frozenset({"nonzero", "unique", "masked_select"})
SYNC_FUNCS = {"numpy.asarray": "np.asarray", "numpy.array": "np.array"}
SYNC_BUILTINS = frozenset({"float", "int", "bool"})
DEVICE_SYNC = "torch.cuda.synchronize"
DATA_SHAPED_FUNCS = frozenset(
    {"torch.nonzero", "torch.unique", "torch.masked_select"})


def _is_cpu(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _sync_method(call: ast.Call,
                 methods: frozenset[str]) -> tuple[str, ast.expr] | None:
    """``(name, receiver)`` when ``call`` is a host-forcing method call
    (one of ``methods``, or ``.to("cpu")``), else None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in methods or func.attr == "to" and (
            any(_is_cpu(a) for a in call.args[:1])
            or any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in call.keywords)):
        return func.attr, func.value
    return None


def _root(expr: ast.expr,
          methods: frozenset[str]) -> tuple[str | None, bool]:
    """The dotted name a value is reached from through indexing and
    method calls (``out[0].sum()`` -> ``out``), and whether that path
    already holds a host-forcing method call (flagged on its own)."""
    synced = False
    while True:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute):
            synced = synced or _sync_method(expr, methods) is not None
            expr = expr.func.value
        else:
            return dotted(expr), synced


def _leaves(target: ast.expr) -> list[str]:
    """Dotted names a (nested) unpack target binds."""
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _leaves(elt)]
    if isinstance(target, ast.Starred):
        return _leaves(target.value)
    name = dotted(target)
    return [name] if name else []


class PortHostSyncRule(Rule):
    rule_id = "EL004"
    pragma_tag = "host-sync"
    description = ("no un-pragma'd host syncs on _timed outputs or "
                   "torch.cuda.synchronize in the port's engine, and none "
                   "at all in its step modules (models, LoRA, kernels)")

    def applies(self, relpath: str) -> bool:
        return relpath == ENGINE or relpath in STEP_FILES \
            or in_scope(relpath, STEP_MODULES)

    def check(self, src: SourceFile) -> list[Violation]:
        imports = ImportMap(src.tree)
        if src.relpath != ENGINE:
            return self._check_step_module(src, imports)
        out: list[Violation] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) \
                    and imports.resolve(node.func) == DEVICE_SYNC:
                self._add(src, out, node, "device-wide sync "
                          "`torch.cuda.synchronize()` in the engine")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_function(src, imports, node))
        # a nested def is walked with its enclosing one and on its own
        return sorted(set(out), key=Violation.sort_key)

    def _add(self, src: SourceFile, out: list[Violation], node: ast.AST,
             what: str) -> None:
        v = self.report(
            src, node,
            f"host sync: {what} — if this round-trip is intentional, "
            f"pragma it with a reason: `# el: allow[host-sync] -- why`")
        if v is not None:
            out.append(v)

    def _check_function(self, src: SourceFile, imports: ImportMap,
                        func: ast.AST) -> list[Violation]:
        tainted: set[str] = set()
        for node in ast.walk(func):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "_timed"):
                continue
            for target in node.targets:
                if isinstance(target, (ast.Tuple, ast.List)) and target.elts:
                    tainted.update(_leaves(target.elts[0]))
                else:
                    tainted.update(_leaves(target))
        if not tainted:
            return []

        out: list[Violation] = []
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            sync = _sync_method(node, SYNC_METHODS)
            if sync is not None:
                name, inner = _root(sync[1], SYNC_METHODS)
                if name in tainted and not inner:
                    self._add(src, out, node, f"`.{sync[0]}()` on device "
                              f"value `{name}` (a _timed output) in the "
                              f"step loop")
                continue
            if not node.args:
                continue
            name, inner = _root(node.args[0], SYNC_METHODS)
            if name not in tainted or inner:
                continue
            resolved = imports.resolve(node.func)
            if resolved in SYNC_FUNCS:
                what = f"{SYNC_FUNCS[resolved]}({name})"
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in SYNC_BUILTINS:
                what = f"{node.func.id}({name})"
            else:
                continue
            self._add(src, out, node, f"`{what}` on a _timed output in "
                      f"the step loop")
        return out

    def _check_step_module(self, src: SourceFile,
                           imports: ImportMap) -> list[Violation]:
        out: list[Violation] = []
        methods = SYNC_METHODS | DATA_SHAPED_METHODS
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = imports.resolve(node.func)
            if resolved == DEVICE_SYNC or resolved in DATA_SHAPED_FUNCS:
                self._add(src, out, node, f"`{resolved}()` in a step "
                          f"module (runs inside every step)")
                continue
            sync = _sync_method(node, methods)
            if sync is None or _root(sync[1], methods)[1]:
                continue  # not a sync, or the chain's first is flagged
            self._add(src, out, node, f"`.{sync[0]}()` in a step module "
                      f"(runs inside every step; the reference's run "
                      f"under jax.jit, where no sync can be written)")
        return out
