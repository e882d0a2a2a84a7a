"""EL003 — compile and cache registry, over the port.

The reference's EL003 registers every ``jax.jit`` site: each is a
compile-cache dimension whose bound must be known. The port has no jit;
its per-shape and per-stream state lives in two kinds of site instead,
both of which must appear in ``tools/lint_torch/compile_registry.json``:

* every compile or capture call: ``torch.compile``,
  ``torch.jit.script`` / ``trace``, ``torch.cuda.graph``,
  ``torch.cuda.CUDAGraph``, ``torch.cuda.make_graphed_callables``
  (called, or as a bare decorator);
* every module-level dict that its module writes under a *computed* key,
  by subscript assignment or ``setdefault``: a cache that grows with the
  keys its callers bring. A counter written only under constant keys
  (``launches["sgmv_shrink"] += 1``), or rewritten only under the keys a
  loop takes from the dict itself (``for k in launches: launches[k] =
  0``), holds a fixed set of keys and is not a cache.

Site identity is the reference's ``relpath::scope::bound_name`` (a cache
is ``relpath::<module>::NAME``, reported at its definition). Each entry
is an object stating the site's ``kind`` (``compile`` or ``cache``), its
``key``, why it is ``bounded``, whether it is ``stream_keyed`` (CUDA-graph
capture runs on a stream of its own, so such a site gains an entry
there), and its ``bound``: the most entries it can hold in a one-card
process, or null where no number can be given. A missing entry, a
malformed one, and a stale one (file scanned, site gone) are violations.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Any

from tools.lint.framework import (
    ImportMap, Rule, SourceFile, Violation, in_scope)

SCOPE = ("src/repro_torch/",)
REGISTRY_PATH = (Path(__file__).resolve().parent.parent
                 / "compile_registry.json")
REGISTRY_RELPATH = "tools/lint_torch/compile_registry.json"

COMPILE_CALLS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.graph", "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables"})
DICT_FACTORIES = frozenset({
    "collections.defaultdict", "collections.OrderedDict"})
KINDS = ("compile", "cache")


def load_registry(path: Path = REGISTRY_PATH) -> dict[str, Any]:
    data = json.loads(path.read_text(encoding="utf-8"))
    sites = data.get("sites", {})
    if not isinstance(sites, dict):
        raise ValueError(f"{path}: 'sites' must be an object")
    return {str(k): v for k, v in sites.items()}


def entry_problem(entry: Any) -> str | None:
    """What is wrong with one registry entry, or None."""
    if not isinstance(entry, dict):
        return "must be an object"
    if entry.get("kind") not in KINDS:
        return f"'kind' must be one of {', '.join(KINDS)}"
    for field in ("key", "bounded"):
        value = entry.get(field)
        if not isinstance(value, str) or not value.strip():
            return f"'{field}' must be a non-empty note"
    if not isinstance(entry.get("stream_keyed"), bool):
        return "'stream_keyed' must be true or false"
    bound = entry.get("bound", False)
    if bound is not None and (isinstance(bound, bool)
                              or not isinstance(bound, int) or bound < 1):
        return "'bound' must be a positive integer or null"
    return None


def _is_dict_value(node: ast.expr | None, imports: ImportMap) -> bool:
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "dict":
            return True
        return imports.resolve(node.func) in DICT_FACTORIES
    return False


def _constant_key(key: ast.expr) -> bool:
    if isinstance(key, ast.Tuple):
        return all(_constant_key(e) for e in key.elts)
    return isinstance(key, ast.Constant)


def _loop_keys(target: ast.expr, it: ast.expr) -> set[tuple[str, str]]:
    """(dict, key name) pairs a ``for`` binds to a dict's own keys:
    ``for k in d``, ``d.keys()`` or ``for k, v in d.items()``."""
    method = None
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
            and it.func.attr in ("keys", "items") and not it.args:
        method, it = it.func.attr, it.func.value
    if not isinstance(it, ast.Name):
        return set()
    if method == "items" and isinstance(target, ast.Tuple) and target.elts:
        target = target.elts[0]
    return {(it.id, target.id)} if isinstance(target, ast.Name) else set()


class CompileRegistryRule(Rule):
    rule_id = "EL003"
    pragma_tag = "jit"
    description = ("every compile/capture call and module-level cache in "
                   "src/repro_torch/ must appear in tools/lint_torch/"
                   "compile_registry.json with its key and bound")

    def __init__(self, registry: dict[str, Any] | None = None) -> None:
        if registry is None:
            registry = load_registry() if REGISTRY_PATH.exists() else {}
        self.registry = registry
        self.seen: dict[str, str] = {}  # site -> kind
        self.scanned_files: set[str] = set()

    def applies(self, relpath: str) -> bool:
        return in_scope(relpath, SCOPE)

    def check(self, src: SourceFile) -> list[Violation]:
        imports = ImportMap(src.tree)
        self.scanned_files.add(src.relpath)
        out: list[Violation] = []
        counters: dict[str, int] = {}

        def record(scope: list[str], bound: str, node: ast.AST,
                   kind: str) -> None:
            base = f"{src.relpath}::{'.'.join(scope) or '<module>'}::{bound}"
            n = counters.get(base, 0)
            counters[base] = n + 1
            site = base if n == 0 else f"{base}#{n + 1}"
            self.seen[site] = kind
            entry = self.registry.get(site)
            if entry is None:
                msg = (f"unregistered {kind} site `{site}` — add it to "
                       f"{REGISTRY_RELPATH} with its key and bound")
            elif isinstance(entry, dict) and entry.get("kind") not in (
                    None, kind):
                msg = (f"`{site}` is a {kind} site but is registered as "
                       f"a {entry.get('kind')!r} site")
            else:
                return
            v = self.report(src, node, msg)
            if v is not None:
                out.append(v)

        for scope, bound, node in self._compile_sites(src.tree, imports):
            record(scope, bound, node, "compile")
        for name, node in self._caches(src.tree, imports):
            record([], name, node, "cache")
        return out

    # -- compile and capture calls ---------------------------------------

    @staticmethod
    def _calls_in(node: ast.AST, imports: ImportMap) -> list[ast.expr]:
        return [sub for sub in ast.walk(node) if isinstance(sub, ast.Call)
                and imports.resolve(sub.func) in COMPILE_CALLS]

    def _compile_sites(self, tree: ast.Module, imports: ImportMap
                       ) -> list[tuple[list[str], str, ast.expr]]:
        """(scope, bound name, node) of every compile or capture call,
        named as the reference names its jit sites."""
        sites: list[tuple[list[str], str, ast.expr]] = []

        def visit(stmts: list[ast.stmt], scope: list[str]) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in stmt.decorator_list:
                        if imports.resolve(dec) in COMPILE_CALLS:
                            sites.append((scope, stmt.name, dec))
                        sites.extend((scope, stmt.name, c)
                                     for c in self._calls_in(dec, imports))
                    visit(stmt.body, scope + [stmt.name])
                elif isinstance(stmt, ast.ClassDef):
                    visit(stmt.body, scope + [stmt.name])
                elif isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                       ast.AugAssign)):
                    if stmt.value is None:
                        continue
                    target = (stmt.targets[0] if isinstance(stmt, ast.Assign)
                              else stmt.target)
                    sites.extend((scope, ast.unparse(target), c)
                                 for c in self._calls_in(stmt.value, imports))
                elif isinstance(stmt, (ast.If, ast.For, ast.While, ast.With,
                                       ast.Try)):
                    # same binding scope, nested control flow
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            sites.extend((scope, "<anonymous>", c) for c in
                                         self._calls_in(child, imports))
                        elif isinstance(child, ast.withitem):
                            sites.extend(
                                (scope, "<anonymous>", c) for c in
                                self._calls_in(child.context_expr, imports))
                    for field in ("body", "orelse", "finalbody"):
                        visit(getattr(stmt, field, []), scope)
                    for handler in getattr(stmt, "handlers", []):
                        visit(handler.body, scope)
                else:
                    sites.extend((scope, "<anonymous>", c)
                                 for c in self._calls_in(stmt, imports))

        visit(tree.body, [])
        return sites

    # -- module-level caches ---------------------------------------------

    @staticmethod
    def _caches(tree: ast.Module,
                imports: ImportMap) -> list[tuple[str, ast.stmt]]:
        """(name, definition) of each module-level dict the module writes
        under a computed key."""
        defs: dict[str, ast.stmt] = {}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
            else:
                continue
            if not _is_dict_value(stmt.value, imports):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    defs.setdefault(t.id, stmt)
        written: set[str] = set()

        def store(container: ast.expr, key: ast.expr,
                  loop_keys: set[tuple[str, str]]) -> None:
            if not isinstance(container, ast.Name) \
                    or container.id not in defs or _constant_key(key):
                return
            if isinstance(key, ast.Name) \
                    and (container.id, key.id) in loop_keys:
                return  # rewrites a key the dict already holds
            written.add(container.id)

        def visit(node: ast.AST, loop_keys: set[tuple[str, str]]) -> None:
            if isinstance(node, (ast.For, ast.AsyncFor)):
                inner = loop_keys | _loop_keys(node.target, node.iter)
                visit(node.iter, loop_keys)
                for stmt in node.body:
                    visit(stmt, inner)
                for stmt in node.orelse:
                    visit(stmt, loop_keys)
                return
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    store(t.value, t.slice, loop_keys)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "setdefault" and node.args:
                store(node.func.value, node.args[0], loop_keys)
            for child in ast.iter_child_nodes(node):
                visit(child, loop_keys)

        visit(tree, set())
        return [(name, stmt) for name, stmt in defs.items()
                if name in written]

    # -- registry hygiene --------------------------------------------------

    def finalize(self) -> list[Violation]:
        out: list[Violation] = []
        for site, entry in sorted(self.registry.items()):
            problem = entry_problem(entry)
            if problem is not None:
                out.append(Violation(
                    self.rule_id, REGISTRY_RELPATH, 1, 0,
                    f"registry entry `{site}`: {problem}"))
            site_file = site.split("::", 1)[0]
            if site_file in self.scanned_files and site not in self.seen:
                out.append(Violation(
                    self.rule_id, REGISTRY_RELPATH, 1, 0,
                    f"stale registry entry `{site}` — no such compile or "
                    f"cache site in {site_file} (remove or update the "
                    f"entry)"))
        return out
