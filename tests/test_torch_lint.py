"""The port's engine invariant linter (``tools/lint_torch``) — per-rule
fixtures, parity with the reference linter, mutation of the port's own
sanctioned sites, and the zero-violations gate over ``src/repro_torch``.

* Each rule: a hit, a pass and a pragma suppression at the port's paths;
  EL003 also a missing, a stale and a malformed registry entry.
* Parity: each fixture of ``tests/test_engine_lint.py`` whose construct
  exists in torch code gets the same rule ids, lines and columns from
  the reference rule at ``src/repro/...`` and the port's rule at
  ``src/repro_torch/...``.
* Mutation: stripping any sanctioned pragma from a copy of the port's
  ``engine.py``, ``workload.py`` or ``models/model.py`` flags exactly
  that line; deleting any registry entry flags its cache as EL003.
"""
from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools.lint.framework import (  # noqa: E402
    KNOWN_TAGS, PRAGMA_RE, SourceFile, Violation, parse_pragmas)
from tools.lint.rules import ALL_RULES as REF_RULES  # noqa: E402
from tools.lint_torch import engine_lint  # noqa: E402
from tools.lint_torch.rules import ALL_RULES  # noqa: E402
from tools.lint_torch.rules.el001_clock import (  # noqa: E402
    PortClockPurityRule)
from tools.lint_torch.rules.el002_tracer import (  # noqa: E402
    PortTracerGuardRule)
from tools.lint_torch.rules.el003_compile_registry import (  # noqa: E402
    CompileRegistryRule, entry_problem, load_registry)
from tools.lint_torch.rules.el004_host_sync import (  # noqa: E402
    PortHostSyncRule)
from tools.lint_torch.rules.el005_rng import PortRngStreamRule  # noqa: E402
from tools.lint_torch.rules.el006_hooks import (  # noqa: E402
    PortHookHygieneRule)

PORT = "src/repro_torch"
SERVING = f"{PORT}/serving/example.py"
ENGINE = f"{PORT}/serving/engine.py"
KERNEL = f"{PORT}/kernels/example.py"
STEP = f"{PORT}/models/example.py"


def make_src(text: str, relpath: str = SERVING) -> SourceFile:
    return SourceFile(path=Path(relpath), relpath=relpath, text=text,
                      tree=ast.parse(text), pragmas=parse_pragmas(text))


def run_rule(rule, text: str, relpath: str = SERVING) -> list[Violation]:
    assert rule.applies(relpath), f"{rule.rule_id} must scope {relpath}"
    return rule.check(make_src(text, relpath)) + rule.finalize()


def lines(vs: list[Violation]) -> list[int]:
    return [v.line for v in vs]


# ---------------------------------------------------------------------------
# EL001 — virtual-clock purity
# ---------------------------------------------------------------------------

TIMER_TEXT = ("import time\n"
              "class E:\n"
              "    def __init__(self, timer=None):\n"
              "        self._timer = timer if timer is not None else time\n"
              "    def step(self):\n"
              "        t0 = self._timer.perf_counter()\n"
              "        return self._timer.monotonic() - t0\n")


class TestClockPurity:
    def test_time_module_bound_as_value_hit(self):
        vs = run_rule(PortClockPurityRule(), TIMER_TEXT)
        assert lines(vs) == [4, 6, 7]
        assert all(v.rule == "EL001" for v in vs)
        assert "used as a value" in vs[0].message
        assert "self._timer.perf_counter()" in vs[1].message

    def test_clock_function_bound_as_value_hit(self):
        text = ("import time\n"
                "clock = time.perf_counter\n"
                "x = clock()\n")
        assert lines(run_rule(PortClockPurityRule(), text)) == [2, 3]

    def test_injected_timer_pass(self):
        text = ("import time\n"
                "class E:\n"
                "    def __init__(self, timer):\n"
                "        self._timer = timer\n"
                "    def step(self):\n"
                "        time.sleep(0)\n"
                "        return self._timer.perf_counter()\n")
        assert run_rule(PortClockPurityRule(), text) == []

    def test_pragma_on_binding_keeps_reads_flagged(self):
        text = TIMER_TEXT.replace(
            "else time\n", "else time  # el: allow[clock] -- default\n")
        assert lines(run_rule(PortClockPurityRule(), text)) == [6, 7]

    def test_pragma_suppression(self):
        text = "\n".join(line + "  # el: allow[clock] -- measured"
                         if "time" in line and "import" not in line
                         else line for line in TIMER_TEXT.split("\n"))
        assert run_rule(PortClockPurityRule(), text) == []

    @pytest.mark.parametrize("call,hit", [
        ("torch.randn(3)", True),
        ("torch.randn(3, generator=g)", False),
        ("torch.randint(0, 5, (3,))", True),
        ("torch.multinomial(p, 1, generator=g)", False),
        ("torch.rand(2, 2)", True),
        ("x.normal_()", True),
        ("x.uniform_(0, 1, generator=g)", False),
        ("torch.empty(3).bernoulli_(0.5)", True),
        ("torch.manual_seed(0)", True),
        ("torch.seed()", True),
        ("torch.Generator().manual_seed(0)", False),
    ])
    def test_torch_global_rng(self, call, hit):
        text = f"import torch\ny = {call}\n"
        assert lines(run_rule(PortClockPurityRule(), text)) == (
            [2] if hit else [])

    def test_scope(self):
        rule = PortClockPurityRule()
        assert rule.applies(f"{PORT}/core/router.py")
        assert rule.applies(ENGINE)
        assert not rule.applies(f"{PORT}/kernels/_build.py")
        assert not rule.applies("src/repro/serving/engine.py")


# ---------------------------------------------------------------------------
# EL002 — tracer fast-path guards
# ---------------------------------------------------------------------------

class TestTracerGuard:
    def test_unguarded_hit_guarded_pass(self):
        text = ("class E:\n"
                "    def step(self, now):\n"
                "        if self.tracer is not None:\n"
                "            self.tracer.sched(now)\n"
                "        self.tracer.finish(now)\n")
        vs = run_rule(PortTracerGuardRule(), text, ENGINE)
        assert [(v.rule, v.line) for v in vs] == [("EL002", 5)]

    def test_pragma_suppression(self):
        text = ("class E:\n"
                "    def step(self):\n"
                "        self.tracer.flush()  # el: allow[tracer] -- t\n")
        assert run_rule(PortTracerGuardRule(), text) == []

    def test_scope(self):
        rule = PortTracerGuardRule()
        assert not rule.applies(f"{PORT}/serving/trace.py")
        assert rule.applies(f"{PORT}/core/adapter_cache.py")
        assert not rule.applies("src/repro/serving/engine.py")


# ---------------------------------------------------------------------------
# EL003 — compile and cache registry
# ---------------------------------------------------------------------------

CACHE_TEXT = ("from typing import Dict\n"
              "launches: Dict[str, int] = {'k': 0}\n"
              "_CACHE: Dict[int, int] = {}\n"
              "_SEEN = dict()\n"
              "def reset():\n"
              "    for k in launches:\n"
              "        launches[k] = 0\n"
              "def get(n):\n"
              "    launches['k'] += 1\n"
              "    if n not in _CACHE:\n"
              "        _CACHE[n] = n * n\n"
              "    _SEEN.setdefault((n, 'x'), []).append(n)\n"
              "    return _CACHE[n]\n")
CACHE_SITES = {f"{KERNEL}::<module>::_CACHE": 3,
               f"{KERNEL}::<module>::_SEEN": 4}
COMPILE_TEXT = ("import torch\n"
                "@torch.compile\n"
                "def f(x):\n"
                "    return x\n"
                "class Runner:\n"
                "    def capture(self, fn):\n"
                "        self.graph = torch.cuda.CUDAGraph()\n"
                "        with torch.cuda.graph(self.graph):\n"
                "            fn()\n"
                "g = torch.jit.script(f)\n")
COMPILE_SITES = {f"{KERNEL}::<module>::f": 2,
                 f"{KERNEL}::Runner.capture::self.graph": 7,
                 f"{KERNEL}::Runner.capture::<anonymous>": 8,
                 f"{KERNEL}::<module>::g": 10}


def entry(kind: str = "cache", bound: int | None = 4) -> dict:
    return {"kind": kind, "key": "k", "bounded": "why",
            "stream_keyed": False, "bound": bound}


class TestCompileRegistry:
    def test_unregistered_caches_flagged_at_definition(self):
        vs = run_rule(CompileRegistryRule(registry={}), CACHE_TEXT, KERNEL)
        assert lines(vs) == sorted(CACHE_SITES.values())
        for v, site in zip(vs, CACHE_SITES):
            assert v.rule == "EL003" and f"`{site}`" in v.message

    def test_counters_are_not_caches(self):
        text = ("launches = {'a': 0, 'b': 0}\n"
                "def reset():\n"
                "    for k in launches.keys():\n"
                "        launches[k] = 0\n"
                "    for k, v in launches.items():\n"
                "        launches[k] = v\n"
                "    launches['a'] += 1\n"
                "    launches[('a', 1)] = 2\n")
        assert run_rule(CompileRegistryRule(registry={}), text, KERNEL) == []

    def test_unregistered_compile_sites(self):
        vs = run_rule(CompileRegistryRule(registry={}), COMPILE_TEXT, KERNEL)
        assert lines(vs) == sorted(COMPILE_SITES.values())
        for v, site in zip(vs, COMPILE_SITES):
            assert f"unregistered compile site `{site}`" in v.message

    def test_registered_pass(self):
        src = (make_src(CACHE_TEXT, KERNEL),
               make_src(COMPILE_TEXT, f"{PORT}/kernels/other.py"))
        registry = {**{s: entry() for s in CACHE_SITES},
                    **{s.replace(KERNEL, src[1].relpath):
                       entry("compile", None) for s in COMPILE_SITES}}
        rule = CompileRegistryRule(registry=registry)
        assert rule.check(src[0]) + rule.check(src[1]) + rule.finalize() \
            == []

    def test_stale_entry(self):
        registry = {s: entry() for s in CACHE_SITES}
        registry[f"{KERNEL}::<module>::_GONE"] = entry()
        vs = run_rule(CompileRegistryRule(registry=registry), CACHE_TEXT,
                      KERNEL)
        assert len(vs) == 1 and "stale registry entry" in vs[0].message
        assert vs[0].path == "tools/lint_torch/compile_registry.json"

    def test_entry_of_unscanned_file_is_not_stale(self):
        registry = {f"{PORT}/kernels/elsewhere.py::<module>::_X": entry()}
        assert run_rule(CompileRegistryRule(registry=registry),
                        "x = 1\n", KERNEL) == []

    @pytest.mark.parametrize("bad,problem", [
        ({"kind": "jit"}, "'kind'"),
        ({"key": " "}, "'key'"),
        ({"bounded": ""}, "'bounded'"),
        ({"stream_keyed": "yes"}, "'stream_keyed'"),
        ({"bound": 0}, "'bound'"),
        ({"bound": "4"}, "'bound'"),
    ])
    def test_malformed_entry(self, bad, problem):
        registry = {s: entry() for s in CACHE_SITES}
        site = next(iter(CACHE_SITES))
        registry[site] = {**registry[site], **bad}
        vs = run_rule(CompileRegistryRule(registry=registry), CACHE_TEXT,
                      KERNEL)
        assert any(problem in v.message for v in vs), vs

    def test_kind_mismatch(self):
        registry = {s: entry("compile") for s in CACHE_SITES}
        vs = run_rule(CompileRegistryRule(registry=registry), CACHE_TEXT,
                      KERNEL)
        assert len(vs) == 2 and all("registered as" in v.message
                                    for v in vs)

    def test_pragma_suppression(self):
        text = CACHE_TEXT.replace(
            "_SEEN = dict()\n", "_SEEN = dict()  # el: allow[jit] -- t\n")
        vs = run_rule(CompileRegistryRule(registry={}), text, KERNEL)
        assert lines(vs) == [3]

    def test_checked_in_registry_well_formed(self):
        registry = load_registry()
        assert len(registry) == 4
        for site, e in registry.items():
            assert entry_problem(e) is None, site


# ---------------------------------------------------------------------------
# EL004 — host syncs
# ---------------------------------------------------------------------------

def timed(body: str) -> str:
    return ("import numpy as np\nimport torch\n"
            "class E:\n"
            "    def step(self):\n"
            "        (toks, self.cache), dt = self._timed('k', self.fn)\n"
            + "".join(f"        {line}\n" for line in body.split("\n")))


class TestHostSync:
    @pytest.mark.parametrize("expr,hit", [
        ("toks.cpu().numpy()", True),
        ("toks.tolist()", True),
        ("toks.item()", True),
        ("toks.to('cpu')", True),
        ("toks.to(device='cpu')", True),
        ("toks.to(torch.int64)", False),
        ("int(toks[0])", True),
        ("float(toks.sum())", True),
        ("np.asarray(toks)[0]", True),
        ("np.array(toks.cpu())", True),
        ("self.cache.cpu()", True),
        ("float(dt)", False),
        ("self.other.cpu()", False),
        ("toks + 1", False),
    ])
    def test_engine_taint(self, expr, hit):
        vs = run_rule(PortHostSyncRule(), timed(f"x = {expr}"), ENGINE)
        assert [(v.rule, v.line) for v in vs] == (
            [("EL004", 6)] if hit else [])

    def test_synchronize_anywhere_in_engine(self):
        text = ("import torch\n"
                "def sync(dev):\n"
                "    torch.cuda.synchronize(dev)\n")
        assert lines(run_rule(PortHostSyncRule(), text, ENGINE)) == [3]

    def test_engine_pragma_suppression(self):
        text = timed("x = toks.cpu().numpy()  # el: allow[host-sync] -- out")
        assert run_rule(PortHostSyncRule(), text, ENGINE) == []

    @pytest.mark.parametrize("expr,hit", [
        ("x.item()", True),
        ("x.tolist()", True),
        ("x.cpu().numpy()", True),
        ("x.to('cpu')", True),
        ("x.nonzero()", True),
        ("x.unique()", True),
        ("torch.nonzero(x)", True),
        ("torch.unique(x)", True),
        ("torch.masked_select(x, m)", True),
        ("torch.cuda.synchronize()", True),
        ("x.sum(0).to(torch.float32)", False),
        ("torch.where(m, x, 0)", False),
    ])
    def test_step_modules(self, expr, hit):
        text = f"import torch\ndef f(x, m):\n    return {expr}\n"
        for relpath in (STEP, f"{PORT}/core/lora.py", f"{PORT}/kernels/sgmv.py"):
            vs = run_rule(PortHostSyncRule(), text, relpath)
            assert lines(vs) == ([3] if hit else []), relpath

    def test_step_module_pragma_suppression(self):
        text = ("import torch\ndef f(x):\n"
                "    return x.item()  # el: allow[host-sync] -- host tensor\n")
        assert run_rule(PortHostSyncRule(), text, STEP) == []

    def test_scope(self):
        rule = PortHostSyncRule()
        for relpath in (ENGINE, f"{PORT}/models/ssm.py", f"{PORT}/kernels/ops.py",
                        f"{PORT}/kernels/flash_prefill.py"):
            assert rule.applies(relpath), relpath
        for relpath in (f"{PORT}/serving/kvpool.py",
                        f"{PORT}/serving/prefix_cache.py",
                        f"{PORT}/kernels/ref.py", f"{PORT}/core/router.py",
                        "src/repro/serving/engine.py"):
            assert not rule.applies(relpath), relpath


# ---------------------------------------------------------------------------
# EL005, EL006 — the reference's contracts at the port's paths
# ---------------------------------------------------------------------------

class TestRngStreamAndHooks:
    def test_rng_hit_pass_pragma(self):
        text = ("import numpy as np\n"
                "a = np.random.default_rng(7)\n"
                "b = np.random.default_rng([7, 0x31])\n"
                "c = np.random.default_rng(7)  # el: allow[rng-stream] -- t\n")
        assert lines(run_rule(PortRngStreamRule(), text)) == [2]

    def test_hook_hit_pass_pragma(self):
        text = ("class E:\n"
                "    def serve(self, tr):\n"
                "        self.pool.on_event = tr.hook\n"
                "        self.kv.on_event = tr.hook  # el: allow[hook] -- t\n"
                "        try:\n"
                "            self.manager.on_event = tr.hook\n"
                "        finally:\n"
                "            self.manager.on_event = None\n")
        vs = run_rule(PortHookHygieneRule(), text, f"{PORT}/launch/x.py")
        assert [(v.rule, v.line) for v in vs] == [("EL006", 3)]


# ---------------------------------------------------------------------------
# parity with the reference linter (tests/test_engine_lint.py's fixtures)
# ---------------------------------------------------------------------------

def _fixture(rule_id: str, *texts: str, engine: bool = False):
    return rule_id, texts, engine


PARITY = {
    "clock_wall": _fixture("EL001", "import time\nt = time.time()\n"),
    "clock_perf_datetime": _fixture(
        "EL001", "import time\nfrom datetime import datetime\n"
        "a = time.perf_counter()\nb = datetime.now()\n"),
    "clock_stdlib_random": _fixture(
        "EL001", "import random\nx = random.random()\n"),
    "clock_unseeded": _fixture(
        "EL001", "import numpy as np\nr = np.random.default_rng()\n"),
    "clock_seeded": _fixture(
        "EL001", "import numpy as np\nr = np.random.default_rng([1, 2])\n"),
    "clock_pragma": _fixture(
        "EL001", "import time\n"
        "t = time.perf_counter()  # el: allow[clock] -- measured\n"),
    "tracer_unguarded": _fixture(
        "EL002", "class E:\n    def step(self, now):\n"
        "        self.tracer.sched(now)\n"),
    "tracer_guarded": _fixture(
        "EL002", "class E:\n    def step(self, now):\n"
        "        if self.tracer is not None:\n"
        "            self.tracer.sched(now)\n"),
    "tracer_alias": _fixture(
        "EL002", "class E:\n    def step(self, now):\n"
        "        tr = self.tracer\n        if tr is not None:\n"
        "            tr.sched(now)\n        tr.finish(now)\n"),
    "tracer_ternary": _fixture(
        "EL002", "class E:\n    def step(self):\n        tr = self.tracer\n"
        "        x = tr.summary() if tr is not None else None\n"
        "        y = tr.summary() if tr is None else None\n"),
    "tracer_boolop_early_return": _fixture(
        "EL002", "class E:\n    def a(self, now):\n        tr = self.tracer\n"
        "        if tr is not None and now > 0:\n            tr.compute(now)\n"
        "    def b(self):\n        tr = self.tracer\n        if tr is None:\n"
        "            return\n        tr.finish(0)\n"),
    "tracer_nested_def": _fixture(
        "EL002", "class E:\n    def step(self):\n        tr = self.tracer\n"
        "        if tr is not None:\n            def hook():\n"
        "                tr.sched(0)\n"),
    "tracer_pragma": _fixture(
        "EL002", "class E:\n    def step(self):\n"
        "        self.tracer.flush()  # el: allow[tracer]\n"),
    "host_sync_asarray": _fixture(
        "EL004", "import numpy as np\nclass E:\n    def step(self):\n"
        "        out, dt = self._timed('k', self.fn)\n"
        "        x = np.asarray(out)\n        y = float(dt)\n", engine=True),
    "host_sync_nested_unpack": _fixture(
        "EL004", "import numpy as np\nclass E:\n    def step(self):\n"
        "        (cache, first), dt = self._timed('k', self.fn)\n"
        "        x = np.asarray(first)\n        t = float(dt)\n", engine=True),
    "host_sync_pragma": _fixture(
        "EL004", "import numpy as np\nclass E:\n    def step(self):\n"
        "        out, dt = self._timed('k', self.fn)\n"
        "        x = np.asarray(out)  # el: allow[host-sync]\n", engine=True),
    "rng_bare_seed": _fixture(
        "EL005", "import numpy as np\nr = np.random.default_rng(7)\n"),
    "rng_salted": _fixture(
        "EL005", "import numpy as np\nr = np.random.default_rng([7, 0x1234])\n"),
    "rng_duplicate_across_files": _fixture(
        "EL005", "import numpy as np\nr = np.random.default_rng([7, 0x99])\n",
        "import numpy as np\nr = np.random.default_rng([8, 0x99])\n"),
    "rng_named_constants": _fixture(
        "EL005", "import numpy as np\nSALT_A = 0x11\nSALT_B = 0x11\n"
        "a = np.random.default_rng([7, SALT_A])\n"
        "b = np.random.default_rng([7, SALT_B])\n"),
    "rng_dynamic_salt": _fixture(
        "EL005", "import numpy as np\ndef f(seed, request):\n"
        "    return np.random.default_rng(\n"
        "        [seed, request.request_id])\n"),
    "rng_pragma": _fixture(
        "EL005", "import numpy as np\n"
        "r = np.random.default_rng(7)  # el: allow[rng-stream]\n"),
    "hook_unprotected": _fixture(
        "EL006", "class E:\n    def serve(self, tr):\n"
        "        self.manager.on_event = tr.hook\n        self.run()\n"
        "        self.manager.on_event = None\n"),
    "hook_try_finally": _fixture(
        "EL006", "class E:\n    def serve(self, tr):\n        try:\n"
        "            self.manager.on_event = tr.hook\n            self.run()\n"
        "        finally:\n            self.manager.on_event = None\n"),
    "hook_other_target": _fixture(
        "EL006", "class E:\n    def serve(self, tr):\n        try:\n"
        "            self.manager.on_event = tr.hook\n        finally:\n"
        "            self.pool.on_event = None\n"),
    "hook_none_default": _fixture(
        "EL006", "class E:\n    def __init__(self):\n"
        "        self.on_event = None\n"),
    "hook_conditional": _fixture(
        "EL006", "class E:\n    def serve(self, tr):\n        try:\n"
        "            if tr is not None:\n"
        "                self.pool.on_event = tr.hook\n        finally:\n"
        "            if self.paged:\n                self.pool.on_event = None\n"),
    "hook_pragma": _fixture(
        "EL006", "class E:\n    def wire(self, hook):\n"
        "        self.pool.on_event = hook  # el: allow[hook]\n"),
}


def _run_package(rules, rule_id: str, package: str, texts, engine: bool):
    rule = next(cls() for cls in rules if cls.rule_id == rule_id)
    out = []
    for i, text in enumerate(texts):
        name = "engine.py" if engine else f"example{i}.py"
        relpath = f"src/{package}/serving/{name}"
        assert rule.applies(relpath)
        out += rule.check(make_src(text, relpath))
    out += rule.finalize()
    return [(v.rule, Path(v.path).name, v.line, v.col) for v in out]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_with_reference(name):
    rule_id, texts, engine = PARITY[name]
    ref = _run_package(REF_RULES, rule_id, "repro", texts, engine)
    port = _run_package(ALL_RULES, rule_id, "repro_torch", texts, engine)
    assert port == ref


# ---------------------------------------------------------------------------
# mutation: the port's own sanctioned sites
# ---------------------------------------------------------------------------

TAG_RULE = {"clock": "EL001", "tracer": "EL002", "jit": "EL003",
            "host-sync": "EL004", "rng-stream": "EL005", "hook": "EL006"}
MUTATED_FILES = (f"{PORT}/serving/engine.py", f"{PORT}/serving/workload.py",
                 f"{PORT}/models/model.py")
PRAGMA_TAIL = re.compile(r"\s*#\s*el:\s*allow\[.*$")


def _sanctioned_sites():
    """(file, line, tag) of every pragma that sits on a line of code (a
    pragma on a comment-only line suppresses nothing)."""
    sites = []
    for relpath in MUTATED_FILES:
        text = (ROOT / relpath).read_text()
        src_lines = text.split("\n")
        for line, tags in sorted(parse_pragmas(text).items()):
            if not src_lines[line - 1].lstrip().startswith("#"):
                sites += [(relpath, line, tag) for tag in sorted(tags)]
    return sites


SANCTIONED = _sanctioned_sites()


def _site_ids(sites):
    """``engine.py-clock-2``: the second clock pragma of engine.py."""
    seen, ids = {}, []
    for relpath, _, tag in sites:
        key = f"{Path(relpath).name}-{tag}"
        seen[key] = seen.get(key, 0) + 1
        ids.append(f"{key}-{seen[key]}")
    return ids


def _lint(root: Path, relpath: str, text: str,
          registry=None) -> list[Violation]:
    """Every port rule over ``text`` written to ``root / relpath``."""
    path = root / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    src = SourceFile.load(path, root)
    assert src.relpath == relpath
    out = []
    for cls in ALL_RULES:
        rule = (cls(registry=registry)
                if registry is not None and cls is CompileRegistryRule
                else cls())
        if rule.applies(relpath):
            out += rule.check(src) + rule.finalize()
    return out


def test_sanctioned_sites_are_the_expected_ones():
    counts = {}
    for relpath, _, tag in SANCTIONED:
        key = (Path(relpath).name, tag)
        counts[key] = counts.get(key, 0) + 1
    assert counts == {("engine.py", "clock"): 5,
                      ("engine.py", "host-sync"): 6,
                      ("workload.py", "rng-stream"): 1,
                      ("model.py", "host-sync"): 1}


@pytest.mark.parametrize("relpath,line,tag", SANCTIONED,
                         ids=_site_ids(SANCTIONED))
def test_stripping_a_pragma_flags_its_line(relpath, line, tag, tmp_path):
    text = (ROOT / relpath).read_text()
    assert _lint(tmp_path, relpath, text) == []
    src_lines = text.split("\n")
    src_lines[line - 1] = PRAGMA_TAIL.sub("", src_lines[line - 1])
    vs = _lint(tmp_path, relpath, "\n".join(src_lines))
    assert [(v.rule, v.line) for v in vs] == [(TAG_RULE[tag], line)]


REGISTRY = load_registry()


@pytest.mark.parametrize("site", sorted(REGISTRY),
                         ids=lambda s: s.rsplit("::", 1)[-1])
def test_deleting_a_registry_entry_flags_its_site(site, tmp_path):
    relpath, _, name = site.split("::")
    text = (ROOT / relpath).read_text()
    line = next(i for i, s in enumerate(text.split("\n"), 1)
                if re.match(rf"{re.escape(name)}\b", s))
    registry = {k: v for k, v in REGISTRY.items() if k != site}
    vs = _lint(tmp_path, relpath, text, registry=registry)
    assert [(v.rule, v.line) for v in vs] == [("EL003", line)]
    assert f"`{site}`" in vs[0].message


# ---------------------------------------------------------------------------
# the port gate and the CLI
# ---------------------------------------------------------------------------

def test_port_zero_violations(capsys):
    rc = engine_lint.main([])
    cap = capsys.readouterr()
    assert rc == 0, f"port engine_lint found violations:\n{cap.out}"
    assert re.search(r"# engine_lint: \d+ files, 6 rules, 0 violations",
                     cap.err), cap.err


def test_cli_exit_codes_and_rule_list(tmp_path, capsys):
    assert engine_lint.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.strip().split("\n")
    assert [r.split(" ", 1)[0] for r in listed] == [
        f"EL00{i}" for i in range(1, 7)]
    assert engine_lint.main(["--select", "EL999"]) == 2
    assert engine_lint.main([str(tmp_path / "missing.py")]) == 2
    capsys.readouterr()
    # the script, as a user runs it
    out = subprocess.run(
        [sys.executable, "tools/lint_torch/engine_lint.py", "--select",
         "EL004", f"{PORT}/models/model.py", f"{PORT}/serving/engine.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2 files, 1 rules, 0 violations" in out.stderr


def test_pragmas_use_known_tags_and_give_reasons():
    for path in sorted((ROOT / PORT).rglob("*.py")):
        text = path.read_text()
        for line, tags in parse_pragmas(text).items():
            assert tags <= KNOWN_TAGS, (path, line, tags)
            code = text.split("\n")[line - 1]
            m = PRAGMA_RE.search(code)
            assert m and re.match(r"\s*--\s*\S", code[m.end():]), (
                f"{path}:{line}: a pragma needs `-- reason`")
