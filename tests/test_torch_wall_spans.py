"""The port's wall spans (``EngineTracer(wall_spans=True)``): a second
record on the host's ``perf_counter`` beside the virtual one.

* The span tree is well nested: every parent id names a span that opened
  before and closed after its child, and the self times of a step's
  spans sum to the step's duration.
* Off (the default, and with no tracer), no span is built and the
  module handle ``repro_torch.core.spans.wall`` is None after ``serve``,
  also when the serve raises.
* On, the token streams, the summary, the virtual events and the
  metrics equal the reference's, and the ones of a run with spans off.
* The LoRA wrapper plans its grouping once per step call (one token
  layout in these steps): ``lora.plan`` spans and the ``lora_plans``
  counter match, every other LoRA call counts as ``lora_plan_reuses``.
* The export carries the spans (``edgelora.wall``, a second process),
  passes the schema check and reads back through the report tool.
* The linter holds the span sites to EL002's guard and sanctions one new
  clock read, the record's own.
"""
import io
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # tools/ and benchmarks/ from the root

from benchmarks.schema import validate_trace_json  # noqa: E402
from repro.serving.trace import EngineTracer as JaxTracer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.trace import (WALL_FIELDS, EngineTracer,  # noqa: E402
                                       WallSpans)
from tools import trace_report  # noqa: E402
from tools.lint.framework import SourceFile  # noqa: E402
from tools.lint_torch.rules import ALL_RULES  # noqa: E402

from test_torch_engine import _FakeTime  # noqa: E402
from test_torch_policies import (Weights, configs, ecfg_kwargs,  # noqa: E402
                                 one_torch_thread,  # noqa: F401 (fixture)
                                 serve_pair, summary_json, trace_kwargs)

MODEL_SPANS = {"embed", "layer", "attn", "qkv", "cache_write", "attention",
               "mlp", "head"}
LORA_SPANS = {"lora", "lora.plan", "lora.gather", "lora.kernels",
              "lora.scatter"}
LOOP_SPANS = {"iteration", "admit", "select", "adapter.load", "step",
              "step.call", "step.sync", "readback"}


@pytest.fixture(scope="module")
def weights():
    return Weights(5)


def _serve(weights, tracer=None, policy="edgelora", kv="paged", **ekw):
    """One port serve under a fake timer; the kernel wrappers' route
    (SGMV, both attention kernels' wrappers) so that every span site
    runs."""
    _, tcfg = configs()
    eng = torch_engine.EdgeLoRAEngine(
        tcfg, torch_engine.EngineConfig(**ecfg_kwargs(policy, kv, **ekw)),
        params=bridge.tree_from_numpy(weights.params), tracer=tracer,
        device="cpu", timer=_FakeTime(),
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            weights.adapters[aid]))
    trace = workload.generate_trace(workload.WorkloadConfig(
        **trace_kwargs(tcfg)))
    summary = eng.serve(trace)
    return summary, trace, eng


KERNEL_ROUTE = dict(lora_backend="sgmv", attn_kernel=True)


@pytest.fixture(scope="module")
def traced(weights):
    """Pinned adapters (no AAS): five tenants over a pool of four, so
    adapters are loaded."""
    tracer = EngineTracer(wall_spans=True)
    summary, trace, eng = _serve(weights, tracer, "edgelora_no_aas",
                                 **KERNEL_ROUTE)
    return tracer, summary, trace, eng


def _children(spans_):
    out = {}
    for s in spans_:
        out.setdefault(s[4], []).append(s)
    return out


def test_span_tree_is_well_nested(traced):
    tracer, _, _, _ = traced
    rec = tracer.wall_spans
    assert rec._open == [] and rec.spans
    by_id = {s[0]: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for sid, name, t0, t1, parent, args in rec.spans:
        assert rec.origin <= t0 <= t1
        assert not (args or {}).get("truncated")
        if parent == -1:
            assert name == "iteration", name
            continue
        p = by_id[parent]
        assert p[0] < sid and p[2] <= t0 and t1 <= p[3], (p, name)
    names = {s[1] for s in rec.spans}
    assert names == MODEL_SPANS | LORA_SPANS | LOOP_SPANS
    kids = _children(rec.spans)
    parent_name = {s[0]: by_id[s[4]][1] for s in rec.spans if s[4] != -1}
    for s in rec.spans:
        if s[1] in ("step.call", "step.sync"):
            assert parent_name[s[0]] == "step"
        elif s[1] in MODEL_SPANS | LORA_SPANS:
            # the model and the LoRA wrapper run inside a step's call
            a = s
            while a[1] not in ("step.call", "iteration"):
                a = by_id[a[4]]
            assert a[1] == "step.call", s
        if s[1].startswith("lora."):
            assert parent_name[s[0]] == "lora"
        if s[1] in ("qkv", "cache_write", "attention"):
            assert parent_name[s[0]] == "attn"
    for st in (s for s in rec.spans if s[1] == "step"):
        # a step's spans' self times sum to its duration
        total, todo = 0.0, [st]
        while todo:
            s = todo.pop()
            below = kids.get(s[0], [])
            total += (s[3] - s[2]) - sum(c[3] - c[2] for c in below)
            todo += below
        assert total == pytest.approx(st[3] - st[2], rel=1e-9, abs=1e-9)
        assert {c[1] for c in kids[st[0]]} == {"step.call", "step.sync"}
        calls = [c for c in kids[st[0]] if c[1] == "step.call"]
        assert len(calls) == (2 if st[5]["warm"] else 1)


def test_step_spans_carry_the_step(traced):
    tracer, summary, trace, eng = traced
    rec = tracer.wall_spans
    steps = [s for s in rec.spans if s[1] == "step"]
    compute = [e for e in tracer.events if e["kind"] == "compute"]
    # one step span per charged step, in order, with its key and group
    assert [s[5]["key"] for s in steps] == [e["args"]["key"]
                                            for e in compute]
    assert [s[5]["requests"] for s in steps] == [
        e["args"].get("requests", []) for e in compute]
    for s in steps:
        a = s[5]
        assert a["kind"] == a["key"][0]
        # the raw seconds of the fake timer (one tick between its reads)
        assert a["wall_s"] == pytest.approx(5e-4)
        # on the CPU the wrappers run their plain versions: no launch
        assert a["launches"] == {}
    loads = [s for s in rec.spans if s[1] == "adapter.load"]
    assert loads and all(s[5]["bytes"] > 0 for s in loads)
    assert rec.counters["adapter_loads"].value == len(loads)
    assert rec.counters["adapter_load_bytes"].value == sum(
        s[5]["bytes"] for s in loads)
    assert len([s for s in rec.spans if s[1] == "readback"]) == (
        summary.prefill_steps + summary.decode_steps)


def test_plan_counters_count_plans_built_and_reused(traced):
    """A step call plans its SGMV grouping once per token layout (one in
    the dense model's steps): one ``lora.plan`` span per step call that
    runs LoRA, counted as ``lora_plans``, and every other LoRA call of
    the step call counted as ``lora_plan_reuses``."""
    tracer, _, _, _ = traced
    rec = tracer.wall_spans
    by_id = {s[0]: s for s in rec.spans}

    def call_of(s):
        while s[1] != "step.call":
            s = by_id[s[4]]
        return s[0]

    loras = [s for s in rec.spans if s[1] == "lora"]
    plans = [s for s in rec.spans if s[1] == "lora.plan"]
    calls = {call_of(s) for s in loras}
    assert sorted(call_of(s) for s in plans) == sorted(calls)
    assert rec.counters["lora_plans"].value == len(plans) == len(calls)
    assert rec.counters["lora_plan_reuses"].value == (len(loras)
                                                      - len(plans))
    assert len(loras) > 2 * len(plans)


def test_slot_state_spans_stamp_each_request(traced):
    tracer, _, trace, _ = traced
    rec = tracer.wall_spans
    virtual = [e for e in tracer.events if e["kind"] == "state"]
    assert len(rec.slots) == len(virtual)
    by_req = {}
    for sid, state, t0, t1, parent, args in rec.slots:
        assert parent == -1 and t0 <= t1
        by_req.setdefault(args["request"], []).append((t0, state))
    assert set(by_req) == {r.request_id for r in trace}
    for rid, visits in by_req.items():
        states = [s for _, s in sorted(visits)]
        assert states[0] == "selecting" and states[-1] == "generate", states
        # the virtual record emits each visit as it ends, in order
        assert states == [e["name"] for e in virtual
                          if e["args"]["request"] == rid]


def test_launch_counts_read_every_wrapper():
    counts = ops.launch_counts()
    assert set(counts) == {"sgmv_shrink", "sgmv_expand", "flash_prefill",
                           "flash_decode", "paged_gather_pages"}


def test_step_span_records_the_launches_it_made(weights, monkeypatch):
    """Each read of the counters finds three more SGMV launches: a step
    reads them at its start and its end, and records the difference."""
    reads = []

    def counts():
        reads.append(None)
        return {"sgmv_shrink": 3 * len(reads), "flash_decode": 0}

    monkeypatch.setattr(torch_engine, "launch_counts", counts)
    tracer = EngineTracer(wall_spans=True)
    _serve(weights, tracer)
    steps = [s for s in tracer.wall_spans.spans if s[1] == "step"]
    assert steps and len(reads) == 2 * len(steps)
    assert all(s[5]["launches"] == {"sgmv_shrink": 3} for s in steps)


def test_spans_off_builds_nothing(weights, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a wall span was built with spans off")

    for name in ("__init__", "open", "close", "call", "state", "count"):
        monkeypatch.setattr(WallSpans, name, refuse)
    for tracer in (None, EngineTracer()):
        _serve(weights, tracer, **KERNEL_ROUTE)
        assert spans.wall is None
        if tracer is not None:
            assert tracer.wall_spans is None
            assert "wall" not in tracer.to_json()["edgelora"]


class _Stop(Exception):
    pass


class _StopTracer(EngineTracer):
    """Ends the serve from its third iteration's sample, with the
    iteration span still open."""

    def sample(self, t, **gauges):
        super().sample(t, **gauges)
        self.samples = getattr(self, "samples", 0) + 1
        if self.samples == 3:
            raise _Stop


def test_handle_cleared_when_serve_raises(weights):
    tracer = _StopTracer(wall_spans=True)
    with pytest.raises(_Stop):
        _serve(weights, tracer)
    assert spans.wall is None
    rec = tracer.wall_spans
    assert rec._open == []
    truncated = [s for s in rec.spans if (s[5] or {}).get("truncated")]
    assert [s[1] for s in truncated] == ["iteration"]


@pytest.mark.parametrize("policy,kv,ekw", [
    ("edgelora", "paged", {}),
    ("dlora", "dense", {}),
    ("edgelora", "paged", dict(prefill_chunk=8)),
], ids=["edgelora-paged", "dlora-dense", "chunked"])
def test_virtual_record_equals_reference_with_spans_on(monkeypatch, weights,
                                                       policy, kv, ekw):
    cfg = configs()[1]
    tracers = (JaxTracer(), EngineTracer(wall_spans=True))
    ref, port = serve_pair(monkeypatch, weights,
                           ecfg_kwargs(policy, kv, **ekw),
                           trace_kwargs(cfg), tracers=tracers)
    jtr, ttr = tracers
    for a, b in zip(ref[1], port[1]):
        assert a.tokens == b.tokens, a.request_id
    assert summary_json(ref[0]) == summary_json(port[0])
    assert len(ttr.events) == len(jtr.events) > 0
    for a, b in zip(jtr.events, ttr.events):
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert ttr.metrics.as_dict() == jtr.metrics.as_dict()
    assert ttr.watchdog_report == jtr.watchdog_report
    assert ttr.wall_spans.spans


@pytest.mark.parametrize("policy,kv", [("edgelora", "paged"),
                                       ("llamacpp", "dense")])
def test_streams_and_summary_equal_with_spans_on_and_off(weights, policy,
                                                         kv):
    out = {}
    for on in (False, True):
        tracer = EngineTracer(wall_spans=on)
        summary, trace, _ = _serve(weights, tracer, policy, kv,
                                   **KERNEL_ROUTE)
        out[on] = ({r.request_id: r.tokens for r in trace},
                   summary_json(summary), tracer.events,
                   tracer.metrics.as_dict())
    assert out[False] == out[True]


def test_export_carries_the_wall_process(traced, tmp_path):
    tracer, _, _, _ = traced
    path = tmp_path / "trace.json"
    tracer.export(path)
    data = json.loads(path.read_text())
    assert validate_trace_json(data, name=path.name) == []
    wall = data["edgelora"]["wall"]
    assert wall["fields"] == list(WALL_FIELDS)
    assert len(wall["spans"]) == len(tracer.wall_spans.spans)
    assert len(wall["slots"]) == len(tracer.wall_spans.slots)
    assert wall["counters"]["adapter_loads"] > 0
    evs = [e for e in data["traceEvents"] if e.get("pid") == 1]
    assert {"process_name", "thread_name"} <= {e["name"] for e in evs
                                               if e["ph"] == "M"}
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == len(wall["spans"]) + len(wall["slots"])
    assert min(e["ts"] for e in xs) >= 0
    # the virtual process is the untraced export's, event for event
    off = EngineTracer()
    off.events, off.meta, off.now = tracer.events, tracer.meta, tracer.now
    off.metrics = tracer.metrics
    assert [e for e in data["traceEvents"] if e.get("pid") != 1] == \
        json.loads(json.dumps(off.chrome_events()))
    buf = io.StringIO()
    trace_report.report(data, out=buf)
    assert "# trace: policy=edgelora_no_aas kv=paged" in buf.getvalue()


def test_wall_spans_unit():
    rec = WallSpans()
    rec.open("a", {"x": 1})
    rec.open("b")
    assert rec.call("c", lambda v: v + 1, 2) == 3
    rec.close({"y": 2})
    rec.open("d")
    rec.close_all()
    got = {s[1]: s for s in rec.spans}
    assert [s[1] for s in rec.spans] == ["c", "b", "d", "a"]
    assert got["b"][4] == got["a"][0] and got["c"][4] == got["b"][0]
    assert got["b"][5] == {"y": 2}
    assert got["a"][5] == {"x": 1, "truncated": True}
    rec.state(0, "idle", "selecting", 7)
    rec.state(0, "selecting", "loading", 7)
    rec.state(0, "loading", "idle", 7)
    assert [(s[1], s[5]) for s in rec.slots] == [
        ("selecting", {"slot": 0, "request": 7}),
        ("loading", {"slot": 0, "request": 7})]
    rec.count("n")
    rec.count("n", 2)
    assert rec.to_json()["counters"] == {"n": 3}


# ---------------------------------------------------------------------------
# the linter: EL002 holds the span sites, one new sanctioned clock read
# ---------------------------------------------------------------------------

def _lint(tmp_path, relpath, text):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    src = SourceFile.load(path, tmp_path)
    out = []
    for cls in ALL_RULES:
        rule = cls()
        if rule.applies(relpath):
            out += rule.check(src)
    return [(v.rule, v.line) for v in out if v.rule in ("EL001", "EL002")]


SPAN_SITES = {
    "handle unguarded": ("from repro_torch.core import spans\n"
                         "def f():\n    spans.wall.open('x')\n", [3]),
    "alias unguarded": ("from repro_torch.core import spans\n"
                        "def f():\n    sp = spans.wall\n"
                        "    sp.open('x')\n", [4]),
    "alias guarded": ("from repro_torch.core import spans\n"
                      "def f():\n    sp = spans.wall\n"
                      "    if sp is not None:\n        sp.open('x')\n", []),
    "conditional alias": ("def f(tr):\n"
                          "    sp = tr.wall_spans if tr is not None "
                          "else None\n    sp.close_all()\n"
                          "    if sp is not None:\n"
                          "        sp.close_all()\n", [3]),
    "nested def": ("from repro_torch.core import spans\n"
                   "def f():\n    sp = spans.wall\n"
                   "    if sp is not None:\n"
                   "        def g():\n            sp.open('x')\n", [6]),
}


@pytest.mark.parametrize("name", sorted(SPAN_SITES))
def test_el002_holds_span_sites(tmp_path, name):
    text, lines = SPAN_SITES[name]
    got = _lint(tmp_path, "src/repro_torch/core/x.py", text)
    assert got == [("EL002", n) for n in lines]


def test_the_wall_clock_is_read_at_one_sanctioned_site(tmp_path):
    relpath = "src/repro_torch/serving/trace.py"
    text = (ROOT / relpath).read_text()
    lines = [i for i, s in enumerate(text.split("\n"), 1)
             if "el: allow[clock]" in s]
    assert len(lines) == 1
    assert _lint(tmp_path, relpath, text) == []
    src_lines = text.split("\n")
    src_lines[lines[0] - 1] = src_lines[lines[0] - 1].split("  #")[0]
    assert _lint(tmp_path, relpath, "\n".join(src_lines)) == [
        ("EL001", lines[0])]
