"""The port's engine tracing against the JAX package's.

* Under one fake timer per engine (``_FakeTime``), the port's trace
  equals the reference's event for event (track, kind, name, virtual
  timestamp, duration and arguments), with the same metric series,
  per-request latency breakdowns and shape-watchdog report, for each
  policy, on dense and paged KV, through preemption and chunked prefill.
* Tracing is a no-op: streams and the summary of a traced serve equal
  the untraced serve's, and the hooks are unwired afterwards.
* The exported file passes ``benchmarks/schema.py``'s trace check and
  reads back through ``tools/trace_report.py`` and
  ``tools/trace_export.py``, unchanged; so does the CLI's ``--trace``.
* The port's copies of ``jit_cache_report`` and ``MetricsRegistry``
  behave as the reference's unit tests say.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # benchmarks/ and tools/ from the root

from benchmarks.schema import validate_trace_json  # noqa: E402
from repro.serving.trace import EngineTracer as JaxTracer  # noqa: E402
from repro.serving.trace import \
    jit_cache_report as jax_jit_cache_report  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.metrics_registry import MetricsRegistry  # noqa: E402
from repro_torch.serving.trace import (EngineTracer,  # noqa: E402
                                       JitRecompileError, jit_cache_report)
from tools import trace_export, trace_report  # noqa: E402

from test_torch_engine import _FakeTime  # noqa: E402
from test_torch_policies import (Weights, configs, ecfg_kwargs,  # noqa: E402
                                 one_torch_thread,  # noqa: F401 (fixture)
                                 serve_pair, summary_json,
                                 trace_kwargs)


@pytest.fixture(scope="module")
def weights():
    return Weights(5)


# (policy, kv, engine settings, workload settings): every policy, both KV
# backends, then tests/test_trace.py's preemption churn (an arena of ten
# 8-token pages under four slots) and chunked prefill
CASES = [
    ("edgelora", "paged", {}, {}),
    ("edgelora_no_aas", "dense", {}, {}),
    ("llamacpp", "paged", {}, {}),
    ("dlora", "dense", {}, {}),
    ("edgelora", "paged",
     dict(n_slots=4, max_ctx=64, kv_block_size=8, kv_arena_blocks=10),
     dict(seed=1, rate=16.0, duration=1.0, input_range=(8, 24),
          output_range=(24, 39))),
    ("edgelora", "paged", dict(prefill_chunk=8),
     dict(seed=2, input_range=(12, 30))),
]


def _traced_pair(monkeypatch, weights, policy, kv, ekw, wkw):
    cfg = configs()[1]
    tracers = (JaxTracer(), EngineTracer())
    ref, port = serve_pair(monkeypatch, weights,
                           ecfg_kwargs(policy, kv, **ekw),
                           trace_kwargs(cfg, **wkw), tracers=tracers)
    return ref, port, tracers


@pytest.mark.parametrize("policy,kv,ekw,wkw", CASES, ids=[
    "edgelora-paged", "edgelora_no_aas-dense", "llamacpp-paged",
    "dlora-dense", "preemption", "chunked"])
def test_trace_matches_reference(monkeypatch, weights, policy, kv, ekw, wkw):
    ref, port, (jtr, ttr) = _traced_pair(monkeypatch, weights, policy, kv,
                                         ekw, wkw)
    for a, b in zip(ref[1], port[1]):
        assert a.tokens == b.tokens, a.request_id
    # the summary with its latency breakdown, exact
    assert summary_json(ref[0]) == summary_json(port[0])
    assert len(ttr.events) == len(jtr.events) > 0
    for i, (a, b) in enumerate(zip(jtr.events, ttr.events)):
        assert json.dumps(a, sort_keys=True) == json.dumps(
            b, sort_keys=True), (i, a, b)
    assert ttr.metrics.as_dict() == jtr.metrics.as_dict()
    assert ttr.watchdog_report == jtr.watchdog_report
    assert ttr.watchdog_report["ok"], ttr.watchdog_report
    assert ttr.open_spans() == []
    names = {(e["kind"], e["name"]) for e in ttr.events}
    if ekw.get("kv_arena_blocks"):
        assert ("sched", "preempt") in names
        assert {("arena", "alloc"), ("arena", "free")} <= names
    if policy in ("llamacpp", "dlora"):
        assert ("sched", "merge_switch") in names


def _port_serve(weights, policy, kv, tracer=None):
    """One serve of the port's engine under a fresh fake timer."""
    from repro_torch import bridge
    _, tcfg = configs()
    eng = torch_engine.EdgeLoRAEngine(
        tcfg, torch_engine.EngineConfig(**ecfg_kwargs(policy, kv)),
        params=bridge.tree_from_numpy(weights.params), tracer=tracer,
        device="cpu", timer=_FakeTime(),
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            weights.adapters[aid]))
    trace = workload.generate_trace(workload.WorkloadConfig(
        **trace_kwargs(tcfg)))
    summary = eng.serve(trace)
    assert eng.manager.on_event is None
    assert not eng.paged or eng.kvpool.on_event is None
    return summary, trace


@pytest.mark.parametrize("policy,kv", [("dlora", "paged"),
                                       ("llamacpp", "dense")])
def test_tracing_is_noop(weights, policy, kv):
    """A traced serve's streams and summary (but for the tracing-only
    latency breakdown) equal the untraced serve's, under one fake
    timer each; no hook outlives the serve."""
    out = {}
    for traced in (False, True):
        summary, trace = _port_serve(weights, policy, kv,
                                     EngineTracer() if traced else None)
        assert (summary.latency_breakdown is None) == (not traced)
        fields = dataclasses.asdict(summary)
        fields.pop("latency_breakdown")
        out[traced] = ({r.request_id: r.tokens for r in trace},
                       json.dumps(fields, sort_keys=True, default=float))
    assert out[False] == out[True]


def test_exported_trace_reads_back(weights, tmp_path):
    """The port's export passes the schema check and both unchanged
    tools."""
    tracer = EngineTracer()
    _port_serve(weights, "dlora", "paged", tracer)
    path = tmp_path / "trace.json"
    tracer.export(path)
    data = json.loads(path.read_text())
    assert validate_trace_json(data, name=path.name) == []
    buf = io.StringIO()
    trace_report.report(data, out=buf)
    text = buf.getvalue()
    assert "# trace: policy=dlora kv=paged" in text
    assert "ok:" in text and "VIOLATION" not in text
    assert trace_report.main([str(path)]) == 0
    assert trace_export.main([str(path)]) == 0


def test_cli_trace_on_cpu(tmp_path):
    out_json = tmp_path / "out.json"
    # one intra-op thread, as the in-process tests run (one_torch_thread)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen2-0.5b", "--policy", "dlora", "--trace",
         str(out_json), "--n-adapters", "6", "--rate", "3", "--duration",
         "2", "--max-ctx", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr
    assert "# trace written to" in run.stderr
    assert run.stdout.strip().splitlines()[-1].startswith("policy=dlora")
    report = subprocess.run(
        [sys.executable, "tools/trace_report.py", str(out_json)], cwd=ROOT,
        env=dict(env, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"),
        capture_output=True, text=True, timeout=240)
    assert report.returncode == 0, report.stderr
    assert "# trace: policy=dlora" in report.stdout


def test_watchdog_flags_rogue_shape():
    _, tcfg = configs()
    ecfg = torch_engine.EngineConfig(**ecfg_kwargs("edgelora"))
    trace = workload.generate_trace(workload.WorkloadConfig(
        **trace_kwargs(tcfg)))
    eng = torch_engine.EdgeLoRAEngine(tcfg, ecfg, tracer=EngineTracer(),
                                      device="cpu")
    eng._durations[("prefill", 33, 3)] = 1e-3   # off the bucket grid
    with pytest.raises(JitRecompileError, match="prefill"):
        eng.serve(trace)
    assert eng.manager.on_event is None


def test_jit_cache_report_matches_reference():
    """The reference's unit cases, and the same report from both
    packages."""
    buckets, n_slots = (16, 32, 48), 4
    ok_keys = [("prefill", 16, 1), ("prefill", 48, 4), ("router", 32, 2),
               ("decode",), ("decode_merged",), ("prefill_merged", 32, 1)]
    rep = jit_cache_report(ok_keys, buckets=buckets, n_slots=n_slots)
    assert rep["ok"] and rep["prefill_bound"] == len(buckets) * 3
    assert rep == jax_jit_cache_report(ok_keys, buckets=buckets,
                                       n_slots=n_slots)
    for bad in [("prefill", 33, 1), ("prefill", 16, 3), ("mystery", 1, 1),
                ("prefill_sfx", 32, 8, 1)]:
        assert not jit_cache_report(ok_keys + [bad], buckets=buckets,
                                    n_slots=n_slots)["ok"], bad
    sfx = [("prefill_sfx", 32, 7, 1), ("prefill_sfx_dense", 48, 19, 2)]
    rep = jit_cache_report(ok_keys + sfx, buckets=buckets, n_slots=n_slots,
                           prefix_cache=True, max_ctx=48)
    assert rep["ok"] and rep["bounds"]["prefill_sfx"] is None
    assert not jit_cache_report([("prefill_sfx", 32, 32, 1)],
                                buckets=buckets, n_slots=n_slots,
                                prefix_cache=True, max_ctx=48)["ok"]


def test_metrics_registry_unit():
    reg = MetricsRegistry()
    c = reg.counter("done")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("done")
    g = reg.gauge("depth")
    g.set(7)
    reg.sample(1.0)
    g.set(9)
    reg.sample(1.0)  # same t replaces, not appends
    reg.sample(2.0)
    assert reg.series["depth"] == [(1.0, 9.0), (2.0, 9.0)]
    h = reg.histogram("step")
    for v in (0.01, 0.7, 1.5):
        h.observe(v)
    assert h.count == 3 and h.snapshot() == {
        "le_0.125": 1, "le_1": 1, "le_2": 1}
