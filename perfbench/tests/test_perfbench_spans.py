"""``harness/spans.py`` and ``span_probe.py``: a traced window read
against the program's wall spans.

* Attribution on a hand-made device trace: each operation belongs to
  the innermost span open at its launch, idle gaps split by the span
  the host was in, the readings computed from them (``read``) and the
  probe's diagnostics (``diagnose``), the profiler's clock fit and the
  bound that early device stamps put on the idle split among them.
* ``SpanTree.innermost`` against a brute-force search over nested spans.
* At a CPU size: the recorder's step stamps are unchanged with the spans
  on (each step's raw wall seconds are exactly its two timer readings
  apart, inside its ``step`` span), and the probe prints the readings a
  CPU run has (no launch events there).
"""
import random
from types import SimpleNamespace

import pytest
import torch

from cpu_cell import small_cell
from perfbench import span_probe
from perfbench.harness import bench
from perfbench.harness.recorder import DECODE_KINDS, PREFILL_KINDS
from perfbench.harness.spans import (DeviceOp, Launches, SpanTree, by_span,
                                     idle_by_span, idle_gaps, read)
from perfbench.span_probe import clock_fit, diagnose, shifted


def _span(sid, name, t0, t1, parent=-1, **args):
    return (sid, name, t0, t1, parent, args or None)


def _hand_made():
    """One iteration [0, 10]: a decode step [1, 9] whose call [1, 7]
    holds a LoRA wrapper [2, 5] (plan [2, 3], kernels [3, 4], scatter
    [4, 5]) and whose sync is [7, 9]; a LOADING visit [0.5, 8.5]."""
    spans = [
        _span(0, "iteration", 0.0, 10.0),
        _span(1, "step", 1.0, 9.0, 0, kind="decode", key=["decode"],
              requests=[3], warm=False, wall_s=8.0, launches={}),
        _span(2, "step.call", 1.0, 7.0, 1),
        _span(3, "lora", 2.0, 5.0, 2),
        _span(4, "lora.plan", 2.0, 3.0, 3),
        _span(5, "lora.kernels", 3.0, 4.0, 3),
        _span(6, "lora.scatter", 4.0, 5.0, 3),
        _span(7, "step.sync", 7.0, 9.0, 1),
    ]
    slots = [(8, "loading", 0.5, 8.5, -1, {"slot": 0, "request": 3})]
    # launches at 2.5 (plan), 3.5 (kernels), 4.5 (scatter), 6 (call),
    # 9.5 (iteration); the ops run later on the device
    calls = {10: ("cudaLaunchKernel", 2.5, 2.51),
             11: ("cudaLaunchKernel", 3.5, 3.51),
             12: ("cudaMemcpyAsync", 4.5, 4.51),
             13: ("cudaLaunchKernel", 6.0, 6.01),
             14: ("cudaLaunchKernel", 9.5, 9.51)}
    ops = [DeviceOp("index_kernel", 3.0, 4.0, 10, 0),
           DeviceOp("sgmv_shrink", 4.0, 4.5, 11, 0),
           DeviceOp("Memcpy", 5.0, 6.0, 12, 0),
           DeviceOp("gemm", 6.5, 8.0, 13, 0),
           DeviceOp("stray", 9.6, 9.7, 99, 0)]
    rec = SimpleNamespace(spans=spans, slots=slots, counters={})
    trace = SimpleNamespace(start=0.0, stop=10.0, window_s=10.0,
                            launches=Launches(ops, calls))
    return SimpleNamespace(rec=SimpleNamespace(wall_spans=rec), start=0.0,
                           end=10.0, window_s=10.0, trace=trace)


def test_attribution_on_a_hand_made_trace():
    out = read(_hand_made())
    assert out["matched_by"] == "correlation_id"
    # the stray op has no launch: 0.1 of 4.1 device seconds unattributed
    assert out["attributed_pct"] == pytest.approx(100 * 4.0 / 4.1)
    assert out["lora_shuffle_device_pct"] == pytest.approx(20.0)
    # one decode step; four of its ops launched inside it
    assert out["decode_steps"] == 1 and out["decode_launches"] == 4
    assert out["decode_enqueue_ms"] == pytest.approx(6e3)
    assert out["decode_sync_ms"] == pytest.approx(2e3)
    assert out["decode_step_span_ms"] == pytest.approx(8e3)
    assert out["decode_wall_s_ms"] == pytest.approx(8e3)
    # idle with the host in lora.plan [2, 3] and lora.scatter [4.5, 5]
    assert out["idle_in_lora_pct"] == pytest.approx(15.0)
    assert out["load_wait_p90_ms"] == pytest.approx(8e3)
    assert out["prefill_steps"] == 0 and "prefill_step_span_ms" not in out


def test_readings_with_nothing_to_read_are_none():
    run = _hand_made()
    run.rec.wall_spans.slots = []
    run.rec.wall_spans.spans = [s for s in run.rec.wall_spans.spans
                                if s[1] != "step"]
    run.trace = None
    out = read(run)
    for key in ("decode_enqueue_ms", "decode_launches", "idle_in_lora_pct",
                "lora_shuffle_device_pct", "load_wait_p90_ms",
                "attributed_pct"):
        assert out[key] is None, key


def test_probe_diagnostics_on_a_hand_made_trace():
    out = diagnose(_hand_made())
    assert out["device_pct_by_span"] == pytest.approx(
        {"lora.plan": 10.0, "lora.kernels": 5.0, "lora.scatter": 10.0,
         "step.call": 15.0})
    # launches 2.5, 3.5, 4.5, 6 -> starts 3, 4, 5, 6.5
    assert out["launch_to_start_us"] == pytest.approx([5e5, 5e5, 5e5])
    assert out["started_before_launch_pct"] == 0.0
    assert out["early_busy_in_lora_pct"] == 0.0
    assert out["idle_pct_by_span_moved"] == out["idle_pct_by_span"]
    # the scatter's copy ends at 6, the gemm at 8: both inside the step
    assert out["step_clock_ok"] and out["op_outside_its_step_us"] == 0.0
    # device busy [3, 4.5], [5, 6], [6.5, 8], [9.6, 9.7]: idle [0, 3]
    # (iteration 0-1, step.call 1-2, lora.plan 2-3), [4.5, 5]
    # (lora.scatter), [6, 6.5] (step.call), [8, 9.6] (step.sync 8-9,
    # iteration 9-9.6), [9.7, 10] (iteration)
    assert out["idle_pct_by_span"] == pytest.approx(
        {"iteration": 10 * (1 + 0.6 + 0.3), "step.call": 15.0,
         "lora.plan": 10.0, "lora.scatter": 5.0, "step.sync": 10.0})
    assert out["idle_in_lora_pct"] == pytest.approx(15.0)
    assert out["outside_step_spans_pct"] == pytest.approx(20.0)


def test_an_op_stamped_before_its_launch_bounds_the_idle_split():
    """The kernels' op launched at 3.5 stamped at [2.2, 2.7], inside
    lora.plan: the idle split counts that half second busy; moved to its
    launch it runs [3.5, 4.0], inside work already there."""
    run = _hand_made()
    run.trace.launches.ops[1] = DeviceOp("sgmv_shrink", 2.2, 2.7, 11, 0)
    out = diagnose(run)
    assert out["started_before_launch_pct"] == pytest.approx(25.0)
    assert out["early_ops"] == [["sgmv_shrink <- cudaLaunchKernel", 1,
                                 pytest.approx(-1.3e6)]]
    assert out["early_busy_pct_by_span"] == pytest.approx({"lora.plan": 5.0})
    assert out["early_busy_in_lora_pct"] == pytest.approx(5.0)
    # as stamped: idle in lora.plan [2, 2.2] + [2.7, 3] and lora.scatter
    # [4, 5]; moved: lora.plan [2, 3], lora.scatter [4, 5] (the index
    # kernel covers lora.kernels [3, 4] either way)
    assert out["idle_in_lora_pct"] == pytest.approx(15.0)
    assert out["idle_in_lora_pct_moved"] == pytest.approx(20.0)


def test_an_op_outside_its_step_is_flagged():
    run = _hand_made()
    run.trace.launches.ops[3] = DeviceOp("gemm", 6.5, 9.1, 13, 0)
    out = diagnose(run)
    assert out["op_outside_its_step_us"] == pytest.approx(1e5)
    assert not out["step_clock_ok"]


def test_linked_ids_are_used_where_they_match_more():
    run = _hand_made()
    run.trace.launches.ops = [DeviceOp(o.name, o.t0, o.t1, 0, o.corr)
                              for o in run.trace.launches.ops]
    assert read(run)["matched_by"] == "linked_correlation_id"


def test_the_profiler_clock_is_fitted_on_the_step_syncs():
    """Two steps' syncs, the profiler's stamps 3 ms late and drifting
    100 ppm: the fit finds both and moves the stamps back."""
    tree = SpanTree([_span(0, "step.sync", 1.0, 1.001),
                     _span(1, "step.sync", 11.0, 11.001),
                     _span(2, "step.sync", 40.0, 40.001)])

    def late(t):
        return t + 3e-3 + 1e-4 * t

    syncs = [("cudaDeviceSynchronize", late(a), late(b))
             for a, b in ((1.0, 1.001), (11.0, 11.001), (40.0, 40.001))]
    launches = Launches([DeviceOp("k", late(5.0), late(5.5), 1, 0)],
                        {1: ("cudaLaunchKernel", late(4.0), late(4.01))},
                        syncs + [("cudaStreamSynchronize", 2.0, 2.1)])
    coef, resid = clock_fit(tree, launches)
    assert coef[0] == pytest.approx(1e-4, rel=1e-3)
    assert max(abs(r) for r in resid) < 1e-9
    moved = shifted(launches, coef)
    assert moved.ops[0].t0 == pytest.approx(5.0, abs=1e-7)
    assert moved.calls[1][1] == pytest.approx(4.0, abs=1e-7)


def test_hand_made_trace_reads_the_same_aligned():
    run = _hand_made()
    spans = run.rec.wall_spans.spans
    spans.append(_span(20, "step.sync", 9.8, 9.9, 0))
    run.trace.launches.syncs = [("cudaDeviceSynchronize", 7.0, 9.0),
                                ("cudaDeviceSynchronize", 9.8, 9.9)]
    out = diagnose(run)
    assert out["clock_offset_us"] == pytest.approx(0.0, abs=1e-6)
    assert out["decode_launches"] == 4
    assert out["idle_in_lora_pct"] == pytest.approx(15.0)


def _nested(rng, lo, hi, parent, out, depth):
    t = lo
    while depth and t < hi and rng.random() < 0.8:
        a = t + rng.uniform(0, (hi - t) / 2)
        b = a + rng.uniform(0, (hi - a) / 2)
        sid = len(out)
        out.append(_span(sid, f"s{sid}", a, b, parent))
        _nested(rng, a, b, sid, out, depth - 1)
        t = b
    return out


def test_innermost_matches_a_brute_force_search():
    rng = random.Random(3)
    spans = _nested(rng, 0.0, 100.0, -1, [], 5)
    tree = SpanTree(spans)
    for _ in range(2000):
        t = rng.uniform(-1, 101)
        open_ = [s for s in spans if s[2] <= t <= s[3]]
        want = max(open_, key=lambda s: (s[2], s[0])) if open_ else None
        assert tree.innermost(t) == want, t


def test_idle_helpers():
    assert idle_gaps([(2, 3), (2.5, 4), (6, 12)], 0, 10) == [
        (0, 2), (4, 6)]
    tree = SpanTree([_span(0, "a", 1, 5), _span(1, "b", 2, 3, 0)])
    assert by_span(tree, [(0, 2.5), (4, 6)], 0, 6) == pytest.approx(
        {"outside spans": 2.0, "a": 2.0, "b": 0.5})
    # busy [2.5, 4]: idle the same two intervals
    assert idle_by_span(tree, [(2.5, 3), (3, 4)], 0, 6) == pytest.approx(
        {"outside spans": 2.0, "a": 2.0, "b": 0.5})


@pytest.fixture(scope="module")
def small_probe():
    torch.set_num_threads(2)
    return span_probe.probe(small_cell("qwen2-0.5b.tenants1k"),
                            2 ** 31 + 21, 1.5, 8, 2, torch.device("cpu"))


def test_probe_prints_the_cpu_readable_readings(small_probe):
    sp = small_probe["spans"]
    assert sp["decode_enqueue_ms"] > 0 and sp["load_wait_p90_ms"] > 0
    assert sp["decode_enqueue_ms"] <= sp["decode_step_span_ms"]
    h = small_probe["harness"]
    assert sp["decode_wall_s_ms"] == pytest.approx(h["decode_step_ms"])
    assert sp["prefill_step_span_ms"] == pytest.approx(
        h["prefill_step_ms"], rel=0.02)
    assert sp["outside_step_spans_pct"] <= h["host_outside_steps_pct"]
    cost = small_probe["cost"]
    for name, rounds in (("decode", 8), ("prefill", 2)):
        assert len(cost[name]["off_ms"]) == len(cost[name]["on_ms"]) \
            == rounds
        assert cost[name]["spans"] > 0
    assert cost["span_us"] > 0


def test_recorder_stamps_unchanged_with_spans_on():
    torch.set_num_threads(2)
    cell = small_cell("sc2-7b.longctx")
    served = bench.set_up(cell, 5, torch.device("cpu"), lambda m: None)
    run = span_probe.spans_window(served, bench.requests_for(cell, 5, 1.0),
                                  1.0, False, True)
    steps = [s for s in run.rec.wall_spans.spans if s[1] == "step"]
    assert len(steps) == len(run.rec.steps) > 0
    for rs, sp in zip(run.rec.steps, steps):
        assert sp[5]["kind"] == rs.kind
        assert tuple(sp[5]["requests"]) == rs.requests
        # the span's raw seconds are the recorder's two readings apart:
        # the engine read its timer exactly as before
        assert sp[5]["wall_s"] == rs.t1 - rs.t0
        assert sp[2] <= rs.t0 and rs.t1 <= sp[3]
    kinds = {s.kind for s in run.rec.steps}
    assert kinds & set(DECODE_KINDS) and kinds & set(PREFILL_KINDS)
