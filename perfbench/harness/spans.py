"""A traced window read against the program's wall spans
(``EngineTracer(wall_spans=True)``, ``repro_torch/serving/trace.py``).

Every device operation (kernel, copy, memset) of the profiler's record is
matched to its launch on the host, the CUDA runtime call with the same
correlation id, and belongs to the innermost program span open at that
launch. Every idle gap of the device is split by the innermost span the
host was in. Both clocks are ``perf_counter`` seconds: the spans read it
directly, the profiler's stamps go through ``DeviceTrace``'s offset.

``LaunchTrace`` is a ``DeviceTrace`` that also keeps those events.
``read(run)`` gives the five readings the span record was built for
(``decode_enqueue_ms``, ``decode_launches``, ``idle_in_lora_pct``,
``lora_shuffle_device_pct``, ``load_wait_p90_ms``) and the step and
attribution readings that check them. Nothing of the benchmark's runs
calls this module yet; ``span_probe.py`` does, and adds its own
diagnostics.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from perfbench.harness.devtrace import DeviceTrace, TraceSummary
from perfbench.harness.recorder import DECODE_KINDS, PREFILL_KINDS

# the spans whose launches shuffle rows for the LoRA wrapper, and the
# whole wrapper
LORA_SHUFFLE = ("lora.plan", "lora.gather", "lora.scatter")
LORA = ("lora", "lora.kernels") + LORA_SHUFFLE


@dataclass
class DeviceOp:
    name: str
    t0: float            # perf_counter seconds
    t1: float
    corr: int
    linked: int


@dataclass
class Launches:
    """A traced window's device operations and the host's runtime calls,
    on the ``perf_counter`` clock."""
    ops: List[DeviceOp]
    calls: Dict[int, Tuple[str, float, float]]   # corr -> (name, t0, t1)
    syncs: List[Tuple[str, float, float]] = field(default_factory=list)
    duplicate_ids: int = 0     # runtime calls whose id an earlier one had


def _kineto_launches(results, device_type, offset: float) -> Launches:
    ops: List[DeviceOp] = []
    calls: Dict[int, Tuple[str, float, float]] = {}
    syncs: List[Tuple[str, float, float]] = []
    dup = 0
    for e in results.events():
        a = e.start_ns() * 1e-9 - offset
        b = a + e.duration_ns() * 1e-9
        if e.device_type() == device_type:
            ops.append(DeviceOp(e.name(), a, b, e.correlation_id(),
                                e.linked_correlation_id()))
            continue
        name = e.name()
        if not name.startswith("cu"):
            continue
        if e.correlation_id():
            if e.correlation_id() in calls:
                dup += 1
            calls[e.correlation_id()] = (name, a, b)
        if "Synchronize" in name:
            syncs.append((name, a, b))
    return Launches(ops, calls, syncs, dup)


class LaunchTrace(DeviceTrace):
    """``DeviceTrace`` whose summary also carries ``launches``: every
    device operation with its correlation ids, and the runtime calls."""

    def end(self, start: float, stop: float, phase_of) -> TraceSummary:
        summary = super().end(start, stop, phase_of)
        summary.launches = _kineto_launches(
            self._prof.profiler.kineto_results, self._dtype, self._offset)
        return summary


class SpanTree:
    """The closed call-tree spans of one ``WallSpans`` (tuples
    ``(id, name, t0, t1, parent, args)``), indexed by start."""

    def __init__(self, spans: List[Tuple]) -> None:
        self.by_id = {s[0]: s for s in spans}
        self.order = sorted(spans, key=lambda s: (s[2], s[0]))
        self.starts = [s[2] for s in self.order]
        self.children: Dict[int, List[Tuple]] = {}
        for s in spans:
            self.children.setdefault(s[4], []).append(s)

    def innermost(self, t: float) -> Optional[Tuple]:
        """The innermost span open at ``t``: the latest to start by
        ``t``, or, where that one had ended, its nearest ancestor still
        open (spans nest, so no other can be)."""
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.order[i] if i >= 0 else None
        while s is not None and s[3] < t:
            s = self.by_id.get(s[4])
        return s

    def ancestor(self, s: Optional[Tuple], name: str) -> Optional[Tuple]:
        while s is not None and s[1] != name:
            s = self.by_id.get(s[4])
        return s

    def segments(self, lo: float, hi: float
                 ) -> List[Tuple[float, float, Optional[Tuple]]]:
        """[lo, hi] cut where the innermost span changes:
        (a, b, innermost span or None)."""
        cuts = sorted({lo, hi} | {t for s in self.order for t in s[2:4]
                                   if lo < t < hi})
        return [(a, b, self.innermost(0.5 * (a + b)))
                for a, b in zip(cuts, cuts[1:])]


def match(launches: Launches) -> Tuple[str, Dict[int, float]]:
    """Which of the device events' ids names their launch (the profiler
    builds differ), and op index -> launch time."""
    best: Tuple[str, Dict[int, float]] = ("correlation_id", {})
    for key in ("corr", "linked"):
        found = {i: launches.calls[getattr(op, key)][1]
                 for i, op in enumerate(launches.ops)
                 if getattr(op, key) in launches.calls}
        if len(found) > len(best[1]):
            best = ("correlation_id" if key == "corr"
                    else "linked_correlation_id", found)
    return best


def attributed(tree: SpanTree, launches: Launches, at: Dict[int, float],
               lo: float, hi: float
               ) -> Iterator[Tuple[int, float, Optional[Tuple]]]:
    """Each operation that runs in [lo, hi]: (its index, its device
    seconds there, the innermost span open at its launch, or None where
    it has no launch or none was open)."""
    for i, op in enumerate(launches.ops):
        a, b = max(op.t0, lo), min(op.t1, hi)
        if b > a:
            yield i, b - a, tree.innermost(at[i]) if i in at else None


def idle_gaps(ops: List[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The gaps in [lo, hi] where none of the ``ops`` intervals runs."""
    out, cursor = [], lo
    for a, b in sorted(ops):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def by_span(tree: SpanTree, intervals: List[Tuple[float, float]],
            lo: float, hi: float) -> Dict[str, float]:
    """Seconds of the (sorted, disjoint) ``intervals`` by the innermost
    span the host was in ("outside spans" where none was open)."""
    out: Dict[str, float] = {}
    segs = tree.segments(lo, hi)
    j = 0
    for ga, gb in intervals:
        while j < len(segs) and segs[j][1] <= ga:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < gb:
            a, b, s = segs[k]
            d = min(b, gb) - max(a, ga)
            if d > 0:
                name = s[1] if s is not None else "outside spans"
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out


def idle_by_span(tree: SpanTree, ops: List[Tuple[float, float]],
                 lo: float, hi: float) -> Dict[str, float]:
    """Idle seconds of the device in [lo, hi] by the innermost span the
    host was in."""
    return by_span(tree, idle_gaps(ops, lo, hi), lo, hi)


def window_steps(tree: SpanTree, lo: float, hi: float,
                 kinds: tuple) -> List[Tuple]:
    """The ``kinds`` steps the harness counts in [lo, hi]: its stamps
    are the engine's timer readings, which lie between the step span's
    start and its first child's, and its last child's end and its own."""
    out = []
    for s in tree.order:
        if s[1] == "step" and s[5]["kind"] in kinds:
            kids = tree.children.get(s[0], ())
            if kids and min(c[2] for c in kids) >= lo \
                    and max(c[3] for c in kids) <= hi:
                out.append(s)
    return out


def sync_s(tree: SpanTree, step: Tuple) -> float:
    """Seconds of ``step``'s closing sync (its ``step.sync`` child)."""
    return sum(c[3] - c[2] for c in tree.children.get(step[0], ())
               if c[1] == "step.sync")


def read(run, launches: Optional[Launches] = None) -> Dict:
    """The readings of a window whose recorder kept wall spans
    (``run.rec.wall_spans``); the device's ones from ``launches``, by
    default those of ``run.trace`` where it is a ``LaunchTrace``'s.
    A reading with nothing to read is None."""
    tree = SpanTree(run.rec.wall_spans.spans)
    out: Dict = {}
    ms = 1e3
    # -- the model step, on the host ------------------------------------
    decode = window_steps(tree, run.start, run.end, DECODE_KINDS)
    prefill = window_steps(tree, run.start, run.end, PREFILL_KINDS)
    for label, steps in (("decode", decode), ("prefill", prefill)):
        out[f"{label}_steps"] = len(steps)
        if steps:
            out[f"{label}_step_span_ms"] = ms * float(np.mean(
                [s[3] - s[2] for s in steps]))
            out[f"{label}_wall_s_ms"] = ms * float(np.mean(
                [s[5]["wall_s"] for s in steps]))
            out[f"{label}_sync_ms"] = ms * float(np.mean(
                [sync_s(tree, s) for s in steps]))
    out["decode_enqueue_ms"] = (
        out["decode_step_span_ms"] - out["decode_sync_ms"] if decode
        else None)
    # -- the adapter pool -----------------------------------------------
    waits = [ms * (t1 - t0)
             for _, state, t0, t1, _, _ in run.rec.wall_spans.slots
             if state == "loading" and run.start <= t1 <= run.end]
    out["load_wait_p90_ms"] = (float(np.percentile(waits, 90))
                               if waits else None)
    # -- the device, by launch ------------------------------------------
    trace = run.trace
    if launches is None and trace is not None:
        launches = getattr(trace, "launches", None)
    for key in ("attributed_pct", "decode_launches", "idle_in_lora_pct",
                "lora_shuffle_device_pct"):
        out[key] = None
    if launches is None:
        return out
    lo, hi = trace.start, trace.stop
    out["matched_by"], at = match(launches)
    total = 0.0
    device: Dict[str, float] = {}
    decode_ops = 0
    for i, d, s in attributed(tree, launches, at, lo, hi):
        total += d
        if s is None:
            continue
        device[s[1]] = device.get(s[1], 0.0) + d
        step = tree.ancestor(s, "step")
        if step is not None and step[5]["kind"] in DECODE_KINDS \
                and run.start <= step[2] and step[3] <= run.end:
            decode_ops += 1
    window = trace.window_s
    if total:
        out["attributed_pct"] = 100.0 * sum(device.values()) / total
    if decode:
        out["decode_launches"] = decode_ops / len(decode)
    out["lora_shuffle_device_pct"] = 100.0 * sum(
        device.get(n, 0.0) for n in LORA_SHUFFLE) / window
    idle = idle_by_span(tree, [(op.t0, op.t1) for op in launches.ops],
                        lo, hi)
    out["idle_in_lora_pct"] = 100.0 * sum(
        idle.get(n, 0.0) for n in LORA) / window
    return out
