"""Engine-wide tracing: typed events and spans on the virtual clock
(a copy of ``repro.serving.trace``; the event stream, its names and the
export format are the reference's, so the same tools read both).

The serving engine's timeline is *virtual* — the clock advances by
measured step wall-times plus cost-model charges — so a trace of
that clock is a complete, deterministic record of where every request's
latency went. :class:`EngineTracer` collects that record:

* **slot state spans** — each slot's residency in SELECTING / LOADING /
  PREFILL / GENERATE, one span per state visit (IDLE is the gap between
  spans, not a span);
* **compute spans** — every ``_timed`` charge (prefill / decode /
  router groups), keyed exactly like the engine's timing table
  ``(kind, bucket, B)``, with the measured wall seconds and the request
  ids the group served attached;
* **transfer spans** — the adapter channel's host→HBM loads and
  prefetches as booked intervals ``[ready − load_seconds, ready]``,
  plus cancel/evict instants;
* **arena events** — KV page alloc / free / OOM / LRU-reclaim /
  copy-on-write instants fired by ``PagedKVPool``'s event hook;
* **scheduler decisions** — admit / defer (pool or KV) / shed /
  timeout / preempt / requeue / merge instants;
* **compile events** — every first-seen ``_timed`` key (in the port,
  the step's uncharged warm-up call: there is no jit cache, but each
  new ``(kind, bucket, B)`` key is a new step shape), feeding the
  shape watchdog (:func:`jit_cache_report`).

From the slot spans the tracer derives a **per-request latency
breakdown**: each completed request's end-to-end latency decomposed
into ``queue_wait`` (arrival→admission, including re-queue waits after
a preemption), ``select``, ``load_stall``, ``prefill``, ``decode``, and
``preempted`` (in-slot time discarded by a KV preemption). The six
segments provably sum to ``finish − arrival``: every instant of the
request's life is spent either queued or resident in exactly one slot
state — the tracer just integrates the transition times the engine
already moves requests through.

The tracer is **opt-in and zero-cost when absent**: every engine call
site guards on ``self.tracer is not None``, so ``tracer=None`` (the
default) allocates nothing and the token streams / summary are
bit-identical to an untraced engine (regression-tested). A traced run
also never changes behavior — instrumentation is read-only — so
enabling it only adds the recording overhead.

``EngineTracer.export(path)`` writes a Chrome-trace/Perfetto JSON
(``traceEvents`` with slots, channel, arena, scheduler, and compute as
tracks, metrics series as counter tracks) plus an ``edgelora`` section
carrying the raw events, metric series, per-request breakdowns, and
the watchdog report — ``tools/trace_report.py`` analyzes that section,
and ``benchmarks/schema.py``'s ``validate_trace_file`` schema-checks
the whole artifact in CI.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.serving.metrics_registry import MetricsRegistry

# slot states that are recorded as spans (IDLE is the absence of a span)
_ACTIVE_STATES = ("selecting", "loading", "prefill", "generate")

# slot state -> latency-breakdown segment
_STATE_SEGMENT = {"selecting": "select", "loading": "load_stall",
                  "prefill": "prefill", "generate": "decode"}

BREAKDOWN_SEGMENTS = ("queue_wait", "select", "load_stall", "prefill",
                      "decode", "preempted")

# the compute-span kinds that constitute prompt prefill (chunked or not)
_PREFILL_KINDS = ("prefill", "prefill_merged", "prefill_sfx",
                  "prefill_sfx_merged", "prefill_sfx_dense",
                  "prefill_sfx_dense_merged")


class JitRecompileError(RuntimeError):
    """The engine's step keys hold shapes outside the documented bound —
    a silent shape-explosion regression (e.g. a group that stopped
    padding to power-of-two occupancy) has crept in."""


class _RequestAcct:
    """Per-request latency integration driven by slot transitions."""

    __slots__ = ("arrival", "queue_wait", "segments", "pending",
                 "queue_since", "preempted", "admits", "prefill_chunks",
                 "finish")

    def __init__(self, arrival: float) -> None:
        self.arrival = arrival
        self.queue_wait = 0.0
        self.segments = {s: 0.0 for s in _STATE_SEGMENT.values()}
        self.pending = {s: 0.0 for s in _STATE_SEGMENT.values()}
        self.queue_since = arrival
        self.preempted = 0.0
        self.admits = 0
        self.prefill_chunks = 0
        self.finish: Optional[float] = None

    def breakdown(self) -> Dict[str, float]:
        out = {"e2e": (self.finish - self.arrival
                       if self.finish is not None else float("nan")),
               "queue_wait": self.queue_wait,
               "preempted": self.preempted,
               "admits": self.admits,
               "prefill_chunks": self.prefill_chunks}
        out.update(self.segments)
        return out


class EngineTracer:
    """Structured event/span recorder for one ``serve()`` run.

    One tracer traces one serve: pass a fresh instance per run
    (``begin`` raises on reuse). ``strict_watchdog=True`` (default)
    makes the engine raise :class:`JitRecompileError` at the end of the
    run when the jit-cache report finds shape violations; ``False``
    records the report without failing the run.
    """

    def __init__(self, strict_watchdog: bool = True) -> None:
        self.events: List[Dict] = []
        self.now = 0.0
        self.metrics = MetricsRegistry()
        self.strict_watchdog = strict_watchdog
        self.meta: Dict = {}
        self.watchdog_report: Optional[Dict] = None
        self._slot_state: Dict[int, Tuple[str, float, Optional[int]]] = {}
        self._acct: Dict[int, _RequestAcct] = {}
        self._began = False
        self._finished = False

    # -- lifecycle --------------------------------------------------------

    def begin(self, now: float, n_slots: int, meta: Optional[Dict] = None
              ) -> None:
        if self._began:
            raise RuntimeError(
                "EngineTracer traces one serve() run; create a fresh "
                "tracer per run")
        self._began = True
        self.now = now
        self.meta = dict(meta or {})
        self.meta["n_slots"] = n_slots
        for i in range(n_slots):
            self._slot_state[i] = ("idle", now, None)

    def finish(self, now: float) -> Dict:
        """Close any still-open slot spans (a ``max_sim_time``-truncated
        run leaves slots mid-state) and return the per-request latency
        breakdowns for completed requests."""
        self.clock(now)
        for idx, (state, since, rid) in list(self._slot_state.items()):
            if state != "idle":
                self._emit_state_span(idx, state, since, now, rid,
                                      truncated=True)
                self._slot_state[idx] = ("idle", now, None)
        self._finished = True
        return self.request_breakdowns()

    # -- clock ------------------------------------------------------------

    def clock(self, now: float) -> None:
        if now > self.now:
            self.now = now

    # -- event emitters (engine-facing) ----------------------------------

    def _emit(self, t: float, track: str, kind: str, name: str,
              dur: float = 0.0, args: Optional[Dict] = None) -> None:
        ev = {"t": float(t), "track": track, "kind": kind, "name": name}
        if dur:
            ev["dur"] = float(dur)
        if args:
            ev["args"] = args
        self.events.append(ev)

    def _emit_state_span(self, slot: int, state: str, t0: float,
                         t1: float, rid: Optional[int],
                         **extra: Any) -> None:
        args = {"request": rid}
        args.update(extra)
        self._emit(t0, f"slot{slot}", "state", state, dur=t1 - t0,
                   args=args)

    def transition(self, t: float, slot: int, old: str, new: str,
                   request: Any, **extra: Any) -> None:
        """Record ``slot`` leaving ``old`` for ``new`` at virtual time
        ``t``; closes the open ``old`` span and integrates the request's
        latency accounting. ``request`` is the engine's Request object
        (only ``request_id`` / ``arrival_time`` are read)."""
        self.clock(t)
        cur, since, cur_rid = self._slot_state[slot]
        if cur != old:
            raise ValueError(
                f"slot {slot}: transition {old}->{new} at t={t:.6f} but "
                f"tracked state is {cur!r} (unbalanced span)")
        rid = request.request_id if request is not None else cur_rid
        if old != "idle":
            self._emit_state_span(slot, old, since, t, rid, next=new)
        self._slot_state[slot] = (new, t, rid if new != "idle" else None)

        acct = self._acct.get(rid)
        if acct is None:
            acct = self._acct[rid] = _RequestAcct(
                getattr(request, "arrival_time", t))
        if old == "idle":  # admission
            acct.queue_wait += max(0.0, t - acct.queue_since)
            acct.admits += 1
            acct.pending = {s: 0.0 for s in _STATE_SEGMENT.values()}
        else:
            acct.pending[_STATE_SEGMENT[old]] += t - since
        if new == "idle":
            if extra.get("preempted"):
                acct.preempted += sum(acct.pending.values())
                acct.pending = {s: 0.0 for s in _STATE_SEGMENT.values()}
                acct.queue_since = t
            else:  # completed
                for seg, v in acct.pending.items():
                    acct.segments[seg] += v
                acct.pending = {s: 0.0 for s in _STATE_SEGMENT.values()}
                acct.finish = t

    def compute(self, t: float, dt: float, key: Tuple,
                requests: Optional[List[int]] = None) -> None:
        """One charged step: a span ``[t, t + dt]`` on the compute
        track, named by its timing key, carrying the request ids the
        group served."""
        kind = key[0]
        name = kind + "".join(f" {k}" for k in key[1:])
        args: Dict = {"key": list(key)}
        if requests:
            args["requests"] = list(requests)
            if kind in _PREFILL_KINDS:
                for rid in requests:
                    acct = self._acct.get(rid)
                    if acct is not None:
                        acct.prefill_chunks += 1
        self._emit(t, "compute", "compute", name, dur=dt, args=args)

    def compile(self, t: float, key: Tuple) -> None:
        """First sighting of a ``_timed`` key: the step's uncharged
        warm-up (the reference's jit compilation). The event keeps the
        reference's name, so both packages' traces compare event for
        event."""
        self._emit(t, "compute", "compile",
                   "jit-compile " + " ".join(str(k) for k in key),
                   args={"key": list(key)})

    def sched(self, t: float, name: str, request: Any = None,
              **args: Any) -> None:
        """Scheduler decision instant: admit / defer_pool / defer_kv /
        shed / timeout / preempt / requeue / merge."""
        self.clock(t)
        if request is not None:
            args["request"] = request.request_id
        self._emit(t, "scheduler", "sched", name, args=args or None)

    # -- hooks (wired onto the pool / manager by the engine) --------------

    def channel_hook(self, name: str, t: Optional[float], args: Dict
                     ) -> None:
        """AdapterMemoryManager event hook. ``load``/``prefetch`` carry
        ``ready``/``load_seconds`` and become transfer spans over the
        booked channel interval; everything else (cancel, evict) is an
        instant."""
        if t is None:
            t = self.now
        self.clock(t)
        ls = args.get("load_seconds", 0.0)
        if name in ("load", "prefetch") and ls > 0.0:
            self._emit(args["ready"] - ls, "channel", "transfer",
                       f"{name} a{args['adapter']}", dur=ls, args=args)
        else:
            self._emit(t, "channel", name, f"{name} a{args['adapter']}",
                       args=args)

    def arena_hook(self, name: str, args: Dict) -> None:
        """PagedKVPool event hook (the pool has no clock: events land at
        the tracer's current virtual time)."""
        self._emit(self.now, "arena", "arena", name, args=args)

    # -- per-step metrics sampling ---------------------------------------

    def sample(self, t: float, **gauges: float) -> None:
        self.clock(t)
        for name, value in gauges.items():
            self.metrics.gauge(name).set(value)
        self.metrics.sample(t)

    # -- derived views ----------------------------------------------------

    def open_spans(self) -> List[Tuple[int, str]]:
        """Slots currently mid-state (non-empty only before finish())."""
        return [(i, st) for i, (st, _, _) in self._slot_state.items()
                if st != "idle"]

    def request_breakdowns(self) -> Dict[int, Dict[str, float]]:
        """request_id → latency breakdown, completed requests only.
        Segment sums equal end-to-end latency (fp tolerance)."""
        return {rid: acct.breakdown()
                for rid, acct in sorted(self._acct.items())
                if acct.finish is not None}

    def breakdown_summary(self) -> Optional[Dict]:
        """The ``ServingSummary.latency_breakdown`` payload: per-request
        breakdowns plus per-segment means over completed requests."""
        per_request = self.request_breakdowns()
        if not per_request:
            return {"n": 0, "mean": None, "per_request": {}}
        n = len(per_request)
        mean = {seg: sum(b[seg] for b in per_request.values()) / n
                for seg in BREAKDOWN_SEGMENTS + ("e2e",)}
        return {"n": n, "mean": mean, "per_request": per_request}

    # -- export -----------------------------------------------------------

    def chrome_events(self) -> List[Dict]:
        """Chrome-trace ``traceEvents`` for Perfetto / chrome://tracing.

        Layout: one process, one thread per slot, plus channel / arena /
        scheduler / compute threads; metric series become counter
        tracks. Times are virtual-clock microseconds."""
        n_slots = int(self.meta.get("n_slots", 0))
        tids = {f"slot{i}": i for i in range(n_slots)}
        tids.update({"compute": 1000, "channel": 1001, "arena": 1002,
                     "scheduler": 1003})
        out: List[Dict] = [{
            "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
            "args": {"name": "edgelora-engine"}}]
        for track, tid in tids.items():
            out.append({"ph": "M", "pid": 0, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
            out.append({"ph": "M", "pid": 0, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        for ev in self.events:
            tid = tids.get(ev["track"])
            if tid is None:  # future-proof: unknown tracks share a tid
                tid = 1999
            base = {"pid": 0, "tid": tid, "name": ev["name"],
                    "cat": ev["kind"], "ts": ev["t"] * 1e6,
                    "args": ev.get("args", {})}
            if "dur" in ev:
                base.update(ph="X", dur=ev["dur"] * 1e6)
            else:
                base.update(ph="i", s="t")
            out.append(base)
        for name, series in self.metrics.series.items():
            for t, v in series:
                out.append({"ph": "C", "pid": 0, "tid": 0, "name": name,
                            "ts": t * 1e6, "args": {"value": v}})
        out.sort(key=lambda e: (e.get("ts", -1.0), e["ph"] != "M"))
        return out

    def to_json(self) -> Dict:
        """The full export payload: ``traceEvents`` (Perfetto opens it
        directly) plus the ``edgelora`` raw section that
        ``tools/trace_report.py`` and the schema check consume."""
        return {
            "displayTimeUnit": "ms",
            "traceEvents": self.chrome_events(),
            "edgelora": {
                "version": 1,
                "meta": self.meta,
                "duration": self.now,
                "events": self.events,
                "metrics": self.metrics.as_dict(),
                "breakdowns": {str(rid): bd for rid, bd in
                               self.request_breakdowns().items()},
                "watchdog": self.watchdog_report,
            },
        }

    def export(self, path: Any) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


# ---------------------------------------------------------------------------
# jit-recompile watchdog
# ---------------------------------------------------------------------------


def _pow2_batches(n_slots: int) -> set:
    """The batch occupancies ``_pad_group`` can produce:
    ``min(2**i, n_slots)``."""
    out, b = set(), 1
    while b < n_slots:
        out.add(b)
        b <<= 1
    out.add(n_slots)
    return out


def jit_cache_report(keys: Iterable[Tuple], *, buckets: Tuple[int, ...],
                     n_slots: int, prefill_chunk: Optional[int] = None,
                     prefix_cache: bool = False, block_size: int = 16,
                     max_ctx: int = 512) -> Dict:
    """Audit the engine's ``_timed`` key set (its step shapes, each
    warmed once uncharged) against the bound the batching design
    promises.

    The batching contract: groups pad to power-of-two occupancy, so the
    plain prefill path runs at most ``#buckets × (⌈log2 n_slots⌉+1)``
    shapes. This report checks that bound — and, structurally, that
    every key is *legal*: batch sizes in the padded set, prefill widths
    drawn from the bucket set (or the chunk width), suffix prefix
    lengths aligned to the chunk / KV-block grid. A key outside those
    sets means some call site stopped padding or bucketing — the silent
    shape explosion this watchdog exists to fail loudly on.

    Returns ``{n_keys, by_kind, bounds, prefill_bound, violations, ok}``.
    """
    keys = list(keys)
    batches = _pow2_batches(n_slots)
    p = len(batches)
    widths = set(buckets)
    if prefill_chunk:
        # a leading chunk prefill runs at width min(chunk, bucket)
        widths |= {min(prefill_chunk, b) for b in buckets}
    # suffix starts/ends are only grid-constrained when chunking *alone*
    # produces them: a prefix-cache hit prefills from
    # min(block-aligned match, prompt_len − 1), and the second arm is an
    # arbitrary (data-dependent) length — those shapes are legal by
    # design and only the generic batch/range checks apply
    constrain_sfx = bool(prefill_chunk) and not prefix_cache
    starts: set = set()
    ends: set = set()
    if constrain_sfx:
        starts = {k * prefill_chunk
                  for k in range(1, max_ctx // prefill_chunk + 1)}
        # a chunk's end is min(start + chunk, bucket)
        ends = {e for e in starts | set(buckets) if e <= max_ctx}

    bounds: Dict[str, Optional[int]] = {
        "prefill": len(widths) * p,
        "prefill_merged": len(widths) * p,
        "router": len(buckets) * p,
        "decode": 1,
        "decode_merged": 1,
    }
    # chunk-grid suffix shapes are enumerable; prefix-cache suffix
    # shapes are data-dependent (one per distinct hit length), so no
    # count bound applies — only structural legality
    sfx_bound = (len(starts) * len(ends) * p if constrain_sfx
                 else (None if prefix_cache else 0))
    for kind in ("prefill_sfx", "prefill_sfx_merged", "prefill_sfx_dense",
                 "prefill_sfx_dense_merged"):
        bounds[kind] = sfx_bound

    by_kind: Dict[str, int] = {}
    violations: List[str] = []
    for key in keys:
        kind = key[0]
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if kind not in bounds:
            violations.append(f"unknown compute kind in key {key!r}")
            continue
        if kind in ("decode", "decode_merged"):
            continue  # shape-free: one [n_slots] step each
        b = key[-1]
        if b not in batches:
            violations.append(
                f"{key!r}: batch {b} not a padded occupancy "
                f"{sorted(batches)} — a group escaped _pad_group")
        if kind in ("prefill", "prefill_merged", "router"):
            allowed = buckets if kind == "router" else widths
            if key[1] not in allowed:
                violations.append(
                    f"{key!r}: width {key[1]} outside the bucket/chunk "
                    f"set {sorted(allowed)}")
        else:  # suffix kinds: (kind, end, start, B)
            end, start = key[1], key[2]
            if not (prefix_cache or prefill_chunk):
                violations.append(
                    f"{key!r}: suffix prefill shape with prefix_cache "
                    "and prefill_chunk both off")
            elif not (0 < start < end <= max_ctx):
                violations.append(
                    f"{key!r}: suffix range [{start}, {end}) outside "
                    f"(0, max_ctx={max_ctx}]")
            elif constrain_sfx and (start not in starts
                                    or end not in ends):
                violations.append(
                    f"{key!r}: suffix range [{start}, {end}) off the "
                    f"chunk grid (chunk={prefill_chunk})")
    for kind, count in by_kind.items():
        bound = bounds.get(kind)
        if bound is not None and count > bound:
            violations.append(
                f"{kind}: {count} compiled shapes exceed the bound "
                f"{bound}")
    return {
        "n_keys": len(keys),
        "by_kind": by_kind,
        "bounds": bounds,
        "prefill_bound": len(widths) * p,
        "pow2_batches": sorted(batches),
        "violations": violations,
        "ok": not violations,
    }


# ---------------------------------------------------------------------------
# trace-level utilities shared by the report/export tools
# ---------------------------------------------------------------------------


def span_utilization(events: List[Dict], duration: float,
                     track: str) -> float:
    """Fraction of ``[0, duration]`` covered by spans on ``track``
    (spans never overlap on single-resource tracks: compute is
    sequential on the virtual clock, the channel serializes)."""
    if duration <= 0:
        return 0.0
    busy = sum(ev.get("dur", 0.0) for ev in events
               if ev["track"] == track and "dur" in ev)
    return min(1.0, busy / duration)


def busiest_spans(events: List[Dict], top: int = 10) -> List[Dict]:
    """Aggregate compute spans by name: count / total / mean seconds,
    sorted by total descending."""
    agg: Dict[str, List[float]] = {}
    for ev in events:
        if ev["kind"] != "compute":
            continue
        cur = agg.setdefault(ev["name"], [0, 0.0])
        cur[0] += 1
        cur[1] += ev.get("dur", 0.0)
    rows = [{"name": name, "count": int(c), "total": tot,
             "mean": tot / c if c else math.nan}
            for name, (c, tot) in agg.items()]
    rows.sort(key=lambda r: -r["total"])
    return rows[:top]
