"""Serving metrics (paper §5, Metrics): throughput, request latency,
first-token latency (TTFT), per-output-token latency (TPOT), SLO
attainment, plus an energy *proxy* (bytes+FLOPs; see DESIGN.md §8 — no
wattmeter exists in this container).

Conventions: all times are virtual-clock **seconds** (the engine advances
its clock by measured jit'd-step wall-times, scaled by
``EngineConfig.time_scale``). "Completed" means ``finish_time`` is set;
requests the admission controller rejected (``Request.rejected`` in
{'shed', 'timeout'}) are **excluded from every latency/percentile
aggregate** (they produced no tokens) but **included in SLO-attainment
denominators** (a shed deadline is a missed deadline) and reported via
``shed_requests``/``timeout_requests``/``slo_stats``.

Zero-completed runs (nothing finished: everything rejected, the trace
was empty, or ``max_sim_time`` cut the run short) report **NaN** for
every latency-shaped aggregate — ``avg_latency``, ``avg_first_token``,
all percentiles, and ``slo_attainment`` alike. There is no attainment
evidence without a completion, so NaN ("no data"), not 0.0 ("all
missed"). Rate-shaped fields (``throughput``, ``tokens_per_second``)
stay 0.0: zero events per second is well-defined.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.slots import Request


def fmt_num(v: Optional[float], digits: int = 3) -> str:
    """``'n/a'`` for None/NaN/inf, fixed-point otherwise — the one
    number format every digest row (and ``tools/trace_report.py``)
    shares."""
    if v is None:
        return "n/a"
    v = float(v)
    if not np.isfinite(v):
        return "n/a"
    return f"{v:.{digits}f}"


def format_digest(fields: Sequence[Tuple[str, object]]) -> str:
    """Render ``(key, value)`` pairs as the ``k=v;k=v`` single-line
    digest used by every ``*_row`` method below (and reused by
    ``tools/trace_report.py``): ';'-separated so a digest stays one
    column in the benchmarks' ``name,us_per_call,derived`` CSV rows."""
    return ";".join(f"{k}={v}" for k, v in fields)


@dataclass
class ServingSummary:
    # ---- core run accounting -----------------------------------------
    n_requests: int              # requests in the trace handed to serve()
    n_completed: int             # requests with a finish_time
    duration: float              # virtual-clock run length (s)
    throughput: float            # completed requests / duration (req/s)
    avg_latency: float           # mean arrival→finish over completed (s)
    avg_first_token: float       # mean arrival→first-token (TTFT) (s)
    p99_first_token: float       # 99th-percentile TTFT (s)
    # fraction of completed requests whose TTFT beat the *global*
    # EngineConfig.slo_seconds knob (the paper's single-SLO metric;
    # per-request ttft_slo/tpot_slo attainment lives in slo_stats)
    slo_attainment: float
    tokens_per_second: float     # generated tokens / duration
    cache_hit_rate: Optional[float] = None   # adapter-pool hits / lookups
    adapter_loads: Optional[int] = None      # host→HBM adapter transfers
    # busy_time / duration: fraction of the clock spent in measured
    # compute — the bytes+FLOPs stand-in for energy (DESIGN.md §8)
    energy_proxy: Optional[float] = None
    # per-phase step invocation counts (one jit'd call each): batched
    # prompt-shaped compute makes prefill_steps + router_steps fall below
    # the number of requests served — the amortization the batching
    # benchmarks assert on. Chunked prefill (prefill_chunk) moves
    # prefill_steps the other way: one call per ≤ chunk-token slice.
    prefill_steps: Optional[int] = None
    decode_steps: Optional[int] = None
    router_steps: Optional[int] = None
    # prefill group size -> #groups (real occupancy, before the engine
    # pads groups to power-of-two batch shapes)
    prefill_batch_hist: Optional[Dict[int, int]] = None
    # most slots simultaneously non-IDLE during the run (the concurrency
    # the paged-KV benchmark compares at fixed arena bytes)
    peak_active_slots: Optional[int] = None
    # paged-KV arena accounting (kv_backend='paged' only): KVPoolStats
    # fields plus arena geometry and the engine's deferral/preemption
    # counts — {backend, n_blocks, block_size, allocs, frees, peak_used,
    # oom_events, deferrals, preemptions}
    kv_stats: Optional[Dict] = None
    # shared-prefix radix cache accounting (prefix_cache=True only):
    # PrefixStats fields — {enabled, lookups, hit_requests, hit_tokens,
    # saved_prefill_tokens, cow_copies, reclaimed_blocks,
    # inserted_blocks, cached_blocks, peak_cached_blocks}
    prefix_stats: Optional[Dict] = None
    # adapter swap-in accounting — {mode (sync|async),
    # load_seconds_total (host→HBM transfer time initiated this serve),
    # load_stall_seconds (clock time stalled on the transfer channel:
    # sync charges every load here; async only the jumps where every
    # runnable slot was load-blocked), overlapped_load_seconds
    # (total − stall: transfer time hidden behind compute),
    # prefetch_issued/hits/waste, cancelled_loads}
    swap_stats: Optional[Dict] = None
    # ---- latency percentiles (seconds, completed requests only) ------
    # TTFT = arrival → first token (queueing + selection + load + prefill)
    ttft_p50: Optional[float] = None
    ttft_p95: Optional[float] = None
    ttft_p99: Optional[float] = None
    # TPOT = (finish − first_token) / (generated − 1): mean decode-step
    # latency per output token; requests with generated ≤ 1 contribute
    # no TPOT sample (there is no decode interval to measure)
    tpot_p50: Optional[float] = None
    tpot_p95: Optional[float] = None
    tpot_p99: Optional[float] = None
    # end-to-end arrival → finish
    latency_p50: Optional[float] = None
    latency_p95: Optional[float] = None
    latency_p99: Optional[float] = None
    # ---- admission control / per-priority SLO accounting --------------
    # requests the admission controller rejected: 'shed' = projected
    # TTFT exceeded the request's ttft_slo at admission (429-style),
    # 'timeout' = the deadline had already passed when the request
    # reached the head of the queue
    shed_requests: int = 0
    timeout_requests: int = 0
    # {"by_priority": {priority: {n, completed, shed, timeout,
    #   ttft_eligible, ttft_attained, ttft_attainment,
    #   tpot_eligible, tpot_attained, tpot_attainment}}}
    # — eligibility means the request carried that SLO; rejected
    # requests stay in the eligible denominator and count as misses
    # (shedding must not launder attainment), which is why
    # ttft_attainment can sit below completed/n
    slo_stats: Optional[Dict] = None
    # ---- per-step latency histogram -----------------------------------
    # charged compute seconds per scheduler iteration (router + prefill
    # + decode steps; cost-model charges like merges and load stalls are
    # accounted separately and excluded), binned by power-of-two
    # milliseconds: {"le_4ms": count} = iterations charged (2, 4] ms.
    # With chunked prefill on, the upper bins empty out — the histogram
    # is the evidence that the chunk budget bounds step time.
    step_time_hist: Optional[Dict[str, int]] = None
    max_step_seconds: Optional[float] = None  # largest single iteration
    # ---- traced-run latency breakdown (tracer attached only) ----------
    # {"n": completed, "mean": {segment: seconds}, "per_request":
    #   {request_id: {queue_wait, select, load_stall, prefill, decode,
    #    preempted, e2e, admits, prefill_chunks}}}
    # — the six segments partition each completed request's
    # arrival→finish interval on the virtual clock, so they sum to e2e
    # (serving/trace.py derives them from slot state-transition spans);
    # None when the engine ran without a tracer
    latency_breakdown: Optional[Dict] = None

    def row(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in (
            "throughput", "avg_latency", "avg_first_token",
            "slo_attainment", "tokens_per_second")}

    def batching_row(self) -> str:
        """Compact step-count digest for benchmark CSV derived fields
        (rendered by ``format_digest``: the digest must stay a single
        CSV column in the ``name,us_per_call,derived`` row format)."""
        hist = "|".join(f"{b}x{n}" for b, n in
                        sorted((self.prefill_batch_hist or {}).items()))
        return format_digest([
            ("pf_steps", self.prefill_steps),
            ("router_steps", self.router_steps),
            ("dec_steps", self.decode_steps),
            ("pf_hist", hist or "n/a")])

    def kv_row(self) -> str:
        """Compact KV-arena digest (same single-CSV-column contract as
        ``batching_row``); 'kv=dense' when the run wasn't paged."""
        kv = self.kv_stats
        if not kv:
            return format_digest([
                ("kv", "dense"), ("peak_active", self.peak_active_slots)])
        return format_digest([
            ("kv", "paged"),
            ("blocks", f"{kv['n_blocks']}x{kv['block_size']}"),
            ("peak_blocks", kv["peak_used"]),
            ("defer", kv["deferrals"]),
            ("preempt", kv["preemptions"]),
            ("peak_active", self.peak_active_slots)])

    def swap_row(self) -> str:
        """Compact adapter swap-in digest (same single-CSV-column
        contract as ``batching_row``)."""
        sw = self.swap_stats
        if not sw:
            return "swap=n/a"
        return format_digest([
            ("swap", sw["mode"]),
            ("load_s", fmt_num(sw["load_seconds_total"])),
            ("stall_s", fmt_num(sw["load_stall_seconds"])),
            ("overlap_s", fmt_num(sw["overlapped_load_seconds"])),
            ("pf", f"{sw['prefetch_hits']}/{sw['prefetch_issued']}"),
            ("waste", sw["prefetch_waste"]),
            ("cancel", sw["cancelled_loads"])])

    def prefix_row(self) -> str:
        """Compact shared-prefix-cache digest (same single-CSV-column
        contract); 'prefix=off' when the run didn't enable it."""
        ps = self.prefix_stats
        if not ps:
            return "prefix=off"
        return format_digest([
            ("prefix", "on"),
            ("hits", f"{ps['hit_requests']}/{ps['lookups']}"),
            ("hit_toks", ps["hit_tokens"]),
            ("saved_toks", ps["saved_prefill_tokens"]),
            ("cow", ps["cow_copies"]),
            ("reclaimed", ps["reclaimed_blocks"]),
            ("cached", ps["cached_blocks"])])

    def slo_row(self) -> str:
        """Compact SLO/percentile digest (same single-CSV-column
        contract): TTFT/TPOT tails, shed/timeout counts, and per-priority
        deadline attainment ('p0=12/15' = 12 of 15 SLO-carrying
        priority-0 requests met their deadline)."""
        fields = [("ttft_p99", fmt_num(self.ttft_p99)),
                  ("tpot_p99", fmt_num(self.tpot_p99)),
                  ("shed", self.shed_requests),
                  ("timeout", self.timeout_requests)]
        if self.max_step_seconds is not None:
            fields.append(("max_step", fmt_num(self.max_step_seconds)))
        by_prio = (self.slo_stats or {}).get("by_priority", {})
        for prio in sorted(by_prio):
            st = by_prio[prio]
            if st["ttft_eligible"]:
                fields.append((
                    f"p{prio}",
                    f"{st['ttft_attained']}/{st['ttft_eligible']}"))
        return format_digest(fields)


def _pct(arr: np.ndarray, q: float) -> float:
    return float(np.percentile(arr, q)) if arr.size else float("nan")


def _slo_stats(requests: List[Request]) -> Dict:
    """Per-priority deadline accounting. Rejected requests stay in the
    eligible denominators (attainment counts them as misses); a request
    still queued when the run ended (no finish, not rejected) likewise
    cannot have attained anything."""
    by_prio: Dict[int, Dict] = {}
    for r in requests:
        st = by_prio.setdefault(getattr(r, "priority", 0), {
            "n": 0, "completed": 0, "shed": 0, "timeout": 0,
            "ttft_eligible": 0, "ttft_attained": 0,
            "tpot_eligible": 0, "tpot_attained": 0})
        st["n"] += 1
        rej = getattr(r, "rejected", None)
        if rej:
            st[rej] += 1
        done = r.finish_time is not None
        if done:
            st["completed"] += 1
        if r.ttft_slo is not None:
            st["ttft_eligible"] += 1
            if done and r.first_token_time is not None and \
                    r.first_token_time - r.arrival_time <= r.ttft_slo:
                st["ttft_attained"] += 1
        if r.tpot_slo is not None and r.output_len > 1:
            st["tpot_eligible"] += 1
            if done and r.first_token_time is not None \
                    and r.generated > 1:
                tpot = (r.finish_time - r.first_token_time) \
                    / (r.generated - 1)
                if tpot <= r.tpot_slo:
                    st["tpot_attained"] += 1
    for st in by_prio.values():
        st["ttft_attainment"] = (st["ttft_attained"] / st["ttft_eligible"]
                                 if st["ttft_eligible"] else float("nan"))
        st["tpot_attainment"] = (st["tpot_attained"] / st["tpot_eligible"]
                                 if st["tpot_eligible"] else float("nan"))
    return {"by_priority": by_prio}


def summarize(requests: List[Request], duration: float,
              slo_seconds: float = 6.0, cache_stats: Optional[Dict] = None,
              energy_proxy: Optional[float] = None,
              step_stats: Optional[Dict] = None) -> ServingSummary:
    """Aggregate a served trace. ``step_stats`` splats extra
    engine-provided fields (step counts, kv/swap/prefix stats, the step
    histogram) straight into the summary; see the field docs above for
    the exclusion rules (rejected requests never enter latency arrays).

    Zero completions (empty trace, everything rejected, or a truncated
    run) is an explicit case: every latency aggregate — means,
    percentiles, and ``slo_attainment`` — is NaN (no evidence, not "all
    missed"; the old ``[nan]`` sentinel arrays made attainment evaluate
    ``mean(nan < slo)`` → a coincidental 0.0). Rates stay 0.0."""
    done = [r for r in requests if r.finish_time is not None]
    lat = np.array([r.finish_time - r.arrival_time for r in done])
    ftl = np.array([r.first_token_time - r.arrival_time for r in done
                    if r.first_token_time is not None])
    tpot = np.array([(r.finish_time - r.first_token_time)
                     / (r.generated - 1) for r in done
                     if r.first_token_time is not None and r.generated > 1])
    tokens = sum(r.generated for r in done)
    n_shed = sum(1 for r in requests
                 if getattr(r, "rejected", None) == "shed")
    n_timeout = sum(1 for r in requests
                    if getattr(r, "rejected", None) == "timeout")
    return ServingSummary(
        n_requests=len(requests),
        n_completed=len(done),
        duration=duration,
        throughput=len(done) / duration if duration > 0 else 0.0,
        avg_latency=float(np.mean(lat)) if lat.size else float("nan"),
        avg_first_token=float(np.mean(ftl)) if ftl.size else float("nan"),
        p99_first_token=_pct(ftl, 99),
        slo_attainment=(float(np.mean(ftl < slo_seconds))
                        if ftl.size else float("nan")),
        tokens_per_second=tokens / duration if duration > 0 else 0.0,
        cache_hit_rate=cache_stats.hit_rate if cache_stats else None,
        adapter_loads=cache_stats.loads if cache_stats else None,
        energy_proxy=energy_proxy,
        ttft_p50=_pct(ftl, 50), ttft_p95=_pct(ftl, 95),
        ttft_p99=_pct(ftl, 99),
        tpot_p50=_pct(tpot, 50), tpot_p95=_pct(tpot, 95),
        tpot_p99=_pct(tpot, 99),
        latency_p50=_pct(lat, 50), latency_p95=_pct(lat, 95),
        latency_p99=_pct(lat, 99),
        shed_requests=n_shed,
        timeout_requests=n_timeout,
        slo_stats=_slo_stats(requests),
        **(step_stats or {}),
    )
