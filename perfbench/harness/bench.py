"""One run of one cell: set-up, the window, the metrics, the check.

Set-up (``setup_s``): the kernels built or loaded from the checkout's
cache, the weights and the adapter bank drawn from the seed, one
``EdgeLoRAEngine`` serving the bank's host tensors, and one short serve
per step shape the cell's traffic can reach (each prefill group size at
each reachable bucket, and the decode step), so that no step runs for
the first time inside the window.

The window: one ``serve()`` of the seed's requests, all queued at its
start, timed on the harness's wall clock through the engine's ``timer``
and ``tracer`` hooks (``recorder.py``). It opens once the first prefill
step has filled every slot, and holds the whole loop iterations that
begin within ``seconds`` of that (``window_end``). With ``trace`` the
profiler records the device across it (``devtrace.py``).

Then the check: the engine is freed, and the plain reference recomputes
a sample of the finished requests (drawn from the seed, the longest
always in it) from their prompts, their served tokens, the weights and
their adapters (``check.py``).
"""
from __future__ import annotations

import bisect
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import check, spec, traffic, work
from perfbench.harness.devtrace import DeviceTrace, TraceSummary
from perfbench.harness.recorder import (PREFILL_KINDS, Recorder, WallClock,
                                        WindowClosed)
from perfbench.harness.weights import AdapterBank, Weights


class QueueDrained(RuntimeError):
    """The window outlasted the queue: the traffic file's
    ``max_finish_per_s`` is too low for this program."""


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: spec.Cell
    setup_s: float
    start: float         # the window, perf_counter seconds: its start,
    end: float           # its end (``window_end``),
    stop: float          # and the end of the traced serve
    rec: Recorder
    requests: Dict[int, Any]
    load_spans: List[tuple]
    trace: Optional[TraceSummary]
    peaks: Optional[Dict]
    kind: str
    _rows: Optional[list] = field(default=None, repr=False)

    @property
    def cfg(self) -> Dict:
        return self.cell.config

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def traced_rows(self):
        """(step, real rows) of every step the traced window holds."""
        if self._rows is None:
            self._rows = work.step_rows(self.rec.steps_in(self.start,
                                                          self.stop),
                                        self.requests)
        return self._rows

    def clipped_steps(self):
        """Steps with their wall interval clipped to the window."""
        for s in self.rec.steps:
            a, b = max(s.t0, self.start), min(s.t1, self.end)
            if b > a:
                yield s, a, b


def percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def ttft_ms(run: Run) -> List[float]:
    """Admission to first token, of each request whose first token came
    inside the window."""
    admit = run.rec.admit
    return [1e3 * (t - admit[rid])
            for rid, t in run.rec.first_tokens(run.start, run.end).items()
            if rid in admit]


def step_ms(run: Run, kinds: tuple) -> Optional[float]:
    """Mean wall ms of the window's step calls of ``kinds``, each from
    the sync before it to the sync after it."""
    ms = [1e3 * (s.t1 - s.t0) for s in run.rec.steps_in(run.start, run.end)
          if s.kind in kinds]
    return sum(ms) / len(ms) if ms else None


def itl_ms(run: Run) -> List[float]:
    """Every gap between two consecutive tokens of one request."""
    return [1e3 * (b - a)
            for stamps in run.rec.tokens_in(run.start, run.end).values()
            for a, b in zip(stamps, stamps[1:]) if b > run.start]


def reachable_buckets(engine: Any, req_spec: Dict) -> List[int]:
    lo, hi = req_spec["prompt_len"]
    return sorted({engine._bucket(n) for n in (lo, hi)}
                  | {b for b in engine._buckets if lo <= b <= hi})


def group_sizes(n_slots: int) -> List[int]:
    """The occupancies a prefill group pads to: powers of two, capped."""
    out, b = [], 1
    while b < n_slots:
        out.append(b)
        b <<= 1
    return out + [n_slots]


def warm_up(engine: Any, req_spec: Dict, vocab: int) -> int:
    """One short serve per reachable step shape, on resident adapters.
    Returns the number of serves."""
    from repro_torch.core.slots import Request
    ecfg = engine.ecfg
    if ecfg.prefill_chunk is not None or ecfg.prefix_cache:
        raise NotImplementedError(
            "warm-up covers whole-prompt prefill steps only; chunked "
            "prefill and the prefix cache add shapes it does not reach")
    resident = list(engine.manager.resident)
    rng = np.random.default_rng(0)
    serves = 0
    for bucket in reachable_buckets(engine, req_spec):
        for n in group_sizes(ecfg.n_slots):
            reqs = [Request(request_id=i, arrival_time=0.0,
                            prompt_len=bucket, output_len=1,
                            adapter_id=resident[i % len(resident)],
                            true_adapter=resident[i % len(resident)],
                            prompt_tokens=rng.integers(0, vocab, bucket,
                                                       dtype=np.int32))
                    for i in range(n)]
            engine.serve(reqs)
            serves += 1
    return serves


def _phase_of(rec: Recorder, load_spans: List[tuple]) -> Callable[[float],
                                                                  str]:
    starts = [s.t0 for s in rec.steps]

    def phase(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= rec.steps[i].t1:
            return f"host in {rec.steps[i].kind} step"
        for a, b in load_spans:
            if a <= t <= b:
                return "host copying an adapter"
        return "host between steps"
    return phase


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Served:
    """The program as set up for a cell: its engine and the inputs the
    harness made for it."""
    cell: spec.Cell
    dev: torch.device
    weights: Weights
    bank: AdapterBank
    clock: WallClock
    engine: Any
    warm_serves: int

    def reseed(self, seed: int) -> None:
        """Another seed's weights and bank, in place, the pool's
        resident adapters copied in again from the new bank, and the
        slots a closed window left busy emptied."""
        from repro_torch.core.slots import SlotManager
        self.engine.slots = SlotManager(self.engine.ecfg.n_slots)
        self.engine.manager.pinned.clear()
        self.weights.fill(seed)
        self.bank.fill(seed)
        for tenant, slot in self.engine.manager.resident.items():
            self.engine._load_adapter(tenant, slot)


def set_up(cell: spec.Cell, seed: int, dev: torch.device,
           log: Callable[[str], None]) -> Served:
    from repro_torch.serving.engine import EdgeLoRAEngine

    cfg, tfc = cell.config, cell.traffic
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        log(f"kernels built (s): {_build.build()}")
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    weights = Weights(cfg, seed, dev)
    bank = AdapterBank(cfg, tfc["bank"], tfc["adapter_delta_rms"], seed, dev,
                       pin=dev.type == "cuda")
    _sync(dev)
    t1 = time.perf_counter()
    clock = WallClock()
    engine = EdgeLoRAEngine(spec.model_config(cfg, tfc),
                            spec.engine_config(tfc, seed),
                            params=weights.tree, device=dev,
                            adapter_source=bank.source, timer=clock)
    t2 = time.perf_counter()
    n = warm_up(engine, tfc["requests"], cfg["vocab_size"])
    log(f"weights and bank {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, "
        f"{n} warm-up serves {time.perf_counter() - t2:.3f} s")
    return Served(cell, dev, weights, bank, clock, engine, n)


def requests_for(cell: spec.Cell, seed: int, seconds: float) -> List[Any]:
    spec_ = cell.traffic["requests"]
    return traffic.generate(spec_, vocab_size=cell.config["vocab_size"],
                            seed=seed,
                            count=traffic.n_requests(spec_, seconds))


def window(served: Served, requests: List[Any], seconds: float,
           trace: bool, t_process: float, log: Callable[[str], None]) -> Run:
    """Serve ``requests`` for ``seconds`` of wall time."""
    dev, engine, bank, clock = (served.dev, served.engine, served.bank,
                                served.clock)
    dtrace = DeviceTrace(dev) if trace else None
    if dtrace is not None:
        t0 = time.perf_counter()
        dtrace.begin()
        log(f"profiler start {time.perf_counter() - t0:.3f} s")
    stats = engine.manager.stats
    bank.loads.clear()
    _sync(dev)
    log(f"{len(requests)} requests queued")
    rec = Recorder(clock, seconds, lambda: (stats.hits, stats.misses))
    engine.tracer = rec
    clock.keep = bank.recording = True
    try:
        engine.serve(requests)
        raise QueueDrained(f"all {len(requests)} requests finished before "
                           "the window closed")
    except WindowClosed:
        pass
    finally:
        _sync(dev)
        stop = time.perf_counter()
        clock.keep = bank.recording = False
        clock.readings.clear()
        engine.tracer = None
    start = rec.start
    setup_s = start - t_process
    log(f"set-up {setup_s:.3f} s ({served.warm_serves} warm-up serves, "
        "the backlog's first fill)")
    load_spans = list(zip((t for t, _ in bank.loads), rec.load_ends))
    summary = None
    if dtrace is not None:
        t0 = time.perf_counter()
        summary = dtrace.end(start, stop, _phase_of(rec, load_spans))
        log(f"trace read in {time.perf_counter() - t0:.3f} s: "
            f"{sum(summary.count_by_name.values())} device events, the "
            f"first {summary.first - start:+.3f} s from the window's start")
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    end = window_end(rec, start)
    return Run(served.cell, setup_s, start, end, stop,
               rec, {r.request_id: r for r in requests}, load_spans,
               summary, work.peaks(kind), kind)


def window_end(rec: Recorder, start: float) -> float:
    """The window ends at a fixed phase of the scheduler loop: the start
    of the last prefill step that began inside the budget. It then holds
    whole loop iterations, each from one prefill step's start to the
    next's (admission, selection, the copies, the prefill, the decode),
    wherever in an iteration the budget runs out. Without a second
    prefill step, the end of the last step inside the budget."""
    starts = [s.t0 for s in rec.steps
              if s.kind in PREFILL_KINDS and start < s.t0 <= rec.end]
    if starts:
        return starts[-1]
    return max((s.t1 for s in rec.steps if s.t1 <= rec.end), default=start)


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
        device: str, t_process: float, log: Callable[[str], None]
        ) -> Dict:
    dev = torch.device(device)
    served = set_up(cell, seed, dev, log)
    requests = requests_for(cell, seed, seconds)
    res = window(served, requests, seconds, trace, t_process, log)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root).read(res)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    weights, bank = served.weights, served.bank
    del served
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check.compare(cell, res, weights.tree, bank, dev, seed, log)
    rec = res.rec
    out = {"correct": verdict["correct"],
           "attempted": sum(1 for t in rec.admit.values() if t <= res.end),
           "failed": sum(1 for r in requests if r.rejected is not None),
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": res.kind, "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if res.trace is not None:
        out["device"]["busy_s"] = res.trace.busy_s
        out["device"]["window_s"] = res.trace.window_s
        out["breakdown"] = {"device_ops": res.trace.top_ops(),
                            "idle_gaps": res.trace.top_idle()}
    out["checks"] = verdict["checks"]
    return out
