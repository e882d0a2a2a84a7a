"""Read one cell through the program's wall spans, on the card.

    python3 perfbench/span_probe.py --workload <cell> --seed <n> \\
        --seconds <s> [--cost-rounds <n>] [--prefill-rows <b>] \\
        [--out <dir>]

Run from the root of a checkout. Sets the cell up as ``run.py`` does,
then serves it in windows of the harness (``bench.window``):

1. ``--cost-rounds`` rounds of the engine's own decode step (a quarter
   as many of a prefill step at the traffic's bucket, ``--prefill-rows``
   rows) called directly on its state, each call synchronised and
   timed, the wall spans off and on in turns (off first in even rounds):
   what the spans cost a step, in one process on one card; and what one
   span costs this host, in a loop;
2. one traced window of ``--seconds`` with the spans on and the
   profiler keeping the CUDA runtime's launch calls (``harness/spans.py``
   ``LaunchTrace``): each device operation attributed to the span that
   launched it, each idle gap to the span the host was in
   (``harness/spans.py`` ``read``), beside the benchmark's own readers
   of the same window; and the probe's diagnostics (``diagnose``): the
   profiler's clock fitted on the steps' syncs, the operations stamped
   before their launch (and the idle split again with them moved to
   it), the self times of a step's spans, the runtime's syncs by span.

Prints one JSON object as the last line of standard output and writes it
to ``<out>/<cell>.<seed>.json`` (default ``chiprun_out/span_probe``).
The benchmark's runs never import this file: it turns the span record on
by handing ``bench.window`` a recorder that keeps one.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
READERS = ("prefill_step_ms", "decode_step_ms", "host_outside_steps_pct",
           "adapter_load_ms", "ttft_p90_ms.pool", "device_idle_pct",
           "pool_hit_pct")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def spans_window(served, requests, seconds, trace, spans_on):
    """``bench.window`` with the recorder's wall spans ``spans_on`` and,
    traced, the launch-keeping profiler.

    ``window`` takes no recorder or trace of the caller's, so the probe
    swaps the module's ``Recorder`` and ``DeviceTrace`` for the window's
    length; it checks that ``window`` still builds both by those names,
    and that the run it returns holds them, so a renamed one fails here
    instead of reading nothing."""
    from perfbench.harness import bench
    from perfbench.harness.recorder import Recorder
    from perfbench.harness.spans import LaunchTrace
    from repro_torch.serving.trace import WallSpans

    class SpanRecorder(Recorder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.wall_spans = WallSpans() if spans_on else None

    names = bench.window.__code__.co_names
    if "Recorder" not in names or "DeviceTrace" not in names:
        raise RuntimeError("bench.window no longer builds Recorder and "
                           "DeviceTrace by name: the probe cannot swap them")
    saved = bench.Recorder, bench.DeviceTrace
    bench.Recorder, bench.DeviceTrace = SpanRecorder, LaunchTrace
    try:
        run = bench.window(served, requests, seconds, trace, T_PROCESS, log)
    finally:
        bench.Recorder, bench.DeviceTrace = saved
    if not isinstance(run.rec, SpanRecorder) or (
            trace and not hasattr(run.trace, "launches")):
        raise RuntimeError("bench.window did not use the probe's recorder "
                           "and trace")
    return run


def span_us(n: int = 200_000) -> float:
    """One span's cost on this host: an ``open`` and a ``close`` behind
    the sites' guard, in a loop, µs."""
    from repro_torch.core import spans
    from repro_torch.serving.trace import WallSpans

    spans.wall = WallSpans()
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            sp = spans.wall
            if sp is not None:
                sp.open("x")
            if sp is not None:
                sp.close()
        return 1e6 * (time.perf_counter() - t0) / n
    finally:
        spans.wall = None


def step_cost(served, rounds: int, rows: int) -> dict:
    """The engine's decode step and a ``rows``-row prefill step at the
    largest bucket, called on its state with the spans off and on in
    turns: ms of each call, sync to sync, and spans per call."""
    import numpy as np
    import torch

    from repro_torch.core import spans
    from repro_torch.serving.trace import WallSpans

    eng, dev = served.engine, served.dev
    n, bucket = eng.ecfg.n_slots, eng._buckets[-1]
    gen = torch.Generator(device="cpu").manual_seed(0)
    vocab = served.cell.config["vocab_size"]
    sids = (torch.arange(n) % eng.n_pool).to(torch.int32)
    dec = (torch.randint(0, vocab, (n,), generator=gen, dtype=torch.int32),
           torch.full((n,), bucket, dtype=torch.int32), sids)
    pre = (torch.randint(0, vocab, (rows, bucket), generator=gen,
                         dtype=torch.int32), sids[:rows],
           torch.full((rows,), bucket, dtype=torch.int32))
    dec = [t.to(dev) for t in dec]
    pre = [t.to(dev) for t in pre]

    def decode():
        eng._decode(eng.params, eng.lora_pool, dec[0], eng.cache, dec[1],
                    dec[2])

    def prefill():
        eng._prefill(eng.params, eng.lora_pool, pre[0],
                     eng._fresh_cache(rows), pre[1], pre[2])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    for name, fn, n_rounds in (("decode", decode, rounds),
                               ("prefill", prefill, max(2, rounds // 4))):
        ms = {False: [], True: []}
        n_spans = 0
        fn()
        sync()
        for r in range(n_rounds):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                rec = WallSpans() if on else None
                spans.wall = rec
                try:
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    ms[on].append(1e3 * (time.perf_counter() - t0))
                finally:
                    spans.wall = None
                if rec is not None:
                    n_spans = len(rec.spans)
        off, on = np.median(ms[False]), np.median(ms[True])
        # each round's on over its off: the host's drift between rounds
        # cancels in a pair
        paired = [100.0 * (b - a) / a for a, b in zip(ms[False], ms[True])]
        q1, q2, q3 = (statistics.quantiles(paired, n=4) if len(paired) > 1
                      else paired * 3)
        out[name] = {"off_ms": ms[False], "on_ms": ms[True],
                     "median_off_ms": float(off), "median_on_ms": float(on),
                     "cost_pct": float(100.0 * (on - off) / off),
                     "paired_cost_pct": [q1, q2, q3],
                     "min_cost_pct": float(100.0 * (min(ms[True])
                                                    - min(ms[False]))
                                           / min(ms[False])),
                     "spans": n_spans}
        log(f"{name} step cost {out[name]['cost_pct']:+.2f} % of medians, "
            f"{q2:+.2f} % paired median (quartiles {q1:+.2f} / {q3:+.2f}), "
            f"{out[name]['min_cost_pct']:+.2f} % of minima "
            f"({off:.2f} -> {on:.2f} ms, {n_spans} spans)")
    out["rows"] = rows
    out["span_us"] = span_us()
    return out


def clock_fit(tree, launches):
    """The profiler's clock against the spans': every ``step.sync`` span
    holds one ``cudaDeviceSynchronize`` (the engine's ``_sync``). The
    call's midpoint minus the span's, per step, fitted as a line in time
    (offset and drift). Returns (the fit's coefficients, the residuals
    in s), or None with fewer than two steps."""
    import bisect

    import numpy as np

    calls = sorted(0.5 * (a + b) for name, a, b in launches.syncs
                   if name.startswith("cudaDeviceSynchronize"))
    if not calls:
        return None
    xs, rs = [], []
    for s in tree.order:
        if s[1] != "step.sync":
            continue
        c = 0.5 * (s[2] + s[3])
        i = bisect.bisect_left(calls, c)
        near = min(calls[max(0, i - 1):i + 1], key=lambda t: abs(t - c))
        if abs(near - c) < 0.05:
            xs.append(c)
            rs.append(near - c)
    if len(xs) < 2:
        return None
    fit = np.polyfit(xs, rs, 1)
    return fit, list(np.asarray(rs) - np.polyval(fit, xs))


def shifted(launches, coef):
    """``launches`` moved onto the spans' clock by ``clock_fit``'s line."""
    from perfbench.harness.spans import DeviceOp, Launches

    drift, offset = float(coef[0]), float(coef[1])

    def at(t: float) -> float:
        return (t - offset) / (1.0 + drift)
    return Launches(
        [DeviceOp(o.name, at(o.t0), at(o.t1), o.corr, o.linked)
         for o in launches.ops],
        {k: (n, at(a), at(b)) for k, (n, a, b) in launches.calls.items()},
        [(n, at(a), at(b)) for n, a, b in launches.syncs],
        launches.duplicate_ids)


def _pct(d, window):
    return {k: 100.0 * v / window for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])}


def _host(run, tree, out):
    """The readings of the spans alone: self times and launches of a
    step, the adapter loads, TTFT from the slot spans, time outside
    steps."""
    import numpy as np

    from perfbench.harness import spans as sp
    from perfbench.harness.recorder import DECODE_KINDS, PREFILL_KINDS

    rec = run.rec.wall_spans
    out["n_spans"] = len(rec.spans)
    out["counters"] = {k: c.value for k, c in rec.counters.items()}
    for label, kinds in (("decode", DECODE_KINDS),
                         ("prefill", PREFILL_KINDS)):
        steps = sp.window_steps(tree, run.start, run.end, kinds)
        if not steps:
            continue
        out[f"{label}_kernel_launches"] = {
            k: float(np.mean([s[5]["launches"].get(k, 0) for s in steps]))
            for k in sorted({k for s in steps for k in s[5]["launches"]})}
        self_ms = {}
        for st in steps:
            todo = [st]
            while todo:
                s = todo.pop()
                kids = tree.children.get(s[0], [])
                own = (s[3] - s[2]) - sum(c[3] - c[2] for c in kids)
                self_ms[s[1]] = self_ms.get(s[1], 0.0) + 1e3 * own
                todo += kids
        out[f"{label}_self_ms"] = {k: v / len(steps) for k, v in sorted(
            self_ms.items(), key=lambda kv: -kv[1])}
    loads = [s for s in rec.spans if s[1] == "adapter.load"
             and run.start <= s[2] <= run.end]
    if loads:
        out["adapter_load_span_ms"] = 1e3 * float(np.mean(
            [s[3] - s[2] for s in loads]))
        out["adapter_load_bytes"] = float(np.mean(
            [s[5]["bytes"] for s in loads]))
    admit, first = {}, {}
    for _, state, t0, t1, _, a in rec.slots:
        if state == "selecting":
            admit.setdefault(a["request"], t0)
        if state == "prefill":
            first.setdefault(a["request"], t1)
    ttft = [1e3 * (t - admit[r]) for r, t in first.items()
            if r in admit and run.start < t <= run.end]
    out["ttft_p90_ms_slots"] = (float(np.percentile(ttft, 90))
                                if ttft else None)
    inside = sum(min(s[3], run.end) - max(s[2], run.start)
                 for s in tree.order if s[1] == "step"
                 and min(s[3], run.end) > max(s[2], run.start))
    out["outside_step_spans_pct"] = 100.0 * (1.0 - inside / run.window_s)


def _device(run, tree, launches, out):
    """The device's diagnostics: where each span's device and idle time
    goes, the stamps' lag behind their launches, each step's operations
    against its wall interval, the runtime's syncs by span, and the idle
    split again with the operations stamped before their launch moved to
    it."""
    import bisect

    import numpy as np

    from perfbench.harness import spans as sp

    trace = run.trace
    lo, hi, window = trace.start, trace.stop, trace.window_s
    key, at = sp.match(launches)
    device, device_op = {}, {}
    worst = 0.0
    for i, d, s in sp.attributed(tree, launches, at, lo, hi):
        if s is None:
            continue
        op = launches.ops[i]
        device[s[1]] = device.get(s[1], 0.0) + d
        k = (s[1], op.name[:60])
        device_op[k] = device_op.get(k, 0.0) + d
        step = tree.ancestor(s, "step")
        if step is not None:
            excess = max(step[2] - op.t0, op.t1 - step[3])
            if excess > worst:
                worst = excess
                out["op_outside_its_step"] = {
                    "op": op.name[:80], "op_s": [op.t0, op.t1],
                    "launch_s": at[i], "span": s[1],
                    "step_s": [step[2], step[3]], "kind": step[5]["kind"]}
    out["op_outside_its_step_us"] = 1e6 * worst
    out["step_clock_ok"] = worst <= 50e-6
    out["device_pct_by_span"] = _pct(device, window)
    out["device_pct_by_span_op"] = [
        [k[0], k[1], 100.0 * v / window] for k, v in sorted(
            device_op.items(), key=lambda kv: -kv[1])[:25]]
    ops = [(op.t0, op.t1) for op in launches.ops]
    idle = sp.idle_by_span(tree, ops, lo, hi)
    out["idle_pct_by_span"] = _pct(idle, window)
    # an operation cannot start before its launch: where the profiler's
    # device stamps sit early against its host stamps, this goes below 0
    lag = sorted(launches.ops[i].t0 - t for i, t in at.items())
    if lag:
        out["launch_to_start_us"] = [1e6 * lag[0],
                                     1e6 * lag[len(lag) // 100],
                                     1e6 * lag[len(lag) // 2]]
        out["started_before_launch_pct"] = 100.0 * bisect.bisect_left(
            lag, 0.0) / len(lag)
    early = {}
    early_iv, moved = [], list(ops)
    for i, t in at.items():
        op = launches.ops[i]
        if op.t0 < t:
            call = launches.calls[op.corr if key == "correlation_id"
                                  else op.linked][0]
            early.setdefault(f"{op.name[:50]} <- {call}", []).append(
                1e6 * (op.t0 - t))
            early_iv.append((op.t0, op.t1))
            moved[i] = (t, t + op.t1 - op.t0)
    out["early_ops"] = sorted(
        ([k, len(v), float(np.median(v))] for k, v in early.items()),
        key=lambda r: -r[1])[:8]
    out["duplicate_ids"] = launches.duplicate_ids
    # the idle split's error from those stamps: their busy time, by the
    # span the host was in while they ran (the most each span's idle
    # reading can be short by), and the split with them moved to their
    # launch
    busy = sp.by_span(tree, [(a, b) for a, b in
                             _union(early_iv, lo, hi)], lo, hi)
    out["early_busy_pct_by_span"] = _pct(busy, window)
    out["early_busy_in_lora_pct"] = 100.0 * sum(
        busy.get(n, 0.0) for n in sp.LORA) / window
    idle_moved = sp.idle_by_span(tree, moved, lo, hi)
    out["idle_pct_by_span_moved"] = _pct(idle_moved, window)
    out["idle_in_lora_pct_moved"] = 100.0 * sum(
        idle_moved.get(n, 0.0) for n in sp.LORA) / window
    syncs = {}
    for name, a, _ in launches.syncs:
        if lo <= a <= hi:
            s = tree.innermost(a)
            k = f"{name} in {s[1] if s else 'outside spans'}"
            syncs[k] = syncs.get(k, 0) + 1
    out["syncs_by_span"] = syncs


def _union(intervals, lo, hi):
    """The union of ``intervals`` clipped to [lo, hi], sorted."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def diagnose(run) -> dict:
    """``harness/spans.py``'s readings of a window with wall spans, on
    the profiler's stamps moved onto the spans' clock by ``clock_fit``,
    and the probe's diagnostics."""
    import numpy as np

    from perfbench.harness import spans as sp

    tree = sp.SpanTree(run.rec.wall_spans.spans)
    out = {}
    _host(run, tree, out)
    launches = getattr(run.trace, "launches", None) if run.trace else None
    if launches is not None:
        fit = clock_fit(tree, launches)
        if fit is not None:
            coef, resid = fit
            mid = 0.5 * (run.trace.start + run.trace.stop)
            out["clock_offset_us"] = 1e6 * float(np.polyval(coef, mid))
            out["clock_drift_ppm"] = 1e6 * float(coef[0])
            out["clock_resid_us"] = [1e6 * min(resid), 1e6 * max(resid)]
            launches = shifted(launches, coef)
        _device(run, tree, launches, out)
    out.update(sp.read(run, launches))
    return out


def probe(cell, seed: int, seconds: float, cost_rounds: int, rows: int,
          dev) -> dict:
    """Set ``cell`` up on ``dev`` and read it as the module says."""
    import torch

    from perfbench.harness import bench, spec

    served = bench.set_up(cell, seed, dev, log)
    out = {"workload": cell.name, "seed": seed,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    if cost_rounds > 0:
        out["cost"] = step_cost(served, cost_rounds, rows)
        served.reseed(seed)
    run = spans_window(served, bench.requests_for(cell, seed, seconds),
                       seconds, True, True)
    t0 = time.perf_counter()
    out["spans"] = diagnose(run)
    log(f"spans read in {time.perf_counter() - t0:.3f} s")
    out["harness"] = {name: spec.reader(name, cell.root).read(run)
                      for name in READERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-rounds", type=int, default=0)
    ap.add_argument("--prefill-rows", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "span_probe"))
    args = ap.parse_args(argv)
    cache = ROOT / "perfbench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.harness import spec

    if not torch.cuda.is_available():
        print("span_probe: no CUDA device", file=sys.stderr)
        return 2
    out = probe(spec.load_cell(args.workload), args.seed, args.seconds,
                args.cost_rounds, args.prefill_rows, torch.device("cuda"))
    line = json.dumps(out)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{args.workload}.{args.seed}.json").write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
