"""Latency-breakdown analyzer for engine traces (``serve --trace``), on the
PyTorch port's serving modules (``tools/trace_report.py`` importing
``repro_torch.serving.metrics`` and ``repro_torch.serving.trace``, which
import no JAX; the same report, byte for byte).

Reads the ``edgelora`` raw section of a trace JSON and prints the
questions a perf investigation starts with:

* **slowest requests** — top-k by end-to-end latency, each with its
  full breakdown (queue_wait / select / load_stall / prefill / decode /
  preempted — the segments provably sum to e2e);
* **segment means** — where the average request's time went;
* **busiest compute spans** — jit'd step keys by total virtual-clock
  seconds (is prefill or decode dominating? which bucket?);
* **utilization** — fraction of the run the compute track and the
  adapter transfer channel were busy, plus the KV arena peak;
* **watchdog** — the jit-cache shape audit (see docs/observability.md).

    python tools/trace_report_torch.py TRACE.json [--top 5]

Pure post-processing: never touches the engine, safe on any artifact
that passes ``tools/trace_export.py``'s schema check.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import IO, Optional, Sequence

# runnable from the repo root without installing the package
_ROOT = Path(__file__).resolve().parent.parent
for p in (str(_ROOT), str(_ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from repro_torch.serving.metrics import fmt_num, format_digest  # noqa: E402
from repro_torch.serving.trace import (  # noqa: E402
    BREAKDOWN_SEGMENTS, busiest_spans, span_utilization)


def _breakdown_digest(bd: dict) -> str:
    """One request's breakdown as a ``k=v;...`` digest row (same
    formatter the ServingSummary digest rows use)."""
    fields = [("e2e", fmt_num(bd.get("e2e")))]
    fields += [(seg, fmt_num(bd.get(seg))) for seg in BREAKDOWN_SEGMENTS]
    fields += [("admits", str(bd.get("admits", 1))),
               ("chunks", str(bd.get("prefill_chunks", 0)))]
    return format_digest(fields)


def report(data: dict, top: int = 5,
           out: IO[str] = sys.stdout) -> None:
    section = data.get("edgelora") or {}
    meta = section.get("meta") or {}
    duration = float(section.get("duration") or 0.0)
    events = section.get("events") or []
    breakdowns = section.get("breakdowns") or {}

    print(f"# trace: policy={meta.get('policy')} "
          f"kv={meta.get('kv_backend')} lora={meta.get('lora_backend')} "
          f"requests={meta.get('n_requests')} "
          f"completed={len(breakdowns)} duration={duration:.3f}s",
          file=out)

    # -- slowest requests -------------------------------------------------
    ranked = sorted(breakdowns.items(),
                    key=lambda kv: -(kv[1].get("e2e") or 0.0))
    print(f"\n== slowest {min(top, len(ranked))} requests "
          f"(of {len(ranked)} completed) ==", file=out)
    for rid, bd in ranked[:top]:
        print(f"  req {rid}: {_breakdown_digest(bd)}", file=out)

    # -- segment means ----------------------------------------------------
    if ranked:
        n = len(ranked)
        print("\n== mean breakdown ==", file=out)
        means = [("e2e",
                  fmt_num(sum(b.get("e2e", 0.0)
                              for _, b in ranked) / n))]
        means += [(seg,
                   fmt_num(sum(b.get(seg, 0.0) for _, b in ranked) / n))
                  for seg in BREAKDOWN_SEGMENTS]
        print(f"  {format_digest(means)}", file=out)

    # -- busiest compute spans -------------------------------------------
    print(f"\n== busiest compute spans (top {top}) ==", file=out)
    for row in busiest_spans(events, top=top):
        print(f"  {row['name']}: n={row['count']} "
              f"total={fmt_num(row['total'])}s "
              f"mean={fmt_num(row['mean'], 6)}s", file=out)

    # -- utilization ------------------------------------------------------
    compute = span_utilization(events, duration, "compute")
    channel = span_utilization(events, duration, "channel")
    arena_series = (section.get("metrics") or {}).get(
        "arena_blocks_used") or []
    arena_peak = max((v for _, v in arena_series), default=None)
    util = [("compute", f"{compute:.1%}"), ("channel", f"{channel:.1%}")]
    if arena_peak is not None:
        util.append(("arena_peak_blocks", str(int(arena_peak))))
    print(f"\n== utilization ==\n  {format_digest(util)}", file=out)

    # -- scheduler events -------------------------------------------------
    sched: dict[str, int] = {}
    for ev in events:
        if ev.get("kind") == "sched":
            sched[ev["name"]] = sched.get(ev["name"], 0) + 1
    if sched:
        rows = sorted(sched.items(), key=lambda kv: -kv[1])
        print("\n== scheduler events ==\n  "
              + format_digest([(k, str(v)) for k, v in rows]), file=out)

    # -- watchdog ---------------------------------------------------------
    wd = section.get("watchdog")
    print("\n== jit-recompile watchdog ==", file=out)
    if not wd:
        print("  (no report)", file=out)
        return
    bound = wd.get("prefill_bound")
    print(f"  {'ok' if wd.get('ok') else 'VIOLATIONS'}: "
          f"{wd.get('n_keys')} jit keys, prefill bound {bound}", file=out)
    for kind, n in sorted((wd.get("by_kind") or {}).items()):
        b = (wd.get("bounds") or {}).get(kind)
        print(f"    {kind}: {n} shapes"
              + (f" (bound {b})" if b is not None else ""), file=out)
    for v in wd.get("violations") or []:
        print(f"    VIOLATION: {v}", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="TRACE_*.json written by serve --trace")
    ap.add_argument("--top", type=int, default=5,
                    help="rows per ranked section")
    args = ap.parse_args(argv)
    path = Path(args.trace)
    if not path.exists():
        print(f"{path}: missing", file=sys.stderr)
        return 1
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as exc:
        print(f"{path}: invalid JSON ({exc})", file=sys.stderr)
        return 1
    if not isinstance(data.get("edgelora"), dict):
        print(f"{path}: no 'edgelora' section (was it exported with "
              f"--strip-raw?)", file=sys.stderr)
        return 1
    report(data, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
