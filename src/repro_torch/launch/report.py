"""Roofline report generator (``repro.launch.report``):
experiments/dryrun_torch/*.json → markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16]

Per (arch × shape × mesh): the three roofline terms in seconds on a
fleet of H100s (``launch/mesh.py``'s constants), the dominant term, the
MODEL_FLOPS/counted-flops usefulness ratio, per-device residency, and
the share of the collective bytes that the dry-run's replicate fallback
issued (gathers around ops DTensor cannot place: ``launch/dryrun.py``),
with the dominant term once those bytes are taken out. Reads the port's
dry-run results only, never the reference's ``experiments/dryrun``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = ["mamba2_130m", "chameleon_34b", "qwen1_5_110b",
              "llama4_maverick_400b_a17b", "whisper_medium", "dbrx_132b",
              "gemma2_9b", "starcoder2_7b", "qwen2_0_5b", "zamba2_2_7b"]

def load(mesh: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(OUT_DIR, f"*__{mesh}.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-6:
        return f"{x*1e9:.1f}ns"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1.0:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def table(mesh: str) -> str:
    rows = load(mesh)
    by_key = {(r["arch"], r["shape"]): r for r in rows}
    # the collective term is DTensor's plan, which moves between torch
    # versions
    torches = ", ".join(sorted({r["torch"] for r in rows if "torch" in r}))
    lines = [
        f"### Mesh {mesh} "
        f"({'512 H100s, 2 pods' if mesh.startswith('2x') else '256 H100s'}; "
        f"torch {torches or 'not recorded'})",
        "",
        "| arch | shape | compute | memory | collective | dominant | "
        "fallback coll. | dominant w/o fallback | useful FLOPs | args/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = by_key.get((arch, shape))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | SKIP | — | "
                             "— | — | — |")
                continue
            t = r["roofline"]
            dom = r["dominant"].replace("_s", "")
            useful = r["useful_flops_ratio"]
            lines.append(
                f"| {arch} | {shape} | {fmt_s(t['compute_s'])} | "
                f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
                f"**{dom}** | {100 * r['collective_fallback_share']:.1f}% | "
                f"{r['dominant_without_fallback'].replace('_s', '')} | "
                f"{useful:.2f} | "
                f"{r['arg_bytes_per_device']/1e9:.2f}GB |")
    return "\n".join(lines)


def summary_stats(mesh: str) -> str:
    rows = [r for r in load(mesh) if r["status"] == "ok"]
    n_dom = {}
    for r in rows:
        n_dom[r["dominant"]] = n_dom.get(r["dominant"], 0) + 1
    lines = [f"Combos: {len(rows)} ok, "
             f"{sum(1 for r in load(mesh) if r['status']=='skipped')} "
             f"skipped. Dominant-term histogram: " +
             ", ".join(f"{k.replace('_s','')}: {v}"
                       for k, v in sorted(n_dom.items()))]
    worst = sorted(rows, key=lambda r: r["useful_flops_ratio"] or 1)[:3]
    lines.append("Worst useful-FLOPs ratios: " + ", ".join(
        f"{r['arch']}×{r['shape']} ({r['useful_flops_ratio']:.2f})"
        for r in worst))
    coll = sorted(rows, key=lambda r: -(r["roofline"]["collective_s"] /
                                        max(sum(r["roofline"].values()),
                                            1e-30)))[:3]
    lines.append("Most collective-bound: " + ", ".join(
        f"{r['arch']}×{r['shape']}" for r in coll))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    print(table(args.mesh))
    print()
    print(summary_stats(args.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
