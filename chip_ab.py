#!/usr/bin/env python3
"""Compare the main path's kernel rows of this checkout and another one on
one NVIDIA GPU, in turns.

    python3 chip_ab.py OTHER_CHECKOUT     # e.g. an unpacked parent commit

Builds both checkouts' CUDA kernels (each source's nvcc seconds printed),
then runs ``chip_smoke.py``'s ``kernel_phase`` (the Llama-3.1-8B decode
step, bf16), ``gather_phase`` (its bf16 pages) and ``attention_phase``
(every main-path attention row) of each checkout in a child process of
its own, in the order other, this, this, other, other, this, so that
drift on the card falls on both sides alike. Prints each row's device µs
by side and the change of this checkout's mean against the other's;
writes the rows to ``chiprun_out/ab/``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "ab"
ORDER = ("other", "this", "this", "other", "other", "this")

_BUILD = """
import sys, time
sys.path.insert(0, "src")
from repro_torch.kernels import _build
t = time.perf_counter()
print(_build.build(), time.perf_counter() - t)
"""

_ROWS = """
import json, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
rows = cs.kernel_phase(torch, dev, dict(cs.LLAMA_SPEC, cases=[("decode", 8)],
                                        dtypes=("bfloat16",)))
rows += cs.gather_phase(torch, dev, dict(cs.LLAMA_SPEC, gather_cases=(
    ("bfloat16", "bfloat16", 1024),)))
rows += cs.attention_phase(torch, dev, cs.LLAMA_SPEC, full=True)
json.dump(rows, open(sys.argv[1], "w"), default=str)
"""


def _key(r):
    return " ".join(str(r[k]) for k in ("kernel", "d", "dtype", "kv_dtype",
                                         "case") if r.get(k) is not None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    args = ap.parse_args(argv)
    trees = {"this": ROOT, "other": args.other.resolve()}
    for side, tree in trees.items():
        if not (tree / "chip_smoke.py").is_file():
            print(f"chip_ab: no chip_smoke.py in {tree}", file=sys.stderr)
            return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for side, tree in trees.items():
        done = subprocess.run([sys.executable, "-c", _BUILD], cwd=tree,
                              capture_output=True, text=True)
        print(f"build {side}: {done.stdout.strip()}", flush=True)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return 1
    OUT.mkdir(parents=True, exist_ok=True)
    table = {}
    for i, side in enumerate(ORDER):
        path = OUT / f"{i}_{side}.json"
        done = subprocess.run([sys.executable, "-c", _ROWS, str(path)],
                              cwd=trees[side], capture_output=True,
                              text=True)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return 1
        for r in json.loads(path.read_text()):
            if r["kernel"] not in ("event_floor", "ops.sgmv"):
                table.setdefault(_key(r), []).append((side, 1e3 * r["ms"]))
    for key, runs in table.items():
        mean = {s: sum(us for t, us in runs if t == s)
                / sum(1 for t, _ in runs if t == s) for s in trees}
        change = 100 * (mean["this"] / mean["other"] - 1)
        print(f"{key}: " + ", ".join(f"{s} {us:.2f}" for s, us in runs)
              + f"; this - other {change:+.2f} %")
    return 0


if __name__ == "__main__":
    sys.exit(main())
