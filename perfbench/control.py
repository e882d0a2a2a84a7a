"""Readings behind a cell's limits: the program's widest logit gap over
many seeds, and the precision control's.

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

For each seed, in one process and on one engine: the seed's weights and
adapter bank drawn in place, a short window at the cell's own load, and
the cell's check on a sample of its finished requests. For each control
seed also the control: the reference put in the program's place and
computed one precision below the configuration's bf16. Every activation
the program holds in bf16 is held in fp8 instead (e4m3, a scale per
row), and every projection's operands are rounded to fp8 (a scale per
row of the activations and per column of the weights), the products
summed in f32 (``control_gap``). Beside it, the milder step a change
might take first: fp8 projection operands alone, every activation kept
in f32 (``operand_gap``). At each served position each one's top token
is read, and its gap below the f32 reference's best. Prints one JSON
line per seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FP8_MAX = 448.0


def fp8_round(x):
    """x rounded to float8 e4m3 with one scale per row."""
    import torch
    sx = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / sx).to(torch.float8_e4m3fn).float() * sx


def fp8_matmul(x, w):
    """x @ w with both operands rounded to float8 e4m3 (per-row scales
    of x, per-column scales of w), products summed in f32."""
    import torch
    return torch.matmul(fp8_round(x), fp8_round(w.t()).t())


def readings(served, seed: int, seconds: float, control: bool, log):
    """One seed: the program's widest gap and, with ``control``, the
    control's, over the same sample of requests."""
    import torch
    from perfbench.harness import bench, check, spec

    cell, dev = served.cell, served.dev
    served.reseed(seed)
    requests = bench.requests_for(cell, seed, seconds)
    res = bench.window(served, requests, seconds, False,
                       time.perf_counter(), log)
    reqs = check.sample(check.finished(res), cell.checks["sample_requests"],
                        seed)
    ref = spec.reference(cell.config, cell.root)
    trees = served.bank.on_device(dev)
    t0 = time.perf_counter()
    exact = check.reference_logits(ref, cell.config, served.weights.tree,
                                   trees, reqs, dev)
    out = {"seed": seed, "requests": len(reqs),
           "reference_s": time.perf_counter() - t0}
    out["program_gap"], out["tokens"] = ref.widest_gap(
        exact, [r.tokens for r in reqs])
    if control:
        t0 = time.perf_counter()
        for key, hooks in (("control_gap", {"rnd": fp8_round}),
                           ("operand_gap", {})):
            low = check.reference_logits(ref, cell.config,
                                         served.weights.tree, trees, reqs,
                                         dev, matmul=fp8_matmul, **hooks)
            tops = [lg.argmax(-1).tolist() for lg in low]
            out[key], _ = ref.widest_gap(exact, tops)
        out["control_s"] = time.perf_counter() - t0
    del trees, exact
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench.harness import bench, spec

    def log(msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)

    cell = spec.load_cell(args.workload)
    served = bench.set_up(cell, args.seeds[0], torch.device("cuda"), log)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        out = readings(served, seed, args.seconds,
                       seed in args.control_seeds, log)
        print(json.dumps({"workload": cell.name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
