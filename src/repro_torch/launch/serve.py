"""Serving launcher of the PyTorch port: the EdgeLoRA engine on a
synthetic workload (``repro.launch.serve`` with ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --n-adapters 8 --rate 2 --duration 4 --max-ctx 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --prefix-cache --system-prompt-len 16 --prefill-chunk 16 \\
        --n-adapters 4 --rate 3 --duration 2 --max-ctx 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen2-0.5b --policy dlora --trace out.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-130m --reduced --n-adapters 6 --duration 2
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on a GPU

Runs on ``cuda`` unless ``--device cpu`` is given (no CUDA: it raises).
``--reduced`` (the default) is the tiny same-family variant; ``--full``
the published widths of ``--arch`` (llama3-8b, qwen2-0.5b, llama3.2-3b,
openelm-1.1b, gemma2-9b, starcoder2-7b, chameleon-34b, dbrx-132b,
llama4-maverick-400b-a17b, qwen1.5-110b, mamba2-130m, zamba2-2.7b;
whisper-medium is refused: the engine's prompts carry no ``frames``). The
flags are the reference's: all four ``--policy``
values, ``--kv-backend paged``, ``--prefix-cache`` (which implies the
paged backend) and ``--prefill-chunk`` serve as there, and the summary
row carries their ``kv=`` and ``prefix=`` digests. ``--trace PATH``
writes the engine trace (Perfetto JSON with the raw ``edgelora``
section that ``tools/trace_report.py`` reads) with the wall spans on:
the engine's loop, steps, model layers and LoRA wrapper on the host's
clock, a second process in the same file (docs/observability-torch.md).
The spans' cost lands inside the steps' timed intervals, so a traced
run's steps are charged a little longer and its virtual schedule is not
an untraced run's: compare token streams across the two, not latencies.
A llamacpp adapter set over ``--memory-budget`` prints ``OOM: ...`` and
exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.configs import get_config, reduced_config
from repro_torch.serving.engine import (EdgeLoRAEngine, EngineConfig,
                                        OutOfMemoryError)
from repro_torch.serving.trace import EngineTracer
from repro_torch.serving.workload import WorkloadConfig, generate_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--policy", default="edgelora",
                    choices=["edgelora", "edgelora_no_aas", "llamacpp",
                             "dlora"])
    ap.add_argument("--n-adapters", type=int, default=20)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--cv", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--max-ctx", type=int, default=256)
    ap.add_argument("--memory-budget", type=float, default=2e9)
    ap.add_argument("--cache-policy", default="lru", choices=["lru", "lfu"])
    ap.add_argument("--lora-backend", default=None,
                    choices=["auto", "einsum", "sgmv"],
                    help="batched-LoRA compute path (default: the model "
                         "config's 'auto' — the sgmv CUDA kernels on a "
                         "GPU, einsum on the CPU)")
    ap.add_argument("--kv-backend", default=None, choices=["dense", "paged"])
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-arena-blocks", type=int, default=None)
    ap.add_argument("--prefix-cache", action="store_true", default=False)
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--system-prompt-len", type=int, default=0)
    ap.add_argument("--shared-prefix-frac", type=float, default=1.0)
    ap.add_argument("--async-swap", dest="async_swap", action="store_true",
                    default=True)
    ap.add_argument("--no-async-swap", dest="async_swap",
                    action="store_false")
    ap.add_argument("--prefetch-depth", type=int, default=4)
    ap.add_argument("--disk-bandwidth", type=float, default=1.0e9)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--no-admission-control", dest="admission_control",
                    action="store_false", default=True)
    ap.add_argument("--interactive-frac", type=float, default=0.0)
    ap.add_argument("--interactive-ttft-slo", type=float, default=2.0)
    ap.add_argument("--interactive-tpot-slo", type=float, default=None)
    ap.add_argument("--long-prompt-frac", type=float, default=0.0)
    ap.add_argument("--long-input-range", type=int, nargs=2,
                    default=(128, 192), metavar=("LO", "HI"))
    ap.add_argument("--no-prefill-batching", dest="prefill_batching",
                    action="store_false")
    ap.add_argument("--no-router-batching", dest="router_batching",
                    action="store_false")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, n_adapters=args.n_adapters))
    if args.prefix_cache and args.kv_backend is None:
        args.kv_backend = "paged"

    wl = WorkloadConfig(
        n_adapters=args.n_adapters, alpha=args.alpha,
        request_rate=args.rate, cv=args.cv, duration=args.duration,
        input_range=(8, 64), output_range=(8, 32),
        system_prompt_len=args.system_prompt_len,
        shared_prefix_frac=args.shared_prefix_frac,
        interactive_frac=args.interactive_frac,
        interactive_ttft_slo=args.interactive_ttft_slo,
        interactive_tpot_slo=args.interactive_tpot_slo,
        long_prompt_frac=args.long_prompt_frac,
        long_input_range=tuple(args.long_input_range),
        vocab_size=cfg.vocab_size, seed=args.seed)
    trace = generate_trace(wl)

    ecfg = EngineConfig(
        n_slots=args.n_slots, top_k=args.top_k, policy=args.policy,
        max_ctx=args.max_ctx, prompt_buckets=(32, 64),
        memory_budget=args.memory_budget, cache_policy=args.cache_policy,
        lora_backend=args.lora_backend,
        kv_backend=args.kv_backend, kv_block_size=args.kv_block_size,
        kv_arena_blocks=args.kv_arena_blocks,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk,
        admission_control=args.admission_control,
        async_swap=args.async_swap, prefetch_depth=args.prefetch_depth,
        disk_bandwidth=args.disk_bandwidth,
        prefill_batching=args.prefill_batching,
        router_batching=args.router_batching, seed=args.seed)
    tracer = EngineTracer(wall_spans=True) if args.trace else None
    try:
        engine = EdgeLoRAEngine(cfg, ecfg, tracer=tracer,
                                device=args.device)
    except OutOfMemoryError as e:
        print(f"OOM: {e}")
        return 2
    summary = engine.serve(trace)
    if tracer is not None:
        tracer.export(args.trace)
        print(f"# trace written to {args.trace} "
              f"({len(tracer.events)} events, "
              f"{len(tracer.wall_spans.spans)} wall spans; open in "
              f"ui.perfetto.dev or inspect with tools/trace_report.py)",
              file=sys.stderr)
    print(f"# lora_backend={engine.lora_backend} "
          f"kv_backend={engine.kv_backend} device={engine.device} "
          f"attn_kernel={engine.attn_kernel}", file=sys.stderr)
    if args.json:
        print(json.dumps(summary.__dict__, default=float, indent=2))
    else:
        print(summary_row(args.policy, args.n_adapters, summary))
    return 0


def summary_row(policy: str, n_adapters: int, summary) -> str:
    """The reference launcher's paper-style summary row."""
    return (f"policy={policy} n={n_adapters} "
            f"completed={summary.n_completed}/{summary.n_requests} "
            f"throughput={summary.throughput:.3f} req/s "
            f"avg_latency={summary.avg_latency:.3f}s "
            f"first_token={summary.avg_first_token:.3f}s "
            f"slo={summary.slo_attainment:.1%} "
            f"hit_rate={summary.cache_hit_rate:.1%} "
            f"{summary.batching_row()} {summary.kv_row()} "
            f"{summary.prefix_row()} {summary.swap_row()} "
            f"{summary.slo_row()}")


if __name__ == "__main__":
    sys.exit(main())
