"""End-to-end driver: multi-tenant serving under a synthetic workload (the
PyTorch port; ``examples/serve_multitenant.py`` on ``repro_torch``).

Reproduces the shape of the paper's §5.1 experiment at container scale:
a Gamma-arrival, power-law-adapter trace served by (1) EdgeLoRA with
adaptive adapter selection, (2) EdgeLoRA w/o AAS, (3) the llama.cpp-style
baseline — printing the Table-4/5/6 style comparison.

    PYTHONPATH=src python examples/serve_multitenant_torch.py         # GPU
    PYTHONPATH=src python examples/serve_multitenant_torch.py --device cpu

The engine's clock advances by each step's measured time, so the rows
measure the device the engine runs on.
"""
import argparse
import dataclasses

from repro_torch.configs import get_config, reduced_config
from repro_torch.serving.engine import (EdgeLoRAEngine, EngineConfig,
                                        OutOfMemoryError)
from repro_torch.serving.workload import WorkloadConfig, generate_trace

POLICIES = ("edgelora", "edgelora_no_aas", "llamacpp")


def run(cfg, device, **engine_kw):
    """The example from its model config on: the trace, then each policy
    on ``device``; ``engine_kw`` goes to every ``EdgeLoRAEngine``
    (``params``, ``adapter_source``, ``timer``). Returns (trace, {policy:
    ServingSummary, or the OutOfMemoryError that refused it})."""
    n_adapters = 32
    cfg = dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, n_adapters=n_adapters,
                                      max_resident=8))
    wl = WorkloadConfig(n_adapters=n_adapters, alpha=1.0, request_rate=4.0,
                        cv=1.0, duration=5.0, input_range=(4, 24),
                        output_range=(4, 12), vocab_size=cfg.vocab_size,
                        seed=0)
    trace = generate_trace(wl)
    print(f"trace: {len(trace)} requests over {wl.duration}s, "
          f"{n_adapters} adapters, α={wl.alpha}")
    # a Jetson-like budget: llama.cpp must preload all 32 adapters
    budget = 8 * cfg.lora_adapter_bytes()

    print(f"{'policy':18s} {'thpt(req/s)':>12s} {'avg_lat(s)':>11s} "
          f"{'first_tok(s)':>13s} {'SLO':>6s} {'hit':>6s}")
    results = {}
    for policy in POLICIES:
        ecfg = EngineConfig(n_slots=4, top_k=3, policy=policy, max_ctx=64,
                            prompt_buckets=(16, 32), memory_budget=budget)
        try:
            engine = EdgeLoRAEngine(cfg, ecfg, device=device, **engine_kw)
        except OutOfMemoryError as e:
            print(f"{policy:18s} {'OOM':>12s}   ({e})")
            results[policy] = e
            continue
        s = engine.serve(trace)
        print(f"{policy:18s} {s.throughput:12.3f} {s.avg_latency:11.3f} "
              f"{s.avg_first_token:13.3f} {s.slo_attainment:6.1%} "
              f"{s.cache_hit_rate:6.1%}")
        results[policy] = s
    return trace, results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(reduced_config(get_config("llama3-8b")), args.device)


if __name__ == "__main__":
    main()
