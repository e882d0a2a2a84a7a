"""Quickstart: multi-tenant Batch LoRA Inference in five minutes (the
PyTorch port; ``examples/quickstart.py`` on ``repro_torch``).

Builds a small Llama-family model, registers four LoRA adapters in the
device pool, and serves a heterogeneous batch — every request with its
own adapter — in ONE forward pass (the paper's Fig. 6), then verifies the
result against per-request runs.

    PYTHONPATH=src python examples/quickstart_torch.py                # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

It takes the routes the port's engine takes: on ``cuda`` the batched
LoRA delta runs on the SGMV kernels and attention on ``flash_prefill`` /
``flash_decode``; on the CPU the gather-einsum delta and the plain
attention, which is what the reference's example computes.
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lora import (LoRAMode, load_adapter_into_slot,
                                   resolve_lora_backend)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.optimizer import tree_map


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def run(model, params, pool, tokens, backend=None):
    """The example after weight creation: one batched forward over
    ``tokens`` [4, S] (row i on pool slot i), each row again alone, and
    8 greedy decode steps. ``backend`` is the batched LoRA backend
    (default: the engine's choice for the model's device); attention
    takes ``model.attn_kernel``. Returns {'logits', 'max_err',
    'decoded'}."""
    cfg, device = model.cfg, model.device
    backend = backend or resolve_lora_backend("auto", device)
    b, s = tokens.shape
    # --- one batch, four different tenants ---
    adapter_ids = torch.arange(b, dtype=torch.int32, device=device)
    mode = LoRAMode("batched", adapter_ids, cfg.lora.scale, backend)
    logits, _ = model.forward(params, {"tokens": tokens}, pool, mode,
                              attn_kernel=model.attn_kernel)
    print(f"batched multi-adapter forward: logits {tuple(logits.shape)}")

    # --- verify against serving each tenant alone ---
    worst = 0.0
    for i in range(b):
        mode1 = LoRAMode("batched", adapter_ids[i:i + 1], cfg.lora.scale,
                         backend)
        ref, _ = model.forward(params, {"tokens": tokens[i:i + 1]}, pool,
                               mode1, attn_kernel=model.attn_kernel)
        err = float(torch.max(torch.abs(logits[i:i + 1].float()
                                        - ref.float())))
        worst = max(worst, err)
    print(f"batched == per-request: max err {worst:.3e}")

    # --- and a short greedy decode with per-slot adapters ---
    cache = model.init_cache(b, 64)
    lg, cache = model.prefill(params, {"tokens": tokens}, cache, pool, mode)
    tok = torch.argmax(lg, -1).to(torch.int32)
    out = [tok]
    for step in range(8):
        lg, cache = model.decode_step(
            params, tok, cache,
            torch.full((b,), s + step, dtype=torch.int32, device=device),
            pool, mode)
        tok = torch.argmax(lg, -1).to(torch.int32)
        out.append(tok)
    decoded = torch.stack(out, 1)[:, :8].tolist()
    print("decoded 8 tokens/tenant:", decoded)
    return {"logits": logits, "max_err": worst, "decoded": decoded}


def draw(model):
    """The example's weights, drawn from seeded generators on the model's
    device: (params, a 4-slot pool with one adapter per slot, tokens [4,
    16])."""
    cfg, device = model.cfg, model.device
    params = model.init(_generator(device, 0))

    # --- the heterogeneous memory manager's device face: a 4-slot pool ---
    pool = model.init_lora(_generator(device, 1), n_slots=4)
    for slot in range(4):
        adapter = model.init_lora(_generator(device, 100 + slot))
        adapter = tree_map(  # give each adapter a distinct signature
            lambda x, slot=slot: x + 0.01 * (slot + 1), adapter)
        # pool leaves are [layer groups, R, ...]: the write goes through
        # views with the slot axis first. (The reference's call writes
        # along axis 0, the layer groups, with the index clamped: in
        # reduced Llama-3.1-8B's 2 groups its slots 0-1 end up with
        # adapter 0 in group 0 and adapter 3 in group 1, slots 2-3 with
        # no adapter.)
        load_adapter_into_slot(tree_map(lambda t: t.movedim(1, 0), pool),
                               adapter, slot)
    print("adapter pool loaded: 4 slots")

    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=_generator(device, 2), device=device,
                           dtype=torch.int32)
    return params, pool, tokens


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(ap.parse_args(argv).device)

    cfg = reduced_config(get_config("llama3-8b"))
    model = build_model(cfg, device, attn_kernel=device.type == "cuda")
    print(f"model: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model})")
    run(model, *draw(model))


if __name__ == "__main__":
    main()
