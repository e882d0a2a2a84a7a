"""Train the multi-tenant artifacts end-to-end (the PyTorch port;
``examples/train_lora_adapter.py`` on ``repro_torch``):

1. LoRA fine-tune two task adapters on the synthetic pipeline (a few
   hundred steps of a ~small model — the training-side driver),
2. train the adapter-router head on profiling data (paper §4.1),
3. checkpoint the adapters (the serving engine's swap "disk"),
4. verify each adapter beats the base model on its own task.

    PYTHONPATH=src python examples/train_lora_adapter_torch.py        # GPU
    PYTHONPATH=src python examples/train_lora_adapter_torch.py --device cpu

The train steps differentiate the plain attention (the kernels have no
backward); the evaluation and the router's trunk run without autograd on
the model's attention route (``flash_prefill`` on ``cuda``).
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lora import LoRAMode
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, lm_batches, router_dataset
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.router_train import router_accuracy, train_router
from repro_torch.training.train import (cross_entropy, init_train_state,
                                        train_loop)


@torch.no_grad()
def eval_loss(model, params, lora, batches, n=8):
    total = 0.0
    mode = LoRAMode("single", None, model.cfg.lora.scale) if lora else \
        LoRAMode()
    for _ in range(n):
        b = next(batches)
        toks = torch.as_tensor(b["tokens"], device=model.device)
        logits, _ = model.forward(params, {"tokens": toks[:, :-1]}, lora,
                                  mode, attn_kernel=model.attn_kernel)
        total += float(cross_entropy(logits, toks[:, 1:]))
    return total / n


def run(model, new_state, steps, n_router=240, n_router_train=192):
    """The example from its model on: ``new_state()`` gives each task's
    starting ``TrainState`` (the reference starts both from one key, so
    the frozen base is shared), ``steps`` train steps per task, a router
    set of ``n_router`` prompts (the first ``n_router_train`` to train
    on). Returns {'hist': {task: [(step, loss)]}, 'eval': {(task,
    adapter or None): loss}, 'router_acc', 'chance', 'adapters'}."""
    cfg = model.cfg
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=48, batch_size=8)

    # shared frozen base
    state0 = new_state()
    adapters, hists = {}, {}
    for task in (0, 1):
        print(f"--- fine-tuning adapter for task {task} ({steps} steps) ---")
        state, hists[task] = train_loop(
            model, lm_batches(dc, task=task), steps, state=new_state(),
            peak_lr=5e-3, log_every=50)
        adapters[task] = state.lora

    base_params = state0.params
    evals = {}
    print("\n--- per-task evaluation (loss; lower is better) ---")
    for task in (0, 1):
        ev = lm_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=48,
                                   batch_size=8, seed=999), task=task)
        base = evals[task, None] = eval_loss(model, base_params, None, ev)
        for a in (0, 1):
            ev2 = lm_batches(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=48, batch_size=8,
                                        seed=999), task=task)
            la = evals[task, a] = eval_loss(model, base_params, adapters[a],
                                            ev2)
            tag = "«match»" if a == task else ""
            print(f"task {task}: adapter{a} {la:.4f} vs base {base:.4f} {tag}")

    print("\n--- adapter router (BCE multi-label head) ---")
    prompts, labels, _ = router_dataset(dc, n_adapters=4,
                                        n_samples=n_router)
    k = n_router_train
    head, bce = train_router(model, base_params, prompts[:k], labels[:k],
                             epochs=6, batch_size=16, lr=3e-3)
    acc = router_accuracy(model, base_params, head, prompts[k:], labels[k:])
    print(f"router top-1 suitable accuracy: {acc:.3f} (chance "
          f"{labels.mean():.3f})")

    with tempfile.TemporaryDirectory() as d:
        for task, lora_tree in adapters.items():
            p = os.path.join(d, f"adapter_task{task}.npz")
            save_checkpoint(p, lora_tree)
            back = load_checkpoint(p, lora_tree)
            assert all(
                torch.equal(a, b) for a, b in
                zip(tree_leaves(lora_tree), tree_leaves(back)))
            print(f"adapter {task} checkpointed to {p} "
                  f"({os.path.getsize(p)/1e6:.1f} MB) and verified")
    return {"hist": hists, "eval": evals, "router_acc": acc,
            "chance": float(labels.mean()), "adapters": adapters}


def main(argv=None, steps=200):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(ap.parse_args(argv).device)

    cfg = reduced_config(get_config("llama3-8b"))
    model = build_model(cfg, device, attn_kernel=device.type == "cuda")
    return run(model, lambda: init_train_state(
        model, torch.Generator(device=device).manual_seed(0)), steps)


if __name__ == "__main__":
    main()
