"""Adapter-router training (paper §4.1; ``repro.training.router_train``).

The router is the frozen base model trunk + one Linear head
[d_model → n_adapters], trained as a multi-label classifier with
BCE-with-logits on profiling data: labels mark which adapters produce
correct responses for a prompt (here: synthetic task→adapter affinities
from ``training/data.py``).

Only the head trains. The trunk's features run without autograd through
the model's own attention route (``attn_kernel=model.attn_kernel``: the
``flash_prefill`` kernel on the card); the head's step is autograd over
the head alone, then ``adamw_update``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.router import trunk_features
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update


def init_router_head(generator: torch.Generator, d_model: int,
                     n_adapters: int) -> Dict[str, torch.Tensor]:
    dev = generator.device
    w = torch.randn((d_model, n_adapters), generator=generator,
                    dtype=torch.float32, device=dev) * 0.02
    return {"w": w, "b": torch.zeros((n_adapters,), dtype=torch.float32,
                                     device=dev)}


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """The reference's stable BCE-with-logits (mean over all entries)."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def make_router_step(model: Model, lr: float = 1e-3
                     ) -> Tuple[Callable, Callable]:
    def loss_fn(head: Dict, feats: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        logits = feats @ head["w"] + head["b"]
        return bce_with_logits(logits, labels)

    @torch.no_grad()
    def features(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        return trunk_features(model, params, tokens)

    def step(head: Dict, opt: AdamWState, feats: torch.Tensor,
             labels: torch.Tensor) -> Tuple[Dict, AdamWState, torch.Tensor]:
        trained = {k: v.detach().requires_grad_(True)
                   for k, v in head.items()}
        loss = loss_fn(trained, feats, labels)
        gw, gb = torch.autograd.grad(loss, (trained["w"], trained["b"]))
        head, opt, _ = adamw_update({"w": gw, "b": gb}, opt, head, lr=lr)
        return head, opt, loss.detach()

    return features, step


def train_router(model: Model, params: Dict, prompts: np.ndarray,
                 labels: np.ndarray, *, epochs: int = 3,
                 batch_size: int = 16, lr: float = 1e-3,
                 generator: Optional[torch.Generator] = None,
                 log_fn: Callable[[str], None] = print
                 ) -> Tuple[Dict, float]:
    """Returns (head, final train loss). Features are precomputed once —
    the trunk is frozen, so this is both faithful and fast."""
    dev = model.device
    generator = (generator if generator is not None
                 else torch.Generator(device=dev).manual_seed(0))
    n, n_adapters = labels.shape
    head = init_router_head(generator, model.cfg.d_model, n_adapters)
    opt = adamw_init(head)
    features, step = make_router_step(model, lr)

    feats = torch.cat([
        features(params, torch.as_tensor(prompts[i:i + batch_size],
                                         device=dev))
        for i in range(0, n, batch_size)])
    labels_t = torch.as_tensor(labels, device=dev)

    order = np.arange(n)
    loss = float("nan")
    nrng = np.random.default_rng(0)
    for ep in range(epochs):
        nrng.shuffle(order)
        for i in range(0, n, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=dev)
            head, opt, loss = step(head, opt, feats[idx], labels_t[idx])
        log_fn(f"router epoch {ep}: bce {float(loss):.4f}")
    return head, float(loss)


def router_accuracy(model: Model, params: Dict, head: Dict,
                    prompts: np.ndarray, labels: np.ndarray,
                    batch_size: int = 16) -> float:
    """Top-1 'suitable adapter' accuracy: argmax score lands on a positive
    label (the paper's router quality notion, Table 12)."""
    features, _ = make_router_step(model)
    correct = 0
    for i in range(0, len(prompts), batch_size):
        f = features(params, torch.as_tensor(prompts[i:i + batch_size],
                                             device=model.device))
        scores = f @ head["w"] + head["b"]
        pred = torch.argmax(scores, -1).cpu().numpy()
        correct += int(labels[np.arange(i, i + len(pred)), pred].sum())
    return correct / len(prompts)
