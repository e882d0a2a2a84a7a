"""Training substrate (``repro.training.train``): the LoRA fine-tuning
step (the paper's setting — the base model is frozen, adapters are the
trainable artifact) plus a full-parameter option for completeness.

``make_train_step`` builds a step:
    state, metrics = step(state, batch)
with cross-entropy next-token loss + the stack's aux losses, AdamW over
the LoRA params only, warmup-cosine schedule, grad clipping. Gradients
come from ``torch.autograd`` through ``Model.forward(...,
attn_kernel=False)``: like the reference, which differentiates its
pure-JAX ``blockwise_attention``, training runs the plain attention —
the attention kernels have no backward. The step is functional: it
returns a new state and leaves the old one's tensors as they were, and
the frozen base params never require grad.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lora import LoRAMode
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update, tree_leaves,
                                            tree_map, warmup_cosine)


class TrainState(NamedTuple):
    params: Any          # frozen base params
    lora: Any            # trainable adapter (f32)
    opt: AdamWState      # optimizer state over `lora` (or `params`)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _trainable(tree: Any) -> Any:
    """Leaves that autograd differentiates, sharing the tree's storage."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def make_train_step(model: Model, *, peak_lr: float = 1e-4,
                    warmup: int = 50, total_steps: int = 1000,
                    weight_decay: float = 0.0,
                    train_base: bool = False,
                    remat: bool = False) -> Callable:
    """LoRA fine-tune step (train_base=False) or full fine-tune step.
    ``remat`` recomputes each layer group's forward in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations: the
    same numbers for less memory. It applies to the decoder-only stacks;
    an encoder-decoder's layers run plainly, as in the reference."""
    scale = model.cfg.lora.scale
    opts = {"remat": remat}

    def loss_fn(lora: Any, params: Any, batch: Dict
                ) -> Tuple[torch.Tensor, Dict]:
        tokens = batch["tokens"]
        inp = {k: v for k, v in batch.items() if k != "tokens"}
        inp["tokens"] = tokens[:, :-1]
        mode = (LoRAMode("single", None, scale) if lora is not None
                else LoRAMode())
        logits, aux = model.forward(params, inp, lora, mode, opts,
                                    attn_kernel=False)
        loss = cross_entropy(logits, tokens[:, 1:], batch.get("loss_mask"))
        total = loss + sum(aux.values()) if aux else loss
        return total, {"loss": loss, **aux}

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        """Differentiate the loss in the trained tree (the adapter, or
        the base params with ``train_base``) and take one AdamW step."""
        trained = state.params if train_base else state.lora
        tree = _trainable(trained)
        params, lora = ((tree, state.lora) if train_base
                        else (state.params, tree))
        total, metrics = loss_fn(lora, params, batch)
        grads_flat = torch.autograd.grad(total, tree_leaves(tree),
                                         materialize_grads=True)
        grads = _unflatten(tree, iter(grads_flat))
        lr = warmup_cosine(state.opt.step + 1, peak_lr=peak_lr,
                           warmup=warmup, total=total_steps)
        new, opt, gnorm = adamw_update(grads, state.opt, trained, lr=lr,
                                       weight_decay=weight_decay)
        metrics = dict({k: v.detach() for k, v in metrics.items()},
                       grad_norm=gnorm, lr=lr)
        if train_base:
            return TrainState(new, state.lora, opt), metrics
        return TrainState(state.params, new, opt), metrics

    return step


def _unflatten(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """Rebuild ``tree``'s structure from leaves in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def init_train_state(model: Model, generator: torch.Generator,
                     train_base: bool = False) -> TrainState:
    params = model.init(generator)
    lora = model.init_lora(generator)  # single adapter, f32
    opt = adamw_init(params if train_base else lora)
    return TrainState(params, lora, opt)


def train_loop(model: Model, batches: Iterator[Dict], n_steps: int, *,
               generator: Optional[torch.Generator] = None,
               log_every: int = 10, state: Optional[TrainState] = None,
               log_fn: Callable[[str], None] = print,
               **step_kwargs: Any) -> Tuple[TrainState, list]:
    """Minimal driver used by the examples and tests (one device)."""
    if state is None:
        generator = (generator if generator is not None else
                     torch.Generator(device=model.device).manual_seed(0))
        state = init_train_state(model, generator)
    step = make_train_step(model, total_steps=n_steps, **step_kwargs)
    history = []
    for i in range(n_steps):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in next(batches).items()}
        state, metrics = step(state, batch)
        if i % log_every == 0 or i == n_steps - 1:
            loss = float(metrics["loss"])
            history.append((i, loss))
            log_fn(f"step {i:5d}  loss {loss:.4f}  "
                   f"gnorm {float(metrics['grad_norm']):.3f}")
    return state, history
