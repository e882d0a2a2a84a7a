"""AdamW with a warmup-cosine schedule (``repro.training.optimizer``).

Plain functions over dict trees of tensors, not ``torch.optim.AdamW``:
the update is the reference's, step for step — a global-norm clip over
every gradient, bias correction as ``bc1``/``bc2``, ``eps`` outside the
square root, decoupled weight decay — so both packages produce the same
numbers. Leaves are visited in sorted-key order (the order of
``jax.tree.leaves``), so the f32 norm sums its terms in the reference's
order. Updates return new tensors; nothing is written in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moment (tree like params, f32)
    nu: Any              # second moment


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a dict tree in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params: Any) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def warmup_cosine(step: Union[torch.Tensor, int], *, peak_lr: float,
                  warmup: int, total: int, floor: float = 0.1
                  ) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``floor · peak_lr`` at ``total``; f32, on the step's device."""
    step_f = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step_f / max(warmup, 1)
    progress = torch.clamp((step_f - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * progress)))
    return torch.where(step_f < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: Union[float, torch.Tensor] = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = 1.0,
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    if max_grad_norm is not None:
        clip = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * clip.to(g.dtype), grads)

    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
            p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat = tree_map(upd, grads, state.mu, state.nu, params)

    def part(i: int) -> Any:
        return tree_map(lambda t: t[i], flat)

    return part(0), AdamWState(step, part(1), part(2)), gnorm
