"""Shared layers: norms, linears (LoRA-aware), MLP (``repro.models.layers``).

Layers are plain functions on tensors: params are nested dicts of
tensors, apply functions take (params, x, ...). LoRA enters every linear
through ``repro_torch.core.lora``; sharding hints through
``logical_constraint`` (the identity off a mesh).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.lora import LoRAMode, apply_lora
from repro_torch.distributed.sharding import logical_constraint


class _Repeats(threading.local):
    def __init__(self) -> None:
        self.elide = False   # set only while counting a step on fake tensors
        self.scale = 1       # product of the elided loops' trip counts


_REPEATS = _Repeats()


@contextlib.contextmanager
def elide_repeats() -> Iterator[None]:
    """Within the block, a ``repeats`` loop over fake tensors runs one
    iteration that stands for all of them. Only for counting a step's
    cost, where no value is computed: the skipped iterations would
    dispatch the same ops on the same shapes. A ``repeats`` loop over
    real tensors raises within it."""
    prev = _REPEATS.elide
    _REPEATS.elide = True
    try:
        yield
    finally:
        _REPEATS.elide = prev


def repeat_scale() -> int:
    """How many iterations each op dispatched now stands for."""
    return _REPEATS.scale


@contextlib.contextmanager
def repeats(n: int, like: torch.Tensor) -> Iterator[int]:
    """A loop of ``n`` iterations that differ only in which block they
    read: yields how many to run. That is ``n``, unless a cost count
    elides repeats (``elide_repeats``, with autograd off, so no backward
    replays the one iteration): then one iteration runs and counts for
    ``n``, as a scan's body counts for its length in the reference's
    ``jaxpr_cost``. ``like`` is a tensor the loop reads; elision needs it
    fake (a ``FakeTensor``, or a DTensor of fake shards) and raises on
    real data, where one iteration would return one block's values for
    all."""
    if not _REPEATS.elide or n <= 1 or torch.is_grad_enabled():
        yield n
        return
    from torch._subclasses.fake_tensor import is_fake
    if not is_fake(like):
        raise RuntimeError(
            "elide_repeats around a loop over real tensors: one iteration "
            "would stand for all and return wrong values")
    _REPEATS.scale *= n
    try:
        yield 1
    finally:
        _REPEATS.scale //= n


def init_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where init functions allocate: the generator's device, or the meta
    device (shapes only) when there is no generator."""
    return generator.device if generator is not None else torch.device("meta")


def truncated_normal_init(generator: Optional[torch.Generator],
                          shape: Tuple[int, ...], scale: float,
                          dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale / sqrt(shape[0])``.

    As in the reference, the stddev comes from ``shape[0]``: for stacked
    weights ``(n_groups, d_in, d_out)`` that is the group count, not
    ``d_in``. Kept as written, so both packages draw from one
    distribution."""
    device = init_device(generator)
    stddev = scale / max(1.0, math.sqrt(shape[0] if shape else 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(stddev).to(dtype)


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
           lora_pair: Optional[Dict[str, torch.Tensor]] = None,
           lora_mode: LoRAMode = LoRAMode()) -> torch.Tensor:
    """y = x W (+ b) + LoRA delta — the paper's ``y_i = W x_i + B_{a_i}
    A_{a_i} x_i`` (Fig. 6): the base GEMM runs over the whole batch."""
    y = torch.matmul(x, params["w"].to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y + apply_lora(x, lora_pair, lora_mode)


def rmsnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float) -> torch.Tensor:
    """Gemma-style RMSNorm: the learned scale enters as ``(1 + scale)``."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + params["scale"].float())).to(dt)


def layernorm_init(d: int, dtype: torch.dtype, *,
                   stack: Tuple[int, ...] = (),
                   device: Any = None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device),
            "bias": torch.zeros((*stack, d), dtype=dtype, device=device)}


def layernorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm with its statistics in f32. The variance is the
    population variance, as ``jnp.var``: torch's default is the sample
    variance."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * params["scale"].float() + params["bias"].float()).to(dt)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda v: F.gelu(v, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_init(generator: Optional[torch.Generator], d_model: int, d_ff: int, *,
             glu: bool, dtype: torch.dtype,
             stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    p = {
        "up": truncated_normal_init(generator, (*stack, d_model, d_ff), 1.0,
                                    dtype),
        "down": truncated_normal_init(generator, (*stack, d_ff, d_model),
                                      1.0, dtype),
    }
    if glu:
        p["gate"] = truncated_normal_init(generator, (*stack, d_model, d_ff),
                                          1.0, dtype)
    return p


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, *, act: str,
        glu: bool, lora: Optional[Dict] = None,
        lora_mode: LoRAMode = LoRAMode()) -> torch.Tensor:
    fn = activation(act)
    lget = (lora or {}).get
    up = linear({"w": params["up"]}, x, lget("up"), lora_mode)
    if glu:
        gate = linear({"w": params["gate"]}, x, lget("gate"), lora_mode)
        h = fn(gate) * up
    else:
        h = fn(up)
    h = logical_constraint(h, "batch", None, "ff")
    return linear({"w": params["down"]}, h, lget("down"), lora_mode)


def unembed(x: torch.Tensor, embed_or_head: torch.Tensor, *, tied: bool,
            softcap: Optional[float]) -> torch.Tensor:
    """Final logits with optional soft-capping."""
    w = embed_or_head.to(x.dtype)
    logits = torch.matmul(x, w.t() if tied else w)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logical_constraint(logits, "batch", None, "vocab")
