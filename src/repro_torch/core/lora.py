"""LoRA core: adapter parameters, application modes, merge (``repro.core.lora``).

A LoRA-augmented linear computes ``y = x W + s · x Aᵀ Bᵀ``. Modes:

* ``single``  — one adapter for the whole batch.
* ``batched`` — the paper's **Batch LoRA Inference** (Fig. 6): every
  request in the batch may use a different adapter; the base GEMM runs
  over the full batch and the LoRA delta comes from a *stacked adapter
  pool* indexed per request (backend ``einsum``: gather-einsum;
  ``sgmv``: the grouped CUDA kernels of ``repro_torch.kernels``).

The pool ``A_stack[R, r, d_in]`` / ``B_stack[R, d_out, r]`` holds
``R = max_resident`` adapter slots and is written in place
(``load_adapter_into_slot``): serving never reallocates it.
"""
from __future__ import annotations

from contextvars import ContextVar
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import spans

# The plan memo (``LoRAMode.plans``) of the mode whose batched delta is
# being computed, for ``_lora_delta_sgmv``. ``apply_lora`` sets it for
# the length of one call and puts the old value back, so it never holds
# a memo past the call. It travels beside the arguments because
# ``lora_delta_batched`` keeps its call (x, A, B, ids, scale, backend):
# the benchmark's planted faults replace it with a wrapper of that call.
_step_plans: ContextVar[Optional[Dict[Any, Any]]] = ContextVar(
    "lora_step_plans", default=None)


class LoRAMode(NamedTuple):
    """How to apply LoRA inside a linear layer.

    kind: 'none' | 'single' | 'batched'
    adapter_ids: [batch] slot indices (batched mode only).
    scale: alpha / rank.
    backend: 'einsum' (gather-einsum) or 'sgmv' (grouped CUDA kernels;
        their plain versions on CPU tensors) — batched mode only.
    plans: None (every sgmv call plans its own grouping) or a dict owned
        by this mode, which the sgmv backend fills, through
        ``apply_lora``, with one grouping plan per token layout
        (``_lora_delta_sgmv``) and every later call on that layout
        reuses. A plan holds for these ``adapter_ids`` only: give each
        mode a fresh ``{}`` and let the memo die with it.
    """

    kind: str = "none"
    adapter_ids: Optional[torch.Tensor] = None
    scale: float = 1.0
    backend: str = "einsum"
    plans: Optional[Dict[Any, Any]] = None


def resolve_lora_backend(requested: str = "auto",
                         device: Any = "cuda") -> str:
    """Map the ModelConfig/EngineConfig knob to a concrete backend.

    'auto' selects the SGMV kernels when the engine runs on CUDA and the
    gather-einsum path on the CPU, as the reference picks its Pallas
    kernels on TPU only.
    """
    if requested == "auto":
        return "sgmv" if torch.device(device).type == "cuda" else "einsum"
    if requested not in ("einsum", "sgmv"):
        raise ValueError(f"unknown lora backend {requested!r}")
    return requested


def init_lora_pair(generator: torch.Generator, d_in: int, d_out: int,
                   rank: int, *, stack: Tuple[int, ...] = (),
                   dtype: torch.dtype = torch.float32,
                   device: Any = None) -> Dict[str, torch.Tensor]:
    """An (A, B) pair, optionally stacked over leading dims (layers,
    slots). A ~ N(0, 1/r), B = 0 so the adapter starts as identity —
    standard LoRA init."""
    device = device if device is not None else generator.device
    a = torch.randn((*stack, rank, d_in), generator=generator,
                    dtype=torch.float32, device=device)
    a = a.div_(rank ** 0.5).to(dtype)
    b = torch.zeros((*stack, d_out, rank), dtype=dtype, device=device)
    return {"A": a, "B": b}


def lora_delta_single(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """s · x Aᵀ Bᵀ for one adapter shared across the batch.
    x: [..., d_in]; A: [r, d_in]; B: [d_out, r]."""
    shrink = torch.einsum("...d,rd->...r", x, a.to(x.dtype))
    return scale * torch.einsum("...r,or->...o", shrink, b.to(x.dtype))


def lora_delta_batched(x: torch.Tensor, a_stack: torch.Tensor,
                       b_stack: torch.Tensor, adapter_ids: torch.Tensor,
                       scale: float, backend: str = "einsum"
                       ) -> torch.Tensor:
    """Batch LoRA Inference: per-request adapters from the stacked pool.

    x: [B, S, d_in] (or [B, d_in]); A_stack: [R, r, d_in];
    B_stack: [R, d_out, r]; adapter_ids: [B] slots.

    backend='einsum' gathers only the per-request adapters ([B, r, d_in]);
    backend='sgmv' flattens the batch to [T, d_in] with per-token slots
    and runs the grouped kernels (``repro_torch.kernels.ops.sgmv``),
    reusing the grouping plans of the calling mode's memo (``apply_lora``
    with ``LoRAMode.plans``). With wall spans on, the whole delta is a
    ``lora`` span.
    """
    sp = spans.wall
    if sp is not None:
        sp.open("lora")
    if backend == "sgmv":
        out = _lora_delta_sgmv(x, a_stack, b_stack, adapter_ids, scale)
    else:
        ids = adapter_ids.long()
        a_sel = a_stack[ids].to(x.dtype)  # [B, r, d_in]
        b_sel = b_stack[ids].to(x.dtype)  # [B, d_out, r]
        if x.dim() == 3:
            shrink = torch.einsum("bsd,brd->bsr", x, a_sel)
            out = scale * torch.einsum("bsr,bor->bso", shrink, b_sel)
        else:
            shrink = torch.einsum("bd,brd->br", x, a_sel)
            out = scale * torch.einsum("br,bor->bo", shrink, b_sel)
    if sp is not None:
        sp.close()
    return out


def _lora_delta_sgmv(x: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor, adapter_ids: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Flatten [B, S, d] -> [T, d] with per-token slots, run ops.sgmv,
    reshape back. The adapters are computed at x.dtype, like the einsum
    backend: the reference casts the pool to x.dtype before its kernels;
    here the kernels round each weight to x.dtype as they load it, which
    gives the same numbers without casting the whole pool per call.

    The plan depends only on the per-token slots, R and blk_t, so with a
    memo (``_step_plans``) it is built once per token layout and slot
    count, and every later projection of the step reuses it: with wall
    spans on, counted as ``lora_plans`` (in ``ops.sgmv_plan``) and
    ``lora_plan_reuses``. The layout is keyed by its token count T: the
    slots' B rows fix S = T / B, and [B, 1, d] shares [B, d]'s plan. The
    key holds the slot tensor's identity and the entry holds the tensor,
    so a memo handed on with other ``adapter_ids`` misses instead of
    routing tokens to another tenant's adapter."""
    from repro_torch.kernels import ops  # deferred, as in the reference

    plans = _step_plans.get()
    lead = x.shape[:-1]
    t, n_slots = lead.numel(), a_stack.shape[0]
    key = (id(adapter_ids), t, n_slots)
    entry = plans.get(key) if plans is not None else None
    if entry is None:
        ids = adapter_ids.to(torch.int32)
        token_slots = (ids[:, None].expand(lead).reshape(-1)
                       if x.dim() == 3 else ids)
        plan = ops.sgmv_plan(token_slots, n_slots, ops.auto_blk_t(t, n_slots))
        if plans is not None:
            plans[key] = (adapter_ids, token_slots, plan)
    else:
        _, token_slots, plan = entry
        sp = spans.wall
        if sp is not None:
            sp.count("lora_plan_reuses")
    delta = ops.sgmv(x.reshape(-1, x.shape[-1]), a_stack, b_stack,
                     token_slots, scale, n_slots=n_slots, blk_t=plan.blk_t,
                     plan=plan)
    return delta.reshape(*lead, b_stack.shape[1])


def apply_lora(x: torch.Tensor, pair: Optional[Dict[str, torch.Tensor]],
               mode: LoRAMode) -> torch.Tensor:
    """LoRA delta for ``x`` given this module's (stacked) pair and mode.

    pair['A'] shapes: single -> [r, d_in]; batched -> [R, r, d_in].
    Returns a scalar zero when mode.kind == 'none' or pair is None —
    callers just add it unconditionally.
    """
    if pair is None or mode.kind == "none":
        return torch.zeros((), dtype=x.dtype, device=x.device)
    if mode.kind == "single":
        return lora_delta_single(x, pair["A"], pair["B"], mode.scale)
    if mode.kind == "batched":
        token = _step_plans.set(mode.plans)
        try:
            return lora_delta_batched(x, pair["A"], pair["B"],
                                      mode.adapter_ids, mode.scale,
                                      backend=mode.backend)
        finally:
            _step_plans.reset(token)
    raise ValueError(f"unknown LoRA mode {mode.kind!r}")


def merge_lora(w: torch.Tensor, pair: Dict[str, torch.Tensor], scale: float,
               sign: float = 1.0) -> torch.Tensor:
    """W ± s·(BA)ᵀ. w: [d_in, d_out]; A: [r, d_in]; B: [d_out, r].
    sign=-1 unmerges."""
    delta = torch.einsum("or,rd->do", pair["B"], pair["A"])
    return w + sign * scale * delta.to(w.dtype)


def load_adapter_into_slot(stack_tree: Any, adapter_tree: Any,
                           slot: int) -> Any:
    """Write one adapter's (A, B) tree into pool slot ``slot``, in place.
    stack_tree leaves: [R, ...]; adapter_tree leaves: [...]. Returns
    ``stack_tree``."""
    if isinstance(stack_tree, dict):
        for k, sub in stack_tree.items():
            load_adapter_into_slot(sub, adapter_tree[k], slot)
        return stack_tree
    stack_tree[slot].copy_(adapter_tree)
    return stack_tree
