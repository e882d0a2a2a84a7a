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

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch


class LoRAMode(NamedTuple):
    """How to apply LoRA inside a linear layer.

    kind: 'none' | 'single' | 'batched'
    adapter_ids: [batch] slot indices (batched mode only).
    scale: alpha / rank.
    backend: 'einsum' (gather-einsum) or 'sgmv' (grouped CUDA kernels;
        their plain versions on CPU tensors) — batched mode only.
    """

    kind: str = "none"
    adapter_ids: Optional[torch.Tensor] = None
    scale: float = 1.0
    backend: str = "einsum"


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
    and runs the grouped kernels (``repro_torch.kernels.ops.sgmv``).
    """
    if backend == "sgmv":
        return _lora_delta_sgmv(x, a_stack, b_stack, adapter_ids, scale)
    ids = adapter_ids.long()
    a_sel = a_stack[ids].to(x.dtype)  # [B, r, d_in]
    b_sel = b_stack[ids].to(x.dtype)  # [B, d_out, r]
    if x.dim() == 3:
        shrink = torch.einsum("bsd,brd->bsr", x, a_sel)
        return scale * torch.einsum("bsr,bor->bso", shrink, b_sel)
    shrink = torch.einsum("bd,brd->br", x, a_sel)
    return scale * torch.einsum("br,bor->bo", shrink, b_sel)


def _lora_delta_sgmv(x: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor, adapter_ids: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Flatten [B, S, d] -> [T, d] with per-token slots, run ops.sgmv,
    reshape back. The adapters are computed at x.dtype, like the einsum
    backend: the reference casts the pool to x.dtype before its kernels;
    here the kernels round each weight to x.dtype as they load it, which
    gives the same numbers without casting the whole pool per call."""
    from repro_torch.kernels import ops  # deferred, as in the reference

    ids = adapter_ids.to(torch.int32)
    if x.dim() == 3:
        b, s, d_in = x.shape
        token_slots = ids.repeat_interleave(s)
        flat = x.reshape(b * s, d_in)
    else:
        token_slots = ids
        flat = x
    delta = ops.sgmv(flat, a_stack, b_stack, token_slots, scale,
                     n_slots=a_stack.shape[0], blk_t=None)
    return delta.reshape(*x.shape[:-1], b_stack.shape[1])


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
        return lora_delta_batched(x, pair["A"], pair["B"], mode.adapter_ids,
                                  mode.scale, backend=mode.backend)
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
