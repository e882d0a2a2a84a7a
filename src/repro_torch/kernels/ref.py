"""Plain-PyTorch oracles for the port's kernels (``repro.kernels.ref``).

Tests compare kernels against these; ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

import torch


def sgmv_shrink_ref(x: torch.Tensor, a_stack: torch.Tensor,
                    token_slots: torch.Tensor) -> torch.Tensor:
    """x: [T, d_in]; a_stack: [R, r, d_in]; token_slots: [T] int.

    Returns [T, r] = x_t · A[slot_t]ᵀ (f32)."""
    a_sel = a_stack[token_slots.long()]  # [T, r, d_in]
    return torch.einsum("td,trd->tr", x.float(), a_sel.float())


def sgmv_expand_ref(s: torch.Tensor, b_stack: torch.Tensor,
                    token_slots: torch.Tensor) -> torch.Tensor:
    """s: [T, r]; b_stack: [R, d_out, r]; token_slots: [T] int.

    Returns [T, d_out] = s_t · B[slot_t]ᵀ (f32)."""
    b_sel = b_stack[token_slots.long()]  # [T, d_out, r]
    return torch.einsum("tr,tor->to", s.float(), b_sel.float())


def sgmv_ref(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
             token_slots: torch.Tensor, scale: float) -> torch.Tensor:
    """Full grouped LoRA delta: scale · B[slot](A[slot] x)."""
    return scale * sgmv_expand_ref(
        sgmv_shrink_ref(x, a_stack, token_slots), b_stack, token_slots)
