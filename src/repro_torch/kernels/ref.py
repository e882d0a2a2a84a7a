"""Plain-PyTorch oracles for the port's kernels (``repro.kernels.ref``).

Tests compare kernels against these; ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Any, Optional

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


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_pos: torch.Tensor, q_pos: Any, *,
                         window: Optional[int] = None,
                         chunked: bool = False,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over a ring cache.

    q: [B, H, hd]; k, v: [B, C, KH, hd]; kv_pos: [B, C] (-1 = empty);
    q_pos: scalar or [B] (the reference takes a scalar; the port's engine
    decodes each row at its own position). Returns [B, H, hd] (f32
    arithmetic, q dtype out)."""
    b, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), k.float()) * hd ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.as_tensor(q_pos, dtype=torch.int32,
                         device=q.device).expand(b)[:, None]
    valid = (kv_pos >= 0) & (kv_pos <= qp)
    if window is not None:
        if chunked:  # torch's // on integer tensors floors, as JAX's does
            valid &= (qp // window) == (kv_pos // window)
        else:
            valid &= (qp - kv_pos) < window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)
