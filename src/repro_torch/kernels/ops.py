"""Public wrappers around the port's kernels (``repro.kernels.ops``).

``sgmv`` is the complete Batch LoRA Inference data path of the paper's
Fig. 6: gather tokens into adapter-homogeneous u-batches (sorted and
padded to the kernel block size), run the grouped shrink/expand kernels,
and scatter the results back to the original batch order. Every shape is
a function of (T, R, blk_t) only, as in the reference: the padded token
count is the static bound ``ceil(T/blk_t)·blk_t + R·blk_t``, so the plan
never waits on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.sgmv import DEFAULT_BLK_T, sgmv_expand, sgmv_shrink


def auto_blk_t(t: int, n_slots: int, requested: int = DEFAULT_BLK_T) -> int:
    """Token-block size for a T-token, R-slot sgmv problem.

    Padded work is (ceil(T/blk_t) + R) · blk_t rows, so decode-sized
    batches (T ≈ R) want small blocks while prefill wants larger ones.
    Target the per-slot run length, clamped to [8, requested] and rounded
    up to a power of two (the reference's rule, kept so both packages
    build the same plan).
    """
    per_slot = max(8, -(-t // max(1, n_slots)))
    blk = 1 << (per_slot - 1).bit_length()
    return max(8, min(requested, blk))


class Grouping(NamedTuple):
    """Static-shaped u-batch layout for a batch of per-token adapter slots."""

    padded_pos: torch.Tensor   # [T] int32 position of each sorted token
    perm: torch.Tensor         # [T] int64 sort permutation
    block_slots: torch.Tensor  # [nb] int32 adapter slot owning each block
    n_padded: int              # nb * blk_t


def plan_grouping(token_slots: torch.Tensor, n_slots: int,
                  blk_t: int = DEFAULT_BLK_T) -> Grouping:
    """Gather/scatter plan for ``token_slots`` [T] (values in [0, R)).

    Tokens are stably sorted by slot; each slot's run is padded to a
    multiple of blk_t so every kernel block is adapter-homogeneous.
    Blocks past the last used one point at the last slot; they hold zero
    padding and are scattered nowhere.
    """
    t = token_slots.shape[0]
    nb = -(-t // blk_t) + n_slots
    dev = token_slots.device
    slots = token_slots.long()
    perm = torch.argsort(slots, stable=True)
    sorted_slots = slots[perm]
    counts = torch.bincount(slots, minlength=n_slots)[:n_slots]      # [R]
    padded_counts = -(-counts // blk_t) * blk_t                      # [R]
    starts = torch.cumsum(padded_counts, 0) - padded_counts          # [R]
    run_start = torch.cumsum(counts, 0) - counts                     # [R]
    rank = torch.arange(t, device=dev) - run_start[sorted_slots]
    padded_pos = (starts[sorted_slots] + rank).to(torch.int32)
    cum_blocks = torch.cumsum(padded_counts // blk_t, 0)
    block_slots = torch.searchsorted(
        cum_blocks, torch.arange(nb, device=dev), right=True)
    block_slots = block_slots.clamp(0, n_slots - 1).to(torch.int32)
    return Grouping(padded_pos, perm, block_slots, nb * blk_t)


def sgmv(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
         token_slots: torch.Tensor, scale: float, *, n_slots: int,
         blk_t: Optional[int] = DEFAULT_BLK_T) -> torch.Tensor:
    """Grouped LoRA delta for a heterogeneous-adapter batch.

    x: [T, d_in]; a_stack: [R, r, d_in]; b_stack: [R, d_out, r];
    token_slots: [T] in [0, R). Returns [T, d_out] = scale·B_s(A_s x) in
    x.dtype. The adapters are rounded to x.dtype inside the kernels (the
    reference casts the whole pool first: the same numbers, without
    re-materialising the pool on every call). blk_t=None picks the block
    size from (T, R) via ``auto_blk_t``.
    """
    t, d_in = x.shape
    if blk_t is None:
        blk_t = auto_blk_t(t, n_slots)
    plan = plan_grouping(token_slots, n_slots, blk_t)
    pos = plan.padded_pos.long()
    xbuf = x.new_zeros((plan.n_padded, d_in))
    xbuf[pos] = x[plan.perm]                        # Fig. 6 gather
    s = sgmv_shrink(xbuf, a_stack, plan.block_slots, blk_t=blk_t)
    y = sgmv_expand(s, b_stack, plan.block_slots, blk_t=blk_t,
                    compute_dtype=x.dtype)
    out = torch.empty((t, b_stack.shape[1]), dtype=y.dtype, device=y.device)
    out[plan.perm] = y[pos]                         # Fig. 6 scatter
    return (scale * out).to(x.dtype)
