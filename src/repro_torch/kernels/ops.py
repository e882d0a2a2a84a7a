"""Public wrappers around the port's kernels (``repro.kernels.ops``).

``sgmv`` is the complete Batch LoRA Inference data path of the paper's
Fig. 6: gather tokens into adapter-homogeneous u-batches (sorted and
padded to the kernel block size), run the grouped shrink/expand kernels,
and scatter the results back to the original batch order. Every shape is
a function of (T, R, blk_t) only, as in the reference: the padded token
count is the static bound ``ceil(T/blk_t)·blk_t + R·blk_t``. The plan is
computed on the device without a host sync, and the number of blocks that
really hold tokens (``n_used``) stays there: the kernels read it and skip
the weights of the zero padding blocks. ``sgmv_plan`` builds the plan
apart, so that calls on the same token slots can share one.

``paged_gather`` is the paged KV arena's page fetch: any-rank arena
leaves through the ``paged_gather_pages`` kernel.

``decode_attention`` and ``flash_prefill`` are the two attention kernels'
entry points (``flash_decode``, ``flash_prefill``); the model reaches them
when its ``attn_kernel`` route is on.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core import spans
from repro_torch.kernels import decode_attention as _decode_attention_mod
from repro_torch.kernels import flash_prefill as _flash_prefill_mod
from repro_torch.kernels import paged_gather as _paged_gather_mod
from repro_torch.kernels import ref
from repro_torch.kernels import sgmv as _sgmv_mod
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill as _flash_prefill
from repro_torch.kernels.paged_gather import paged_gather_pages
from repro_torch.kernels.sgmv import DEFAULT_BLK_T, sgmv_expand, sgmv_shrink


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launches so far, by kernel name (the
    wrappers' ``launches`` counters, read on the host)."""
    return {**_sgmv_mod.launches, **_flash_prefill_mod.launches,
            **_decode_attention_mod.launches, **_paged_gather_mod.launches}


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
    n_used: torch.Tensor       # () int32 blocks that hold tokens (the rest
    #                            are zero padding), on the device


def plan_grouping(token_slots: torch.Tensor, n_slots: int,
                  blk_t: int = DEFAULT_BLK_T) -> Grouping:
    """Gather/scatter plan for ``token_slots`` [T] (values in [0, R)).

    Tokens are stably sorted by slot; each slot's run is padded to a
    multiple of blk_t so every kernel block is adapter-homogeneous.
    Blocks past the last used one (``n_used``, the cumulative block count's
    last entry) point at the last slot; they hold zero padding and are
    scattered nowhere. Every step stays on the device: the per-slot counts
    are a ``scatter_add_``, not ``torch.bincount``, which reads its input's
    maximum back to the host.
    """
    t = token_slots.shape[0]
    nb = -(-t // blk_t) + n_slots
    dev = token_slots.device
    slots = token_slots.long()
    perm = torch.argsort(slots, stable=True)
    sorted_slots = slots[perm]
    counts = torch.zeros(n_slots, dtype=torch.long, device=dev)
    counts.scatter_add_(0, slots, torch.ones_like(slots))            # [R]
    padded_counts = -(-counts // blk_t) * blk_t                      # [R]
    starts = torch.cumsum(padded_counts, 0) - padded_counts          # [R]
    run_start = torch.cumsum(counts, 0) - counts                     # [R]
    rank = torch.arange(t, device=dev) - run_start[sorted_slots]
    padded_pos = (starts[sorted_slots] + rank).to(torch.int32)
    cum_blocks = torch.cumsum(padded_counts // blk_t, 0)
    block_slots = torch.searchsorted(
        cum_blocks, torch.arange(nb, device=dev), right=True)
    block_slots = block_slots.clamp(0, n_slots - 1).to(torch.int32)
    n_used = cum_blocks[-1].to(torch.int32)
    return Grouping(padded_pos, perm, block_slots, nb * blk_t, n_used)


class SgmvPlan(NamedTuple):
    """A grouping ready for ``sgmv``: ``plan_grouping``'s result, its
    positions as the int64 index of the gather and the scatter, and the
    block size it was built for."""

    grouping: Grouping
    pos: torch.Tensor  # [T] int64 padded_pos
    blk_t: int


def sgmv_plan(token_slots: torch.Tensor, n_slots: int,
              blk_t: int) -> SgmvPlan:
    """Build the plan ``sgmv`` runs on. With wall spans on, a
    ``lora.plan`` span, counted as ``lora_plans``."""
    sp = spans.wall
    if sp is not None:
        sp.open("lora.plan")
    grouping = plan_grouping(token_slots, n_slots, blk_t)
    plan = SgmvPlan(grouping, grouping.padded_pos.long(), blk_t)
    if sp is not None:
        sp.close()
        sp.count("lora_plans")
    return plan


def sgmv(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
         token_slots: torch.Tensor, scale: float, *, n_slots: int,
         blk_t: Optional[int] = DEFAULT_BLK_T,
         plan: Optional[SgmvPlan] = None) -> torch.Tensor:
    """Grouped LoRA delta for a heterogeneous-adapter batch.

    x: [T, d_in]; a_stack: [R, r, d_in]; b_stack: [R, d_out, r];
    token_slots: [T] in [0, R). Returns [T, d_out] = scale·B_s(A_s x) in
    x.dtype. The adapters are rounded to x.dtype inside the kernels (the
    reference casts the whole pool first: the same numbers, without
    re-materialising the pool on every call). blk_t=None picks the block
    size from (T, R) via ``auto_blk_t``. ``plan``, from ``sgmv_plan`` on
    these ``token_slots``, skips the planning (blk_t is then the plan's).
    No step waits on the device. With wall spans on, its four phases are
    spans: ``lora.plan`` (where it builds the plan), ``lora.gather``,
    ``lora.kernels`` and ``lora.scatter`` (the scatter, the scale and the
    cast).
    """
    t, d_in = x.shape
    if plan is None:
        if blk_t is None:
            blk_t = auto_blk_t(t, n_slots)
        plan = sgmv_plan(token_slots, n_slots, blk_t)
    grouping, pos, blk_t = plan
    sp = spans.wall
    if sp is not None:
        sp.open("lora.gather")
    xbuf = x.new_zeros((grouping.n_padded, d_in))
    xbuf[pos] = x[grouping.perm]                    # Fig. 6 gather
    if sp is not None:
        sp.close()
        sp.open("lora.kernels")
    s = sgmv_shrink(xbuf, a_stack, grouping.block_slots, blk_t=blk_t,
                    n_used=grouping.n_used)
    y = sgmv_expand(s, b_stack, grouping.block_slots, blk_t=blk_t,
                    compute_dtype=x.dtype, n_used=grouping.n_used)
    if sp is not None:
        sp.close()
        sp.open("lora.scatter")
    out = torch.empty((t, b_stack.shape[1]), dtype=y.dtype, device=y.device)
    out[grouping.perm] = y[pos]                     # Fig. 6 scatter
    out = (scale * out).to(x.dtype)
    if sp is not None:
        sp.close()
    return out


def paged_gather(arena: torch.Tensor, tables: torch.Tensor, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """Gather block-table-addressed KV pages into contiguous sequences.

    arena: [ng, n_pages, block_size, ...] (trailing dims are flattened
    into one feature axis for the kernel and restored after); tables:
    [B, MB] int32 physical page ids, -1 beyond each sequence's length.
    -1 routes to the *last* page (``tables % n_pages``, a floor modulo):
    the serving arena reserves that slot as the trash page. Returns
    [ng, B, MB·block_size, ...]. ``use_kernel=False`` is the indexing
    route ``arena[:, tables % n_pages]``; both are exact gathers of the
    same pages.
    """
    ng, n_pages, bs = arena.shape[:3]
    rest = arena.shape[3:]
    b, mb = tables.shape
    if not use_kernel:
        pages = arena[:, tables.long() % n_pages]
        return pages.reshape(ng, b, mb * bs, *rest)
    flat = arena.reshape(ng, n_pages, bs, -1)
    out = paged_gather_pages(flat, tables)
    return out.reshape(ng, b, mb * bs, *rest)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_pos: torch.Tensor, q_pos: Any, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     window: Optional[int] = None, chunked: bool = False,
                     softcap: Optional[float] = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """Flash-decode over the ring cache (see ``decode_attention.py``);
    ``q_pos`` a scalar or [B]. An int8 ring comes with its scales
    [B, C, KH] as the cache stores them (bf16); they are cast to the
    kernel's f32 here, as the Pallas wrapper casts them: one elementwise
    op per scale leaf on the device, no host sync. ``use_kernel=False``
    is the oracle ``ref.decode_attention_ref`` (int8 dequantized in f32
    first)."""
    if k_scale is not None:
        k_scale, v_scale = k_scale.float(), v_scale.float()
    if not use_kernel:
        if k_scale is not None:
            k = k.float() * k_scale[..., None]
            v = v.float() * v_scale[..., None]
        return ref.decode_attention_ref(q, k, v, kv_pos, q_pos,
                                        window=window, chunked=chunked,
                                        softcap=softcap)
    return flash_decode(q, k, v, kv_pos, q_pos, k_scale=k_scale,
                        v_scale=v_scale, window=window, chunked=chunked,
                        softcap=softcap)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  qpos: Optional[torch.Tensor] = None,
                  kpos: Optional[torch.Tensor] = None, causal: bool = True,
                  window: Optional[int] = None, chunked: bool = False,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Tiled prefill attention (see ``flash_prefill.py``)."""
    return _flash_prefill(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                          window=window, chunked=chunked, softcap=softcap)
