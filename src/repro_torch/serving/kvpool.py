"""Paged KV-block pool: the paper's pre-allocated-pool discipline applied
to KV memory (vLLM-style paging, pool-block flavored).

The heterogeneous memory manager (§3.3) avoids runtime allocation by
carving adapter memory into fixed blocks; the same discipline applies to
KV context memory: a fixed arena of ``n_blocks`` physical pages of
``block_size`` tokens each, a free stack, and per-sequence block tables.
This lets γ slots share one arena sized for the *expected* total context
instead of γ × max_ctx — the overcommit that makes large-γ serving fit on
a small device.

Two faces:

* **Host side** (``PagedKVPool``): the numpy block allocator. Allocation
  is a scheduling concern — the engine registers/extends/releases
  sequences between device steps and only ships int32 block tables to
  the device.
* **Device side** (``build_arena`` / ``paged_view`` / ``scatter_prefill``
  / ``scatter_decode``): torch gather/scatter over a fixed arena of KV
  pages on the engine's device; the scatters write the arena in place
  (the reference returns new arrays), each a pure function of its
  inputs, so repeating one writes the same values. ``paged_view``
  reconstructs, from block tables + lengths alone, exactly the dense
  ring-cache layout ``models/attention.py`` decodes over — same shapes,
  same stored values, same position masks — so the paged engine
  produces bit-identical token streams to the dense one. Invalid rows/positions route through a trailing *trash block*
  (physical block ``n_blocks``), keeping every scatter dense and
  mask-free. On a GPU the page gather runs through the hand-written
  ``paged_gather_pages`` CUDA kernel (``kernels/ops.paged_gather``).

Ported from ``repro.serving.kvpool``: ``PagedKVPool`` and the numpy
helpers are copied line for line; the device side keeps the reference's
functions, names and semantics in PyTorch.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch


class OutOfBlocksError(RuntimeError):
    pass


@dataclass
class KVPoolStats:
    allocs: int = 0
    frees: int = 0
    peak_used: int = 0
    # allocation requests that hit an empty free list (each is either an
    # admission deferral or a decode-time preemption upstream)
    oom_events: int = 0

    def as_dict(self) -> Dict[str, int]:
        return asdict(self)


class PagedKVPool:
    """Fixed arena of KV pages with per-sequence block tables.

    Blocks are **ref-counted**: a physical page may be held by several
    sequences at once (shared prompt-prefix pages spliced in by
    ``replace_prefix``) and/or by the prefix cache
    (``serving/prefix_cache.py``, which holds one ref per radix node).
    ``release``/``drop_ref`` decrement; a block returns to the free list
    only at refcount zero. An optional ``reclaimer`` (the prefix cache)
    extends capacity: blocks held *only* by the cache form an LRU pool
    that ``can_allocate``/``can_append`` count as available and that
    allocation evicts on demand — reclaim happens *before* the engine's
    deferral/preemption machinery ever sees an exhausted arena.
    """

    def __init__(self, n_blocks: int, block_size: int) -> None:
        assert n_blocks > 0 and block_size > 0
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.free: List[int] = list(range(n_blocks))[::-1]
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.refs: Dict[int, int] = {}
        # duck-typed prefix cache: .reclaimable() -> int,
        # .reclaim(k) -> int, .note_block_ref(blk) (refcount-change hook)
        self.reclaimer: Optional[Any] = None
        self.stats = KVPoolStats()
        # optional observer: callable(name, args) — the engine wires
        # serving/trace.py's arena hook here during a traced serve();
        # None (default) costs one condition per event site
        self.on_event: Optional[Any] = None

    def _event(self, name: str, **args: Any) -> None:
        if self.on_event is not None:
            self.on_event(name, args)

    # ------------------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self.free)

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def _check_seq(self, seq_id: int) -> None:
        if seq_id not in self.tables:
            raise KeyError(
                f"seq {seq_id} not registered in KV pool (released twice, "
                "or used before register()?)")

    def _available(self) -> int:
        """Free blocks plus cache-held blocks the reclaimer could evict
        right now (an exact lower bound — see ``PrefixCache.reclaimable``)."""
        extra = self.reclaimer.reclaimable() if self.reclaimer else 0
        return len(self.free) + extra

    def _take_block(self) -> int:
        """Pop a free block, evicting one cached block first if needed.
        Callers must have checked ``_available()``."""
        if not self.free and self.reclaimer is not None:
            self.reclaimer.reclaim(1)
            self._event("reclaim", blocks=1)
        blk = self.free.pop()
        self.refs[blk] = 1
        self.stats.allocs += 1
        return blk

    def add_ref(self, blk: int) -> None:
        self.refs[blk] += 1
        if self.reclaimer is not None:
            self.reclaimer.note_block_ref(blk)

    def drop_ref(self, blk: int) -> None:
        self.refs[blk] -= 1
        if self.refs[blk] <= 0:
            del self.refs[blk]
            self.free.append(blk)
            self.stats.frees += 1
        if self.reclaimer is not None:
            self.reclaimer.note_block_ref(blk)

    def can_allocate(self, n_tokens: int) -> bool:
        """Would registering a fresh sequence of ``n_tokens`` succeed?
        (Admission gate: check *before* registering so a refusal leaves
        no table behind.)"""
        return self.blocks_for(n_tokens) <= self._available()

    def can_append(self, seq_id: int, n: int = 1) -> bool:
        self._check_seq(seq_id)
        needed = self.blocks_for(self.lengths[seq_id] + n)
        return needed - len(self.tables[seq_id]) <= self._available()

    def register(self, seq_id: int) -> None:
        assert seq_id not in self.tables, seq_id
        self.tables[seq_id] = []
        self.lengths[seq_id] = 0

    def release(self, seq_id: int) -> None:
        """Drop the sequence's hold on its pages (shared pages survive
        while other sequences or the prefix cache still reference them).
        Releasing an unknown/already-released seq raises ``KeyError``."""
        self._check_seq(seq_id)
        for blk in self.tables.pop(seq_id):
            self.drop_ref(blk)
        del self.lengths[seq_id]
        self._event("free", seq=seq_id, used=self.used_blocks)

    def append_tokens(self, seq_id: int, n: int = 1) -> List[int]:
        """Extend seq by n tokens, allocating pages on demand. Returns the
        (possibly empty) list of newly allocated physical blocks."""
        self._check_seq(seq_id)
        table = self.tables[seq_id]
        length = self.lengths[seq_id]
        needed = -(-(length + n) // self.block_size)
        n_new = needed - len(table)
        if n_new > self._available():
            # all-or-nothing: never leave a partially-extended table
            self.stats.oom_events += 1
            self._event("oom", seq=seq_id, need=n_new,
                        free=len(self.free))
            raise OutOfBlocksError(
                f"KV arena exhausted: need {n_new} blocks, "
                f"{len(self.free)} free of {self.n_blocks} × "
                f"{self.block_size} tokens")
        new = []
        for _ in range(n_new):
            blk = self._take_block()
            table.append(blk)
            new.append(blk)
        self.lengths[seq_id] = length + n
        self.stats.peak_used = max(self.stats.peak_used, self.used_blocks)
        if new:
            self._event("alloc", seq=seq_id, blocks=len(new),
                        used=self.used_blocks)
        return new

    def adopt_prefix(self, seq_id: int, shared: List[int], n_tokens: int,
                     cow_last: bool = False) -> Optional[Tuple[int, int]]:
        """Build a freshly registered (empty) sequence's table as shared
        prefix pages + newly allocated private suffix pages, in one
        atomic step — the prefix-aware admission path, which never holds
        private pages for the shared span (no transient footprint).

        All shared blocks are held (ref'd) *before* any allocation so
        on-demand reclaim cannot evict the pages being adopted; with
        ``cow_last`` the final shared block's hold is then swapped for a
        private copy-on-write page and ``(src, dst)`` returned for the
        device-side copy. Callers guarantee capacity via the admission
        gate ``can_allocate(n_tokens + 1)``: the +1 headroom block is
        exactly what the COW copy consumes when the prompt is
        block-aligned (the only case COW arises).
        """
        self._check_seq(seq_id)
        assert not self.tables[seq_id] and not self.lengths[seq_id], seq_id
        n_total = self.blocks_for(n_tokens)
        assert len(shared) <= n_total, (seq_id, shared, n_tokens)
        for blk in shared:
            self.add_ref(blk)
        table = list(shared)
        pair = None
        if cow_last:
            dst = self._take_block()
            table[-1] = dst
            pair = (shared[-1], dst)
            self.drop_ref(shared[-1])
        for _ in range(n_total - len(shared)):
            table.append(self._take_block())
        self.tables[seq_id] = table
        self.lengths[seq_id] = n_tokens
        self.stats.peak_used = max(self.stats.peak_used, self.used_blocks)
        self._event("adopt", seq=seq_id, shared=len(shared),
                    cow=pair is not None, used=self.used_blocks)
        if pair is not None:
            self._event("cow", seq=seq_id, src=pair[0], dst=pair[1])
        return pair

    def replace_prefix(self, seq_id: int, shared: List[int],
                       cow_last: bool = False) -> Optional[Tuple[int, int]]:
        """Splice cached prefix pages into a freshly admitted sequence.

        The sequence's first ``len(shared)`` table entries (private,
        just-allocated, never written) are released and replaced by the
        shared physical blocks (ref-counted holds). With ``cow_last`` the
        final shared block is **copied on write** instead of held: the
        sequence's prefill/decode will write inside it (a partial-block
        append onto a shared page), so a private copy is allocated and
        ``(src, dst)`` returned for the caller's device-side page copy.
        The preceding releases guarantee the copy allocation succeeds.
        """
        self._check_seq(seq_id)
        table = self.tables[seq_id]
        assert len(shared) <= len(table), (seq_id, shared, table)
        for old in table[:len(shared)]:
            self.drop_ref(old)
        hold = shared[:-1] if cow_last else shared
        for blk in hold:
            self.add_ref(blk)
        new_prefix = list(shared)
        pair = None
        if cow_last:
            dst = self._take_block()
            new_prefix[-1] = dst
            pair = (shared[-1], dst)
        self.tables[seq_id] = new_prefix + table[len(shared):]
        self._event("splice", seq=seq_id, shared=len(shared),
                    cow=pair is not None, used=self.used_blocks)
        if pair is not None:
            self._event("cow", seq=seq_id, src=pair[0], dst=pair[1])
        return pair

    def slot_of(self, seq_id: int, pos: int) -> Tuple[int, int]:
        """(physical block, offset) of token ``pos`` of sequence seq_id."""
        assert pos < self.lengths[seq_id]
        table = self.tables[seq_id]
        return table[pos // self.block_size], pos % self.block_size

    def block_table(self, seq_id: int, max_blocks: int) -> np.ndarray:
        """Padded physical-block table for device-side gathers (-1 pad)."""
        t = self.tables[seq_id]
        out = np.full(max_blocks, -1, np.int32)
        out[:len(t)] = t
        return out


# ---------------------------------------------------------------------------
# Device-side reference: gather a sequence's KV out of the paged arena
# ---------------------------------------------------------------------------


def write_kv(arena: np.ndarray, pool: PagedKVPool, seq_id: int, pos: int,
             value: np.ndarray) -> None:
    """arena: [n_blocks, block_size, ...]; writes token ``pos``'s KV."""
    blk, off = pool.slot_of(seq_id, pos)
    arena[blk, off] = value


def gather_kv(arena: np.ndarray, table: np.ndarray, length: int
              ) -> np.ndarray:
    """Reference paged read: [length, ...] contiguous KV for a sequence.

    table: padded block table (-1 pad); arena: [n_blocks, block_size, ...].
    """
    block_size = arena.shape[1]
    n = -(-length // block_size)
    pages = arena[table[:n]]                       # [n, block_size, ...]
    flat = pages.reshape(-1, *arena.shape[2:])
    return flat[:length]



# ---------------------------------------------------------------------------
# torch arena: block-table gather/scatter over the model cache
# ---------------------------------------------------------------------------
#
# The model's dense cache is a tree whose *attention nodes* are dicts
# {'k', 'v', 'pos'} with leaves shaped [ng, B, clen, ...] (layer-group
# stack leading, batch at axis 1, ring length clen at axis 2). The paged
# arena replaces each such node by {'k', 'v'} leaves shaped
# [ng, n_blocks + 1, block_size, ...] — one shared physical page pool per
# leaf, block ``n_blocks`` being the trash page — and drops 'pos'
# entirely: ring positions are a pure function of per-sequence lengths,
# so the view recomputes them. Non-attention leaves (the SSM slots' conv
# rings and recurrent states of mamba2 and zamba2) keep their dense
# per-slot [ng, B, ...] layout.
#
# Torch indexing wraps negative indices silently, so every block index
# is resolved to a real page (or the trash page) before it indexes.


class PagedMeta(NamedTuple):
    """Static description of a paged cache."""

    attn_paths: Tuple[Tuple[Tuple[str, ...], int], ...]  # ((path, clen), ...)
    block_size: int
    n_blocks: int          # real blocks; arena leaves carry n_blocks + 1
    # block-table width: covers logical positions up to max_len
    # *inclusive* — a prompt_len == max_len request's one decode write
    # lands at position max_len (the dense ring wraps; pages just extend)
    max_blocks: int

    @property
    def trash_block(self) -> int:
        return self.n_blocks


def _is_attn_node(node: Any) -> bool:
    return isinstance(node, dict) and "k" in node and "pos" in node


def attn_node_paths(cache: Dict) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
    """(path, clen) for every attention node in a dense cache template."""
    out: List[Tuple[Tuple[str, ...], int]] = []

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if _is_attn_node(node):
            out.append((path, node["k"].shape[-3]))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))

    walk(cache, ())
    return tuple(out)


def paged_meta(cache: Dict, n_blocks: int, block_size: int,
               max_len: int) -> PagedMeta:
    """``max_len``: longest logical position a sequence can reach
    (the engine's max_ctx; block tables are sized to hold position
    max_len itself — see ``PagedMeta.max_blocks``)."""
    max_blocks = -(-(max_len + 1) // block_size)
    return PagedMeta(attn_node_paths(cache), block_size, n_blocks,
                     max_blocks)


def _node_at(tree: Dict, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _replace_at(tree: Dict, path: Tuple[str, ...], value: Any) -> Dict:
    """Replace the subtree at ``path`` in a shallow copy of ``tree``."""
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _replace_at(tree[path[0]], path[1:], value)
    return out


def _int32(x: Any, device: Any = None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def build_arena(cache: Dict, meta: PagedMeta) -> Dict:
    """Dense cache template → paged cache: attention nodes become page
    arenas [ng, n_blocks + 1, block_size, ...] (zeroed; + trash block),
    everything else is kept as-is (per-slot dense state)."""
    out = cache
    for path, _clen in meta.attn_paths:
        node = _node_at(cache, path)
        arena_node = {}
        for key, leaf in node.items():
            if key == "pos":
                continue
            ng = leaf.shape[0]
            rest = leaf.shape[3:]
            arena_node[key] = torch.zeros(
                (ng, meta.n_blocks + 1, meta.block_size, *rest),
                dtype=leaf.dtype, device=leaf.device)
        out = _replace_at(out, path, arena_node)
    return out


def ring_view_positions(lengths: Any, clen: int) -> torch.Tensor:
    """[B, clen] logical position stored at each ring index, or -1.

    Reproduces the dense ring-buffer invariant: after writing positions
    0..L-1 with ``idx = pos % clen``, ring index c holds the *largest*
    p < L with p ≡ c (mod clen) — or nothing (-1) if no such p exists.
    """
    lengths = _int32(lengths)
    c = torch.arange(clen, dtype=torch.int32,
                     device=lengths.device)[None, :]       # [1, clen]
    last = lengths[:, None] - 1                            # [B, 1]
    base = torch.div(last, clen, rounding_mode="floor") * clen + c
    p = torch.where(base > last, base - clen, base)
    return torch.where((lengths[:, None] > 0) & (p >= 0), p, -1)


def dense_ring_positions(lengths: Any, prompt_lens: Any,
                         pad_lens: Any, clen: int) -> torch.Tensor:
    """[B, clen] position each dense ring index shows *mid-serving*.

    The dense engine's write history per sequence is NOT a prefix: the
    prefill bulk-write covers the padded bucket [0, bw) (right-pad rows
    overwrite earlier prompt entries whose ring index they share — those
    entries are then invalidated, not restored), and decode appends
    [L, cur) on top. Ring index c therefore shows:

    * the largest decode-written p ∈ [L, cur) with p ≡ c — decode wrote
      last, so it wins; else
    * the largest prefill-written p ∈ [0, bw) with p ≡ c, *valid only if
      p < L* (pad writes carry pos = -1); else
    * nothing (-1).

    The paged view must reproduce this exactly — deriving positions from
    ``cur`` alone would resurrect prompt entries the dense ring lost to
    pad overwrites (window-local layers with clen < bucket) and streams
    would diverge.
    """
    q = ring_view_positions(lengths, clen)                 # latest ≤ cur-1
    ppre = ring_view_positions(pad_lens, clen)             # prefill pattern
    lp = _int32(prompt_lens, q.device)[:, None]
    return torch.where(q >= lp, q,
                       torch.where((ppre >= 0) & (ppre < lp), ppre, -1))


def _page_coords(meta: PagedMeta, tables: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block, offset) int64 index tensors for logical ``positions`` (any
    shape with leading batch); invalid positions, -1 table entries and
    logical blocks past the table → trash block (the reference's
    ``take_along_axis`` fills those with a negative value, which its
    ``where`` sends to the trash block too)."""
    pc = positions.clamp_min(0)
    lblk = torch.div(pc, meta.block_size, rounding_mode="floor").long()
    inside = lblk < tables.shape[1]
    blk = torch.gather(tables, 1, lblk.clamp_max(tables.shape[1] - 1))
    ok = (positions >= 0) & inside & (blk >= 0)
    blk = torch.where(ok, blk, meta.trash_block)
    return blk.long(), (pc % meta.block_size).long()


def paged_view(arena_cache: Dict, tables: torch.Tensor, lengths: Any,
               prompt_lens: Any, pad_lens: Any,
               meta: PagedMeta,
               page_gather: Optional[Callable] = None) -> Dict:
    """Reconstruct the dense ring-cache view a decode step attends over.

    tables: [B, max_blocks] int32 physical block table per row (-1 padded;
    all -1 for inactive rows); lengths: [B] tokens written so far (cur);
    prompt_lens/pad_lens: [B] real prompt length and padded prefill
    bucket (see ``dense_ring_positions`` — the dense ring is a function
    of all three). The returned tree has exactly the dense cache's
    shapes/dtypes: values bit-identical at every valid ring index, 'pos'
    recomputed (invalid indices carry -1, so downstream masks see the
    dense layout). With ``page_gather`` (``kernels/ops.paged_gather``)
    the page fetch runs through the kernel and the ring select picks
    within contiguous pages, zeroing invalid ring indices; without it,
    invalid indices read the trash page. Both routes agree at every
    valid (unmasked) ring index. The view is a fresh tree: the decode
    step writes it in place without touching the arena.
    """
    out = arena_cache
    for path, clen in meta.attn_paths:
        node = _node_at(arena_cache, path)
        p = dense_ring_positions(lengths, prompt_lens, pad_lens, clen)
        view: Dict[str, Any] = {}
        if page_gather is None:
            blk, off = _page_coords(meta, tables, p)
            for key, leaf in node.items():
                view[key] = leaf[:, blk, off]              # [ng, B, clen, ...]
        else:
            # the ring select as one indexing gather: row b of the
            # contiguous pages, ring index c -> page-run index pc[b, c]
            pc = p.clamp_min(0).long()
            rows = torch.arange(p.shape[0], device=p.device)[:, None]
            invalid = p < 0
            for key, leaf in node.items():
                pages = page_gather(leaf, tables)  # [ng, B, MB*bs, ...]
                got = pages[:, rows, pc]           # [ng, B, clen, ...]
                mask = invalid.reshape(1, *invalid.shape,
                                       *(1,) * (got.dim() - 3))
                view[key] = got.masked_fill_(mask, 0)
        ng = node["k"].shape[0]
        # materialised (not an expanded view): the decode step writes it
        view["pos"] = p[None].expand(ng, *p.shape).contiguous()
        out = _replace_at(out, path, view)
    return out


def scatter_prefill(arena_cache: Dict, mini_cache: Dict,
                    tables: torch.Tensor, lengths: Any, pad_lens: Any,
                    slot_idx: torch.Tensor, meta: PagedMeta) -> Dict:
    """Land a batched-prefill group's fresh cache into the paged cache,
    in place; returns ``arena_cache``.

    Attention nodes: the mini cache's ring was bulk-written with the
    *padded* positions [0, bw), so ring index c holds position
    ``ring_view_positions(bw)[c]``; entries that are real prompt tokens
    (p < length) scatter to their pages, pad entries (and -1 table rows)
    land in the trash block — the page arena holds exactly what the
    dense ring kept. Positions are distinct per row and rows own
    disjoint blocks, so writes never collide outside the trash page;
    replica rows from power-of-two group padding share a table and
    rewrite identical data (an ordinary indexed write, never an
    accumulate). Non-attention leaves keep the dense per-slot scatter at
    ``slot_idx``.
    """
    attn = dict(meta.attn_paths)
    lengths_b = _int32(lengths, tables.device)[:, None]

    def walk(anode: Any, mnode: Any, path: Tuple[str, ...]) -> None:
        if path in attn:
            clen = attn[path]
            p = ring_view_positions(_int32(pad_lens, tables.device), clen)
            p = torch.where(p < lengths_b, p, -1)          # pads → trash
            blk, off = _page_coords(meta, tables, p)
            for key, leaf in anode.items():
                leaf[:, blk, off] = mnode[key].to(leaf.dtype)
        elif isinstance(anode, dict):
            for k in anode:
                walk(anode[k], mnode[k], path + (k,))
        else:
            # dense per-slot leaf: batch at axis 1, same duplicate-row
            # semantics
            anode[:, slot_idx.long()] = mnode.to(anode.dtype)

    walk(arena_cache, mini_cache, ())
    return arena_cache


def prefix_unsupported_reason(cache: Dict, max_ctx: int) -> Optional[str]:
    """Why prefix sharing cannot be bit-exact for this cache template
    (None when it can).

    Sharing splices *per-position* KV pages between sequences, so it
    needs every cache node to (a) be a plain attention ring of full
    ``max_ctx`` length — window-local rings lose positions to
    pad-overwrites that depend on the donor's prefill bucket — (b) store
    unquantized values — int8 pages re-quantize on write, so a suffix
    attending over dequantized prefix KV would diverge from the cold
    full prefill — and (c) carry no per-sequence recurrent state (SSM
    conv/state, cross-attention K/V), which has no per-position pages to
    share.
    """
    reasons: List[str] = []

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        name = "/".join(path) or "<root>"
        if _is_attn_node(node):
            if path and path[0] == "shared":
                # weight-tied shared-attention block: forward_stack's
                # prefix plumbing covers plain attention slots only
                reasons.append(f"weight-tied shared-attention ring at "
                               f"{name}")
            if node["k"].shape[-3] < max_ctx:
                reasons.append(
                    f"window-local ring at {name} (clen "
                    f"{node['k'].shape[-3]} < max_ctx {max_ctx})")
            if "k_scale" in node:
                reasons.append(f"int8-quantized KV cache at {name}")
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            reasons.append(f"per-sequence recurrent state at {name}")

    walk(cache, ())
    return reasons[0] if reasons else None


def gather_prefix(arena_cache: Dict, tables: torch.Tensor, prefix_len: int,
                  meta: PagedMeta) -> Dict:
    """Gather positions [0, prefix_len) of every attention node out of
    the page arena: a tree mirroring the cache structure whose leaves are
    [ng, B, prefix_len, ...]. ``prefix_len`` is a Python int. Callers
    guarantee every gathered position was written by a donor prefill
    (prefix matching is block-aligned and capped below the donor's prompt
    length), so no validity mask is needed — exactly the dense positions
    a cold prefill would attend to.
    """
    b = tables.shape[0]
    pos = torch.arange(prefix_len, dtype=torch.int32,
                       device=tables.device)[None, :].expand(b, prefix_len)
    blk, off = _page_coords(meta, tables, pos)
    out: Dict[str, Any] = {}
    for path, _clen in meta.attn_paths:
        node = _node_at(arena_cache, path)
        sub = {key: leaf[:, blk, off] for key, leaf in node.items()}
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = sub
    return out


def scatter_suffix(arena_cache: Dict, mini_cache: Dict,
                   tables: torch.Tensor, lengths: Any, prefix_len: int,
                   suffix_len: int, meta: PagedMeta) -> Dict:
    """Land a suffix prefill's fresh KV into the paged cache, in place;
    returns ``arena_cache``.

    The mini cache's ring was bulk-written at positions
    [prefix_len, prefix_len + suffix_len) (``cache_fill`` with offset
    positions; prefix sharing is gated to clen == max_ctx ≥ bucket, so
    ring index == position, no wrap). Entries that are real prompt
    tokens (p < length) scatter to their pages; pad entries — and the
    replica rows of power-of-two group padding, which share tables and
    rewrite identical data — land in the trash block. Prefix-shared
    configs have no non-attention leaves (see
    ``prefix_unsupported_reason``), so only attention nodes move.
    """
    lengths_b = _int32(lengths, tables.device)[:, None]
    positions = prefix_len + torch.arange(suffix_len, dtype=torch.int32,
                                          device=tables.device)
    for path, clen in meta.attn_paths:
        anode = _node_at(arena_cache, path)
        mnode = _node_at(mini_cache, path)
        p = torch.where(positions[None, :] < lengths_b,
                        positions[None, :], -1)             # [B, sfx]
        blk, off = _page_coords(meta, tables, p)
        idx = (positions % clen).long()
        for key, leaf in anode.items():
            mini = mnode[key][:, :, idx]                    # [ng, B, sfx, ...]
            leaf[:, blk, off] = mini.to(leaf.dtype)
    return arena_cache


def copy_block(arena_cache: Dict, src: int, dst: int,
               meta: PagedMeta) -> Dict:
    """Copy-on-write page copy, in place: physical block ``src`` → ``dst``
    on every attention leaf. Returns ``arena_cache``."""
    for path, _clen in meta.attn_paths:
        node = _node_at(arena_cache, path)
        for leaf in node.values():
            leaf[:, int(dst)] = leaf[:, int(src)]
    return arena_cache


def scatter_decode(arena_cache: Dict, view_cache: Dict,
                   tables: torch.Tensor, pos: Any,
                   meta: PagedMeta) -> Dict:
    """Persist one decode step, in place; returns ``arena_cache``. Each
    row's freshly written ring entry (index ``pos % clen`` — where
    ``cache_update`` just wrote it) moves from the view into its page;
    non-attention leaves (recurrent state) are replaced wholesale.
    Inactive rows (-1 tables) hit the trash block, matching the dense
    engine exactly."""
    attn = dict(meta.attn_paths)
    pos = _int32(pos, tables.device)
    rows = torch.arange(pos.shape[0], device=pos.device)

    def walk(anode: Any, vnode: Any, path: Tuple[str, ...]) -> None:
        if path in attn:
            clen = attn[path]
            blk, off = _page_coords(meta, tables, pos[:, None])
            blk, off = blk[:, 0], off[:, 0]                # [B]
            ridx = (pos % clen).long()
            for key, leaf in anode.items():
                written = vnode[key][:, rows, ridx]        # [ng, B, ...]
                leaf[:, blk, off] = written.to(leaf.dtype)
        elif isinstance(anode, dict):
            for k in anode:
                walk(anode[k], vnode[k], path + (k,))
        else:
            anode.copy_(vnode.to(anode.dtype))

    walk(arena_cache, view_cache, ())
    return arena_cache
