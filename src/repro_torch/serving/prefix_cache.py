"""Shared-prefix radix KV cache: ref-counted copy-on-write pages over the
paged arena (``serving/kvpool.py``).

A copy of ``repro.serving.prefix_cache`` (numpy only), kept line for line
so both packages index, match and reclaim identically
(``tests/test_torch_kvpool.py`` holds them together).

EdgeLoRA's multi-tenant setting replays the same per-tenant system
prompt on every request — each adapter's traffic shares a long common
prefix that a cold engine re-prefills from scratch and stores once per
sequence. S-LoRA's unified paging shows page-granular KV sharing is the
memory lever at high tenancy; vLLM-style prefix caching is the latency
lever. This module is the index that turns the paged arena into both:

* A **radix tree over token blocks**: each edge is one ``block_size``
  token chunk (keyed by its exact bytes — collision-free), each node
  pins one physical page of the arena. A path from the root spells a
  block-aligned prompt prefix and the pages holding its KV.
* Trees are **keyed by execution identity** ``(merged, adapter_id)``:
  KV at depth > 0 depends on the residual stream, which depends on the
  request's adapter (and on merged- vs unmerged-LoRA execution), so
  pages are shared only between requests that would compute bit-equal
  prefixes. This is exactly the paper's per-tenant system-prompt
  setting — tenant = adapter.
* Nodes hold one pool ref each (``PagedKVPool.add_ref``). Pages whose
  only remaining ref is the cache's form an **LRU reclaim pool**: the
  pool counts them as available capacity and evicts leaf-first, oldest
  first, *before* the engine's deferral/LIFO-preemption machinery ever
  observes an exhausted arena.

The engine (``serving/engine.py``) drives the lifecycle: ``match`` at
adapter-selection time (splice + suffix-only prefill), ``insert`` after
each prefill lands (cold or warm), and ``reclaim`` implicitly through
pool allocation. Copy-on-write (``PagedKVPool.replace_prefix``) covers
the one case where a sequence appends inside a shared page: a fully
block-aligned whole-prompt match, where the last prompt token is
re-prefilled (first-token logits need it) into a private copy.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np


@dataclass
class PrefixStats:
    lookups: int = 0
    hit_requests: int = 0
    # prompt tokens served from cached pages (block-aligned match width)
    hit_tokens: int = 0
    # prompt tokens whose prefill compute was skipped (suffix-only
    # prefill width saving; == hit_tokens minus COW'd re-done tokens)
    saved_prefill_tokens: int = 0
    cow_copies: int = 0
    # cache-held pages evicted back to the free list under pressure
    reclaimed_blocks: int = 0
    inserted_blocks: int = 0
    cached_blocks: int = 0
    peak_cached_blocks: int = 0

    def as_dict(self) -> Dict[str, int]:
        return asdict(self)


class _Node:
    __slots__ = ("key", "parent", "children", "block", "last_used")

    def __init__(self, key: Optional[bytes], parent: Optional["_Node"],
                 block: int) -> None:
        self.key = key
        self.parent = parent
        self.children: Dict[bytes, _Node] = {}
        self.block = block
        self.last_used = 0


class PrefixCache:
    """Radix index over token-block hashes → physical arena pages."""

    def __init__(self, pool: Any, block_size: int) -> None:
        self.pool = pool
        # self-wire as the pool's reclaimer: the memoized reclaimable()
        # below is only correct if every cached-page refcount change
        # reaches note_block_ref
        pool.reclaimer = self
        self.block_size = block_size
        # execution identity -> radix root (roots carry no block)
        self.roots: Dict[Hashable, _Node] = {}
        self.nodes: Dict[int, _Node] = {}  # physical block -> node
        self.stats = PrefixStats()
        self._tick = 0
        # memoized reclaimable() (the pool queries it on the per-token
        # can_append path): recomputed only after an event that can
        # change evictability — insert, evict, or a refcount change on a
        # cached block (pool.add_ref/drop_ref call note_block_ref).
        # Decode-time private-page churn never dirties it.
        self._reclaimable_dirty = True
        self._reclaimable_memo = 0

    # -- radix walk ------------------------------------------------------

    def _block_keys(self, tokens: Any) -> List[bytes]:
        toks = np.asarray(tokens, dtype=np.int32)
        bs = self.block_size
        return [toks[i * bs:(i + 1) * bs].tobytes()
                for i in range(len(toks) // bs)]

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    def match(self, exec_key: Hashable, tokens: Any) -> List[int]:
        """Physical pages of the longest cached block-aligned prefix of
        ``tokens`` under ``exec_key`` (empty on a miss). Touches the
        matched path (LRU recency)."""
        self.stats.lookups += 1
        node = self.roots.get(exec_key)
        blocks: List[int] = []
        if node is None:
            return blocks
        for key in self._block_keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            blocks.append(child.block)
            node = child
        return blocks

    def insert(self, exec_key: Hashable, tokens: Any,
               table: List[int]) -> int:
        """Index every full block of a freshly prefilled prompt: block i
        of ``tokens`` is served by physical page ``table[i]``. Existing
        nodes are kept (first writer is canonical — identical content);
        new nodes take one pool ref on their page. Returns #new nodes."""
        root = self.roots.setdefault(exec_key, _Node(None, None, -1))
        node = root
        created = 0
        for i, key in enumerate(self._block_keys(tokens)):
            child = node.children.get(key)
            if child is None:
                blk = table[i]
                child = _Node(key, node, blk)
                node.children[key] = child
                self.nodes[blk] = child
                self.pool.add_ref(blk)
                self._reclaimable_dirty = True
                created += 1
            self._touch(child)
            node = child
        self.stats.inserted_blocks += created
        self.stats.cached_blocks = len(self.nodes)
        self.stats.peak_cached_blocks = max(self.stats.peak_cached_blocks,
                                            len(self.nodes))
        return created

    # -- LRU reclaim (the pool's capacity extension) --------------------

    def _cache_only(self, node: _Node) -> bool:
        return self.pool.refs.get(node.block, 0) == 1

    def note_block_ref(self, blk: int) -> None:
        """Pool callback on any add_ref/drop_ref: a refcount change on a
        *cached* page can flip its (and its ancestors') evictability."""
        if blk in self.nodes:
            self._reclaimable_dirty = True

    def reclaimable(self) -> int:
        """Exact number of pages ``reclaim`` could free right now: nodes
        whose page is held only by the cache AND whose whole subtree is —
        eviction is leaf-first, so an inner node shadowed by a live
        descendant cannot be freed yet. Memoized: the recursive walk
        reruns only after insert/evict/cached-ref changes, so the pool's
        per-token capacity checks stay O(1)."""
        if not self._reclaimable_dirty:
            return self._reclaimable_memo

        def walk(node: _Node) -> Tuple[int, bool]:
            count, all_ok = 0, True
            for c in node.children.values():
                c_count, c_ok = walk(c)
                count += c_count
                all_ok = all_ok and c_ok
            ok = all_ok and self._cache_only(node)
            return count + (1 if ok else 0), ok

        total = 0
        for root in self.roots.values():
            for c in root.children.values():
                total += walk(c)[0]
        self._reclaimable_memo = total
        self._reclaimable_dirty = False
        return total

    def reclaim(self, k: int) -> int:
        """Evict up to ``k`` LRU cache-only leaves (freeing their pages);
        evicting a leaf may expose its parent for the next round."""
        freed = 0
        while freed < k:
            victim: Optional[_Node] = None
            for node in self.nodes.values():
                if node.children or not self._cache_only(node):
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._evict(victim)
            freed += 1
        self.stats.reclaimed_blocks += freed
        return freed

    def _evict(self, node: _Node) -> None:
        del node.parent.children[node.key]
        del self.nodes[node.block]
        self.pool.drop_ref(node.block)
        self._reclaimable_dirty = True
        self.stats.cached_blocks = len(self.nodes)

    # -- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    def summary(self) -> Dict[str, Any]:
        return {"enabled": 1, **self.stats.as_dict()}
