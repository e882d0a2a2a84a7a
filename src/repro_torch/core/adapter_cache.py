"""Heterogeneous memory management (paper §3.3 / §4.2).

Two cooperating structures, exactly as in the paper:

* **Memory cache** — an LRU map adapter_id → pool slot. Frequently used
  adapters stay resident; when full, the least-recently-used adapter is
  evicted and its block returns to the pool.
* **Pre-allocated memory pool** — ``max_resident`` fixed-size blocks
  reserved at init (the paper's ``std::stack<std::shared_ptr<adapter>>``).
  A block here is a *slot index* into the stacked device tensors
  ``A_stack[R, ...]`` (see ``core/lora.py``): loading an adapter is an
  in-place ``dynamic_update_index_in_dim`` — no allocation, no recompile.

The device-side write is delegated to a callable so this module stays pure
bookkeeping (unit-testable without jax); the engine wires it to
``load_adapter_into_slot``.

Swap-in cost model — the host→HBM **transfer channel**: every pool miss
starts a ``load_seconds``-long transfer (``adapter_bytes /
disk_bandwidth``; the paper's disk→RAM swap). Transfers *serialize* on
one channel: a load requested while another is in flight queues behind
it, so its ``ready_time`` is ``max(now, channel_free_at) +
load_seconds``. ``acquire`` returns a :class:`Reservation` carrying that
``ready_time`` instead of mutating engine state through ``load_fn`` —
the synchronous engine stalls the clock to ``ready_time`` (one explicit
charge per load), while the asynchronous engine parks the slot in
LOADING and keeps every other slot decoding until the transfer lands.

In-flight loads live in ``loading`` (adapter_id → ready_time) *and* in
``resident`` (their pool block is committed and the device write already
issued). Pinning protects resident and loading adapters alike; evicting
an unpinned in-flight load cancels it (the channel time is not refunded
— the bytes were already on the wire). ``prefetch`` starts the same
transfer speculatively for a queued request, but only into a free block
or over a victim outside the caller's ``protect`` set, so warming the
pool can never evict a pinned or hotter (sooner-needed) adapter.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    loads: int = 0
    # async swap-in accounting: speculative transfers issued, how many
    # were later demanded (hit) vs evicted unused (waste), and in-flight
    # transfers cancelled by eviction before their ready_time
    prefetch_issued: int = 0
    prefetch_hits: int = 0
    prefetch_waste: int = 0
    cancelled_loads: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PoolExhaustedError(RuntimeError):
    """Every resident adapter is pinned by an in-flight request — no pool
    block can be evicted. Callers (the engine) defer and retry; kept a
    RuntimeError subclass for backwards compatibility."""


@dataclass
class Reservation:
    """One ``acquire``/``prefetch`` outcome.

    ``ready_time`` is the sim time the adapter becomes usable (== the
    request time for a resident hit); ``load_cost`` is the seconds a
    synchronous caller must charge to its clock (transfer + channel
    queueing; 0.0 on a hit). Iterating yields ``(slot, loaded)`` for
    backwards compatibility with the pre-reservation API.
    """
    adapter_id: int
    slot: int
    loaded: bool       # this call started a swap-in
    ready_time: float
    load_cost: float

    def __iter__(self) -> Iterator:
        yield self.slot
        yield self.loaded


class AdapterMemoryManager:
    """LRU cache over a fixed pool of adapter slots.

    policy: 'lru' (paper default) or 'lfu' (paper §4.2 notes LFU can win
    under strong locality — both provided, benchmarked in the locality
    ablation).

    ``load_seconds`` is the per-adapter host→HBM transfer time (the
    engine passes ``adapter_bytes / disk_bandwidth``); 0.0 keeps every
    ``ready_time`` at the request time (bookkeeping-only mode, the unit
    tests' default).
    """

    def __init__(self, max_resident: int,
                 load_fn: Optional[Callable[[int, int], None]] = None,
                 policy: str = "lru", load_seconds: float = 0.0) -> None:
        assert policy in ("lru", "lfu")
        self.max_resident = max_resident
        self.policy = policy
        self.load_fn = load_fn or (lambda adapter_id, slot: None)
        self.load_seconds = float(load_seconds)
        # pool of free blocks (paper: std::stack of pre-allocated blocks)
        self.free_slots: List[int] = list(range(max_resident))[::-1]
        # adapter_id -> slot; ordered for LRU recency
        self.resident: "collections.OrderedDict[int, int]" = collections.OrderedDict()
        self.use_counts: Dict[int, int] = collections.defaultdict(int)
        self.pinned: Dict[int, int] = collections.defaultdict(int)
        # in-flight transfers: adapter_id -> ready_time. The pool block
        # is committed (the adapter is in `resident` too); the adapter is
        # just not *usable* until ready_time.
        self.loading: Dict[int, float] = {}
        self.channel_free_at = 0.0
        # prefetched-but-never-demanded adapters (hit/waste accounting)
        self._prefetched: set = set()
        self.stats = CacheStats()
        # optional observer: callable(name, now, args) — the engine
        # wires serving/trace.py's channel hook here during a traced
        # serve(); None (default) costs one condition per event site
        self.on_event: Optional[Callable[[str, float, Dict], None]] = None

    def _event(self, name: str, now: float, **args: Any) -> None:
        if self.on_event is not None:
            self.on_event(name, now, args)

    # -- queries ---------------------------------------------------------

    def __contains__(self, adapter_id: int) -> bool:
        return adapter_id in self.resident

    def slot_of(self, adapter_id: int) -> Optional[int]:
        return self.resident.get(adapter_id)

    @property
    def n_resident(self) -> int:
        return len(self.resident)

    def is_loading(self, adapter_id: int) -> bool:
        return adapter_id in self.loading

    def reset_channel(self) -> None:
        """Start a new timeline (the engine calls this when serve()
        resets its clock to 0): transfers from the previous run are
        considered landed and the channel is idle — without this, a
        stale ``channel_free_at`` would charge phantom queueing from the
        last run onto the first loads of the next."""
        self.loading.clear()
        self.channel_free_at = 0.0

    def ready_time(self, adapter_id: int, now: float = 0.0) -> float:
        """When ``adapter_id`` becomes usable (``now`` if not in flight)."""
        return max(now, self.loading.get(adapter_id, now))

    # -- pinning (adapters in use by an active slot must not evict) ------

    def pin(self, adapter_id: int) -> None:
        self.pinned[adapter_id] += 1

    def unpin(self, adapter_id: int) -> None:
        if adapter_id not in self.pinned:
            return  # unmatched unpin must not underflow into a negative pin
        self.pinned[adapter_id] -= 1
        if self.pinned[adapter_id] <= 0:
            del self.pinned[adapter_id]

    # -- core operations --------------------------------------------------

    def acquire(self, adapter_id: int, now: float = 0.0) -> Reservation:
        """Ensure ``adapter_id`` is resident (or in flight); returns a
        :class:`Reservation`.

        A miss commits a pool block, issues the device write, and books
        the transfer on the channel — the caller charges ``load_cost``
        (sync) or waits on ``ready_time`` (async). Raises
        PoolExhaustedError, state untouched, when every block is pinned.
        """
        self._expire(now)
        if adapter_id in self.resident:
            self.stats.hits += 1
            if adapter_id in self._prefetched:
                # the speculation paid off: a demand acquire found the
                # adapter resident or already on the wire
                self._prefetched.discard(adapter_id)
                self.stats.prefetch_hits += 1
            self._touch(adapter_id)
            return Reservation(adapter_id, self.resident[adapter_id],
                               False, self.ready_time(adapter_id, now), 0.0)
        if not self.free_slots:
            victim = self._pick_victim()
            if victim is None:
                # no miss counted: the engine defers and retries, and a
                # retry storm must not skew the hit-rate stats
                raise PoolExhaustedError(
                    "adapter pool exhausted: all resident adapters pinned")
            self._evict(victim, now)
        self.stats.misses += 1
        slot = self.free_slots.pop()
        ready = self._start_load(adapter_id, slot, now)
        self._touch(adapter_id)
        self._event("load", now, adapter=adapter_id, slot=slot,
                    ready=ready, load_seconds=self.load_seconds)
        return Reservation(adapter_id, slot, True, ready, ready - now)

    def prefetch(self, adapter_id: int, now: float = 0.0,
                 protect: Iterable[int] = ()) -> Optional[Reservation]:
        """Speculatively start ``adapter_id``'s swap-in for a queued
        request. Returns None (no-op) when it is already resident/in
        flight, or when warming it would require evicting a pinned
        adapter or one in ``protect`` (a hotter upcoming need). Does not
        touch recency/frequency state — speculation must not distort the
        demand-driven eviction order — and counts neither hit nor miss.
        """
        self._expire(now)
        if adapter_id in self.resident:
            return None
        if not self.free_slots:
            victim = self._pick_victim(exclude=protect)
            if victim is None:
                return None
            self._evict(victim, now)
        slot = self.free_slots.pop()
        ready = self._start_load(adapter_id, slot, now)
        self._prefetched.add(adapter_id)
        self.stats.prefetch_issued += 1
        self._event("prefetch", now, adapter=adapter_id, slot=slot,
                    ready=ready, load_seconds=self.load_seconds)
        return Reservation(adapter_id, slot, True, ready, ready - now)

    def prefill_random(self, adapter_ids: List[int]) -> None:
        """Paper §4.2: the cache is prefilled with adapters at server
        init. Deduplicates preserving first-occurrence order *before*
        capping at ``max_resident`` (truncating first under-filled the
        pool on duplicate ids). Server-start warmup is free: no channel
        time is booked."""
        unique: List[int] = []
        seen: set = set()
        for a in adapter_ids:
            if a not in seen:
                seen.add(a)
                unique.append(a)
        for a in unique[: self.max_resident]:
            if a not in self.resident and self.free_slots:
                slot = self.free_slots.pop()
                self.load_fn(a, slot)
                self.stats.loads += 1
                self.resident[a] = slot

    # -- internals --------------------------------------------------------

    def _expire(self, now: float) -> None:
        """Retire transfers whose ready_time has passed."""
        for aid in [a for a, t in self.loading.items() if t <= now]:
            del self.loading[aid]

    def _start_load(self, adapter_id: int, slot: int, now: float) -> float:
        """Issue the device write and book the transfer on the channel;
        returns the ready_time."""
        self.load_fn(adapter_id, slot)
        self.stats.loads += 1
        self.resident[adapter_id] = slot
        if self.load_seconds <= 0.0:
            return now
        ready = max(now, self.channel_free_at) + self.load_seconds
        self.channel_free_at = ready
        self.loading[adapter_id] = ready
        return ready

    def _evict(self, victim: int, now: float = 0.0) -> None:
        slot = self.resident.pop(victim)
        self.free_slots.append(slot)
        self.stats.evictions += 1
        cancelled = victim in self.loading
        if cancelled:
            # in-flight load cancelled; channel time is not refunded
            del self.loading[victim]
            self.stats.cancelled_loads += 1
        if victim in self._prefetched:
            self._prefetched.discard(victim)
            self.stats.prefetch_waste += 1
        self._event("cancel" if cancelled else "evict", now,
                    adapter=victim, slot=slot)

    def _touch(self, adapter_id: int) -> None:
        self.use_counts[adapter_id] += 1
        if self.policy == "lru":
            self.resident.move_to_end(adapter_id)

    def _pick_victim(self, exclude: Iterable[int] = ()) -> Optional[int]:
        exclude = set(exclude)
        if self.policy == "lru":
            for aid in self.resident:  # oldest first
                if aid not in self.pinned and aid not in exclude:
                    return aid
            return None
        # lfu
        best, best_count = None, None
        for aid in self.resident:
            if aid in self.pinned or aid in exclude:
                continue
            c = self.use_counts[aid]
            if best_count is None or c < best_count:
                best, best_count = aid, c
        return best
