"""EdgeLoRA serving engine: continuous batching across heterogeneous
adapters (paper §3/§4), ported from ``repro.serving.engine``.

A host-side **Server Manager** (slot state machine, adaptive adapter
selection, heterogeneous memory manager) drives a **Computing Backend**
(the model's prefill/decode steps on the engine's device):

* **SELECTING**: forward-costing routers are scored in one batched call
  per prompt bucket; scores are cached on the slot, so pool-exhausted
  deferral retries never re-score.
* **PREFILL** (gather→batch→scatter): PREFILL slots are grouped by
  prompt bucket, each group runs one ``[B, bucket]`` prefill with per-row
  lengths and adapter pool slots, and the fresh KV lands in the global
  cache in one indexed write (``_write_slots``).
* **GENERATE**: one decode step batches *all* slots whatever adapter
  each uses — Batch LoRA Inference — through ``LoRAMode('batched')``.

Groups are padded to power-of-two occupancy by replicating a real row,
whose duplicate cache write is identical. The virtual clock advances by
*measured* step times, keyed by ``(kind, bucket, B)``; each key's first
call runs once uncharged to warm up (``_timed``). Adapter swap-in is
asynchronous: a pool miss books a transfer on the manager's serialized
channel and the slot waits in LOADING while the other slots run, with a
queue-ahead prefetcher warming the pool for waiting requests.

This slice ports the ``edgelora`` and ``edgelora_no_aas`` policies on the
dense KV cache. The ``llamacpp`` and ``dlora`` policies, the paged KV
arena, the prefix cache, chunked prefill and tracing raise
``NotImplementedError`` at engine init (later slices, see ROADMAP.md).
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_cache import (AdapterMemoryManager,
                                            PoolExhaustedError)
from repro_torch.core.lora import LoRAMode, resolve_lora_backend
from repro_torch.core.router import OracleRouter, select_adapter
from repro_torch.core.slots import Request, Slot, SlotManager, SlotState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.serving.metrics import ServingSummary, summarize


@dataclass
class EngineConfig:
    """Field for field the reference's ``EngineConfig`` (same defaults);
    see ``repro.serving.engine.EngineConfig`` for each knob. Knobs of
    features outside this slice must stay at their off values."""

    n_slots: int = 8
    top_k: int = 3
    policy: str = "edgelora"
    max_ctx: int = 512
    prompt_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    lora_backend: Optional[str] = None
    prefill_batching: bool = True
    router_batching: bool = True
    kv_backend: Optional[str] = None
    kv_block_size: int = 16
    kv_arena_blocks: Optional[int] = None
    kv_gather_kernel: Optional[bool] = None
    prefix_cache: bool = False
    async_swap: bool = True
    prefetch_depth: int = 4
    disk_bandwidth: float = 1.0e9
    mem_bandwidth: float = 60.0e9
    memory_budget: float = 6.0e9
    dlora_window: int = 8
    dlora_merge_uniques: int = 2
    cache_policy: str = "lru"
    prefill_chunk: Optional[int] = None
    admission_control: bool = True
    slo_seconds: float = 6.0
    router_accuracy: float = 0.95
    time_scale: float = 1.0
    seed: int = 0


_PORTED_POLICIES = ("edgelora", "edgelora_no_aas")


def _check_slice(cfg: ModelConfig, ecfg: EngineConfig, tracer: Any) -> str:
    """Raise for engine features outside this slice; returns the KV
    backend ('dense')."""
    if ecfg.policy not in _PORTED_POLICIES:
        if ecfg.policy in ("llamacpp", "dlora"):
            raise NotImplementedError(
                f"policy {ecfg.policy!r} is not yet ported to repro_torch "
                "(slice: remaining engine features and policies)")
        raise ValueError(f"unknown policy {ecfg.policy!r}")
    kv_backend = ecfg.kv_backend or cfg.kv_backend
    if kv_backend == "paged":
        raise NotImplementedError(
            "kv_backend='paged' is not yet ported to repro_torch (slice: "
            "paged KV with kvpool.py and the paged_gather_pages kernel)")
    if kv_backend != "dense":
        raise ValueError(f"unknown kv_backend {kv_backend!r} "
                         "(expected 'dense' or 'paged')")
    unported = {"prefix_cache": ecfg.prefix_cache,
                "prefill_chunk": ecfg.prefill_chunk is not None,
                "tracer": tracer is not None}
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"{name} is not yet ported to repro_torch (slice: "
                "remaining engine features and policies)")
    return kv_backend


class EdgeLoRAEngine:
    """``adapter_source(adapter_id)`` returns one adapter as the LoRA tree
    of ``Model.init_lora(generator)`` (leaves ``[ng, r, d]``); the default
    draws it on the engine's device. ``timer`` supplies ``perf_counter``
    to ``_timed`` (default: the ``time`` module)."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 router: Any = None, params: Any = None,
                 tracer: Any = None, *, device: DeviceLike = "cuda",
                 adapter_source: Optional[Callable[[int], Any]] = None,
                 timer: Any = None) -> None:
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.kv_backend = _check_slice(cfg, engine_cfg, tracer)
        self.device = resolve_device(device)
        # concrete batched-LoRA backend ('einsum' | 'sgmv')
        self.lora_backend = resolve_lora_backend(
            engine_cfg.lora_backend or cfg.lora_backend, self.device)
        self._timer = timer if timer is not None else time
        # buckets cover max_ctx so no prompt that fits the KV capacity is
        # ever silently truncated by _padded_prompt
        self._buckets = tuple(sorted(
            {min(b, engine_cfg.max_ctx) for b in engine_cfg.prompt_buckets
             if b > 0} | {engine_cfg.max_ctx}))
        self.model = build_model(cfg, self.device)
        if params is None:
            self.params = self.model.init(self._generator(engine_cfg.seed))
        else:
            self.params = self.model.load_params(params)
        self.n_pool = cfg.lora.max_resident
        self.lora_pool = self.model.init_lora(
            self._generator(engine_cfg.seed + 1), n_slots=self.n_pool)
        self.adapter_source = adapter_source or self._adapter_host
        self.adapter_bytes = cfg.lora_adapter_bytes()
        self.router = router or OracleRouter(
            cfg.lora.n_adapters, accuracy=engine_cfg.router_accuracy,
            seed=engine_cfg.seed)
        self.manager = AdapterMemoryManager(
            self.n_pool, load_fn=self._load_adapter,
            policy=engine_cfg.cache_policy,
            load_seconds=self.adapter_bytes / engine_cfg.disk_bandwidth)
        self.slots = SlotManager(engine_cfg.n_slots)
        self._build_steps()
        self._durations: Dict[Any, float] = {}
        self.busy_time = 0.0
        # init prefill is free (server start): books no channel time
        self.manager.prefill_random(list(range(
            min(cfg.lora.n_adapters, self.n_pool))))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    # device-side adapter pool (heterogeneous memory manager, device face)
    # ------------------------------------------------------------------

    _LEAD_AXIS = {"layers": 1}

    def _adapter_host(self, adapter_id: int) -> Any:
        """'Disk' fetch: adapters are deterministic functions of their id
        (stand-in for checkpoint files), drawn on the engine's device
        with the reference's distribution (A ~ N(0, 1/r), B = 0)."""
        return self.model.init_lora(self._generator(10_000 + adapter_id))

    def _load_adapter(self, adapter_id: int, slot: int) -> None:
        """Device-side pool write, in place (``pool[:, slot].copy_``). The
        transfer's cost is booked by the manager, not here."""
        adapter = self.adapter_source(adapter_id)

        def write(pool: Any, item: Any, ax: int) -> None:
            if isinstance(pool, dict):
                for k, sub in pool.items():
                    write(sub, item[k], ax)
            else:
                pool.select(ax, slot).copy_(item)

        for key, sub in self.lora_pool.items():
            write(sub, adapter[key], self._LEAD_AXIS[key])

    # ------------------------------------------------------------------
    # compute steps
    # ------------------------------------------------------------------

    def _build_steps(self) -> None:
        model, scale, backend = self.model, self.cfg.lora.scale, \
            self.lora_backend

        @torch.no_grad()
        def prefill_fn(params: Any, pool: Any, tokens: Any, cache1: Any,
                       slot_id: Any, length: Any) -> Any:
            mode = LoRAMode("batched", slot_id, scale, backend)
            logits, cache1 = model.prefill(params, {"tokens": tokens},
                                           cache1, pool, mode,
                                           lengths=length)
            return torch.argmax(logits, -1).to(torch.int32), cache1

        @torch.no_grad()
        def decode_fn(params: Any, pool: Any, tokens: Any, cache: Any,
                      pos: Any, slot_ids: Any) -> Any:
            mode = LoRAMode("batched", slot_ids, scale, backend)
            logits, cache = model.decode_step(params, tokens, cache, pos,
                                              pool, mode)
            return torch.argmax(logits, -1).to(torch.int32), cache

        self._prefill = prefill_fn
        self._decode = decode_fn
        self.cache = self.model.init_cache(self.ecfg.n_slots,
                                           self.ecfg.max_ctx)

    def _write_slots(self, gcache: Any, bcache: Any,
                     slot_idx: torch.Tensor) -> Any:
        """Land all B fresh KV slices at their slot indices in one indexed
        write per leaf (batch is axis 1 of every leaf). Duplicate indices
        (power-of-two padding rows) carry identical data."""
        for key, g in gcache.items():
            if isinstance(g, dict):
                self._write_slots(g, bcache[key], slot_idx)
            else:
                g[:, slot_idx] = bcache[key].to(g.dtype)
        return gcache

    def _fresh_cache(self, batch: int) -> Any:
        """Zeroed prefill cache for one batch group."""
        return self.model.init_cache(batch, self.ecfg.max_ctx)

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest bucket "
            f"{self._buckets[-1]} (max_ctx={self.ecfg.max_ctx})")

    def _slot_prompt(self, slot: Slot) -> np.ndarray:
        """Bucket + right-pad the slot's prompt once (host copy)."""
        if slot.padded_prompt is None:
            slot.bucket = self._bucket(slot.request.prompt_len)
            slot.padded_prompt = self._padded_prompt(slot.request,
                                                     slot.bucket)
        return slot.padded_prompt

    def _pad_group(self, group: List[Slot]) -> List[Slot]:
        """Pad a batch group to power-of-two occupancy (capped at
        n_slots) by replicating its first slot."""
        k = len(group)
        padded = min(1 << (k - 1).bit_length(), self.ecfg.n_slots)
        return group + [group[0]] * (padded - k)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, key: Tuple, fn: Callable, *args: Any,
               now: Optional[float] = None,
               requests: Optional[List[Request]] = None
               ) -> Tuple[Any, float]:
        """Run fn; charge its measured duration. The first call per key
        warms up and is *not* charged: fn runs twice, so every step is a
        pure function of its inputs (repeated in-place cache writes store
        the same values). The ``perf_counter`` calls are the reference's,
        in the same order."""
        del now, requests  # tracing hooks of the reference (not ported)
        if key not in self._durations:
            out = fn(*args)  # warm-up (uncharged)
            self._sync()
            t0 = self._timer.perf_counter()
            out = fn(*args)
            self._sync()
            self._durations[key] = self._timer.perf_counter() - t0
        else:
            t0 = self._timer.perf_counter()
            out = fn(*args)
            self._sync()
            self._durations[key] = 0.5 * self._durations[key] + 0.5 * (
                self._timer.perf_counter() - t0)
        dt = self._durations[key] * self.ecfg.time_scale
        self.busy_time += dt
        return out, dt

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------

    def serve(self, trace: List[Request],
              max_sim_time: Optional[float] = None) -> ServingSummary:
        ecfg = self.ecfg
        for r in trace:
            if r.prompt_len > ecfg.max_ctx:
                raise ValueError(
                    f"request {r.request_id}: prompt_len {r.prompt_len} "
                    f"exceeds max_ctx {ecfg.max_ctx}; truncate the prompt "
                    f"explicitly or raise max_ctx")
        now = 0.0
        queue = sorted(trace, key=lambda r: r.arrival_time)
        completed: List[Request] = []
        rejected: List[Request] = []
        self.prefill_steps = 0
        self.decode_steps = 0
        self.router_steps = 0
        self.prefill_batch_hist: Dict[int, int] = {}
        # admission: a priority heap of (priority, class, seq, request);
        # class 0 would be requeued (preempted) work, which only the
        # paged backend produces
        self._queue = queue
        self._qi = 0
        self._ready: List[Tuple[int, int, int, Request]] = []
        self._push_seq = 0
        self._admit_counter = 0
        self._ttft_ewma: Dict[int, float] = {}
        self._step_hist: Dict[str, int] = {}
        self.max_step_seconds = 0.0
        self.peak_active_slots = 0
        self.load_stall_seconds = 0.0
        self._serve_loads0 = self.manager.stats.loads
        self.manager.reset_channel()

        def arrivals_ready() -> bool:
            self._ingest(now)
            return bool(self._ready)

        while len(completed) + len(rejected) < len(queue):
            if max_sim_time is not None and now > max_sim_time:
                break
            progressed = False
            busy0 = self.busy_time

            # ---- admission -------------------------------------------
            idle = self.slots.idle()
            while idle and arrivals_ready():
                req = self._ready[0][3]
                if ecfg.admission_control and req.ttft_slo is not None \
                        and self._reject_expired(req, now, rejected):
                    progressed = True
                    continue
                heapq.heappop(self._ready)
                slot = idle.pop()
                slot.assign(req)
                req.admit_time = now
                slot.admit_seq = self._admit_counter
                self._admit_counter += 1
                progressed = True
            self.peak_active_slots = max(
                self.peak_active_slots,
                sum(s.state != SlotState.IDLE for s in self.slots.slots))

            # ---- adapter selection (Algorithm 1) ---------------------
            if (ecfg.router_batching and ecfg.policy != "edgelora_no_aas"
                    and getattr(self.router, "costs_forward", False)):
                unscored = [
                    s for s in self.slots.in_state(SlotState.SELECTING)
                    if s.sel_scores is None and s.request.adapter_id is None]
                score_groups: Dict[int, List[Slot]] = {}
                for slot in unscored:
                    self._slot_prompt(slot)
                    score_groups.setdefault(slot.bucket, []).append(slot)
                for b, group in score_groups.items():
                    rows = self._pad_group(group)
                    toks = self._to_device(
                        np.stack([s.padded_prompt for s in rows]))
                    sb, dt = self._timed(("router", b, len(rows)),
                                         self.router.scores_batch, toks)
                    now += dt
                    self.router_steps += 1
                    sb = np.asarray(sb)
                    for i, slot in enumerate(group):
                        slot.sel_scores = sb[i]
            for slot in self.slots.in_state(SlotState.SELECTING):
                req = slot.request
                slot.merged = False
                if ecfg.policy == "edgelora_no_aas" \
                        or req.adapter_id is not None:
                    req.selected_adapter = (req.adapter_id
                                            if req.adapter_id is not None
                                            else req.true_adapter)
                else:
                    scores = slot.sel_scores
                    if scores is None:
                        if getattr(self.router, "costs_forward", False):
                            toks = self._to_device(
                                self._slot_prompt(slot)[None, :])
                            sb, dt = self._timed(("router", slot.bucket, 1),
                                                 self.router.scores_batch,
                                                 toks)
                            now += dt
                            self.router_steps += 1
                            scores = np.asarray(sb)[0]
                        else:
                            scores = np.asarray(self.router.scores(req))
                        slot.sel_scores = scores
                    aid, _ = select_adapter(scores, self.manager,
                                            ecfg.top_k)
                    req.selected_adapter = aid
                try:
                    res = self.manager.acquire(req.selected_adapter,
                                               now=now)
                except PoolExhaustedError:
                    # every pool block is pinned by an in-flight request:
                    # stay SELECTING and retry after a completion unpins
                    continue
                slot.sel_scores = None
                now = self._finish_acquire(slot, res, now)
                progressed = True

            # ---- async swap-in: transfers that have landed ------------
            if ecfg.async_swap:
                for slot in self.slots.in_state(SlotState.LOADING):
                    if slot.ready_time <= now:
                        slot.state = SlotState.PREFILL
                        progressed = True
                if ecfg.prefetch_depth > 0:
                    self._run_prefetch(now)

            # ---- prefill (gather→batch→scatter) ----------------------
            prefilling = self.slots.in_state(SlotState.PREFILL)
            if prefilling:
                groups: Dict[Tuple[int, bool, int], List[Slot]] = {}
                for slot in prefilling:
                    self._slot_prompt(slot)
                    groups.setdefault(
                        (slot.bucket, slot.merged, slot.prefix_len),
                        []).append(slot)
                work: List[Tuple[int, List[Slot]]] = []
                for (b, _merged, _pfx), group in groups.items():
                    if ecfg.prefill_batching:
                        work.append((b, group))
                    else:  # pre-batching baseline: one B=1 call per slot
                        work.extend((b, [s]) for s in group)
                for b, group in work:
                    now += self._prefill_group(b, group, now)
                progressed = True

            # ---- batched decode (Batch LoRA Inference) ----------------
            gen = self.slots.in_state(SlotState.GENERATE)
            if gen:
                # idle rows run too: token 0, pos 0, pool slot 0 — they
                # write ring index 0 of idle slots, as in the reference
                tokens = np.zeros((ecfg.n_slots,), np.int32)
                pos = np.zeros((ecfg.n_slots,), np.int32)
                sids = np.zeros((ecfg.n_slots,), np.int32)
                for slot in gen:
                    tokens[slot.index] = slot.last_token
                    pos[slot.index] = slot.pos
                    sids[slot.index] = slot.adapter_slot
                (next_toks, self.cache), dt = self._timed(
                    ("decode",), self._decode, self.params, self.lora_pool,
                    self._to_device(tokens), self.cache,
                    self._to_device(pos), self._to_device(sids))
                now += dt
                self.decode_steps += 1
                next_np = next_toks.cpu().numpy()
                for slot in gen:
                    req = slot.request
                    slot.last_token = int(next_np[slot.index])
                    slot.pos += 1
                    req.generated += 1
                    req.tokens.append(slot.last_token)
                    if req.generated >= req.output_len \
                            or slot.pos >= ecfg.max_ctx - 1:
                        req.finish_time = now
                        self.manager.unpin(req.selected_adapter)
                        completed.append(slot.release())
                progressed = True

            # ---- per-iteration step time (compute charged this tick) --
            step_busy = self.busy_time - busy0
            if step_busy > 0.0:
                self._note_step(step_busy)

            # ---- idle / load-blocked: jump to the earliest event ------
            if not progressed:
                loading = self.slots.in_state(SlotState.LOADING)
                if loading:
                    wake = min(s.ready_time for s in loading)
                    if not self._ready and self._qi < len(queue):
                        arr = max(now, queue[self._qi].arrival_time)
                        if now < arr < wake:
                            now = arr  # an arrival may unblock admission
                            continue
                    self.load_stall_seconds += max(0.0, wake - now)
                    now = max(now, wake)
                elif self._ready:
                    continue
                elif self._qi < len(queue):
                    now = max(now, queue[self._qi].arrival_time)
                else:
                    break

        duration = max(now, 1e-9)
        mst = self.manager.stats
        total_load = ((mst.loads - self._serve_loads0)
                      * self.manager.load_seconds)
        swap_stats = {
            "mode": "async" if ecfg.async_swap else "sync",
            "load_seconds_total": total_load,
            "load_stall_seconds": self.load_stall_seconds,
            "overlapped_load_seconds": max(
                0.0, total_load - self.load_stall_seconds),
            "prefetch_issued": mst.prefetch_issued,
            "prefetch_hits": mst.prefetch_hits,
            "prefetch_waste": mst.prefetch_waste,
            "cancelled_loads": mst.cancelled_loads,
        }
        return summarize(queue, duration, ecfg.slo_seconds,
                         cache_stats=self.manager.stats,
                         energy_proxy=self.busy_time / duration,
                         step_stats={
                             "prefill_steps": self.prefill_steps,
                             "decode_steps": self.decode_steps,
                             "router_steps": self.router_steps,
                             "prefill_batch_hist": dict(
                                 self.prefill_batch_hist),
                             "peak_active_slots": self.peak_active_slots,
                             "kv_stats": None,
                             "prefix_stats": None,
                             "swap_stats": swap_stats,
                             "step_time_hist":
                                 dict(self._step_hist) or None,
                             "max_step_seconds":
                                 (self.max_step_seconds
                                  if self._step_hist else None),
                             "latency_breakdown": None,
                         })

    # ------------------------------------------------------------------
    # priority admission, SLO shedding, step-time accounting
    # ------------------------------------------------------------------

    def _push_ready(self, req: Request, requeued: bool = False) -> None:
        heapq.heappush(self._ready, (req.priority, 0 if requeued else 1,
                                     self._push_seq, req))
        self._push_seq += 1

    def _ingest(self, now: float) -> None:
        """Move every arrival the clock has passed into the ready heap."""
        q = self._queue
        while self._qi < len(q) and q[self._qi].arrival_time <= now:
            self._push_ready(q[self._qi])
            self._qi += 1

    def _reject_expired(self, req: Request, now: float,
                        rejected: List[Request]) -> bool:
        """Admission control at the heap head: 'timeout' when the TTFT
        deadline already passed, 'shed' when wait + the per-bucket EWMA
        of admit→first-token times exceeds it (no estimate: never shed).
        Returns True if the request was popped and recorded."""
        wait = now - req.arrival_time
        if wait >= req.ttft_slo:
            why = "timeout"
        else:
            est = self._ttft_ewma.get(self._bucket(req.prompt_len))
            if est is None or wait + est <= req.ttft_slo:
                return False
            why = "shed"
        heapq.heappop(self._ready)
        req.rejected = why
        req.reject_time = now
        rejected.append(req)
        return True

    def _note_ttft(self, bucket: int, req: Request, t_first: float) -> None:
        if req.admit_time is None:
            return
        obs = max(0.0, t_first - req.admit_time)
        prev = self._ttft_ewma.get(bucket)
        self._ttft_ewma[bucket] = (obs if prev is None
                                   else 0.5 * prev + 0.5 * obs)

    def _note_step(self, dt: float) -> None:
        """Bin one scheduler iteration's charged compute seconds into the
        power-of-two-millisecond step histogram."""
        self.max_step_seconds = max(self.max_step_seconds, dt)
        ms = dt * 1e3
        if ms <= 0.125:
            key = "le_0.125ms"
        else:
            exp = min(14, math.ceil(math.log2(ms)))
            key = f"le_{2.0 ** exp:g}ms"
        self._step_hist[key] = self._step_hist.get(key, 0) + 1

    def _prefill_group(self, bucket: int, group: List[Slot],
                       now: float) -> float:
        """One batched prefill over ``group`` (same bucket, mixed
        adapters); all fresh KV slices land in the global cache in one
        indexed write. Returns the time charged for the group."""
        rows = self._pad_group(group)
        lengths = self._to_device(np.fromiter(
            (s.request.prompt_len for s in rows), np.int32, count=len(rows)))
        cacheb = self._fresh_cache(len(rows))
        toks = self._to_device(np.stack([s.padded_prompt for s in rows]))
        sids = self._to_device(np.fromiter(
            (s.adapter_slot for s in rows), np.int32, count=len(rows)))
        (first, cacheb), dt = self._timed(
            ("prefill", bucket, len(rows)), self._prefill, self.params,
            self.lora_pool, toks, cacheb, sids, lengths)
        slot_idx = self._to_device(np.fromiter(
            (s.index for s in rows), np.int64, count=len(rows)))
        self.cache = self._write_slots(self.cache, cacheb, slot_idx)
        self.prefill_steps += 1
        self.prefill_batch_hist[len(group)] = \
            self.prefill_batch_hist.get(len(group), 0) + 1
        first_np = first.cpu().numpy()
        for i, slot in enumerate(group):
            req = slot.request
            slot.pos = req.prompt_len
            slot.last_token = int(first_np[i])
            req.first_token_time = now + dt
            req.generated = 1
            req.tokens = [slot.last_token]
            slot.state = SlotState.GENERATE
            self._note_ttft(slot.bucket, req, now + dt)
        return dt

    def _padded_prompt(self, req: Request, bucket: int) -> np.ndarray:
        toks = np.zeros((bucket,), np.int32)
        n = min(req.prompt_len, bucket)
        toks[:n] = np.asarray(req.prompt_tokens)[:n]  # right-padded
        return toks

    # ------------------------------------------------------------------
    # adapter swap-in (reservation routing, queue-ahead prefetch)
    # ------------------------------------------------------------------

    def _finish_acquire(self, slot: Slot, res: Any, now: float) -> float:
        """Pin the reserved adapter and route the slot by swap mode:
        async parks it in LOADING until the transfer's ready_time; sync
        stalls the clock to ready_time. Returns the (possibly advanced)
        clock."""
        self.manager.pin(res.adapter_id)
        slot.adapter_slot = res.slot
        if self.ecfg.async_swap:
            if res.ready_time > now:
                slot.ready_time = res.ready_time
                slot.state = SlotState.LOADING
            else:
                slot.state = SlotState.PREFILL
            return now
        if res.ready_time > now:
            self.load_stall_seconds += res.ready_time - now
            now = res.ready_time
        slot.state = SlotState.PREFILL
        return now

    def _known_adapter(self, req: Request) -> Optional[int]:
        """The pool adapter a waiting request will demand, when already
        determined (None: AAS picks at SELECTING)."""
        if req.adapter_id is not None:
            return req.adapter_id
        if self.ecfg.policy == "edgelora_no_aas":
            return req.true_adapter
        return None

    def _predicted_adapter(self, req: Request) -> Optional[int]:
        """Known adapter, or a cheap AAS prediction: a bookkeeping-only
        router scores a waiting request for free, so run the cache-aware
        selection it will make on admission; a forward-costing router
        reuses only a preempted request's previous selection. None: not
        predictable, or already resident."""
        aid = self._known_adapter(req)
        if aid is not None:
            return aid
        if self.ecfg.policy != "edgelora":
            return None
        if not getattr(self.router, "costs_forward", False):
            if req.sel_scores is None:  # once per request, not per tick
                req.sel_scores = np.asarray(self.router.scores(req))
            aid, cached = select_adapter(req.sel_scores, self.manager,
                                         self.ecfg.top_k)
            return None if cached else aid
        return req.prefetch_hint

    def _run_prefetch(self, now: float) -> None:
        """Queue-ahead prefetch: start swap-ins for the ready heap's
        upcoming demand (admission order), bounded by ``prefetch_depth``;
        the lookahead window is the manager's protect set, and the
        channel is never booked more than a window ahead of the clock."""
        ecfg = self.ecfg
        self._ingest(now)
        targets: List[int] = []
        waiting = [e[3] for e in heapq.nsmallest(
            4 * ecfg.prefetch_depth, self._ready)]
        for r in waiting:
            aid = self._predicted_adapter(r)
            if aid is not None:
                targets.append(aid)
        seen: set = set()
        todo: List[int] = []
        for aid in targets:
            if aid not in seen:
                seen.add(aid)
                todo.append(aid)
        todo = todo[:ecfg.prefetch_depth]
        protect = set(todo)
        horizon = now + ecfg.prefetch_depth * self.manager.load_seconds
        for aid in todo:
            if self.manager.channel_free_at > horizon:
                break
            self.manager.prefetch(aid, now=now, protect=protect)
