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

KV memory (``kv_backend``): 'dense' keeps a ``max_ctx`` ring per slot;
'paged' shares one ``serving/kvpool.py`` page arena across the slots
through per-sequence block tables. A paged decode step rebuilds the
dense ring view from the tables (``Model.decode_step_paged``; on a GPU
the page fetch runs through the ``paged_gather_pages`` CUDA kernel),
so token streams equal the dense backend's; an exhausted arena defers
admissions and LIFO-preempts the youngest slot (restart-recompute).
On the arena, ``prefix_cache`` splices the cached pages of a matching
block-aligned prompt prefix (``serving/prefix_cache.py``, keyed by
execution identity, copy-on-write on a whole-prompt match) and prefills
only the suffix; ``prefill_chunk`` bounds every prefill call to that
many prompt tokens on either backend, interleaving chunks with decode
steps. Both run through the same suffix-prefill steps.

Scheduler policies, all four of the reference's, on every KV feature
above:

* ``edgelora``          — adaptive adapter selection on
* ``edgelora_no_aas``   — adapters pinned by the request
* ``llamacpp``          — baseline: every adapter preloaded (checked
  against ``memory_budget``: ``OutOfMemoryError``), one active adapter
  at a time, merged into W; a switch drains the batch and charges the
  unmerge and merge at ``mem_bandwidth``
* ``dlora``             — switches between MERGED execution (the hot
  adapter folded into W, same-adapter batching only) and UNMERGED
  batched execution, driven by the adapter diversity of the upcoming
  queue (``dlora_window``, ``dlora_merge_uniques``)

A merged step runs the base model with no LoRA at all (the adapter is
taken to be folded into W): no SGMV kernel runs, the attention kernels
and the page gather do.

Tracing is opt-in (``tracer=``, ``serving/trace.py``): every site guards
on ``tracer is not None``, so an untraced engine runs exactly as if the
hooks were absent, and a traced one adds no device sync and no host read
of device data. Events, names and virtual timestamps are the
reference's.
"""
from __future__ import annotations

import functools
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
from repro_torch.kernels.ops import paged_gather
from repro_torch.models import build_model
from repro_torch.models.model import require_token_batches
from repro_torch.serving import kvpool as kvlib
from repro_torch.serving.kvpool import PagedKVPool
from repro_torch.serving.metrics import ServingSummary, summarize
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.trace import (EngineTracer, JitRecompileError,
                                       jit_cache_report)


class OutOfMemoryError(RuntimeError):
    """Adapter working set exceeds the device memory budget (the paper's
    OOM cells in Tables 4-6)."""


@dataclass
class EngineConfig:
    """Field for field the reference's ``EngineConfig`` (same defaults);
    see ``repro.serving.engine.EngineConfig`` for each knob.
    ``kv_gather_kernel=None`` routes the paged page fetch through the
    ``paged_gather_pages`` kernel when the engine runs on CUDA (the
    reference: only on a real TPU). ``attn_kernel`` is the port's own
    knob (the reference model never calls its attention kernels):
    ``None`` runs every prefill and decode step's attention through the
    ``flash_prefill`` / ``flash_decode`` kernels on CUDA and the plain
    code on the CPU; ``True`` on the CPU routes through the kernel
    wrappers, which run their plain versions; ``False`` runs plain
    attention."""

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
    attn_kernel: Optional[bool] = None
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


POLICIES = ("edgelora", "edgelora_no_aas", "llamacpp", "dlora")


def _check_engine_config(cfg: ModelConfig, ecfg: EngineConfig) -> str:
    """Validate the policy and the KV backend; returns the KV backend
    ('dense' or 'paged'). An encoder-decoder config is refused: the
    engine's prompts are tokens alone. Model features outside the ported
    slices raise in ``models.model.check_supported``."""
    require_token_batches(
        cfg, "the serving engine",
        "src/repro/serving/engine.py:337 calls model.prefill(params, "
        "{'tokens': tokens}, ...)")
    if ecfg.policy not in POLICIES:
        raise ValueError(f"unknown policy {ecfg.policy!r} (expected one "
                         f"of {', '.join(POLICIES)})")
    kv_backend = ecfg.kv_backend or cfg.kv_backend
    if kv_backend not in ("dense", "paged"):
        raise ValueError(f"unknown kv_backend {kv_backend!r} "
                         "(expected 'dense' or 'paged')")
    return kv_backend


class EdgeLoRAEngine:
    """``adapter_source(adapter_id)`` returns one adapter as the LoRA tree
    of ``Model.init_lora(generator)`` (leaves ``[ng, r, d]``); the default
    draws it on the engine's device. ``timer`` supplies ``perf_counter``
    to ``_timed`` (default: the ``time`` module). ``tracer`` (an
    ``EngineTracer``, one per serve) records the run."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 router: Any = None, params: Any = None,
                 tracer: Optional[EngineTracer] = None, *,
                 device: DeviceLike = "cuda",
                 adapter_source: Optional[Callable[[int], Any]] = None,
                 timer: Any = None) -> None:
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.tracer = tracer
        self.kv_backend = _check_engine_config(cfg, engine_cfg)
        self.paged = self.kv_backend == "paged"
        self.adapter_bytes = cfg.lora_adapter_bytes()
        if engine_cfg.policy == "llamacpp":
            # checked before anything is allocated on the device
            total = cfg.lora.n_adapters * self.adapter_bytes
            if total > engine_cfg.memory_budget:
                raise OutOfMemoryError(
                    f"llama.cpp preloads all adapters: "
                    f"{cfg.lora.n_adapters} × {self.adapter_bytes/1e6:.2f}MB "
                    f"= {total/1e6:.2f}MB > budget "
                    f"{engine_cfg.memory_budget/1e6:.2f}MB")
        self.device = resolve_device(device)
        # concrete batched-LoRA backend ('einsum' | 'sgmv')
        self.lora_backend = resolve_lora_backend(
            engine_cfg.lora_backend or cfg.lora_backend, self.device)
        self._timer = timer if timer is not None else time  # el: allow[clock] -- _timed's default
        # buckets cover max_ctx so no prompt that fits the KV capacity is
        # ever silently truncated by _padded_prompt
        self._buckets = tuple(sorted(
            {min(b, engine_cfg.max_ctx) for b in engine_cfg.prompt_buckets
             if b > 0} | {engine_cfg.max_ctx}))
        attn_kernel = engine_cfg.attn_kernel
        if attn_kernel is None:  # only where the kernels run: CUDA
            attn_kernel = self.device.type == "cuda"
        self.attn_kernel = bool(attn_kernel)
        self.model = build_model(cfg, self.device,
                                 attn_kernel=self.attn_kernel)
        if params is None:
            self.params = self.model.init(self._generator(engine_cfg.seed))
        else:
            self.params = self.model.load_params(params)
        self.n_pool = cfg.lora.max_resident
        self.lora_pool = self.model.init_lora(
            self._generator(engine_cfg.seed + 1), n_slots=self.n_pool)
        self.adapter_source = adapter_source or self._adapter_host
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

    # the pool axis of each LoRA subtree: behind the group axis under
    # 'layers', leading under zamba2's unstacked 'shared_attn'
    _LEAD_AXIS = {"layers": 1, "shared_attn": 0}

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
        model, cfg, ecfg = self.model, self.cfg, self.ecfg
        scale, backend = cfg.lora.scale, self.lora_backend
        self.prefix_enabled = False
        self.prefix_cache: Optional[PrefixCache] = None
        self.kv_gather_kernel = False
        chunk = ecfg.prefill_chunk
        if chunk is not None and chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 (or None to "
                             f"disable), got {chunk}")
        self.chunked = chunk is not None

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

        # merged-execution variants (llamacpp, dlora merged): the adapter
        # is taken to be folded into W, so the step runs no LoRA at all
        @torch.no_grad()
        def prefill_merged(params: Any, tokens: Any, cache1: Any,
                           length: Any) -> Any:
            logits, cache1 = model.prefill(params, {"tokens": tokens},
                                           cache1, lengths=length)
            return torch.argmax(logits, -1).to(torch.int32), cache1

        @torch.no_grad()
        def decode_merged(params: Any, tokens: Any, cache: Any,
                          pos: Any) -> Any:
            logits, cache = model.decode_step(params, tokens, cache, pos)
            return torch.argmax(logits, -1).to(torch.int32), cache

        self._prefill = prefill_fn
        self._decode = decode_fn
        self._prefill_merged = prefill_merged
        self._decode_merged = decode_merged
        template = self.model.init_cache(ecfg.n_slots, ecfg.max_ctx)
        if not self.paged:
            if ecfg.prefix_cache:
                raise ValueError(
                    "prefix_cache=True requires kv_backend='paged' — the "
                    "shared pages live in the block arena")
            self.cache = template
            if not self.chunked:
                return
            # chunked prefill shares the suffix-over-cached-prefix cache
            # contract with the prefix cache, so the same gate applies
            reason = kvlib.prefix_unsupported_reason(self.cache,
                                                     ecfg.max_ctx)
            if reason is not None:
                raise ValueError(
                    f"prefill_chunk unsupported for {cfg.name}: {reason}")

            @torch.no_grad()
            def prefill_sfx_dense_fn(params: Any, pool: Any, tokens: Any,
                                     cache1: Any, gcache: Any, slot_idx: Any,
                                     sids: Any, length: Any, *,
                                     prefix_len: int) -> Any:
                mode = LoRAMode("batched", sids, scale, backend)
                logits, cache1 = model.prefill_suffix_dense(
                    params, tokens, cache1, gcache, slot_idx, length,
                    prefix_len, pool, mode)
                return torch.argmax(logits, -1).to(torch.int32), cache1

            @torch.no_grad()
            def prefill_sfx_dense_merged_fn(params: Any, tokens: Any,
                                            cache1: Any, gcache: Any,
                                            slot_idx: Any, length: Any, *,
                                            prefix_len: int) -> Any:
                logits, cache1 = model.prefill_suffix_dense(
                    params, tokens, cache1, gcache, slot_idx, length,
                    prefix_len)
                return torch.argmax(logits, -1).to(torch.int32), cache1

            self._prefill_sfx_dense = prefill_sfx_dense_fn
            self._prefill_sfx_dense_merged = prefill_sfx_dense_merged_fn
            return

        # ---- paged KV: shared page arena + per-sequence block tables --
        bs = ecfg.kv_block_size
        per_seq = -(-(ecfg.max_ctx + 1) // bs)  # worst-case one-seq pages
        n_blocks = (ecfg.kv_arena_blocks if ecfg.kv_arena_blocks
                    else ecfg.n_slots * per_seq)
        if n_blocks < per_seq:
            raise ValueError(
                f"kv_arena_blocks={n_blocks} cannot hold one max_ctx="
                f"{ecfg.max_ctx} sequence ({per_seq} blocks of {bs}): "
                "a lone request could never complete")
        meta = kvlib.paged_meta(template, n_blocks, bs, ecfg.max_ctx)
        self._kv_meta = meta
        self.kvpool = PagedKVPool(n_blocks, bs)
        self.cache = kvlib.build_arena(template, meta)
        use_kernel = ecfg.kv_gather_kernel
        if use_kernel is None:  # only where the kernel runs: CUDA
            use_kernel = self.device.type == "cuda"
        self.kv_gather_kernel = bool(use_kernel)
        page_gather = (functools.partial(paged_gather, use_kernel=True)
                       if use_kernel else None)

        @torch.no_grad()
        def paged_decode_fn(params: Any, pool: Any, tokens: Any, cache: Any,
                            tables: Any, lengths: Any, prompt_lens: Any,
                            pad_lens: Any, pos: Any, slot_ids: Any) -> Any:
            mode = LoRAMode("batched", slot_ids, scale, backend)
            logits, cache = model.decode_step_paged(
                params, tokens, cache, tables, lengths, prompt_lens,
                pad_lens, pos, pool, mode,
                meta=meta, page_gather=page_gather)
            return torch.argmax(logits, -1).to(torch.int32), cache

        @torch.no_grad()
        def paged_decode_merged(params: Any, tokens: Any, cache: Any,
                                tables: Any, lengths: Any, prompt_lens: Any,
                                pad_lens: Any, pos: Any) -> Any:
            logits, cache = model.decode_step_paged(
                params, tokens, cache, tables, lengths, prompt_lens,
                pad_lens, pos, meta=meta, page_gather=page_gather)
            return torch.argmax(logits, -1).to(torch.int32), cache

        self._decode_paged = paged_decode_fn
        self._decode_merged_paged = paged_decode_merged

        # ---- shared-prefix radix cache over the arena -----------------
        # (its suffix-prefill step doubles as chunked prefill's backbone,
        # so it is built whenever either feature is on)
        self.prefix_enabled = bool(ecfg.prefix_cache)
        if not (self.prefix_enabled or self.chunked):
            return
        reason = kvlib.prefix_unsupported_reason(template, ecfg.max_ctx)
        if reason is not None:
            feature = ("prefix_cache" if self.prefix_enabled
                       else "prefill_chunk")
            raise ValueError(
                f"{feature} unsupported for {cfg.name}: {reason}")
        if self.prefix_enabled:
            # PrefixCache wires itself in as the pool's reclaimer
            self.prefix_cache = PrefixCache(self.kvpool, bs)

        @torch.no_grad()
        def prefill_suffix_fn(params: Any, pool: Any, tokens: Any,
                              cache1: Any, arena: Any, tables: Any,
                              slot_id: Any, length: Any, *,
                              prefix_len: int) -> Any:
            mode = LoRAMode("batched", slot_id, scale, backend)
            logits, cache1 = model.prefill_suffix(
                params, tokens, cache1, arena, tables, length, prefix_len,
                pool, mode, meta=meta)
            return torch.argmax(logits, -1).to(torch.int32), cache1

        @torch.no_grad()
        def prefill_suffix_merged_fn(params: Any, tokens: Any, cache1: Any,
                                     arena: Any, tables: Any, length: Any,
                                     *, prefix_len: int) -> Any:
            logits, cache1 = model.prefill_suffix(
                params, tokens, cache1, arena, tables, length, prefix_len,
                meta=meta)
            return torch.argmax(logits, -1).to(torch.int32), cache1

        self._prefill_suffix = prefill_suffix_fn
        self._prefill_suffix_merged = prefill_suffix_merged_fn

    def _dense_scatter_suffix(self, gcache: Any, bcache: Any,
                              slot_idx: torch.Tensor, lengths: Any, *,
                              prefix_len: int, suffix_len: int) -> Any:
        """Land mini-ring positions [prefix_len, prefix_len + sfx) in the
        global per-slot rings, in place (ring index == position: chunking
        is gated to full-length rings). K/V copy unconditionally; the pos
        leaf marks right-pad columns past each row's real prompt -1, as
        ``_invalidate_past`` does for a whole-bucket prefill. Duplicate
        slot rows (power-of-two padding) write identical data."""
        dev = slot_idx.device
        positions = prefix_len + torch.arange(suffix_len, dtype=torch.int32,
                                              device=dev)
        lb = torch.as_tensor(lengths, dtype=torch.int32,
                             device=dev)[:, None]
        valid = torch.where(positions[None, :] < lb, positions[None, :],
                            -1)                              # [B, sfx]
        sl = slice(prefix_len, prefix_len + suffix_len)
        rows = slot_idx.long()

        def walk(gnode: Any, bnode: Any) -> None:
            if isinstance(gnode, dict) and "k" in gnode and "pos" in gnode:
                for key, gleaf in gnode.items():
                    if key == "pos":
                        gleaf[:, rows, sl] = valid.to(gleaf.dtype)
                    else:
                        gleaf[:, rows, sl] = bnode[key][:, :, sl].to(
                            gleaf.dtype)
                return
            for k in gnode:
                walk(gnode[k], bnode[k])

        walk(gcache, bcache)
        return gcache

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
            torch.cuda.synchronize(self.device)  # el: allow[host-sync] -- _timed measures

    def _recurrent_leaves(self, args: Tuple) -> List[torch.Tensor]:
        """The engine cache's per-slot recurrent state (the leaves of its
        nodes that hold no K/V: SSM conv rings and states) when ``args``
        hands the cache to a step, else nothing."""
        if not any(a is self.cache for a in args):
            return []
        leaves: List[torch.Tensor] = []

        def walk(node: Dict) -> None:
            if "k" in node:
                return
            for v in node.values():
                if isinstance(v, dict):
                    walk(v)
                else:
                    leaves.append(v)

        walk(self.cache)
        return leaves

    def _timed(self, key: Tuple, fn: Callable, *args: Any,
               now: Optional[float] = None,
               requests: Optional[List[Request]] = None
               ) -> Tuple[Any, float]:
        """Run fn; charge its measured duration. The first call per key
        warms up and is *not* charged: fn runs twice, so every step is a
        pure function of its inputs (repeated in-place cache writes store
        the same values, and the recurrent state the warm-up advanced is
        restored first). The ``perf_counter`` calls are the reference's,
        in the same order. With a tracer attached and ``now`` given, the
        charge lands on the trace as a compute span (a key's first call
        also as a compile instant: the warm-up); ``requests`` names the
        real group members the span served (padding replicas
        excluded)."""
        warm = key not in self._durations
        if warm:
            # the warm-up's in-place attention writes are repeated with
            # the same values; the recurrent state (SSM conv rings and
            # states) it advances is put back before the charged call
            state = self._recurrent_leaves(args)
            saved = [t.clone() for t in state]
            out = fn(*args)  # warm-up (uncharged)
            for t, v in zip(state, saved):
                t.copy_(v)
            self._sync()
            t0 = self._timer.perf_counter()  # el: allow[clock] -- _timed measures
            out = fn(*args)
            self._sync()
            self._durations[key] = self._timer.perf_counter() - t0  # el: allow[clock] -- _timed
        else:
            t0 = self._timer.perf_counter()  # el: allow[clock] -- _timed measures
            out = fn(*args)
            self._sync()
            self._durations[key] = 0.5 * self._durations[key] + 0.5 * (
                self._timer.perf_counter() - t0)  # el: allow[clock] -- _timed
        dt = self._durations[key] * self.ecfg.time_scale
        self.busy_time += dt
        tr = self.tracer
        if tr is not None and now is not None:
            if warm:
                tr.compile(now, key)
            tr.compute(now, dt, key, requests)
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
        # class 0 is requeued (KV-preempted) work, class 1 fresh arrivals
        self._queue = queue
        self._qi = 0
        self._ready: List[Tuple[int, int, int, Request]] = []
        self._push_seq = 0
        self._admit_counter = 0
        self._ttft_ewma: Dict[int, float] = {}
        self._step_hist: Dict[str, int] = {}
        self.max_step_seconds = 0.0
        self.kv_deferrals = 0
        self.kv_preemptions = 0
        self.peak_active_slots = 0
        self.load_stall_seconds = 0.0
        self._serve_loads0 = self.manager.stats.loads
        self.manager.reset_channel()
        # tracing: open the run and wire the channel and arena hooks for
        # this serve only; the finally below unwires them even when the
        # loop raises
        tr = self.tracer
        try:
            if tr is not None:
                tr.begin(now, ecfg.n_slots, meta={
                    "policy": ecfg.policy, "kv_backend": self.kv_backend,
                    "lora_backend": self.lora_backend,
                    "async_swap": ecfg.async_swap,
                    "prefill_chunk": ecfg.prefill_chunk,
                    "prefix_cache": self.prefix_enabled,
                    "buckets": list(self._buckets),
                    "n_requests": len(queue)})
                self.manager.on_event = tr.channel_hook
                if self.paged:
                    self.kvpool.on_event = tr.arena_hook
            active_adapter: Optional[int] = None  # llamacpp single-active
            dlora_mode = "unmerged"               # dlora dynamic mode
            dlora_merged_adapter: Optional[int] = None

            def dlora_desired() -> Tuple[str, Optional[int]]:
                """Merge when the next window of requests (requeued work
                first) is dominated by few adapters, on the head's
                adapter (dLoRA §3)."""
                ahead = [r.true_adapter for r in
                         self._upcoming(ecfg.dlora_window)]
                if not ahead:
                    return dlora_mode, dlora_merged_adapter
                uniq = set(ahead)
                if len(uniq) <= ecfg.dlora_merge_uniques \
                        and ahead.count(ahead[0]) * 2 >= len(ahead):
                    return "merged", ahead[0]
                return "unmerged", None

            def arrivals_ready() -> bool:
                self._ingest(now)
                return bool(self._ready)

            while len(completed) + len(rejected) < len(queue):
                if max_sim_time is not None and now > max_sim_time:
                    break
                progressed = False
                busy0 = self.busy_time

                # ---- admission ---------------------------------------
                idle = self.slots.idle()
                if ecfg.policy == "dlora" and idle and arrivals_ready():
                    want_mode, want_adapter = dlora_desired()
                    if (want_mode, want_adapter) != (dlora_mode,
                                                     dlora_merged_adapter):
                        if self.slots.any_active:
                            idle = []  # drain before switching modes
                        else:
                            # unmerge old and/or merge new: weight-sized
                            # traffic
                            cost = 0.0
                            if dlora_merged_adapter is not None:
                                cost += (2 * self.adapter_bytes
                                         / ecfg.mem_bandwidth)
                            if want_adapter is not None:
                                cost += (2 * self.adapter_bytes
                                         / ecfg.mem_bandwidth)
                            now += cost
                            dlora_mode, dlora_merged_adapter = (
                                want_mode, want_adapter)
                            if tr is not None:
                                tr.sched(now, "merge_switch",
                                         mode=want_mode,
                                         adapter=want_adapter, cost=cost)
                while idle and arrivals_ready():
                    req = self._ready[0][3]
                    if ecfg.admission_control \
                            and req.ttft_slo is not None \
                            and self._reject_expired(req, now, rejected):
                        progressed = True
                        continue
                    if ecfg.policy == "dlora" and dlora_mode == "merged" \
                            and req.true_adapter != dlora_merged_adapter:
                        break  # merged mode serves only the folded adapter
                    if self.paged and not self.kvpool.can_allocate(
                            req.prompt_len + 1):
                        # KV arena exhausted: leave the request queued and
                        # retry once a completion (or preemption) frees
                        # pages; checked before any merge cost is charged.
                        # +1: the first decode write must never run out
                        # right after admission.
                        self.kv_deferrals += 1
                        if tr is not None:
                            tr.sched(now, "defer_kv", request=req)
                        break
                    if ecfg.policy == "llamacpp":
                        want = req.true_adapter
                        if active_adapter is None:
                            active_adapter = want
                            # merge the adapter into the base weights
                            now += (2 * self.adapter_bytes
                                    / ecfg.mem_bandwidth)
                            if tr is not None:
                                tr.sched(now, "merge_switch", adapter=want)
                        if want != active_adapter:
                            if self.slots.any_active:
                                break  # drain before switching adapters
                            # unmerge old + merge new
                            now += (4 * self.adapter_bytes
                                    / ecfg.mem_bandwidth)
                            active_adapter = want
                            if tr is not None:
                                tr.sched(now, "merge_switch", adapter=want)
                    heapq.heappop(self._ready)
                    slot = idle.pop()
                    slot.assign(req)
                    req.admit_time = now
                    slot.admit_seq = self._admit_counter
                    self._admit_counter += 1
                    if tr is not None:
                        tr.sched(now, "admit", request=req, slot=slot.index)
                        tr.transition(now, slot.index, "idle", "selecting",
                                      req)
                    if self.paged:
                        self.kvpool.register(req.request_id)
                        key = (self._admission_exec_key(req, dlora_mode)
                               if self.prefix_enabled else None)
                        if key is not None:
                            # execution identity known at admission:
                            # splice cached prefix pages now and allocate
                            # only the suffix (the +1 headroom covers the
                            # COW page)
                            slot.prefix_len = self._admit_prefix(req, key)
                        else:
                            # AAS-routed: adapter unknown until selection
                            # — reserve the whole prompt, swap shared
                            # pages in at SELECTING→PREFILL
                            self.kvpool.append_tokens(req.request_id,
                                                      req.prompt_len)
                    progressed = True
                self.peak_active_slots = max(
                    self.peak_active_slots,
                    sum(s.state != SlotState.IDLE for s in self.slots.slots))

                # ---- adapter selection (Algorithm 1) -----------------
                if (ecfg.router_batching
                        and ecfg.policy not in ("dlora", "llamacpp",
                                                "edgelora_no_aas")
                        and getattr(self.router, "costs_forward", False)):
                    unscored = [
                        s for s in self.slots.in_state(SlotState.SELECTING)
                        if s.sel_scores is None
                        and s.request.adapter_id is None]
                    score_groups: Dict[int, List[Slot]] = {}
                    for slot in unscored:
                        self._slot_prompt(slot)
                        score_groups.setdefault(slot.bucket, []).append(slot)
                    for b, group in score_groups.items():
                        rows = self._pad_group(group)
                        toks = self._to_device(
                            np.stack([s.padded_prompt for s in rows]))
                        rids = ([s.request.request_id for s in group]
                                if tr is not None else None)
                        sb, dt = self._timed(("router", b, len(rows)),
                                             self.router.scores_batch, toks,
                                             now=now, requests=rids)
                        now += dt
                        self.router_steps += 1
                        # scores_batch copies its scores to the host
                        # (core/router.py): np.asarray only views them
                        sb = np.asarray(sb)  # el: allow[host-sync] -- no-op
                        for i, slot in enumerate(group):
                            slot.sel_scores = sb[i]
                for slot in self.slots.in_state(SlotState.SELECTING):
                    req = slot.request
                    if ecfg.policy == "dlora":
                        req.selected_adapter = req.true_adapter
                        slot.merged = dlora_mode == "merged"
                        if not slot.merged:
                            try:
                                res = self.manager.acquire(
                                    req.selected_adapter, now=now)
                            except PoolExhaustedError:
                                if tr is not None:
                                    tr.sched(now, "defer_pool", request=req)
                                continue  # pool fully pinned: defer
                            now = self._finish_acquire(slot, res, now)
                        else:
                            slot.adapter_slot = 0
                            slot.state = SlotState.PREFILL
                            if tr is not None:
                                tr.transition(now, slot.index, "selecting",
                                              "prefill", req)
                        progressed = True
                        continue
                    slot.merged = False
                    if ecfg.policy == "llamacpp":
                        # merged execution: the active adapter was folded
                        # into W at admission (cost charged there), so the
                        # steps run no LoRA at all
                        req.selected_adapter = req.true_adapter
                        slot.merged = True
                    elif ecfg.policy == "edgelora_no_aas" \
                            or req.adapter_id is not None:
                        req.selected_adapter = (req.adapter_id
                                                if req.adapter_id is not None
                                                else req.true_adapter)
                    else:
                        # scores are computed (and charged) once per
                        # request and cached on the slot: a deferral below
                        # must not re-roll the oracle or re-charge a
                        # router forward
                        scores = slot.sel_scores
                        if scores is None:
                            if getattr(self.router, "costs_forward", False):
                                toks = self._to_device(
                                    self._slot_prompt(slot)[None, :])
                                rids = ([req.request_id]
                                        if tr is not None else None)
                                sb, dt = self._timed(
                                    ("router", slot.bucket, 1),
                                    self.router.scores_batch, toks, now=now,
                                    requests=rids)
                                now += dt
                                self.router_steps += 1
                                scores = np.asarray(sb)[0]  # el: allow[host-sync] -- no-op
                            else:
                                scores = np.asarray(self.router.scores(req))
                            slot.sel_scores = scores
                        aid, _ = select_adapter(scores, self.manager,
                                                ecfg.top_k)
                        req.selected_adapter = aid
                    if ecfg.policy != "llamacpp":
                        try:
                            res = self.manager.acquire(req.selected_adapter,
                                                       now=now)
                        except PoolExhaustedError:
                            # every pool block is pinned by an in-flight
                            # request: stay SELECTING and retry after a
                            # completion unpins
                            if tr is not None:
                                tr.sched(now, "defer_pool", request=req)
                            continue
                        slot.sel_scores = None
                        now = self._finish_acquire(slot, res, now)
                    else:
                        slot.sel_scores = None
                        slot.adapter_slot = 0  # merged: the adapter rides W
                        slot.state = SlotState.PREFILL
                        if tr is not None:
                            tr.transition(now, slot.index, "selecting",
                                          "prefill", req)
                    if self.prefix_enabled and \
                            self._admission_exec_key(req, dlora_mode) is None:
                        # AAS-routed: match now that the adapter is known
                        # and swap shared pages into the reserved table
                        self._attach_prefix(slot)
                    progressed = True

                # ---- async swap-in: transfers that have landed --------
                if ecfg.async_swap:
                    for slot in self.slots.in_state(SlotState.LOADING):
                        if slot.ready_time <= now:
                            slot.state = SlotState.PREFILL
                            if tr is not None:
                                tr.transition(now, slot.index, "loading",
                                              "prefill", slot.request)
                            progressed = True
                    if ecfg.prefetch_depth > 0 and ecfg.policy != "llamacpp":
                        self._run_prefetch(now, dlora_mode)

                # ---- prefill (gather→batch→scatter) ------------------
                prefilling = self.slots.in_state(SlotState.PREFILL)
                if prefilling:
                    # groups share bucket, merged-ness and start: merged
                    # steps run no LoRA, prefix-hit rows prefill only
                    # their suffix and chunked rows resume at their
                    # progress, each start a different step shape
                    chunk = ecfg.prefill_chunk
                    groups: Dict[Tuple[int, bool, int], List[Slot]] = {}
                    for slot in prefilling:
                        self._slot_prompt(slot)
                        # chunked progress starts at the prefix-cache hit
                        if slot.prefill_pos < slot.prefix_len:
                            slot.prefill_pos = slot.prefix_len
                        start = (slot.prefill_pos if self.chunked
                                 else slot.prefix_len)
                        groups.setdefault((slot.bucket, slot.merged, start),
                                          []).append(slot)
                    work: List[Tuple[int, bool, int, List[Slot]]] = []
                    for (b, merged, start), group in groups.items():
                        if ecfg.prefill_batching:
                            work.append((b, merged, start, group))
                        else:  # pre-batching baseline: one B=1 call each
                            work.extend((b, merged, start, [s])
                                        for s in group)
                    for b, merged, start, group in work:
                        span = b - start
                        # whole-span groups take the un-chunked paths;
                        # dense mid-prompt progress always goes through
                        # _prefill_chunk (_prefill_group's suffix branch
                        # is paged-only)
                        if not self.chunked or (
                                chunk >= span
                                and (start == 0 or self.paged)):
                            now += self._prefill_group(b, merged, start,
                                                       group, now)
                        else:
                            now += self._prefill_chunk(
                                b, merged, start, min(chunk, span), group,
                                now)
                    progressed = True

                # ---- batched decode (Batch LoRA Inference) -----------
                gen = self.slots.in_state(SlotState.GENERATE)
                if gen and self.paged:
                    # allocate this step's page per sequence up front; a
                    # dry arena preempts the youngest admission (LIFO
                    # restart)
                    gen = self._secure_decode_blocks(gen, now)
                    progressed = True  # preemption alone is progress
                if gen:
                    rids = ([s.request.request_id for s in gen]
                            if tr is not None else None)
                    # idle rows run too: token 0, pos 0, pool slot 0 —
                    # they write ring index 0 of idle slots (dense) or the
                    # trash page (paged), as in the reference
                    tokens = np.zeros((ecfg.n_slots,), np.int32)
                    pos = np.zeros((ecfg.n_slots,), np.int32)
                    sids = np.zeros((ecfg.n_slots,), np.int32)
                    for slot in gen:
                        tokens[slot.index] = slot.last_token
                        pos[slot.index] = slot.pos
                        sids[slot.index] = slot.adapter_slot
                    merged_step = (ecfg.policy == "llamacpp"
                                   or (ecfg.policy == "dlora"
                                       and dlora_mode == "merged"))
                    if self.paged:
                        tables, lengths, plens, bwlens = \
                            self._decode_tables(gen)
                        if merged_step:
                            (next_toks, self.cache), dt = self._timed(
                                ("decode_merged",), self._decode_merged_paged,
                                self.params, self._to_device(tokens),
                                self.cache, tables, lengths, plens, bwlens,
                                self._to_device(pos), now=now,
                                requests=rids)
                        else:
                            (next_toks, self.cache), dt = self._timed(
                                ("decode",), self._decode_paged, self.params,
                                self.lora_pool, self._to_device(tokens),
                                self.cache, tables, lengths, plens, bwlens,
                                self._to_device(pos), self._to_device(sids),
                                now=now, requests=rids)
                    elif merged_step:
                        (next_toks, self.cache), dt = self._timed(
                            ("decode_merged",), self._decode_merged,
                            self.params, self._to_device(tokens), self.cache,
                            self._to_device(pos), now=now, requests=rids)
                    else:
                        (next_toks, self.cache), dt = self._timed(
                            ("decode",), self._decode, self.params,
                            self.lora_pool, self._to_device(tokens),
                            self.cache, self._to_device(pos),
                            self._to_device(sids), now=now, requests=rids)
                    now += dt
                    self.decode_steps += 1
                    next_np = next_toks.cpu().numpy()  # el: allow[host-sync] -- output stream
                    for slot in gen:
                        req = slot.request
                        slot.last_token = int(next_np[slot.index])
                        slot.pos += 1
                        req.generated += 1
                        req.tokens.append(slot.last_token)
                        if req.generated >= req.output_len \
                                or slot.pos >= ecfg.max_ctx - 1:
                            req.finish_time = now
                            if ecfg.policy != "llamacpp" \
                                    and not slot.merged:
                                self.manager.unpin(req.selected_adapter)
                            if tr is not None:
                                tr.transition(now, slot.index, "generate",
                                              "idle", req)
                            if self.paged:
                                self.kvpool.release(req.request_id)
                            completed.append(slot.release())
                    progressed = True

                # ---- per-iteration step time (compute charged) -------
                step_busy = self.busy_time - busy0
                if step_busy > 0.0:
                    self._note_step(step_busy)

                # ---- once-per-step metrics sampling (tracing only) ---
                if tr is not None:
                    if self.paged:
                        tr.metrics.gauge("arena_blocks_used").set(
                            self.kvpool.used_blocks)
                    tr.sample(
                        now,
                        queue_depth=len(self._ready),
                        active_slots=sum(s.state != SlotState.IDLE
                                         for s in self.slots.slots),
                        decode_batch=len(gen),
                        resident_adapters=self.manager.n_resident,
                        loading_adapters=len(self.manager.loading))

                # ---- idle / load-blocked: jump to the earliest event --
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

            if tr is not None:
                tr.finish(now)
                # shape watchdog: audit every step key against the bound
                # the power-of-two group padding promises
                tr.watchdog_report = jit_cache_report(
                    self._durations.keys(), buckets=self._buckets,
                    n_slots=ecfg.n_slots, prefill_chunk=ecfg.prefill_chunk,
                    prefix_cache=self.prefix_enabled,
                    block_size=ecfg.kv_block_size, max_ctx=ecfg.max_ctx)
                if tr.strict_watchdog and not tr.watchdog_report["ok"]:
                    raise JitRecompileError(
                        "step keys exceeded the documented shape bound:\n  "
                        + "\n  ".join(tr.watchdog_report["violations"]))
        finally:
            # the observers wired above never outlive this serve
            self.manager.on_event = None
            if self.paged:
                self.kvpool.on_event = None
        duration = max(now, 1e-9)
        kv_stats = None
        if self.paged:
            kv_stats = {"backend": "paged",
                        "n_blocks": self.kvpool.n_blocks,
                        "block_size": self.kvpool.block_size,
                        **self.kvpool.stats.as_dict(),
                        "deferrals": self.kv_deferrals,
                        "preemptions": self.kv_preemptions}
        prefix_stats = (self.prefix_cache.summary()
                        if self.prefix_enabled else None)
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
                             "kv_stats": kv_stats,
                             "prefix_stats": prefix_stats,
                             "swap_stats": swap_stats,
                             "step_time_hist":
                                 dict(self._step_hist) or None,
                             "max_step_seconds":
                                 (self.max_step_seconds
                                  if self._step_hist else None),
                             "latency_breakdown":
                                 (tr.breakdown_summary()
                                  if tr is not None else None),
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

    def _upcoming(self, n: int) -> List[Request]:
        """The next ``n`` requests admission will see, in order: heap
        order over the ready set, then future arrivals (the window
        dlora's merge heuristic scans)."""
        head = [e[3] for e in heapq.nsmallest(n, self._ready)]
        return (head + self._queue[self._qi:self._qi + n])[:n]

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
        if self.tracer is not None:
            self.tracer.sched(now, why, request=req, wait=wait)
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

    def _group_rows(self, rows: List[Slot]) -> Tuple[torch.Tensor, ...]:
        """[B] prompt lengths, adapter pool slots and slot indices of a
        padded group, on the device."""
        n = len(rows)
        lengths = self._to_device(np.fromiter(
            (s.request.prompt_len for s in rows), np.int32, count=n))
        sids = self._to_device(np.fromiter(
            (s.adapter_slot for s in rows), np.int32, count=n))
        slot_idx = self._to_device(np.fromiter(
            (s.index for s in rows), np.int64, count=n))
        return lengths, sids, slot_idx

    def _group_tables(self, rows: List[Slot]) -> torch.Tensor:
        """[B, max_blocks] block tables of a padded group (replica rows
        share the real row's sequence, so their page writes repeat the
        same data)."""
        mb = self._kv_meta.max_blocks
        return self._to_device(np.stack(
            [self.kvpool.block_table(s.request.request_id, mb)
             for s in rows]))

    def _prefill_group(self, bucket: int, merged: bool, prefix_len: int,
                       group: List[Slot], now: float) -> float:
        """One batched prefill over ``group`` (same bucket, same
        merged-ness, same prefix length, mixed adapters); all fresh KV
        slices land in the global cache in one indexed write per leaf.
        Prefix-hit groups (prefix_len > 0, paged only) run the
        suffix-only prefill over their spliced block tables. Merged
        groups run the step with no LoRA. Returns the time charged for
        the group."""
        tr = self.tracer
        rids = ([s.request.request_id for s in group]
                if tr is not None else None)
        rows = self._pad_group(group)
        lengths, sids, slot_idx = self._group_rows(rows)
        cacheb = self._fresh_cache(len(rows))
        tables = self._group_tables(rows) if self.paged else None
        if prefix_len:
            # suffix-only prefill: the padded prompt minus its cached
            # prefix columns keeps key widths equal to the cold prefill
            toks = self._to_device(np.stack(
                [s.padded_prompt[prefix_len:] for s in rows]))
            if merged:
                fn = functools.partial(self._prefill_suffix_merged,
                                       prefix_len=prefix_len)
                (first, cacheb), dt = self._timed(
                    ("prefill_sfx_merged", bucket, prefix_len, len(rows)),
                    fn, self.params, toks, cacheb, self.cache, tables,
                    lengths, now=now, requests=rids)
            else:
                fn = functools.partial(self._prefill_suffix,
                                       prefix_len=prefix_len)
                (first, cacheb), dt = self._timed(
                    ("prefill_sfx", bucket, prefix_len, len(rows)), fn,
                    self.params, self.lora_pool, toks, cacheb, self.cache,
                    tables, sids, lengths, now=now, requests=rids)
            self.cache = kvlib.scatter_suffix(
                self.cache, cacheb, tables, lengths, prefix_len,
                bucket - prefix_len, self._kv_meta)
        else:
            toks = self._to_device(np.stack([s.padded_prompt for s in rows]))
            if merged:
                (first, cacheb), dt = self._timed(
                    ("prefill_merged", bucket, len(rows)),
                    self._prefill_merged, self.params, toks, cacheb,
                    lengths, now=now, requests=rids)
            else:
                (first, cacheb), dt = self._timed(
                    ("prefill", bucket, len(rows)), self._prefill,
                    self.params, self.lora_pool, toks, cacheb, sids, lengths,
                    now=now, requests=rids)
            if self.paged:
                bwlens = torch.full((len(rows),), bucket, dtype=torch.int32,
                                    device=self.device)
                self.cache = kvlib.scatter_prefill(
                    self.cache, cacheb, tables, lengths, bwlens, slot_idx,
                    self._kv_meta)
            else:
                self.cache = self._write_slots(self.cache, cacheb, slot_idx)
        self.prefill_steps += 1
        self.prefill_batch_hist[len(group)] = \
            self.prefill_batch_hist.get(len(group), 0) + 1
        first_np = first.cpu().numpy()  # el: allow[host-sync] -- output stream
        for i, slot in enumerate(group):
            req = slot.request
            slot.pos = req.prompt_len
            slot.last_token = int(first_np[i])
            req.first_token_time = now + dt
            req.generated = 1
            req.tokens = [slot.last_token]
            slot.state = SlotState.GENERATE
            if tr is not None:
                # the group's charged step ends at now + dt, when the
                # request's first token exists
                tr.transition(now + dt, slot.index, "prefill", "generate",
                              req)
            self._note_ttft(slot.bucket, req, now + dt)
        if self.prefix_enabled:
            # index every full prompt block (cold rows donate fresh
            # pages; warm rows walk their matched path)
            for slot in group:
                self.prefix_cache.insert(
                    self._exec_key(slot), slot.request.prompt_tokens,
                    self.kvpool.tables[slot.request.request_id])
        return dt

    def _prefill_chunk(self, bucket: int, merged: bool, start: int,
                       width: int, group: List[Slot], now: float) -> float:
        """One bounded slice of chunked prefill: prompt positions
        [start, start + width) for every slot in ``group`` (same bucket,
        same merged-ness, same progress) as a suffix prefill over the KV
        earlier chunks wrote; then either advance ``prefill_pos`` (more
        chunks pending: decode steps interleave before the next) or emit
        the first token (terminal chunk). start == 0 reuses the plain
        prefill step at chunk width; later chunks the suffix step (paged)
        or its dense sibling, each with its merged variant. Timing keys
        are the reference's. Returns the time charged for the group."""
        tr = self.tracer
        rids = ([s.request.request_id for s in group]
                if tr is not None else None)
        rows = self._pad_group(group)
        end = start + width
        real, sids, slot_idx = self._group_rows(rows)
        # tokens past the chunk don't exist yet: the step sees lengths
        # clamped to the chunk end; the scatters get the REAL lengths so
        # right-pad columns stay invalid
        lengths = real.clamp_max(end)
        cacheb = self._fresh_cache(len(rows))
        toks = self._to_device(np.stack(
            [s.padded_prompt[start:end] for s in rows]))
        if start == 0:
            if merged:
                (first, cacheb), dt = self._timed(
                    ("prefill_merged", width, len(rows)),
                    self._prefill_merged, self.params, toks, cacheb,
                    lengths, now=now, requests=rids)
            else:
                (first, cacheb), dt = self._timed(
                    ("prefill", width, len(rows)), self._prefill,
                    self.params, self.lora_pool, toks, cacheb, sids, lengths,
                    now=now, requests=rids)
        if self.paged:
            tables = self._group_tables(rows)
            if start and merged:
                fn = functools.partial(self._prefill_suffix_merged,
                                       prefix_len=start)
                (first, cacheb), dt = self._timed(
                    ("prefill_sfx_merged", end, start, len(rows)), fn,
                    self.params, toks, cacheb, self.cache, tables, lengths,
                    now=now, requests=rids)
            elif start:
                fn = functools.partial(self._prefill_suffix,
                                       prefix_len=start)
                (first, cacheb), dt = self._timed(
                    ("prefill_sfx", end, start, len(rows)), fn, self.params,
                    self.lora_pool, toks, cacheb, self.cache, tables, sids,
                    lengths, now=now, requests=rids)
            # scatter_suffix covers start == 0 too (mini ring index ==
            # position); pad columns land in the trash page
            self.cache = kvlib.scatter_suffix(
                self.cache, cacheb, tables, real, start, width,
                self._kv_meta)
        elif start == 0:
            # fresh slots: the whole-ring copy is correct (positions past
            # the chunk are still at their invalid init state)
            self.cache = self._write_slots(self.cache, cacheb, slot_idx)
        else:
            if merged:
                fn = functools.partial(self._prefill_sfx_dense_merged,
                                       prefix_len=start)
                (first, cacheb), dt = self._timed(
                    ("prefill_sfx_dense_merged", end, start, len(rows)), fn,
                    self.params, toks, cacheb, self.cache, slot_idx, lengths,
                    now=now, requests=rids)
            else:
                fn = functools.partial(self._prefill_sfx_dense,
                                       prefix_len=start)
                (first, cacheb), dt = self._timed(
                    ("prefill_sfx_dense", end, start, len(rows)), fn,
                    self.params, self.lora_pool, toks, cacheb, self.cache,
                    slot_idx, sids, lengths, now=now, requests=rids)
            self.cache = self._dense_scatter_suffix(
                self.cache, cacheb, slot_idx, real, prefix_len=start,
                suffix_len=width)
        self.prefill_steps += 1
        self.prefill_batch_hist[len(group)] = \
            self.prefill_batch_hist.get(len(group), 0) + 1
        first_np = first.cpu().numpy()  # el: allow[host-sync] -- output stream
        for i, slot in enumerate(group):
            req = slot.request
            if req.prompt_len <= end:
                # terminal chunk: _prefill_group's completion protocol
                slot.pos = req.prompt_len
                slot.last_token = int(first_np[i])
                req.first_token_time = now + dt
                req.generated = 1
                req.tokens = [slot.last_token]
                slot.state = SlotState.GENERATE
                if tr is not None:
                    tr.transition(now + dt, slot.index, "prefill",
                                  "generate", req)
                self._note_ttft(slot.bucket, req, now + dt)
                if self.prefix_enabled:
                    self.prefix_cache.insert(
                        self._exec_key(slot), req.prompt_tokens,
                        self.kvpool.tables[req.request_id])
            else:
                slot.prefill_pos = end
        return dt

    # ------------------------------------------------------------------
    # shared-prefix radix cache (splice, COW, stats)
    # ------------------------------------------------------------------

    def _exec_key(self, slot: Slot) -> Tuple:
        """Execution identity under which prefix KV is shareable: KV at
        depth > 0 depends on the adapter (and on merged execution)."""
        return (slot.merged, slot.request.selected_adapter)

    def _admission_exec_key(self, req: Request,
                            dlora_mode: str) -> Optional[Tuple]:
        """The execution identity a request will run under when it is
        known at admission (every policy but AAS-routed ``edgelora``).
        None for AAS-routed requests: admission reserves conservatively
        and the prefix match happens at selection."""
        policy = self.ecfg.policy
        if policy == "llamacpp":
            return (True, req.true_adapter)
        if policy == "dlora":
            # merged admissions pass the gate only on the folded adapter,
            # and the mode cannot flip before selection (a switch drains
            # the batch first)
            return (dlora_mode == "merged", req.true_adapter)
        if req.adapter_id is not None:
            return (False, req.adapter_id)
        if policy == "edgelora_no_aas":
            return (False, req.true_adapter)
        return None

    def _admit_prefix(self, req: Request, exec_key: Tuple) -> int:
        """Admission-time prefix adoption: match, splice shared pages,
        allocate only the suffix. Returns the prefix length served from
        cache (0 on a miss)."""
        blocks = self.prefix_cache.match(exec_key, req.prompt_tokens)
        matched = len(blocks) * self.kvpool.block_size
        prefix_len = min(matched, req.prompt_len - 1)
        if prefix_len <= 0:
            blocks, matched, prefix_len = [], 0, 0
        pair = self.kvpool.adopt_prefix(req.request_id, blocks,
                                        req.prompt_len,
                                        cow_last=prefix_len < matched)
        st = self.prefix_cache.stats
        if pair is not None:
            self.cache = kvlib.copy_block(self.cache, *pair,
                                          self._kv_meta)
            st.cow_copies += 1
        if prefix_len:
            st.hit_requests += 1
            st.hit_tokens += matched
            st.saved_prefill_tokens += prefix_len
        return prefix_len

    def _attach_prefix(self, slot: Slot) -> None:
        """At SELECTING→PREFILL (adapter now known): splice the longest
        cached block-aligned prefix into the sequence's reserved table
        (releasing the private pages admission reserved for that span)
        and shrink the prefill to the suffix. A whole-prompt match keeps
        one token to re-prefill, inside a copy-on-write page."""
        req = slot.request
        slot.prefix_len = 0
        blocks = self.prefix_cache.match(self._exec_key(slot),
                                         req.prompt_tokens)
        if not blocks:
            return
        matched = len(blocks) * self.kvpool.block_size
        prefix_len = min(matched, req.prompt_len - 1)
        if prefix_len <= 0:
            return
        pair = self.kvpool.replace_prefix(req.request_id, blocks,
                                          cow_last=prefix_len < matched)
        st = self.prefix_cache.stats
        if pair is not None:
            self.cache = kvlib.copy_block(self.cache, *pair,
                                          self._kv_meta)
            st.cow_copies += 1
        st.hit_requests += 1
        st.hit_tokens += matched
        st.saved_prefill_tokens += prefix_len
        slot.prefix_len = prefix_len

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
        tr = self.tracer
        self.manager.pin(res.adapter_id)
        slot.adapter_slot = res.slot
        if self.ecfg.async_swap:
            if res.ready_time > now:
                slot.ready_time = res.ready_time
                slot.state = SlotState.LOADING
                if tr is not None:
                    tr.transition(now, slot.index, "selecting", "loading",
                                  slot.request, adapter=res.adapter_id)
            else:
                slot.state = SlotState.PREFILL
                if tr is not None:
                    tr.transition(now, slot.index, "selecting", "prefill",
                                  slot.request)
            return now
        if res.ready_time > now:
            self.load_stall_seconds += res.ready_time - now
            # the whole engine stalls through a sync load: the trace
            # records it as a LOADING interval
            if tr is not None:
                tr.transition(now, slot.index, "selecting", "loading",
                              slot.request, adapter=res.adapter_id)
            now = res.ready_time
            slot.state = SlotState.PREFILL
            if tr is not None:
                tr.transition(now, slot.index, "loading", "prefill",
                              slot.request)
            return now
        slot.state = SlotState.PREFILL
        if tr is not None:
            tr.transition(now, slot.index, "selecting", "prefill",
                          slot.request)
        return now

    def _known_adapter(self, req: Request,
                       dlora_mode: str) -> Optional[int]:
        """The pool adapter a waiting request will demand, when already
        determined (None: AAS picks at SELECTING, or the policy runs
        merged and never touches the pool)."""
        if req.adapter_id is not None:
            return req.adapter_id
        policy = self.ecfg.policy
        if policy == "edgelora_no_aas":
            return req.true_adapter
        if policy == "dlora" and dlora_mode != "merged":
            return req.true_adapter
        return None

    def _predicted_adapter(self, req: Request,
                           dlora_mode: str) -> Optional[int]:
        """Known adapter, or a cheap AAS prediction: a bookkeeping-only
        router scores a waiting request for free, so run the cache-aware
        selection it will make on admission; a forward-costing router
        reuses only a preempted request's previous selection. None: not
        predictable, or already resident."""
        aid = self._known_adapter(req, dlora_mode)
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

    def _run_prefetch(self, now: float, dlora_mode: str) -> None:
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
            aid = self._predicted_adapter(r, dlora_mode)
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

    # ------------------------------------------------------------------
    # paged-KV scheduling (block tables, preemption)
    # ------------------------------------------------------------------

    def _decode_tables(self, gen: List[Slot]) -> Tuple[torch.Tensor, ...]:
        """[n_slots, max_blocks] page table and [n_slots] written lengths
        / prompt lengths / prefill buckets for a decode step, on the
        device. Rows of slots not decoding this tick are -1 / 0: their
        reads and writes go to the trash page."""
        mb = self._kv_meta.max_blocks
        n = self.ecfg.n_slots
        tables = np.full((n, mb), -1, np.int32)
        lengths = np.zeros((n,), np.int32)
        plens = np.zeros((n,), np.int32)
        bwlens = np.zeros((n,), np.int32)
        for slot in gen:
            tables[slot.index] = self.kvpool.block_table(
                slot.request.request_id, mb)
            lengths[slot.index] = slot.pos  # tokens written pre-step
            plens[slot.index] = slot.request.prompt_len
            bwlens[slot.index] = slot.bucket  # padded prefill write span
        return tuple(self._to_device(a)
                     for a in (tables, lengths, plens, bwlens))

    def _secure_decode_blocks(self, gen: List[Slot],
                              now: float) -> List[Slot]:
        """Allocate one page-extension per decoding sequence, oldest
        admission first. When the arena is dry, preempt the *youngest*
        active slot (LIFO restart-recompute). The init-time capacity
        check (arena ≥ one max_ctx sequence) guarantees the oldest
        admission always makes progress."""
        if self.tracer is not None:
            self.tracer.clock(now)  # arena events land at this step
        secured: List[Slot] = []
        for slot in sorted(gen, key=lambda s: s.admit_seq):
            if slot.state != SlotState.GENERATE:
                continue  # preempted as an earlier slot's victim
            rid = slot.request.request_id
            alive = True
            while not self.kvpool.can_append(rid, 1):
                victims = [s for s in self.slots.slots
                           if s.state != SlotState.IDLE and s is not slot
                           and s not in secured]
                if victims:
                    self._preempt(max(victims,
                                      key=lambda s: s.admit_seq), now)
                else:
                    self._preempt(slot, now)
                    alive = False
                    break
            if alive:
                self.kvpool.append_tokens(rid, 1)
                secured.append(slot)
        return [s for s in gen if s in secured]

    def _preempt(self, slot: Slot, now: float) -> None:
        """Evict an in-flight request to free its KV pages: restart
        semantics — partial output is discarded and the request
        re-admits (and re-prefills) ahead of new arrivals once capacity
        returns."""
        req = slot.request
        tr = self.tracer
        if tr is not None:
            # close the slot's open span before release mutates state;
            # its in-slot time becomes the request's 'preempted' segment
            tr.transition(now, slot.index, slot.state.value, "idle",
                          req, preempted=True)
            tr.sched(now, "preempt", request=req, slot=slot.index)
            tr.sched(now, "requeue", request=req)
        self.kvpool.release(req.request_id)
        if self.ecfg.policy != "llamacpp" and not slot.merged \
                and slot.state in (SlotState.LOADING, SlotState.PREFILL,
                                   SlotState.GENERATE):
            self.manager.unpin(req.selected_adapter)
        if req.selected_adapter is not None:
            req.prefetch_hint = req.selected_adapter
        req.selected_adapter = None
        req.first_token_time = None
        req.generated = 0
        req.tokens = []
        # restart semantics reset the admission clock too: the TTFT
        # estimator must not learn from a partially-served admission
        req.admit_time = None
        slot.release()
        self._push_ready(req, requeued=True)
        self.kv_preemptions += 1
