"""Slot state machine (paper §4, Fig. 7).

A fixed number of slots bounds concurrency (and therefore batch shapes —
static shapes mean no XLA recompilation at runtime). Each slot walks:

    IDLE -> SELECTING [-> LOADING] -> PREFILL -> GENERATE -> IDLE

SELECTING runs Algorithm 1 (adaptive adapter selection) unless the request
pins an adapter explicitly; LOADING (async adapter swap-in only) waits on
the host→HBM transfer channel's ``ready_time`` while *other* slots keep
prefilling and decoding; PREFILL decodes the prompt and emits the first
token; GENERATE iterates until the request's output length.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class SlotState(enum.Enum):
    IDLE = "idle"
    SELECTING = "selecting"
    LOADING = "loading"
    PREFILL = "prefill"
    GENERATE = "generate"


@dataclass
class Request:
    request_id: int
    arrival_time: float
    prompt_len: int
    output_len: int
    # explicit adapter (bypasses adaptive selection) or None
    adapter_id: Optional[int] = None
    # ground-truth best adapter (workload synthesis; the router predicts it)
    true_adapter: Optional[int] = None
    prompt_tokens: Optional[object] = None  # jnp [prompt_len] int32
    # scheduling class: lower admits first (0 = most urgent). Ties fall
    # back to FIFO (requeued work still leads — see engine admission),
    # so all-equal priorities reproduce the plain FIFO queue exactly.
    priority: int = 0
    # per-request SLOs (seconds), both optional. ttft_slo is a deadline
    # on arrival→first-token: the engine's admission control sheds the
    # request (429-style) when the projected TTFT exceeds it, and times
    # it out when the deadline has already passed unserved. tpot_slo
    # bounds the per-token decode latency (finish − first_token over
    # generated − 1) and is used for attainment *reporting* only.
    ttft_slo: Optional[float] = None
    tpot_slo: Optional[float] = None

    # filled during serving
    selected_adapter: Optional[int] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    generated: int = 0
    # generated token ids, in order (observable output: regression tests
    # compare these across engine configurations)
    tokens: List[int] = field(default_factory=list)
    # the adapter this request ran under before a KV preemption (restart
    # discards selected_adapter; the queue-ahead prefetcher uses the old
    # choice as a warm-up hint when re-scoring would cost a forward)
    prefetch_hint: Optional[int] = None
    # the prefetcher's stash of this request's router scores (oracle
    # scores are a pure function of (seed, request_id) — computing them
    # once per request instead of once per scheduler tick keeps the
    # stall-loop ticks cheap)
    sel_scores: Optional[object] = None
    # sim time of the (latest) slot assignment; the admission-control
    # TTFT estimator keys its admit→first-token EWMA off it
    admit_time: Optional[float] = None
    # admission-control outcome: None = served (or still queued at
    # max_sim_time), 'shed' = projected TTFT exceeded ttft_slo at
    # admission (the 429 path), 'timeout' = deadline already passed
    # when the request reached the head of the queue. Rejected requests
    # are recorded, never silently dropped: they stay in the trace the
    # summary sees and count against SLO attainment.
    rejected: Optional[str] = None
    reject_time: Optional[float] = None


@dataclass
class Slot:
    index: int
    state: SlotState = SlotState.IDLE
    request: Optional[Request] = None
    pos: int = 0                 # next token position
    adapter_slot: int = 0        # pool slot of the active adapter
    last_token: int = 0
    # router scores cached across SELECTING retries (pool-exhausted
    # deferral must not re-score the request)
    sel_scores: Optional[object] = None
    # merged execution (llamacpp / dlora-merged): steps skip LoRA math
    merged: bool = False
    # prompt padded once to its bucket and cached for the request's
    # lifetime — the router forward and the prefill share one copy, and
    # batch grouping keys off the cached bucket
    bucket: Optional[int] = None
    padded_prompt: Optional[object] = None  # jnp [bucket] int32
    # monotone admission counter (engine-assigned): the paged-KV engine
    # preempts the youngest admission first (LIFO) when the block arena
    # runs dry mid-decode
    admit_seq: int = 0
    # tokens of the prompt served from shared cached pages (prefix-cache
    # hit; 0 = cold). Prefill runs only on the remaining suffix.
    prefix_len: int = 0
    # chunked prefill progress: prompt positions [0, prefill_pos) are
    # already in the KV cache (0 = none beyond any prefix-cache hit).
    # The engine advances it one ≤ prefill_chunk-token chunk per
    # scheduler iteration; a preemption resets it (restart-recompute).
    prefill_pos: int = 0
    # async adapter swap-in: sim time the slot's adapter transfer lands
    # (the LOADING state waits on it; meaningless outside LOADING)
    ready_time: float = 0.0

    def assign(self, req: Request) -> None:
        assert self.state == SlotState.IDLE
        self.request = req
        self.state = SlotState.SELECTING
        self.pos = 0
        self.sel_scores = None
        self.merged = False
        self.bucket = None
        self.padded_prompt = None
        self.prefix_len = 0
        self.prefill_pos = 0
        self.ready_time = 0.0

    def release(self) -> Request:
        req = self.request
        self.request = None
        self.state = SlotState.IDLE
        self.pos = 0
        self.sel_scores = None
        self.merged = False
        self.bucket = None
        self.padded_prompt = None
        self.prefix_len = 0
        self.prefill_pos = 0
        self.ready_time = 0.0
        return req


class SlotManager:
    def __init__(self, n_slots: int) -> None:
        self.slots = [Slot(i) for i in range(n_slots)]

    def idle(self) -> List[Slot]:
        return [s for s in self.slots if s.state == SlotState.IDLE]

    def in_state(self, state: SlotState) -> List[Slot]:
        return [s for s in self.slots if s.state == state]

    @property
    def any_active(self) -> bool:
        return any(s.state != SlotState.IDLE for s in self.slots)
