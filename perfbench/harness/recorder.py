"""Wall-clock stamps of one serve, taken through the engine's own hooks.

``WallClock`` is the engine's ``timer``: ``_timed`` reads it right
before a step's call and right after the step's device sync, so its last
two readings are the step's wall interval. ``Recorder`` is the engine's
``tracer`` (an ``EngineTracer`` that records as usual): ``sched('admit')``
stamps each admission, ``compute`` each step with the requests it served
(a prefill step gives each of them its first token, a decode step its
next one), and ``sample``, called once per scheduler iteration, the
adapter pool's counters.

The window opens at the start of the serve's second prefill step: the
first fills every slot from the backlog at once, a burst no steady
stream of requests sees, and counts as set-up. It has ``seconds`` of
budget from there. Once a step ends, or an iteration passes, after the
budget's end, the recorder raises ``WindowClosed`` out of ``serve()``.
The harness then ends the window at the same phase of the loop
(``bench.window_end``), and reads only the stamps inside it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.trace import EngineTracer

PREFILL_KINDS = ("prefill", "prefill_merged", "prefill_sfx",
                 "prefill_sfx_merged", "prefill_sfx_dense",
                 "prefill_sfx_dense_merged")
DECODE_KINDS = ("decode", "decode_merged")


class WindowClosed(Exception):
    """The window's wall time has run out."""


class WarmupMissed(RuntimeError):
    """A step shape ran for the first time inside the window."""


class WallClock:
    """``time.perf_counter``, each reading kept while ``keep`` is set."""

    def __init__(self) -> None:
        self.keep = False
        self.readings: List[float] = []

    def perf_counter(self) -> float:
        t = time.perf_counter()
        if self.keep:
            self.readings.append(t)
        return t


@dataclass
class Step:
    kind: str
    t0: float
    t1: float
    requests: Tuple[int, ...]


@dataclass
class PoolCount:
    t: float
    hits: int
    misses: int


class Recorder(EngineTracer):
    """Stamps for one serve. ``start`` and ``end`` (perf_counter
    seconds) are the window's opening and the end of its budget, set
    once the second prefill step has run."""

    def __init__(self, clock: WallClock, seconds: float,
                 pool_counts: Callable[[], Tuple[int, int]]) -> None:
        super().__init__(strict_watchdog=False)
        self.wall = clock
        self.seconds = seconds
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self._pool_counts = pool_counts
        self.admit: Dict[int, float] = {}
        self.tokens: Dict[int, List[float]] = {}
        self.steps: List[Step] = []
        self.load_ends: List[float] = []
        self.pool: List[PoolCount] = [
            PoolCount(time.perf_counter(), *pool_counts())]

    # -- engine hooks ----------------------------------------------------

    def sched(self, t, name, request=None, **args):
        super().sched(t, name, request=request, **args)
        if name == "admit":
            self.admit[request.request_id] = time.perf_counter()

    def channel_hook(self, name, t, args):
        super().channel_hook(name, t, args)
        if name in ("load", "prefetch"):
            # fired right after the adapter's copy into the pool
            self.load_ends.append(time.perf_counter())

    def compile(self, t, key):
        raise WarmupMissed(f"step {key!r} first ran inside the window: "
                           "set-up did not warm it")

    def compute(self, t, dt, key, requests=None):
        super().compute(t, dt, key, requests)
        t0, t1 = self.wall.readings[-2:]
        rids = tuple(requests or ())
        self.steps.append(Step(key[0], t0, t1, rids))
        if self.start is None and key[0] in PREFILL_KINDS \
                and any(s.kind in PREFILL_KINDS for s in self.steps[:-1]):
            self.start, self.end = t0, t0 + self.seconds
        if self.end is not None and t1 > self.end:
            raise WindowClosed
        for rid in rids:
            self.tokens.setdefault(rid, []).append(t1)

    def sample(self, t, **gauges):
        super().sample(t, **gauges)
        now = time.perf_counter()
        if self.end is not None and now > self.end:
            raise WindowClosed
        self.pool.append(PoolCount(now, *self._pool_counts()))

    # -- what the window holds ------------------------------------------

    def steps_in(self, lo: float, hi: float) -> List[Step]:
        return [s for s in self.steps if s.t0 >= lo and s.t1 <= hi]

    def tokens_in(self, start: float, end: float
                  ) -> Dict[int, List[float]]:
        """request -> the stamps of its tokens up to ``end``, for each
        request with a token in (``start``, ``end``]."""
        out = {rid: [t for t in ts if t <= end]
               for rid, ts in self.tokens.items()}
        return {rid: ts for rid, ts in out.items() if ts and ts[-1] > start}

    def first_tokens(self, start: float, end: float) -> Dict[int, float]:
        """request -> its first token's stamp, where that is in
        (``start``, ``end``]."""
        return {rid: ts[0] for rid, ts in self.tokens.items()
                if start < ts[0] <= end}

    def pool_in(self, start: float, end: float
                ) -> Tuple[PoolCount, PoolCount]:
        """The pool's counters at the last iteration that ended by
        ``start`` and at the last that ended by ``end``."""
        return ([p for p in self.pool if p.t <= start][-1],
                [p for p in self.pool if p.t <= end][-1])
