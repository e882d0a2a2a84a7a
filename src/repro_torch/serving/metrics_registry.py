"""Lightweight metrics registry: counters, gauges, and power-of-two
histograms, sampled into time series on the engine's virtual clock.

This is the in-process analogue of a Prometheus client: the engine (via
``serving/trace.py``) sets gauges once per scheduler step — queue depth,
active slots, arena blocks in use, resident/loading adapters, decode
batch occupancy — and ``MetricsRegistry.sample(t)`` snapshots every
metric's current value into its series. The exporter turns each series
into a Perfetto counter track, so arena pressure and queue depth are
visible *on the same timeline* as the slot/channel spans.

Sampling the same virtual timestamp twice keeps only the latest
snapshot (scheduler iterations that charge no compute do not advance
the clock, and duplicate points at one ``t`` would draw as a vertical
smear in Perfetto).

The registry is engine-agnostic and framework-free (a copy of
``repro.serving.metrics_registry``): it can be unit-tested and
reused by any component that wants cheap time-series accounting.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple, Type, TypeVar, Union

Number = Union[int, float]
_M = TypeVar("_M", "Counter", "Gauge", "Histogram")


class Counter:
    """Monotonically increasing count (``inc`` only)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Point-in-time value (``set`` to anything)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Power-of-two-bucketed histogram (the step-time-histogram shape
    the engine already uses): ``observe(v)`` bins ``v`` by
    ``2**ceil(log2(v))`` with a bottom bucket for tiny values. The
    sampled series value is the observation *count*; the bucket map is
    available via :meth:`snapshot`."""

    __slots__ = ("name", "bins", "count", "total")

    def __init__(self, name: str) -> None:
        self.name = name
        self.bins: Dict[str, int] = {}
        self.count = 0
        self.total = 0.0

    def observe(self, v: Number) -> None:
        self.count += 1
        self.total += v
        if v <= 0.125:
            key = "le_0.125"
        else:
            key = f"le_{2.0 ** math.ceil(math.log2(v)):g}"
        self.bins[key] = self.bins.get(key, 0) + 1

    @property
    def value(self) -> float:  # sampled series value
        return self.count

    def snapshot(self) -> Dict[str, int]:
        return dict(self.bins)


class MetricsRegistry:
    """Named metrics + their sampled time series.

    ``counter``/``gauge``/``histogram`` get-or-create by name (a name is
    bound to one metric type for the registry's lifetime);
    ``sample(t)`` appends ``(t, value)`` to every metric's series,
    replacing the last point when ``t`` repeats.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}
        self.series: Dict[str, List[Tuple[float, float]]] = {}

    def _get(self, name: str, cls: Type[_M]) -> _M:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
            self.series[name] = []
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def sample(self, t: float) -> None:
        for name, metric in self._metrics.items():
            series = self.series[name]
            point = (float(t), float(metric.value))
            if series and series[-1][0] == point[0]:
                series[-1] = point
            else:
                series.append(point)

    def as_dict(self) -> Dict[str, List[List[float]]]:
        """Series as plain lists (JSON-ready)."""
        return {k: [list(p) for p in v] for k, v in self.series.items()}
