"""Adaptive Adapter Selection (paper §3.2, Algorithm 1; §4.1).

Port of ``repro.core.router``: the cache-aware top-k selection and the
``OracleRouter`` workload stand-in. Both are host-side numpy and draw
from the same ``np.random.default_rng([seed, request_id])`` stream as the
reference, so scores are bit-identical. ``LearnedRouter`` (a base-model
forward plus a trained head) comes with the training slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.adapter_cache import AdapterMemoryManager
from repro_torch.core.slots import Request


def select_adapter(scores: np.ndarray, manager: AdapterMemoryManager,
                   top_k: int) -> tuple:
    """Algorithm 1, lines 8-14: cache-aware top-k selection.

    Returns (adapter_id, was_cached). ``scores``: [n_adapters].
    """
    order = np.argsort(-scores)
    top = order[:top_k]
    for a in top:
        if int(a) in manager:
            return int(a), True
    return int(top[0]), False


class OracleRouter:
    """Scores peaked at the true adapter; ``accuracy`` controls how often
    the argmax lands on it (models an imperfect learned router).

    Scores are a pure function of ``(seed, request_id)`` — NOT of call
    order, so scheduling changes never re-roll a selection.
    """

    def __init__(self, n_adapters: int, accuracy: float = 0.95,
                 seed: int = 0) -> None:
        self.n_adapters = n_adapters
        self.accuracy = accuracy
        self.seed = seed

    def scores(self, request: Request) -> np.ndarray:
        rng = np.random.default_rng([self.seed, request.request_id])
        s = rng.uniform(0.0, 0.5, self.n_adapters)
        true = request.true_adapter if request.true_adapter is not None else 0
        if rng.uniform() < self.accuracy:
            s[true] = 1.0
        else:
            s[rng.integers(self.n_adapters)] = 1.0
            s[true] = 0.9
        return s

    # Oracle scoring is bookkeeping only — no model forward.
    costs_forward = False
