"""The one traffic generator: reads a traffic file's ``requests`` section
and draws the requests of a run from the seed.

Its arithmetic is a frozen copy of the program's synthetic workload
(``serving/workload.py``): tenants drawn from a power law, P(i) ∝
(i+1)^-alpha, prompt and output lengths uniform over closed ranges, and
prompt tokens uniform over the vocabulary. Two departures make runs of
different seeds do the same amount of work:

* Draws are stratified in blocks of ``block`` requests: each quantity's
  ``block`` quantiles, one from each of ``block`` equal strata, in an
  order the seed shuffles. Every block holds the same spread of lengths
  and tenants; the seed changes which request gets which, and the
  jitter within each stratum.
* Arrivals: every request is in the queue at the start of the window
  (an offline backlog that never empties while the window runs). No
  arrival process is offered: the engine admits on its virtual clock, so
  an open-loop schedule needs a wall-clock entry into the engine first.

Every request names its tenant's adapter, so the check knows each
request's adapter from the inputs alone.

Parameters (``requests`` section):
  block              requests per stratified block
  max_finish_per_s   an upper estimate of requests the window finishes
                     per second; a run draws twice that many
  prompt_len         [lo, hi] uniform, inclusive
  output_len         [lo, hi] uniform, inclusive
  tenants, alpha     the tenant count and the power-law exponent
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from repro_torch.core.slots import Request

SALT = 0x9E7F


def n_requests(spec: Dict, seconds: float) -> int:
    """Twice what the window can finish, in whole blocks."""
    block = spec["block"]
    want = 2 * spec["max_finish_per_s"] * seconds
    return block * max(1, math.ceil(want / block))


def _strata(rng: np.random.Generator, n: int) -> np.ndarray:
    """n quantiles in (0, 1), one in each of n equal strata, shuffled."""
    return (rng.permutation(n) + rng.random(n)) / n


def _uniform_int(q: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return lo + np.minimum((q * (hi - lo + 1)).astype(np.int64), hi - lo)


def tenant_cdf(tenants: int, alpha: float) -> np.ndarray:
    w = np.arange(1, tenants + 1, dtype=np.float64) ** (-alpha)
    return np.cumsum(w / w.sum())


def generate(spec: Dict, *, vocab_size: int, seed: int,
             count: int) -> List[Request]:
    rng = np.random.default_rng([seed, SALT])
    block = spec["block"]
    cdf = tenant_cdf(spec["tenants"], spec["alpha"])
    reqs: List[Request] = []
    for _ in range(-(-count // block)):
        plen = _uniform_int(_strata(rng, block), *spec["prompt_len"])
        olen = _uniform_int(_strata(rng, block), *spec["output_len"])
        tenant = np.minimum(np.searchsorted(cdf, _strata(rng, block),
                                            side="right"),
                            spec["tenants"] - 1)
        for i in range(block):
            rid = len(reqs)
            tokens = rng.integers(0, vocab_size, int(plen[i]),
                                  dtype=np.int32)
            reqs.append(Request(
                request_id=rid, arrival_time=0.0, prompt_len=int(plen[i]),
                output_len=int(olen[i]), adapter_id=int(tenant[i]),
                true_adapter=int(tenant[i]), prompt_tokens=tokens))
    return reqs[:count]
