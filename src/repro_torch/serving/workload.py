"""Synthetic workload traces (paper §5.1).

Arrivals follow a Gamma renewal process with shape 1/cv² and scale cv²/R —
cv=1 is Poisson, cv>1 bursty. The optimal adapter for each request is
drawn from a power-law over adapters, P(i) ∝ i^(−α): lower α concentrates
traffic (high locality). Input/output lengths are uniform in [Il, Iu] /
[Ol, Ou]. All parameters mirror the paper's Table 3 defaults.

Multi-tenant system prompts: with ``system_prompt_len > 0`` every adapter
gets its own fixed system prompt (drawn once per adapter from a dedicated
stream), and a ``shared_prefix_frac`` fraction of each adapter's requests
open with it before their unique tail — the repeated per-tenant prefix
the shared-prefix KV cache (``serving/prefix_cache.py``) exploits.

Mixed-SLO tenants: with ``interactive_frac > 0`` that fraction of
requests is tagged interactive — ``priority=0`` plus the configured
``ttft_slo``/``tpot_slo`` deadlines — while the rest become
``priority=1`` batch traffic. With ``long_prompt_frac > 0`` that
fraction of requests extends its unique tail by a draw from
``long_input_range`` (the heavy-tailed prompt mix that makes chunked
prefill matter).

RNG-stream guarantees (the bit-identical regression tests rely on
these): the *main* stream (``default_rng(seed)``) draws, per request and
in this exact order — inter-arrival gamma, adapter choice, input length,
output length, explicit-adapter uniform, tail tokens, and (only when
``system_prompt_len > 0``) the shared-prefix uniform. Every optional
knob added since draws from its own dedicated stream
(``default_rng([seed, salt])``): system prompts 0xED6E, the SLO class
0x510, long-prompt extension 0x7A11. Turning any of these knobs on or
off therefore never shifts the main stream — a trace generated with
``interactive_frac=0.3`` has byte-identical arrival times, adapters,
output lengths, and base prompts to the same-seed trace with the knob
off; only the added fields/tokens differ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.slots import Request


@dataclass(frozen=True)
class WorkloadConfig:
    n_adapters: int = 20          # n
    alpha: float = 1.0            # power-law exponent (locality)
    request_rate: float = 0.5     # R (req/s)
    cv: float = 1.0               # burstiness
    duration: float = 300.0       # trace length (s); paper default 5 min
    input_range: Tuple[int, int] = (8, 256)     # [Il, Iu] (unique tail)
    output_range: Tuple[int, int] = (8, 128)    # [Ol, Ou]
    # fraction of requests that explicitly pin an adapter (bypass AAS)
    explicit_adapter_frac: float = 0.0
    # per-adapter shared system prompt: requests open with their
    # adapter's fixed system_prompt_len tokens (before the unique tail
    # drawn from input_range); shared_prefix_frac of each adapter's
    # requests carry it (the rest are prefix-cold)
    system_prompt_len: int = 0
    shared_prefix_frac: float = 1.0
    # mixed-SLO tenant classes: this fraction of requests is tagged
    # interactive — priority 0 (admits ahead of batch traffic) with the
    # deadlines below; the rest become priority-1 batch requests with no
    # deadline. 0.0 (default) leaves every request priority 0 / SLO-free
    # — the pre-SLO trace, byte-identical (dedicated stream 0x510).
    interactive_frac: float = 0.0
    interactive_ttft_slo: float = 2.0      # arrival→first-token deadline (s)
    interactive_tpot_slo: Optional[float] = None  # per-decode-token SLO (s)
    # heavy-tailed prompt mix: this fraction of requests appends a
    # long_input_range draw of extra unique-tail tokens (dedicated
    # stream 0x7A11 — base prompts of the other requests are unchanged)
    long_prompt_frac: float = 0.0
    long_input_range: Tuple[int, int] = (256, 512)
    vocab_size: int = 512
    seed: int = 0

    def __post_init__(self) -> None:
        il, iu = self.input_range
        ol, ou = self.output_range
        if not (0 < il <= iu):
            raise ValueError(f"input_range must satisfy 0 < Il <= Iu, "
                             f"got {self.input_range}")
        if not (0 < ol <= ou):
            raise ValueError(f"output_range must satisfy 0 < Ol <= Ou, "
                             f"got {self.output_range}")
        if not self.request_rate > 0:
            raise ValueError(f"request_rate must be > 0, "
                             f"got {self.request_rate}")
        if not self.cv > 0:
            raise ValueError(f"cv must be > 0, got {self.cv}")
        if not self.n_adapters > 0:
            raise ValueError(f"n_adapters must be > 0, "
                             f"got {self.n_adapters}")
        if self.system_prompt_len < 0:
            raise ValueError(f"system_prompt_len must be >= 0, "
                             f"got {self.system_prompt_len}")
        if not 0.0 <= self.shared_prefix_frac <= 1.0:
            raise ValueError(f"shared_prefix_frac must be in [0, 1], "
                             f"got {self.shared_prefix_frac}")
        if not 0.0 <= self.interactive_frac <= 1.0:
            raise ValueError(f"interactive_frac must be in [0, 1], "
                             f"got {self.interactive_frac}")
        if not self.interactive_ttft_slo > 0:
            raise ValueError(f"interactive_ttft_slo must be > 0, "
                             f"got {self.interactive_ttft_slo}")
        if self.interactive_tpot_slo is not None \
                and not self.interactive_tpot_slo > 0:
            raise ValueError(f"interactive_tpot_slo must be > 0, "
                             f"got {self.interactive_tpot_slo}")
        if not 0.0 <= self.long_prompt_frac <= 1.0:
            raise ValueError(f"long_prompt_frac must be in [0, 1], "
                             f"got {self.long_prompt_frac}")
        llo, lhi = self.long_input_range
        if not (0 < llo <= lhi):
            raise ValueError(f"long_input_range must satisfy 0 < lo <= hi, "
                             f"got {self.long_input_range}")


def adapter_popularity(n: int, alpha: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    return w / w.sum()


# RNG stream salts (EL005): each optional draw consumer gets its own
# `default_rng([seed, SALT])` stream so enabling one knob never shifts
# the values another stream produces. Salts must stay distinct — the
# linter cross-checks every constant salt in serving/core.
SALT_SYSTEM_PROMPTS = 0xED6E
SALT_SLO_CLASSES = 0x510
SALT_LONG_PROMPTS = 0x7A11


def system_prompts(cfg: WorkloadConfig) -> Dict[int, np.ndarray]:
    """The per-adapter system prompts a trace opens its requests with
    (deterministic in (seed, adapter) — a dedicated stream, so changing
    trace-length knobs never reshuffles tenant prompts)."""
    if cfg.system_prompt_len <= 0:
        return {}
    srng = np.random.default_rng([cfg.seed, SALT_SYSTEM_PROMPTS])
    return {i: srng.integers(0, cfg.vocab_size, cfg.system_prompt_len,
                             dtype=np.int32)
            for i in range(cfg.n_adapters)}


def generate_trace(cfg: WorkloadConfig) -> List[Request]:
    """Draw one trace. See the module docstring for the per-stream draw
    order — optional knobs (system prompts, SLO classes, long prompts)
    use dedicated streams so enabling them never perturbs the main one."""
    # el: allow[rng-stream] -- the historical whole-trace main stream:
    # salting it now would shift every existing golden trace
    rng = np.random.default_rng(cfg.seed)  # el: allow[rng-stream] -- golden traces
    probs = adapter_popularity(cfg.n_adapters, cfg.alpha)
    shape = 1.0 / (cfg.cv ** 2)
    scale = cfg.cv ** 2 / cfg.request_rate
    sys_prompts = system_prompts(cfg)
    slo_rng = (np.random.default_rng([cfg.seed, SALT_SLO_CLASSES])
               if cfg.interactive_frac > 0 else None)
    long_rng = (np.random.default_rng([cfg.seed, SALT_LONG_PROMPTS])
                if cfg.long_prompt_frac > 0 else None)

    reqs: List[Request] = []
    t = 0.0
    rid = 0
    while True:
        t += rng.gamma(shape, scale)
        if t > cfg.duration:
            break
        adapter = int(rng.choice(cfg.n_adapters, p=probs))
        il, iu = cfg.input_range
        ol, ou = cfg.output_range
        plen = int(rng.integers(il, iu + 1))
        olen = int(rng.integers(ol, ou + 1))
        explicit = rng.uniform() < cfg.explicit_adapter_frac
        tokens = rng.integers(0, cfg.vocab_size, plen, dtype=np.int32)
        if long_rng is not None \
                and long_rng.uniform() < cfg.long_prompt_frac:
            llo, lhi = cfg.long_input_range
            extra = int(long_rng.integers(llo, lhi + 1))
            tokens = np.concatenate([tokens, long_rng.integers(
                0, cfg.vocab_size, extra, dtype=np.int32)])
            plen += extra
        if sys_prompts and rng.uniform() < cfg.shared_prefix_frac:
            tokens = np.concatenate([sys_prompts[adapter], tokens])
            plen += cfg.system_prompt_len
        priority, ttft_slo, tpot_slo = 0, None, None
        if slo_rng is not None:
            if slo_rng.uniform() < cfg.interactive_frac:
                ttft_slo = cfg.interactive_ttft_slo
                tpot_slo = cfg.interactive_tpot_slo
            else:
                priority = 1  # batch class yields to interactive traffic
        reqs.append(Request(
            request_id=rid,
            arrival_time=t,
            prompt_len=plen,
            output_len=olen,
            adapter_id=adapter if explicit else None,
            true_adapter=adapter,
            prompt_tokens=tokens,
            priority=priority,
            ttft_slo=ttft_slo,
            tpot_slo=tpot_slo,
        ))
        rid += 1
    return reqs
