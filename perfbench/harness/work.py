"""The work a window's requests need, counted from their real sizes: the
yardstick behind every roofline and MFU figure.

Formulas follow ``chip_smoke.py``'s bound arithmetic (bytes at the HBM
rate or operations at the bf16 peak, the larger), applied to what the
cell's own requests need: real rows and real prompt lengths, never the
bucket or power-of-two padding; each input byte read once and each
output byte written once. A later change that drops padding or fuses a
kernel does the same counted work in less time, so no share can pass
100 % unless the time leaves out part of the work.

* ``flash_prefill``, per layer and prefill step: each real row of prompt
  length L attends ``pairs(L)`` (query, key) pairs, 4·hd operations a
  pair and head (q·k and p·v); it reads q, k, v and writes o once.
* SGMV (``sgmv_shrink`` + ``sgmv_expand``, counted as one pair), per
  LoRA module, layer and step: T real tokens, n distinct adapters;
  2·T·r·(d_in + d_out) operations; x read and the delta written in the
  activation dtype, each distinct adapter's A and B read once as the
  pool stores them (f32).
* An expert layer (``moe_bound``), per MoE layer and step: T real
  tokens, each through top_k experts' (gated) MLP, 2·T·top_k·(3 or
  2)·d·f operations; each token's activation read and its output written
  once, and the weights of ``experts_read`` experts read once (at least
  top_k, at most min(E, T·top_k)).
* Model FLOPs of a step: 2 per weight per real token through every
  projection a layer holds (an MoE layer: its router, top_k experts and
  any shared expert) and each LoRA pair it carries, attention at the
  real context, and the head for the one position a row reads (prefill:
  the last prompt token; decode: the new token).

Layers are counted one by one, each as the program builds its pattern
slot (``transformer.slot_is_moe``: an MoE block on the last of every
``moe_layer_period`` layers; ``init_lora_stack``: an MoE slot carries
MLP LoRA pairs only on a shared expert).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench.harness.recorder import DECODE_KINDS, PREFILL_KINDS, Step

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"
ACT_BYTES = 2     # bf16 activations
WEIGHT_BYTES = 2  # bf16 weights
POOL_BYTES = 4    # the adapter pool's f32

MLP_MODULES = ("up", "gate", "down")
LORA_DIMS = {
    "q": lambda c: (c["d_model"], c["n_heads"] * head_dim(c)),
    "k": lambda c: (c["d_model"], c["n_kv_heads"] * head_dim(c)),
    "v": lambda c: (c["d_model"], c["n_kv_heads"] * head_dim(c)),
    "o": lambda c: (c["n_heads"] * head_dim(c), c["d_model"]),
    "up": lambda c: (c["d_model"], c["d_ff"]),
    "gate": lambda c: (c["d_model"], c["d_ff"]),
    "down": lambda c: (c["d_ff"], c["d_model"]),
}


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def peaks(kind: str) -> Optional[Dict]:
    """The device's published peaks, or None for a device not listed."""
    return json.loads(PEAKS.read_text()).get(kind)


def pairs(length: int, window: Optional[int]) -> int:
    """Causal (query, key) pairs of a prompt of ``length``, at most
    ``window`` keys a query."""
    if window is None or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


@dataclass
class Row:
    """One real row of a step: its new tokens and the keys each sees."""
    tenant: int
    tokens: int           # positions computed (prefill: the prompt)
    start: int            # position of the first of them


@dataclass
class Bound:
    flops: float = 0.0
    bytes: float = 0.0
    seconds: float = 0.0  # sum over calls of max(operations, bytes) time

    def add(self, flops: float, nbytes: float, pk: Dict) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.seconds += max(flops / pk["bf16_flops_per_s"],
                            nbytes / pk["hbm_bytes_per_s"])


def _windows(cfg: Dict) -> List[Optional[int]]:
    pat = cfg["attn"]["layer_pattern"]
    w = cfg["attn"]["sliding_window"]
    return [w if pat[i % len(pat)] == "local" else None
            for i in range(cfg["n_layers"])]


def _row_pairs(row: Row, window: Optional[int]) -> int:
    """Pairs the row's new positions see: all keys up to each one."""
    end = row.start + row.tokens
    return pairs(end, window) - pairs(row.start, window)


def is_moe(cfg: Dict, layer: int) -> bool:
    """Layer ``layer`` holds an MoE block."""
    moe = cfg.get("moe")
    if not moe:
        return False
    period = moe.get("moe_layer_period", 1)
    return layer % period == period - 1


def _mlp_params(cfg: Dict) -> int:
    """One (gated) MLP of width ``d_ff``: a dense layer's or an expert's."""
    return (3 if cfg["glu"] else 2) * cfg["d_model"] * cfg["d_ff"]


def lora_names(cfg: Dict, layer: int = 0) -> List[str]:
    """The LoRA modules layer ``layer`` carries, in ``target_modules``
    order: no gate without a gated MLP, no MLP pair on an MoE layer
    without a shared expert."""
    bare = is_moe(cfg, layer) and not cfg["moe"].get("shared_expert")
    return [m for m in cfg["lora"]["target_modules"]
            if (m != "gate" or cfg["glu"])
            and not (bare and m in MLP_MODULES)]


def lora_modules(cfg: Dict, layer: int = 0) -> List[Tuple[int, int]]:
    """(d_in, d_out) of each LoRA pair layer ``layer`` carries."""
    return [LORA_DIMS[m](cfg) for m in lora_names(cfg, layer)]


def linear_params(cfg: Dict, layer: int = 0) -> int:
    """Weights a token passes through in layer ``layer``: attention, then
    the dense MLP, or the router, top_k experts and any shared expert."""
    d, hd = cfg["d_model"], head_dim(cfg)
    qs, kvs = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    attn = d * (qs + 2 * kvs) + qs * d
    if not is_moe(cfg, layer):
        return attn + _mlp_params(cfg)
    moe = cfg["moe"]
    return (attn + d * moe["n_experts"] + moe["top_k"] * _mlp_params(cfg)
            + (_mlp_params(cfg) if moe.get("shared_expert") else 0))


def flash_prefill_bound(cfg: Dict, rows: Sequence[Row], pk: Dict,
                        out: Bound) -> None:
    """Adds one prefill step's attention calls, one per layer."""
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    for window in _windows(cfg):
        flops = sum(4 * h * hd * _row_pairs(r, window) for r in rows)
        nbytes = sum(r.tokens for r in rows) * (2 * h + 2 * kh) * hd \
            * ACT_BYTES
        out.add(flops, nbytes, pk)


def sgmv_bound(cfg: Dict, rows: Sequence[Row], pk: Dict,
               out: Bound) -> None:
    """Adds one step's SGMV pairs, one per LoRA module and layer that
    carries it."""
    t = sum(r.tokens for r in rows)
    n = len({r.tenant for r in rows})
    rank = cfg["lora"]["rank"]
    carried = [lora_names(cfg, i) for i in range(cfg["n_layers"])]
    for m in cfg["lora"]["target_modules"]:
        d_in, d_out = LORA_DIMS[m](cfg)
        flops = 2 * t * rank * (d_in + d_out)
        nbytes = t * (d_in + d_out) * ACT_BYTES \
            + n * rank * (d_in + d_out) * POOL_BYTES
        for _ in range(sum(m in names for names in carried)):
            out.add(flops, nbytes, pk)


def moe_bound(cfg: Dict, rows: Sequence[Row], pk: Dict, out: Bound,
              experts_read: Optional[int] = None) -> None:
    """Adds one step's expert layers, one call per MoE layer: the step's
    real tokens through their top_k experts. ``experts_read`` experts'
    weights are read: by default top_k, the least any routing reads, and
    never fewer, nor more than min(E, T·top_k), so no share passes 100 %
    for want of a routing count."""
    moe = cfg["moe"]
    t = sum(r.tokens for r in rows)
    k, e = moe["top_k"], moe["n_experts"]
    read = min(e, t * k, max(k, experts_read or k))
    flops = 2 * t * k * _mlp_params(cfg)
    nbytes = 2 * t * cfg["d_model"] * ACT_BYTES \
        + read * _mlp_params(cfg) * WEIGHT_BYTES
    for i in range(cfg["n_layers"]):
        if is_moe(cfg, i):
            out.add(flops, nbytes, pk)


def model_flops(cfg: Dict, rows: Sequence[Row]) -> float:
    """Useful FLOPs of one step over its real rows."""
    h, hd = cfg["n_heads"], head_dim(cfg)
    rank = cfg["lora"]["rank"]
    per_token = sum(2 * linear_params(cfg, i)
                    + sum(2 * rank * (a + b) for a, b in lora_modules(cfg, i))
                    for i in range(cfg["n_layers"]))
    total = 0.0
    for r in rows:
        total += r.tokens * per_token
        total += sum(4 * h * hd * _row_pairs(r, w) for w in _windows(cfg))
        total += 2 * cfg["d_model"] * cfg["vocab_size"]
    return total


def step_rows(steps: Iterable[Step], requests: Dict) -> List[
        Tuple[Step, List[Row]]]:
    """Each prefill or decode step with its real rows. A prefill row
    computes the whole prompt; a decode row its one new position, after
    the prompt and the tokens the request already had."""
    had: Dict[int, int] = {}
    out = []
    for s in steps:
        rows = []
        for rid in s.requests:
            req = requests[rid]
            if s.kind in PREFILL_KINDS:
                rows.append(Row(req.adapter_id, req.prompt_len, 0))
                had[rid] = 1
            elif s.kind in DECODE_KINDS:
                n = had.get(rid, 1)
                rows.append(Row(req.adapter_id, 1, req.prompt_len + n - 1))
                had[rid] = n + 1
        out.append((s, rows))
    return out
