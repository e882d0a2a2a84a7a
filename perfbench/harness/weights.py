"""Weights and the adapter bank, made from the seed on the device.

Both are inputs the harness hands to the program and to the reference
alike. The layout is the one the served model loads
(``Model.load_params``, which checks every path and shape): per pattern
slot ``p`` of ``period`` slots, stacked over ``n_layers / period``
groups, ``layers.slot{p}.{ln1, attn, ln2, mlp}``, beside ``embed``,
``final_norm`` and, untied, ``lm_head``.

Distributions (all drawn in one call per tensor group, in the served
dtype): each projection ``W [d_in, d_out]`` ~ N(0, 1/d_in), so a
unit-RMS input gives a unit-RMS output; ``embed`` and ``lm_head`` ~
N(0, 1/d_model), so the logits are ~N(0, 1); norm scales and biases ~
N(0, 0.1²). An adapter's ``A [r, d_in]`` ~ N(0, 1/r) and
``B [d_out, r]`` ~ N(0, sigma²) with ``sigma = delta_rms / (s *
sqrt(d_in))``: its delta ``s * u A^T B^T`` is ``delta_rms`` of its base
projection's RMS on any input (``s = alpha / rank``), large enough that
a request served with another adapter's weights fails the comparison.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

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


def _seed(seed: int, stream: int) -> int:
    """A torch seed for one stream of draws of ``seed``."""
    return (seed * 1_000_003 + stream) % (2 ** 63)


def param_layout(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                          float]]:
    """(path, shape, std) of every weight of the served model."""
    d, v, f = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    hd = head_dim(cfg)
    qs, kvs = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    period = len(cfg["attn"]["layer_pattern"])
    ng = cfg["n_layers"] // period
    out: List = [(("embed",), (v, d), d ** -0.5),
                 (("final_norm", "scale"), (d,), 0.1)]
    if not cfg["tie_embeddings"]:
        out.append((("lm_head",), (d, v), d ** -0.5))
    for p in range(period):
        s = ("layers", f"slot{p}")
        out += [(s + ("ln1", "scale"), (ng, d), 0.1),
                (s + ("attn", "wq"), (ng, d, qs), d ** -0.5),
                (s + ("attn", "wk"), (ng, d, kvs), d ** -0.5),
                (s + ("attn", "wv"), (ng, d, kvs), d ** -0.5),
                (s + ("attn", "wo"), (ng, qs, d), qs ** -0.5),
                (s + ("ln2", "scale"), (ng, d), 0.1),
                (s + ("mlp", "up"), (ng, d, f), d ** -0.5),
                (s + ("mlp", "down"), (ng, f, d), f ** -0.5)]
        if cfg["glu"]:
            out.append((s + ("mlp", "gate"), (ng, d, f), d ** -0.5))
        if cfg["attn"].get("qkv_bias"):
            out += [(s + ("attn", "bq"), (ng, qs), 0.1),
                    (s + ("attn", "bk"), (ng, kvs), 0.1),
                    (s + ("attn", "bv"), (ng, kvs), 0.1)]
    return out


def _put(tree: Dict, path: Tuple[str, ...], leaf: torch.Tensor) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


class Weights:
    """The served model's weights (``tree``), drawn on ``device`` in the
    served dtype: one flat buffer drawn in one call, each leaf a scaled
    view of it. ``fill`` draws another seed's weights in place."""

    def __init__(self, cfg: Dict, seed: int, device: Any) -> None:
        layout = param_layout(cfg)
        total = sum(math.prod(shape) for _, shape, _ in layout)
        self.flat = torch.empty(total, device=device,
                                dtype=_DTYPES[cfg["dtype"]])
        self.tree: Dict = {}
        self._scaled: List[Tuple[torch.Tensor, float]] = []
        at = 0
        for path, shape, std in layout:
            n = math.prod(shape)
            leaf = self.flat[at:at + n].view(shape)
            _put(self.tree, path, leaf)
            self._scaled.append((leaf, std))
            at += n
        self.fill(seed)

    def fill(self, seed: int) -> None:
        gen = torch.Generator(device=self.flat.device).manual_seed(
            _seed(seed, 1))
        self.flat.normal_(generator=gen)
        for leaf, std in self._scaled:
            leaf.mul_(std)


def lora_layout(cfg: Dict, delta_rms: float
                ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf of one adapter, in the pool's
    layout (``A [n_groups, r, d_in]``, ``B [n_groups, d_out, r]``)."""
    lora = cfg["lora"]
    r, s = lora["rank"], lora["alpha"] / lora["rank"]
    period = len(cfg["attn"]["layer_pattern"])
    ng = cfg["n_layers"] // period
    out = []
    for p in range(period):
        for m in lora["target_modules"]:
            if m == "gate" and not cfg["glu"]:
                continue
            d_in, d_out = LORA_DIMS[m](cfg)
            base = ("layers", f"slot{p}", m)
            out += [(base + ("A",), (ng, r, d_in), r ** -0.5),
                    (base + ("B",), (ng, d_out, r),
                     delta_rms / (s * math.sqrt(d_in)))]
    return out


class AdapterBank:
    """``size`` adapters drawn on the device from the seed, then held in
    pinned host memory. Tenant ``i`` is entry ``i mod size``. ``source``
    is the engine's ``adapter_source``: it returns the entry's host
    tensors, so every swap-in is a real host-to-device copy, and notes
    the moment each load starts (``loads``) while ``recording``."""

    def __init__(self, cfg: Dict, size: int, delta_rms: float, seed: int,
                 device: Any, pin: bool = True) -> None:
        self.size, self.device = size, device
        self.layout = lora_layout(cfg, delta_rms)
        self.per_entry = sum(math.prod(sh) for _, sh, _ in self.layout)
        self.host = torch.empty((size, self.per_entry), dtype=torch.float32,
                                pin_memory=pin)
        self.entries = [self._tree(self.host[i]) for i in range(size)]
        self.loads: List[Tuple[float, int]] = []
        self.recording = False
        self.fill(seed)

    def _tree(self, flat: torch.Tensor) -> Dict:
        tree: Dict = {}
        at = 0
        for path, shape, _ in self.layout:
            n = math.prod(shape)
            _put(tree, path, flat[at:at + n].view(shape))
            at += n
        return tree

    def fill(self, seed: int) -> None:
        """Draw ``seed``'s bank into the pinned buffer, one entry a call."""
        gen = torch.Generator(device=self.device).manual_seed(_seed(seed, 2))
        scale = torch.cat([torch.full((math.prod(sh),), std)
                           for _, sh, std in self.layout]).to(self.device)
        entry = torch.empty(self.per_entry, device=self.device)
        for i in range(self.size):
            entry.normal_(generator=gen)
            self.host[i].copy_(entry.mul_(scale))

    def source(self, tenant: int) -> Dict:
        if self.recording:
            self.loads.append((time.perf_counter(), tenant))
        return self.entries[tenant % self.size]

    def on_device(self, device: Any) -> List[Dict]:
        """Every entry as a tree of device tensors (the reference's copy)."""
        flat = self.host.to(device)
        return [self._tree(flat[i]) for i in range(self.size)]
