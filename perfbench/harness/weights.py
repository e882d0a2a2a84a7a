"""Weights and the adapter bank, made from the seed on the device.

Both are inputs the harness hands to the program and to the reference
alike. The layout is the one the served model loads
(``Model.load_params``, which checks every path and shape): ``embed``,
``final_norm`` and, untied, ``lm_head``, beside the program's own stack
(``transformer.init_stack``, built on the meta device): per pattern slot
``p`` of the stack's period, stacked over its groups,
``layers.slot{p}.{ln1, attn, ln2}`` and either ``mlp`` or ``moe``
(``router`` and ``experts.{up, gate, down}``, stacked over the experts).
A slot's leaves are drawn in the order ``SLOT_ORDER`` gives, then its
others in the program's tree order, so a dense slot draws what it always
drew. An adapter's pairs are the ones the program's ``init_lora_stack``
gives each slot: an MoE slot without a shared expert carries no MLP pair.

Distributions (all drawn in one call per dtype, each leaf in the dtype
the program's tree gives it: the served dtype, the router f32): each
projection ``W [..., d_in, d_out]`` (the router and the stacked experts
included) ~ N(0, 1/d_in), so a unit-RMS input gives a unit-RMS output;
``embed`` and ``lm_head`` ~ N(0, 1/d_model), so the logits are ~N(0, 1);
norm scales and biases ~ N(0, 0.1²). A leaf no rule covers raises. An
adapter's ``A [r, d_in]`` ~ N(0, 1/r) and ``B [d_out, r]`` ~ N(0,
sigma²) with ``sigma = delta_rms / (s * sqrt(d_in))``: its delta ``s * u
A^T B^T`` is ``delta_rms`` of its base projection's RMS on any input
(``s = alpha / rank``), large enough that a request served with another
adapter's weights fails the comparison.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch

from perfbench.harness import spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# The order of a dense slot's leaves; a slot's other leaves follow them.
SLOT_ORDER = (("ln1", "scale"), ("attn", "wq"), ("attn", "wk"),
              ("attn", "wv"), ("attn", "wo"), ("ln2", "scale"),
              ("mlp", "up"), ("mlp", "down"), ("mlp", "gate"),
              ("attn", "bq"), ("attn", "bk"), ("attn", "bv"))
PROJECTIONS = ("wq", "wk", "wv", "wo", "up", "gate", "down", "router")
VECTORS = ("scale", "bq", "bk", "bv")

KeyPath = Tuple[str, ...]
Leaf = Tuple[KeyPath, Tuple[int, ...], float, torch.dtype]


def _seed(seed: int, stream: int) -> int:
    """A torch seed for one stream of draws of ``seed``."""
    return (seed * 1_000_003 + stream) % (2 ** 63)


def _leaves(tree: Dict, path: KeyPath = ()) -> Iterator[Tuple[KeyPath, Any]]:
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, path + (key,))
        else:
            yield path + (key,), node


def _std(path: KeyPath, shape: Tuple[int, ...]) -> float:
    if path[-1] in PROJECTIONS:
        return shape[-2] ** -0.5
    if path[-1] in VECTORS:
        return 0.1
    raise NotImplementedError(
        f"no distribution for the program's leaf {'.'.join(path)} "
        f"{list(shape)}: the harness draws projections {PROJECTIONS} and "
        f"vectors {VECTORS} only")


def _blocks(tree: Dict) -> Iterator[Tuple[KeyPath, Dict]]:
    """Each pattern slot of a stack tree, then any block beside them."""
    for name, slot in tree["layers"].items():
        yield ("layers", name), slot
    for name, block in tree.items():
        if name != "layers":
            yield (name,), block


def _layout(cfg: Dict) -> List[Leaf]:
    from repro_torch.models import transformer
    d, v = cfg["d_model"], cfg["vocab_size"]
    dt = _DTYPES[cfg["dtype"]]
    out: List[Leaf] = [(("embed",), (v, d), d ** -0.5, dt),
                       (("final_norm", "scale"), (d,), 0.1, dt)]
    if not cfg["tie_embeddings"]:
        out.append((("lm_head",), (d, v), d ** -0.5, dt))
    stack = transformer.init_stack(None, spec.program_config(cfg), dt)
    for base, block in _blocks(stack):
        leaves = dict(_leaves(block))
        order = [k for k in SLOT_ORDER if k in leaves]
        order += [k for k in leaves if k not in order]
        for key in order:
            shape = tuple(leaves[key].shape)
            out.append((base + key, shape, _std(base + key, shape),
                        leaves[key].dtype))
    return out


def param_layout(cfg: Dict) -> List[Tuple[KeyPath, Tuple[int, ...], float]]:
    """(path, shape, std) of every weight of the served model."""
    return [(path, shape, std) for path, shape, std, _ in _layout(cfg)]


def _put(tree: Dict, path: KeyPath, leaf: torch.Tensor) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


class Weights:
    """The served model's weights (``tree``), drawn on ``device``: one
    flat buffer per dtype, the served dtype's first, each drawn in one
    call and each leaf a scaled view of it. ``fill`` draws another
    seed's weights in place."""

    def __init__(self, cfg: Dict, seed: int, device: Any) -> None:
        layout = _layout(cfg)
        dtypes = list(dict.fromkeys([_DTYPES[cfg["dtype"]]]
                                    + [dt for *_, dt in layout]))
        self.tree: Dict = {}
        self._parts: List[Tuple[torch.Tensor,
                                List[Tuple[torch.Tensor, float]]]] = []
        for dt in dtypes:
            part = [leaf for leaf in layout if leaf[3] == dt]
            flat = torch.empty(sum(math.prod(sh) for _, sh, _, _ in part),
                               device=device, dtype=dt)
            scaled, at = [], 0
            for path, shape, std, _ in part:
                n = math.prod(shape)
                leaf = flat[at:at + n].view(shape)
                _put(self.tree, path, leaf)
                scaled.append((leaf, std))
                at += n
            self._parts.append((flat, scaled))
        self.fill(seed)

    def fill(self, seed: int) -> None:
        """Streams: 1 for the served dtype's buffer (2 is the bank's),
        3, 4, ... for the others'."""
        for i, (flat, scaled) in enumerate(self._parts):
            if not flat.numel():
                continue
            gen = torch.Generator(device=flat.device).manual_seed(
                _seed(seed, 1 if i == 0 else 2 + i))
            flat.normal_(generator=gen)
            for leaf, std in scaled:
                leaf.mul_(std)


def _lora_shapes(cfg: Dict) -> Dict[KeyPath, Dict[str, Tuple[Tuple[int, ...],
                                                        ...]]]:
    """Per block of the program's LoRA tree for one adapter, the (A, B)
    shapes of each module it carries: ``init_lora_stack`` run on the CPU
    at rank 1, which allocates little, with the rank put back on A's
    axis -2 and B's axis -1."""
    from repro_torch.models import transformer
    mc = spec.program_config(cfg)
    r = mc.lora.rank
    tree = transformer.init_lora_stack(
        torch.Generator(),
        dataclasses.replace(mc, lora=dataclasses.replace(mc.lora, rank=1)))
    return {base: {m: ((*p["A"].shape[:-2], r, p["A"].shape[-1]),
                       (*p["B"].shape[:-1], r))
                   for m, p in block.items()}
            for base, block in _blocks(tree)}


def lora_layout(cfg: Dict, delta_rms: float
                ) -> List[Tuple[KeyPath, Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf of one adapter, in the pool's
    layout (``A [n_groups, r, d_in]``, ``B [n_groups, d_out, r]``), each
    block's modules in the order of ``target_modules``."""
    lora = cfg["lora"]
    r, s = lora["rank"], lora["alpha"] / lora["rank"]
    out = []
    for base, mods in _lora_shapes(cfg).items():
        for m in lora["target_modules"]:
            if m not in mods:
                continue
            a, b = mods[m]
            out += [(base + (m, "A"), a, r ** -0.5),
                    (base + (m, "B"), b,
                     delta_rms / (s * math.sqrt(a[-1])))]
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
