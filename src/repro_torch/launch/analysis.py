"""Cost analysis for the dry-run (``repro.launch.analysis``).

The reference walks a step's jaxpr: ``jaxpr_cost`` counts MXU flops
(dot_general), VPU flops (elementwise and reductions) and algorithmic
HBM bytes, recursing into scan bodies × their length, and
``parse_hlo_collectives`` reads the compiled per-device HLO for
collective bytes. The port has no program to walk; it runs the step
once and watches what is dispatched:

* ``step_cost`` runs ``fn`` under a ``TorchDispatchMode`` and counts
  every aten op it dispatches, with the reference's meanings and fusion
  model. There is no trip multiplier: the port runs its layers, groups
  and attention blocks as Python loops, so every executed op is
  dispatched and counted, which makes "scan-aware" automatic, and
  ``while_trip_estimate`` has no counterpart. Backward ops, recomputed
  ``torch.utils.checkpoint`` regions included, are dispatched too.
  On DTensor arguments the mode sees each op before DTensor splits it,
  so shapes, flops and bytes are global (pre-partitioning) counts, as
  the reference's jaxpr counts are.
* ``collective_bytes`` records the functional collectives DTensor issues
  while it redistributes (all-gather, reduce-scatter, all-reduce,
  all-to-all), per device, by their result bytes: what the reference
  reads off each collective's HLO result shape.

On a CPU mesh DTensor runs a shard-to-shard all-to-all as an all-gather
and a chunk (torch's gloo has no all-to-all). ``collective_bytes``
counts what DTensor asked for: while it records, that redistribution is
wrapped, counted once as an all-to-all of its result bytes, and the
all-gather inside it is not counted.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import L2_BYTES
from repro_torch.models.layers import repeat_scale

aten = torch.ops.aten

# data movement that is charged whatever its size (the reference's
# gather / scatter / dynamic_slice / dynamic_update_slice)
_MOVE_ALWAYS = {
    aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_,
    aten.gather, aten.scatter, aten.scatter_, aten.scatter_add,
    aten.scatter_add_, aten.index_select, aten.embedding, aten.index_add,
    aten.index_add_, aten.index_copy, aten.index_copy_, aten.take_along_dim,
    aten.slice_scatter, aten.select_scatter,
}
# copies and concatenations: charged like an elementwise op, no flops
# (the reference's other data-movement primitives)
_MOVE = {
    aten.clone, aten.copy_, aten.copy, aten._to_copy, aten.cat, aten.stack,
    aten.constant_pad_nd, aten.flip, aten.roll, aten.repeat,
    aten.expand_copy, aten.contiguous, aten.fill_, aten.zero_,
}
# reductions (cumulative and sorting ones included): one op per input
# element
_REDUCE = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.argmax, aten.argmin, aten.cumsum, aten.cumprod, aten.logsumexp,
    aten.sort, aten.topk, aten.var, aten.var_mean, aten.std, aten.prod,
    aten.any, aten.all, aten._softmax, aten._log_softmax, aten.norm,
    aten.linalg_vector_norm, aten._softmax_backward_data,
    aten._log_softmax_backward_data,
}


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    """Counts mxu/vpu flops and bytes of every op dispatched under it."""

    def __init__(self, n_chips: int, fused_cutoff: float) -> None:
        super().__init__()
        self.n_chips = n_chips
        self.cutoff = fused_cutoff
        self.total = {"mxu_flops": 0.0, "vpu_flops": 0.0, "bytes": 0.0}
        # tensors resident on chip (a fused op's small output): free
        # for their consumers
        self.fused = WeakIdKeyDictionary()

    def _charge_inputs(self, ins: List[torch.Tensor]) -> float:
        return float(sum(_bytes(t) for t in ins if t not in self.fused))

    def _emit(self, outs: List[torch.Tensor], always: bool = False) -> float:
        if not always and all(_bytes(t) / self.n_chips <= self.cutoff
                              for t in outs):
            for t in outs:
                self.fused[t] = True
            return 0.0
        for t in outs:
            self.fused.pop(t, None)
        return float(sum(_bytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            # a metadata query (a fake tensor's ``prim.device``): no data
            return out
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        # an op in an elided loop stands for every iteration
        # (``models.layers.repeats``)
        mult = repeat_scale()
        tot = self.total
        if packet in flop_registry:
            tot["mxu_flops"] += mult * flop_registry[packet](
                *args, **kwargs, out_val=out)
            tot["bytes"] += mult * (self._charge_inputs(ins)
                                    + self._emit(outs))
        elif func.is_view or not ins:
            # layout-only (views, factories): outputs inherit the inputs'
            # residency
            if all(t in self.fused for t in ins):
                for t in outs:
                    self.fused[t] = True
        elif packet in _MOVE_ALWAYS:
            tot["bytes"] += mult * (self._charge_inputs(ins)
                                    + self._emit(outs, True))
        elif packet in _MOVE:
            tot["bytes"] += mult * (self._charge_inputs(ins)
                                    + self._emit(outs))
        elif packet in _REDUCE:
            tot["vpu_flops"] += mult * sum(t.numel() for t in ins)
            tot["bytes"] += mult * (self._charge_inputs(ins)
                                    + self._emit(outs))
        else:
            # elementwise: one op per output element
            tot["vpu_flops"] += mult * sum(t.numel() for t in outs)
            tot["bytes"] += mult * (self._charge_inputs(ins)
                                    + self._emit(outs))
        return out


def step_cost(fn: Callable, *args: Any, n_chips: int = 1,
              fused_cutoff: float = L2_BYTES, **kwargs: Any
              ) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once and return {'flops', 'mxu_flops',
    'vpu_flops', 'bytes', 'out'}: ``mxu_flops`` 2·out·contract of every
    matmul (mm, bmm, addmm, baddbmm and what einsum and matmul lower to,
    through ``torch.utils.flop_counter``'s registry), ``vpu_flops`` one
    per output element of an elementwise op and one per input element of
    a reduction (cumsum and sort included), ``bytes`` the algorithmic
    HBM traffic, ``out`` what ``fn`` returned.

    Fusion model for bytes (the reference's): a value is charged when it
    moves, its bytes at each op that reads it; an op's outputs whose
    per-chip size (bytes / ``n_chips``) is at most ``fused_cutoff`` stay
    on chip (fused) and are free for their consumers. Views and factory
    ops are layout-only: their outputs inherit their inputs' residency.
    Gathers, scatters and indexed writes are always charged. The default
    cutoff is the H100's 50 MB L2; the reference's 32 MB is a TPU VMEM
    figure, so comparisons with it pass its cutoff explicitly.
    """
    mode = _CostMode(n_chips, fused_cutoff)
    with mode:
        out = fn(*args, **kwargs)
    total = dict(mode.total)
    total["flops"] = total["mxu_flops"] + total["vpu_flops"]
    total["out"] = out
    return total


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


class _CollectiveMode(TorchDispatchMode):
    """Records the collectives issued on local tensors under it; ops with
    DTensor arguments pass through (``NotImplemented``) so that DTensor
    runs first and its collectives reach this mode."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = {c: 0.0 for c in COLLECTIVES}
        self.count = 0
        self.muted = 0
        # bytes recorded within ``fallback_collectives``
        self.fallback = 0.0
        self.in_fallback = 0

    def record(self, kind: str, out: Any) -> None:
        if self.muted:
            return
        mult = repeat_scale()
        n = mult * sum(_bytes(t) for t in _tensors(out))
        self.bytes[kind] += n
        self.count += mult
        if self.in_fallback:
            self.fallback += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KIND.get(func._overloadpacket.__name__)
        if kind and func.namespace in _NAMESPACES:
            self.record(kind, out)
        return out


@contextlib.contextmanager
def _alltoall_as_asked(mode: _CollectiveMode) -> Iterator[None]:
    """Count DTensor's shard-to-shard redistribution as the all-to-all it
    asks for, whatever the CPU group runs in its place."""
    from torch.distributed.tensor import placement_types

    real = getattr(placement_types, "shard_dim_alltoall", None)
    if real is None:
        yield
        return

    def counted(*a: Any, **k: Any) -> torch.Tensor:
        mode.muted += 1
        try:
            out = real(*a, **k)
        finally:
            mode.muted -= 1
        mode.record("all-to-all", out)
        return out

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


_RECORDING: List[_CollectiveMode] = []


@contextlib.contextmanager
def fallback_collectives() -> Iterator[None]:
    """Collectives recorded within the block are also summed under
    ``fallback`` by every ``collective_bytes`` block open around it: the
    gathers a caller issues around an op DTensor cannot place, as
    against DTensor's own plan."""
    for mode in _RECORDING:
        mode.in_fallback += 1
    try:
        yield
    finally:
        for mode in _RECORDING:
            mode.in_fallback -= 1


@contextlib.contextmanager
def collective_bytes() -> Iterator[Dict[str, float]]:
    """Within the block, record collectives; the yielded dict is filled
    on exit with per-device result bytes under the reference's keys
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), ``count`` and ``total``, and ``fallback``:
    the part of ``total`` recorded within ``fallback_collectives``.
    Enter it before ``step_cost``'s mode (outside it), so both see one
    run."""
    result: Dict[str, float] = {}
    mode = _CollectiveMode()
    _RECORDING.append(mode)
    try:
        with mode, _alltoall_as_asked(mode):
            yield result
    finally:
        _RECORDING.remove(mode)
    result.update(mode.bytes)
    result["count"] = float(mode.count)
    result["total"] = sum(mode.bytes[c] for c in COLLECTIVES)
    result["fallback"] = mode.fallback

