"""Logical-axis sharding on DTensor (``repro.distributed.sharding``).

Model code annotates activations with *logical* axis names through
``logical_constraint(x, 'batch', 'seq', None)``; parameters get logical
axes from the path rules of ``param_specs``. A mesh maps logical names to
mesh axes with divisibility checks: a rule that does not divide the
dimension is dropped rather than raising (kv_heads 8 on a model axis of
16 falls back to replicated heads).

The rules, ``spec_for`` and ``_leaf_spec`` are the reference's and are
pure Python over any mesh that names its axes: a ``DeviceMesh`` (its
``mesh_dim_names`` and sizes) or any object whose ``shape`` maps axis
names to sizes (the reference's tests pass such a ``FakeMesh``). A spec
is a ``PartitionSpec``, a tuple whose entries are ``None``, an axis name
or a tuple of names, so it compares with the reference's by
``tuple(spec)``. ``placements_for`` turns a spec into DTensor placements
for a ``DeviceMesh``, and ``distribute_tree`` places a tree of tensors.

Outside a mesh, or on a tensor that is not a DTensor, everything here is
the identity and runs no tensor op, so the same model code runs on one
card (with the same launches and host syncs) and in the dry-run over a
256- or 512-rank mesh.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# logical axis -> physical mesh axis (or tuple of axes). The 'pod' axis
# extends data parallelism so pod-crossing traffic is batch-only.
LOGICAL_RULES: Dict[str, Union[str, Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,            # sequence kept unsharded by default (see §Perf)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert": "model",
    "embed": None,           # d_model replicated by default (Megatron TP)
    "ssm_heads": "model",
    "ssm_inner": "model",
    "fsdp": "data",         # weight sharding over data (ZeRO-3 / 2D TP)
    "head_dim": "model",    # KV-cache fallback when kv_heads < model axis
    # §Perf lever: shard the KV cache on its SEQUENCE dim instead —
    # distributed flash-decode: per-shard partial softmax + tiny psums
    # instead of all-reducing [B, H, C] scores. Off by default; enable
    # with rules_patch={'kv_seq': 'model'}.
    "kv_seq": None,
}


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple
    of names (sharded over their product, in mesh order)."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class _MeshState(threading.local):
    def __init__(self) -> None:
        self.mesh: Any = None
        self.rules: Dict[str, Any] = dict(LOGICAL_RULES)


_STATE = _MeshState()


def set_mesh(mesh: Any, rules: Optional[Dict[str, Any]] = None) -> None:
    _STATE.mesh = mesh
    _STATE.rules = dict(LOGICAL_RULES if rules is None else rules)


@contextlib.contextmanager
def use_mesh(mesh: Any, rules: Optional[Dict[str, Any]] = None):
    prev = (_STATE.mesh, _STATE.rules)
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def mesh_axes(mesh: Any) -> Mapping[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s named dims, else ``mesh.shape``
    (a mapping, as the reference's meshes have)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return mesh.shape


def _axis_size(mesh: Any, phys: Union[str, Tuple[str, ...], None]) -> int:
    if phys is None:
        return 1
    if isinstance(phys, str):
        phys = (phys,)
    axes = mesh_axes(mesh)
    n = 1
    for p in phys:
        if p in axes:
            n *= axes[p]
        else:
            return 0  # physical axis absent from this mesh -> unusable rule
    return n


def _resolve(mesh: Any, rules: Dict[str, Any], logical: Optional[str],
             dim: int) -> Optional[Union[str, Tuple[str, ...]]]:
    """Map one logical axis to mesh axes, dropping non-dividing rules."""
    if logical is None:
        return None
    phys = rules.get(logical)
    if phys is None:
        return None
    axes = mesh_axes(mesh)
    size = _axis_size(mesh, phys)
    if size == 0:
        # drop axes that aren't in the mesh (e.g. 'pod' on single-pod)
        if isinstance(phys, tuple):
            phys = tuple(p for p in phys if p in axes)
            if not phys:
                return None
            size = _axis_size(mesh, phys)
        else:
            return None
    if size == 0 or dim % size != 0:
        # try progressively smaller prefixes of a tuple rule
        if isinstance(phys, tuple) and len(phys) > 1:
            for cut in range(len(phys) - 1, 0, -1):
                sub = phys[:cut]
                s = _axis_size(mesh, sub)
                if s and dim % s == 0:
                    return sub if len(sub) > 1 else sub[0]
        return None
    if isinstance(phys, tuple) and len(phys) == 1:
        return phys[0]  # ('data',) and 'data' shard identically; normalize
    return phys


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh: Any = None,
             rules: Optional[Dict[str, Any]] = None) -> PartitionSpec:
    mesh = mesh or _STATE.mesh
    rules = rules or _STATE.rules
    if mesh is None:
        return P()
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"logical axes {tuple(logical_axes)}")
    used: set = set()
    parts = []
    for dim, logical in zip(shape, logical_axes):
        phys = _resolve(mesh, rules, logical, dim)
        # each mesh axis may appear at most once in a spec
        flat = (phys,) if isinstance(phys, str) else (phys or ())
        if phys is not None and not any(f in used for f in flat):
            used.update(flat)
            parts.append(phys)
        else:
            parts.append(None)
    return P(*parts)


def placements_for(spec: Sequence[Any], mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: a tensor dim
    sharded on a tuple of axes is ``Shard(dim)`` on each of those mesh
    dims (DTensor splits them in mesh order, as the tuple reads); every
    other mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else (entry or ())):
            owner[name] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in mesh.mesh_dim_names)


def _is_dtensor(x: Any) -> bool:
    # a class-name test, so the identity path imports nothing and runs no
    # tensor op on the card
    return type(x).__name__ == "DTensor"


def logical_constraint(x: torch.Tensor,
                       *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical axes; the
    identity without a mesh or when ``x`` is not a DTensor.

    Tolerates rank mismatch by dropping *middle* axes — the same model code
    annotates [B, S, ...] (prefill/train) and [B, ...] (decode) tensors.
    """
    mesh = _STATE.mesh
    if mesh is None or not _is_dtensor(x):
        return x
    if len(logical_axes) != x.ndim:
        if x.ndim < len(logical_axes):
            keep_tail = x.ndim - 1
            logical_axes = ((logical_axes[0],) + logical_axes[
                len(logical_axes) - keep_tail:]) if keep_tail else (
                logical_axes[0],)
        else:
            logical_axes = logical_axes + (None,) * (x.ndim - len(logical_axes))
    spec = spec_for(x.shape, logical_axes, mesh, _STATE.rules)
    return x.redistribute(mesh, placements_for(spec, mesh))


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-regex -> logical axes for trailing dims).
# Leading stacked dims (layers / groups / pattern slots / adapter slots) are
# replicated; rules describe the *trailing* canonical dims of each leaf.
# ---------------------------------------------------------------------------

PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # ---- serving caches (see models/attention.py, models/ssm.py) ----
    # KV ring caches [.., B, C, KH, hd]; positions [.., B, C].
    # kv_heads rarely divides the model axis (GQA kv=2..8 vs model=16), so
    # the head_dim fallback keeps the cache model-sharded for memory.
    (r"(^|/)(k|v|cross_k|cross_v)$",
     ("batch", "kv_seq", "kv_heads", "head_dim")),
    (r"(^|/)(k_scale|v_scale)$", ("batch", "kv_seq", "kv_heads")),
    (r"(^|/)pos$", ("batch", "kv_seq")),
    # SSM recurrent state [.., B, H, P, N]; conv window [.., B, w, C]
    (r"(^|/)state$", ("batch", "ssm_heads", None, None)),
    (r"(^|/)conv$", ("batch", None, "ssm_inner")),
    # ---- LoRA adapter pool. The shrink x·Aᵀ contracts d_in: sharding
    # A's d_in on the MODEL axis makes it a local partial-sum plus a tiny
    # [B, r] psum (sharding it on fsdp instead forces a full A all-gather
    # per layer — measured as the dominant decode collective, §Perf).
    # B for q/k/v/up rides the base projection's head sharding so the
    # expand is local; o/down B stays replicated (d·r·R is ~MBs). ----
    (r"/(q|k|v|up|gate|in_proj)/B$", ("heads", None)),
    (r"/(o|down|out_proj)/B$", (None, None)),
    (r"/A$", (None, "heads")),
    # embeddings / lm head
    (r"embed$", ("vocab", None)),
    (r"lm_head$", (None, "vocab")),
    (r"pos_embed$", (None, None)),
    # attention projections: [d_model, H*hd] / [H*hd, d_model] — 2D
    # sharded (fsdp on the contracting dim, tensor on heads/ff) so 100B+
    # weights fit per chip; GSPMD turns the contraction into activation
    # movement rather than weight gathers when that is cheaper.
    (r"(wq|wk|wv)$", ("fsdp", "heads")),
    (r"(bq|bk|bv)$", ("heads",)),
    (r"wo$", ("heads", "fsdp")),
    # MoE: experts stacked on an 'expert'-sharded leading dim (must match
    # before the generic MLP rules below)
    (r"experts/(up|gate)$", ("expert", "fsdp", "ff")),
    (r"experts/down$", ("expert", "ff", "fsdp")),
    (r"router$", (None, None)),
    # MLP
    (r"(up|gate)$", ("fsdp", "ff")),
    (r"down$", ("ff", "fsdp")),
    # Mamba2 / SSD
    (r"in_proj$", ("fsdp", "ssm_inner")),
    (r"out_proj$", ("ssm_inner", "fsdp")),
    (r"conv_w$", (None, "ssm_inner")),
    (r"conv_b$", ("ssm_inner",)),
    (r"(A_log|D|dt_bias)$", ("ssm_heads",)),
    # norms & scalars
    (r"(ln|norm|scale|post|q_norm|k_norm)", (None,)),
)


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh: Any,
               rules: Dict[str, Any], itemsize: int = 2) -> PartitionSpec:
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            # pad leading stacked dims with None
            n_lead = len(shape) - len(logical)
            if n_lead < 0:
                # leaf has fewer dims than rule (e.g. unstacked scalar)
                logical = logical[-len(shape):] if len(shape) else ()
                n_lead = 0
            axes = (None,) * n_lead + tuple(logical)
            # §Perf lever: small weights skip fsdp sharding — replicating
            # them removes the per-step weight all-gathers that dominate
            # small-model decode (rules['replicate_below'] = global bytes)
            threshold = rules.get("replicate_below", 0)
            if threshold:
                nbytes = itemsize
                for d in shape:
                    nbytes *= d
                if nbytes < threshold:
                    axes = tuple(None if a == "fsdp" else a for a in axes)
            return spec_for(shape, axes, mesh, rules)
    return P()  # replicate by default


def _path_str(path: Sequence[Any]) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn: Any, tree: Any, path: Tuple[Any, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (named
    tuples keep their type); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(tree: Any, mesh: Any = None,
                rules: Optional[Dict[str, Any]] = None) -> Any:
    """PartitionSpec tree for a tree of tensors (real, fake or meta) by
    path rules; a path is the tree's keys joined by '/', as the
    reference's ``_path_str`` joins a dict tree's."""
    mesh = mesh or _STATE.mesh
    rules = rules or _STATE.rules

    def _one(path: Tuple[Any, ...], leaf: Any) -> PartitionSpec:
        if mesh is None:
            return P()
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = getattr(leaf, "dtype", None)
        itemsize = dtype.itemsize if dtype is not None else 2
        return _leaf_spec(_path_str(path), shape, mesh, rules, itemsize)

    return _map_with_path(_one, tree)


def distribute_leaf(x: torch.Tensor, mesh: Any, spec: Sequence[Any]) -> Any:
    """``x`` as a DTensor placed by ``spec``. Each rank's shard is
    ``x``'s chunk on a one-rank mesh; on a wider mesh, where the leaf
    stands for a global shape (a fake or meta tensor, as in the
    dry-run), rank 0's shard is a new tensor of the shard's shape and
    no collective runs."""
    from torch.distributed.tensor import DTensor, Shard

    placements = placements_for(spec, mesh)
    if mesh.size() == 1:
        return DTensor.from_local(x, mesh, placements, run_check=False)
    local = list(x.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(x.new_empty(local), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def distribute_tree(tree: Any, mesh: Any,
                    rules: Optional[Dict[str, Any]] = None) -> Any:
    """The counterpart of the reference's ``named_sharding_tree``: the
    tree with every leaf a DTensor placed by ``param_specs``."""
    specs = param_specs(tree, mesh, rules)
    return _map_with_path(
        lambda path, leaf: distribute_leaf(leaf, mesh, _get(specs, path)),
        tree)


def _get(tree: Any, path: Tuple[Any, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree
