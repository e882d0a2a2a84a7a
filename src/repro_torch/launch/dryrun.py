"""Multi-pod dry-run (``repro.launch.dryrun``): run every (architecture ×
input shape) step once over the production mesh, on fake tensors, with
no device allocation.

For each combo this builds the step —

    train_4k     → LoRA fine-tune train_step (frozen base, AdamW on LoRA,
                   ``remat`` on by default)
    prefill_32k  → prefill_step (prompt pass + KV/state cache fill,
                   multi-tenant LoRA pool in batched mode)
    decode_32k / long_500k → serve_step (one token over a seq_len cache)

— gives it DTensor arguments of the full shapes, each placed by the
logical-axis rules (``distributed/sharding.py``) on a 16×16 (or 2×16×16)
``DeviceMesh`` over torch's fake process group, their local shards
``FakeTensor``s, runs it once, and records the counted flops and bytes
(``analysis.step_cost``), the collectives DTensor issues
(``analysis.collective_bytes``) and the roofline terms of an H100 fleet
(``mesh.roofline_terms``).

Steps run the plain routes: attention without the kernels
(``attn_kernel=False``) and the ``einsum`` LoRA backend. Kernels cannot
run on fake tensors, and the reference too resolves ``'auto'`` to einsum
on host devices.

Where DTensor cannot run an op at its arguments' placements (no
strategy, or a local op that fails on a shard), the step gathers the
op's DTensor arguments to ``Replicate()``, runs it on the whole values
and, for an in-place op, writes the result back at the target's
placements (``_ReplicateFallback``): the op computes what it computes on
one device, and the gathers it costs are counted. Each combo lists such
ops in ``replicated_ops``. Which ops they are depends on the installed
torch's DTensor. With torch 2.13, over ``ARCH_IDS`` on the 16×16 mesh:

* ``aten.view``: a ``[.., heads·hd]`` projection split into heads that do
  not divide the model axis (14 or 8 heads on 16; q, k, v and the
  attention output), and a view of a padded shard where whisper's 1500
  frames were split 16 ways;
* ``aten.argmax``: long_500k's single row of logits, sharded on the
  vocabulary (DTensor's argmax gather fails on the fake group).

With torch 2.11 also ``aten.scatter_`` (the ring writes of
``cache_update``: no strategy there, so each layer's write gathers the
whole ring), ``aten.add`` and ``aten.index_put_`` (MoE's queue-position
scatter). The ring writes are ``scatter_`` / ``index_copy_`` along the
ring dim, not ``index_put_`` with a batch index, so that a DTensor
version that shards them writes each shard in place, as the reference's
partitioner does.

Result fields are the reference's, but for those with no counterpart
here: ``memory`` (XLA's ``memory_analysis``), ``hlo_flops_per_device_raw``
and ``hlo_bytes_per_device_raw`` (XLA's ``cost_analysis``) and
``lower_s``/``compile_s`` are replaced by ``trace_s``, the seconds the
fake run took. New: ``replicated_ops``; ``collectives['fallback']``, the
collective bytes the fallback's gathers and write-backs issued, and
``collective_fallback_share``, their part of the total;
``dominant_without_fallback``, the dominant term once they are taken out
(what DTensor's own plan costs); ``torch``, the version whose DTensor
made the plan.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.lora import LoRAMode
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, distribute_tree, use_mesh
from repro_torch.launch.analysis import (collective_bytes,
                                        fallback_collectives, step_cost)
from repro_torch.launch.mesh import (make_production_mesh, release_mesh,
                                     roofline_terms)
from repro_torch.models import build_model
from repro_torch.models.layers import elide_repeats
from repro_torch.training.optimizer import AdamWState, adamw_init
from repro_torch.training.train import TrainState, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# long_500k applicability: SSM/hybrid + local-attention archs
LONG_OK = {a: get_config(a).supports_long_context for a in ARCH_IDS}


def _is_dtensor(x: Any) -> bool:
    return type(x).__name__ == "DTensor"


class _ReplicateFallback(TorchDispatchMode):
    """Runs an op DTensor cannot shard on replicated arguments: each
    DTensor argument is gathered to ``Replicate()`` (collectives that
    ``collective_bytes`` counts), the op runs on the local tensors, which
    now hold the whole values, and its result is a replicated DTensor; an
    in-place op's result is written back at its target's placements."""

    def __init__(self) -> None:
        super().__init__()
        self.sites: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(t.__name__ == "DTensor" for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, ValueError):
            # no strategy at these placements, or a local op that fails
            # on a shard; a fault of the op itself fails again below, on
            # whole values
            pass
        from torch.distributed.tensor import DTensor, Replicate

        mesh = next(x.device_mesh for x in tree_flatten((args, kwargs))[0]
                    if _is_dtensor(x))
        whole = [Replicate()] * mesh.ndim

        def local(x: Any) -> Any:
            if _is_dtensor(x):
                return x.redistribute(mesh, whole).to_local()
            return x

        with fallback_collectives():
            largs, lkwargs = tree_map(local, args), tree_map(local, kwargs)
        out = func(*largs, **lkwargs)
        out = tree_map(lambda t: DTensor.from_local(t, mesh, whole,
                                                    run_check=False)
                       if isinstance(t, torch.Tensor) else t, out)
        name = str(func)
        self.sites[name] = self.sites.get(name, 0) + 1
        if func._schema.is_mutable:     # an in-place op: write it back
            dst = args[0]
            with fallback_collectives():
                back = out.redistribute(mesh, dst.placements)
            dst.copy_(back)
            return dst
        return out


def _fake_tree(tree: Any) -> Any:
    """A tree of meta (shape-only) tensors as tensors of the current
    ``FakeTensorMode`` on the CPU."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype)


def _batch_spec(mesh: Any, batch: int) -> P:
    axes_sizes = sharding.mesh_axes(mesh)
    axes = [a for a in ("pod", "data") if a in axes_sizes]
    n = math.prod(axes_sizes[a] for a in axes) if axes else 1
    return P(tuple(axes)) if axes and batch % n == 0 else P()


def _placed(shape: Tuple[int, ...], dtype: torch.dtype, mesh: Any,
            spec: Any) -> Any:
    return sharding.distribute_leaf(torch.empty(shape, dtype=dtype), mesh,
                                    tuple(spec))


def input_specs(cfg: ModelConfig, shape: InputShape, mesh: Any,
                opts: Optional[Dict] = None) -> Tuple[Any, Dict[str, Any]]:
    """Build (step_fn, kwargs of DTensors) for one combo. Call it under a
    ``FakeTensorMode`` for a dry-run (the tensors it makes are the
    mode's) and under ``use_mesh(mesh)``."""
    opts = dict(opts or {})
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    bspec = _batch_spec(mesh, shape.global_batch)
    params = distribute_tree(_fake_tree(model._param_tree(None)), mesh)
    b = shape.global_batch

    def frames() -> Any:
        return _placed((b, cfg.encoder.n_frames, cfg.d_model),
                       torch.bfloat16, mesh, bspec + P(None, None))

    if shape.kind == "train":
        lora = distribute_tree(model.init_lora(gen), mesh)
        opt = adamw_init(lora)
        opt = AdamWState(_placed((), torch.int32, mesh, P()),
                         distribute_tree(opt.mu, mesh),
                         distribute_tree(opt.nu, mesh))
        state = TrainState(params, lora, opt)
        batch = {"tokens": _placed((b, shape.seq_len + 1), torch.int32,
                                   mesh, bspec + P(None))}
        if cfg.encoder is not None:
            batch["frames"] = frames()
        step = make_train_step(model, remat=opts.pop("remat", True))

        def train_step(state, batch):
            return step(state, batch)

        return train_step, {"state": state, "batch": batch}

    # ---- serving paths: multi-tenant LoRA pool in batched mode ----
    # the serving pool is bf16 (the paper serves quantized adapters;
    # training uses f32 LoRA)
    pool = distribute_tree(model.init_lora(gen, n_slots=cfg.lora.max_resident,
                                           dtype=torch.bfloat16), mesh)
    scale = cfg.lora.scale
    cache = distribute_tree(model.init_cache(b, shape.seq_len), mesh)
    slot_ids = _placed((b,), torch.int32, mesh, bspec)

    if shape.kind == "prefill":
        batch = {"tokens": _placed((b, shape.seq_len), torch.int32, mesh,
                                   bspec + P(None))}
        if cfg.encoder is not None:
            batch["frames"] = frames()
        fwd_opts = opts

        def prefill_step(params, pool, batch, cache, slot_ids):
            mode = LoRAMode("batched", slot_ids, scale, "einsum")
            logits, cache = model.prefill(params, batch, cache, pool, mode,
                                          fwd_opts)
            return torch.argmax(logits, -1).to(torch.int32), cache

        return prefill_step, {"params": params, "pool": pool,
                              "batch": batch, "cache": cache,
                              "slot_ids": slot_ids}

    tokens = _placed((b,), torch.int32, mesh, bspec)
    pos = _placed((b,), torch.int32, mesh, bspec)

    def serve_step(params, pool, tokens, cache, pos, slot_ids):
        mode = LoRAMode("batched", slot_ids, scale, "einsum")
        logits, cache = model.decode_step(params, tokens, cache, pos, pool,
                                          mode)
        return torch.argmax(logits, -1).to(torch.int32), cache

    return serve_step, {"params": params, "pool": pool, "tokens": tokens,
                        "cache": cache, "pos": pos, "slot_ids": slot_ids}


@contextlib.contextmanager
def traced(mesh: Any, rules: Optional[Dict[str, Any]] = None, *,
           train: bool = False) -> Iterator[Dict[str, Any]]:
    """The context a dry-run step runs in: the mesh and its rules,
    implicit replication of plain tensors (the positions, masks and
    constants a step makes), the replicate fallback and the collective
    recorder. Yields {'fake', 'collectives', 'replicated_ops'}: 'fake' is
    the ``FakeTensorMode`` to build the arguments under (``input_specs``);
    the other two are filled on exit.

    The step itself runs outside that mode: ops on its fake arguments
    stay fake (a ``FakeTensor`` dispatches to its own mode), while the
    small tensors the step and DTensor's planner make from nothing
    (positions, masks, shard indices) are real, so DTensor can read
    them.

    A serving step runs without autograd and with its attention block
    loops elided (``models.layers.elide_repeats``): one (q block, kv
    block) iteration runs and counts for all of them, as the reference's
    scans count their bodies. A train step runs every iteration: its
    backward replays what its forward ran."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    # DeviceMesh bookkeeping and the step's small real tensors meet the
    # fake ones: let them in
    rec: Dict[str, Any] = {"fake": FakeTensorMode(allow_non_fake_inputs=True)}
    fallback = _ReplicateFallback()
    serving = contextlib.ExitStack()
    if not train:
        serving.enter_context(torch.no_grad())
        serving.enter_context(elide_repeats())
    with use_mesh(mesh, rules), implicit_replication(), \
            collective_bytes() as coll, fallback, serving:
        rec["collectives"] = coll
        yield rec
    rec["replicated_ops"] = dict(fallback.sites)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              opts: Optional[Dict] = None, save: bool = True,
              verbose: bool = True,
              config_patch: Optional[Dict] = None,
              rules_patch: Optional[Dict] = None,
              variant: str = "") -> Dict[str, Any]:
    """config_patch: dataclasses.replace kwargs applied to the ModelConfig
    (nested 'attn'/'moe'/'ssm'/'lora' dicts patch the sub-configs);
    rules_patch: extra logical-sharding rules (e.g.
    {'replicate_below': 64e6}). Builds the production mesh (on the fake
    process group) and releases it before returning."""
    cfg = get_config(arch)
    if config_patch:
        patch = dict(config_patch)
        for sub in ("attn", "moe", "ssm", "lora"):
            if sub in patch:
                cur = getattr(cfg, sub)
                patch[sub] = dataclasses.replace(cur, **patch[sub])
        cfg = dataclasses.replace(cfg, **patch)
    shape = INPUT_SHAPES[shape_name]
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    n_chips = math.prod(mesh_shape)
    mesh_name = "x".join(str(s) for s in mesh_shape)

    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips, "status": "ok",
    }

    if shape_name == "long_500k" and not cfg.supports_long_context:
        result["status"] = "skipped"
        result["reason"] = ("full-attention architecture without a "
                            "sub-quadratic variant")
        if save:
            _save(result)
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] SKIPPED: "
                  f"{result['reason']}")
        return result

    rules = None
    if rules_patch:
        rules = dict(sharding.LOGICAL_RULES)
        rules.update(rules_patch)
    if variant:
        result["variant"] = variant

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        with traced(mesh, rules, train=shape.kind == "train") as rec:
            with rec["fake"]:
                step_fn, kwargs = input_specs(cfg, shape, mesh, opts)
            arg_bytes_dev = _arg_bytes_per_device(kwargs, mesh)
            jc = step_cost(step_fn, n_chips=n_chips, **kwargs)
    finally:
        release_mesh()
    t_trace = time.time() - t0
    coll = rec["collectives"]

    flops = jc["mxu_flops"]                 # global matmul flops
    hbm_bytes = jc["bytes"]                 # global algorithmic bytes
    coll_global = {k: v * n_chips for k, v in coll.items()}
    terms = roofline_terms(flops, hbm_bytes, coll_global["total"], n_chips)
    # the same terms with the replicate fallback's gathers taken out:
    # DTensor's own plan
    planned = roofline_terms(flops, hbm_bytes,
                             coll_global["total"] - coll_global["fallback"],
                             n_chips)

    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens

    result.update({
        "trace_s": round(t_trace, 2),
        "arg_bytes_per_device": arg_bytes_dev,
        "flops": flops,
        "vpu_flops": jc["vpu_flops"],
        "hbm_bytes": hbm_bytes,
        "collectives": coll_global,
        "roofline": terms,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else None,
        "dominant": max(terms, key=terms.get),
        "tokens": tokens,
        "replicated_ops": rec["replicated_ops"],
        "collective_fallback_share": (coll["fallback"] / coll["total"]
                                      if coll["total"] else 0.0),
        "dominant_without_fallback": max(planned, key=planned.get),
        "torch": torch.__version__,
    })
    if save:
        _save(result)
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] OK "
              f"trace={t_trace:.1f}s args/dev={arg_bytes_dev/1e9:.2f}GB "
              f"flops={flops:.3e} bytes={hbm_bytes:.3e} "
              f"coll={coll_global['total']:.3e} "
              f"dominant={result['dominant']} "
              f"fallback={result['collective_fallback_share']:.3f} "
              f"useful={result['useful_flops_ratio'] and round(result['useful_flops_ratio'], 3)}")
    return result


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _arg_bytes_per_device(kwargs: Any, mesh: Any) -> float:
    """Σ leaf bytes / shards(leaf) — exact per-device residency of all
    step arguments (weights, adapter pool, caches, optimizer state),
    from each DTensor's placements (a plain tensor is one shard)."""
    n = 0.0
    for leaf in _leaves(kwargs):
        size = float(leaf.numel()) * leaf.element_size()
        if _is_dtensor(leaf):
            mesh_sizes = leaf.device_mesh.mesh.shape
            shards = math.prod(mesh_sizes[i] for i, p in
                               enumerate(leaf.placements) if p.is_shard())
            size /= shards
        n += size
    return n


def _save(result: Dict[str, Any]) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = f"__{result['variant']}" if result.get("variant") else ""
    name = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
            f"{suffix}.json")
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(result, f, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) combo")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")

    failures = []
    for arch, shape in combos:
        try:
            run_combo(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:  # noqa: BLE001 (reported, then next combo)
            failures.append((arch, shape, repr(e)))
            traceback.print_exc()
            if not args.continue_on_error:
                return 1
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("all dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
