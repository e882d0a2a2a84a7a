"""Decoder stacks, dense, MoE, SSM and hybrid (``repro.models.transformer``):
global and local (sliding-window, chunked-local) attention slots, gated or
plain MLPs or mixture-of-experts blocks (every ``moe_layer_period``-th
slot), optional post-norms; Mamba-2 slots (mamba2: period 1), and zamba2's
six Mamba-2 slots a group followed by one weight-tied attention + MLP block.

Layers are organised into **groups** of ``period`` pattern slots with
stacked params, as in the reference::

    params['layers']['slot{p}'][module_leaf]   # leading dim = n_groups
    params['shared_attn']                      # zamba2's block, one copy

The reference scans over groups; here a Python loop walks them, taking
views of group ``i`` of every stacked leaf (with ``remat``, each group
under ``torch.utils.checkpoint``). The residual stream is constrained to
the batch axis after every slot (``logical_constraint``), as in the
reference. LoRA params mirror the layout
under a separate tree (pool layout ``[ng, R, r, d]``); caches use the
same slot layout and are written in place: attention slots carry ring
KV, SSM slots (conv, state), and ``cache['shared']`` the shared block's
ring, stacked over the groups.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAMode, init_lora_pair
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (init_device, linear, mlp, mlp_init,
                                      rmsnorm)


# ---------------------------------------------------------------------------
# Stack topology
# ---------------------------------------------------------------------------


def stack_period(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 1
    if cfg.shared_attn_every:
        return cfg.shared_attn_every
    p = len(cfg.attn.layer_pattern)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.moe_layer_period)
    return p


def n_groups(cfg: ModelConfig) -> int:
    period = stack_period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"multiple of the stack period {period}")
    return cfg.n_layers // period


def slot_kind(cfg: ModelConfig, p: int) -> str:
    """Mixer kind for pattern slot p: 'ssm' | 'global' | 'local'."""
    if cfg.family == "ssm" or cfg.shared_attn_every:
        return "ssm"
    return cfg.attn.layer_pattern[p % len(cfg.attn.layer_pattern)]


def slot_is_moe(cfg: ModelConfig, p: int) -> bool:
    """Slot p holds an MoE block: the last of every ``moe_layer_period``."""
    if cfg.moe is None:
        return False
    per = cfg.moe.moe_layer_period
    return p % per == per - 1


def cache_len_for(kind: str, cfg: ModelConfig, max_len: int) -> int:
    """Ring length of a slot: local layers keep only their window."""
    if kind == "local":
        return min(cfg.attn.sliding_window, max_len)
    return max_len


def group_view(tree: Any, i: int) -> Any:
    """Views of group ``i`` of every stacked leaf (the scan's slice)."""
    if isinstance(tree, dict):
        return {k: group_view(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_slot(generator: Optional[torch.Generator], cfg: ModelConfig, p: int,
              ng: int, dtype: torch.dtype) -> Dict:
    dev, d = init_device(generator), cfg.d_model
    if slot_kind(cfg, p) == "ssm":
        out = {"ln1": {"scale": torch.zeros((ng, d), dtype=dtype, device=dev)},
               "ssm": ssm_lib.ssm_init(generator, cfg, stack=(ng,),
                                       dtype=dtype)}
        if cfg.d_ff:  # zamba2: an MLP on every Mamba slot; mamba2 has none
            out["ln2"] = {"scale": torch.zeros((ng, d), dtype=dtype,
                                               device=dev)}
            out["mlp"] = mlp_init(generator, d, cfg.d_ff, glu=cfg.glu,
                                  dtype=dtype, stack=(ng,))
        return out
    out = {
        "ln1": {"scale": torch.zeros((ng, d), dtype=dtype, device=dev)},
        "attn": attn_lib.attention_init(generator, cfg, stack=(ng,),
                                        dtype=dtype),
        "ln2": {"scale": torch.zeros((ng, d), dtype=dtype, device=dev)},
    }
    if slot_is_moe(cfg, p):
        out["moe"] = moe_lib.moe_init(generator, cfg, stack=(ng,),
                                      dtype=dtype)
    else:
        out["mlp"] = mlp_init(generator, d, cfg.d_ff, glu=cfg.glu,
                              dtype=dtype, stack=(ng,))
    if cfg.post_norm:  # gemma2: RMSNorm of each block's output
        for name in ("post1", "post2"):
            out[name] = {"scale": torch.zeros((ng, d), dtype=dtype,
                                              device=dev)}
    return out


def init_stack(generator: Optional[torch.Generator], cfg: ModelConfig,
               dtype: torch.dtype) -> Dict:
    ng = n_groups(cfg)
    params: Dict[str, Any] = {
        "layers": {f"slot{p}": init_slot(generator, cfg, p, ng, dtype)
                   for p in range(stack_period(cfg))}}
    if cfg.shared_attn_every:
        # zamba2's weight-tied attention + MLP block: one copy, unstacked
        dev, d = init_device(generator), cfg.d_model
        params["shared_attn"] = {
            "ln1": {"scale": torch.zeros((d,), dtype=dtype, device=dev)},
            "attn": attn_lib.attention_init(generator, cfg, dtype=dtype),
            "ln2": {"scale": torch.zeros((d,), dtype=dtype, device=dev)},
            "mlp": mlp_init(generator, d, cfg.d_ff, glu=cfg.glu,
                            dtype=dtype),
        }
    return params


_LORA_DIMS = {
    "q": lambda c: (c.d_model, c.q_size),
    "k": lambda c: (c.d_model, c.kv_size),
    "v": lambda c: (c.d_model, c.kv_size),
    "o": lambda c: (c.q_size, c.d_model),
    "up": lambda c: (c.d_model, c.d_ff),
    "gate": lambda c: (c.d_model, c.d_ff),
    "down": lambda c: (c.d_ff, c.d_model),
    "in_proj": lambda c: (c.d_model,
                          2 * c.ssm.d_inner(c.d_model)
                          + 2 * c.ssm.n_groups * c.ssm.d_state
                          + c.ssm.n_heads(c.d_model)),
    "out_proj": lambda c: (c.ssm.d_inner(c.d_model), c.d_model),
}

_ATTN_MODULES = ("q", "k", "v", "o")
_MLP_MODULES = ("up", "gate", "down")
_SSM_MODULES = ("in_proj", "out_proj")


def init_lora_stack(generator: torch.Generator, cfg: ModelConfig, *,
                    n_slots: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """LoRA tree mirroring the stack. n_slots=None -> single adapter
    (leaves [ng, r, d]); n_slots=R -> stacked pool ([ng, R, r, d]).
    SSM slots carry ``in_proj``/``out_proj`` only (zamba2's per-slot MLPs
    carry none); zamba2's shared block carries q, k, v, o with a pool axis
    and no group axis ([R, r, d]), and no MLP LoRA."""
    ng = n_groups(cfg)
    pool = () if n_slots is None else (n_slots,)
    targets = set(cfg.lora.target_modules)
    tree: Dict[str, Any] = {"layers": {}}
    for p in range(stack_period(cfg)):
        if slot_kind(cfg, p) == "ssm":
            mods = tuple(m for m in _SSM_MODULES if m in targets)
        else:
            mods = tuple(m for m in _ATTN_MODULES if m in targets)
            # an MoE slot's MLP LoRA lives on its shared expert, if it has one
            if not slot_is_moe(cfg, p) or cfg.moe.shared_expert:
                mods += tuple(m for m in _MLP_MODULES if m in targets
                              and cfg.d_ff and (cfg.glu or m != "gate"))
        tree["layers"][f"slot{p}"] = {
            m: init_lora_pair(generator, *_LORA_DIMS[m](cfg), cfg.lora.rank,
                              stack=(ng, *pool), dtype=dtype)
            for m in mods}
    if cfg.shared_attn_every:
        tree["shared_attn"] = {
            m: init_lora_pair(generator, *_LORA_DIMS[m](cfg), cfg.lora.rank,
                              stack=pool, dtype=dtype)
            for m in _ATTN_MODULES if m in targets}
    return tree


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _attn_block_full(slot_p: Dict, lora_p: Optional[Dict], x: torch.Tensor,
                     cfg: ModelConfig, kind: str, positions: torch.Tensor,
                     lora_mode: LoRAMode, opts: Dict,
                     cache_slot: Optional[Dict] = None,
                     prefix_kv: Optional[Dict] = None,
                     prefix_positions: Optional[torch.Tensor] = None,
                     attn_kernel: bool = False):
    h = rmsnorm(slot_p["ln1"], x, cfg.norm_eps)
    q, k, v = attn_lib.project_qkv(slot_p["attn"], h, cfg, positions,
                                   lora_p, lora_mode)
    if cache_slot is not None:
        attn_lib.cache_fill(cache_slot, k, v, positions)
    k_all, v_all, kpos = k, v, positions
    if prefix_kv is not None:
        # suffix prefill over a cached prefix: keys/values are the
        # gathered prefix KV (positions [0, P), post-RoPE) followed by
        # this pass's fresh suffix KV — the key order, positions and mask
        # a cold full prefill sees
        k_all = torch.cat([prefix_kv["k"].to(k.dtype), k], dim=1)
        v_all = torch.cat([prefix_kv["v"].to(v.dtype), v], dim=1)
        kpos = torch.cat([prefix_positions.to(positions.dtype), positions])
    o = attn_lib.blockwise_attention(
        q, k_all, v_all, positions, kpos, kind=kind, cfg=cfg,
        block_q=opts.get("block_q", 512), block_kv=opts.get("block_kv", 1024),
        use_kernel=attn_kernel)
    o = o.reshape(*x.shape[:-1], cfg.q_size)
    o = linear({"w": slot_p["attn"]["wo"]}, o, (lora_p or {}).get("o"),
               lora_mode)
    if cfg.post_norm:
        o = rmsnorm(slot_p["post1"], o, cfg.norm_eps)
    return o


def _ffn_block(slot_p: Dict, lora_p: Optional[Dict], h: torch.Tensor,
               cfg: ModelConfig, lora_mode: LoRAMode):
    """The slot's MLP or MoE block on the normed ``h`` [B, S, d]. Returns
    (y, aux losses: empty for an MLP)."""
    if "moe" in slot_p:
        return moe_lib.moe_block(slot_p["moe"], h, cfg, lora_p, lora_mode)
    return mlp(slot_p["mlp"], h, act=cfg.act, glu=cfg.glu, lora=lora_p,
               lora_mode=lora_mode), {}


def _ffn_block_full(slot_p: Dict, lora_p: Optional[Dict], x: torch.Tensor,
                    cfg: ModelConfig, lora_mode: LoRAMode):
    h = rmsnorm(slot_p["ln2"], x, cfg.norm_eps)
    y, aux = _ffn_block(slot_p, lora_p, h, cfg, lora_mode)
    if cfg.post_norm:
        y = rmsnorm(slot_p["post2"], y, cfg.norm_eps)
    return y, aux


def _ssm_slot_full(sp: Dict, lp: Optional[Dict], h: torch.Tensor,
                   cfg: ModelConfig, lora_mode: LoRAMode,
                   cache_slot: Optional[Dict],
                   seq_mask: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """A Mamba-2 slot on [B, S, d]: the SSM block (with a cache, its final
    state and conv tail written in place) and, where the slot has one,
    its MLP. Returns the new residual stream."""
    hn = rmsnorm(sp["ln1"], h, cfg.norm_eps)
    if cache_slot is not None:
        y, state, conv_tail = ssm_lib.ssm_block_full(
            sp["ssm"], hn, cfg, lp, lora_mode, return_state=True,
            seq_mask=seq_mask, lengths=lengths)
        cache_slot["state"].copy_(state)
        cache_slot["conv"].copy_(conv_tail)
    else:
        y = ssm_lib.ssm_block_full(sp["ssm"], hn, cfg, lp, lora_mode,
                                   seq_mask=seq_mask)
    h = h + y
    if "mlp" in sp:
        h = h + mlp(sp["mlp"], rmsnorm(sp["ln2"], h, cfg.norm_eps),
                    act=cfg.act, glu=cfg.glu, lora=lp, lora_mode=lora_mode)
    return h


def _shared_attn_block(shared_p: Dict, lora_p: Optional[Dict],
                       x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor, lora_mode: LoRAMode,
                       opts: Dict, cache_slot: Optional[Dict] = None,
                       attn_kernel: bool = False) -> torch.Tensor:
    """zamba2's weight-tied global attention + MLP block (full sequence),
    its K/V filled into ``cache_slot`` when given: the attention slot's
    block (no post-norm: ``check_supported``), then an MLP without LoRA.
    The reference projects q, k, v twice on the prefill path (once for
    the cache fill, once in the block) from the same input; here they are
    projected once, so a prefill runs the same LoRA calls as a decode
    step."""
    x = x + _attn_block_full(shared_p, lora_p, x, cfg, "global", positions,
                             lora_mode, opts, cache_slot,
                             attn_kernel=attn_kernel)
    h = rmsnorm(shared_p["ln2"], x, cfg.norm_eps)
    return x + mlp(shared_p["mlp"], h, act=cfg.act, glu=cfg.glu)


def forward_stack(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, lora: Optional[Dict] = None,
                  lora_mode: LoRAMode = LoRAMode(),
                  opts: Optional[Dict] = None, cache: Optional[Dict] = None,
                  seq_mask: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None,
                  prefix_kv: Optional[Dict] = None,
                  prefix_positions: Optional[torch.Tensor] = None,
                  attn_kernel: bool = False):
    """x: [B, S, d] -> (hidden [B, S, d], aux losses[, filled cache]).

    With ``cache`` this is the **prefill** path: attention slots also
    bulk-write their K/V into the ring caches, SSM slots their final
    state and conv tail (in place). ``seq_mask`` [B, S] / ``lengths`` [B]
    matter only to SSM slots (dt = 0 at right-padding; the conv tail
    gathered at the last real tokens); attention slots' right-padded rows
    are handled by the caller's last-token gather and cache invalidation,
    as in the reference.

    ``prefix_kv`` (suffix prefill over a cached prefix: the shared-prefix
    cache and chunked prefill): a tree mirroring the attention slots of
    ``cache`` with leaves [ng, B, P, ...] — per-layer K/V for positions
    ``prefix_positions`` [P]. Attention runs over prefix-then-fresh keys;
    only the fresh suffix is written to ``cache``.

    ``attn_kernel`` routes every layer's attention through the
    ``flash_prefill`` kernel instead of the plain blockwise loops.

    The aux losses are the MoE blocks' load-balance and router z-losses,
    summed over layers (zero without MoE).

    zamba2's shared block runs after each group (``_shared_attn_block``),
    its ring ``cache['shared']`` filled on prefill.

    ``opts['remat']`` (the train step's ``remat``) runs each group under
    ``torch.utils.checkpoint`` (non-reentrant): the backward pass
    recomputes the group's forward instead of keeping its activations.
    It applies without a cache only; a prefill, which has no backward,
    runs its groups plainly.
    """
    shared_params = params.get("shared_attn")
    if prefix_kv is not None and (cache is None
                                  or shared_params is not None):
        raise ValueError("prefix_kv requires the prefill path (a cache) on "
                         "a stack without a shared block")
    opts = opts or {}
    period = stack_period(cfg)
    lora_layers = (lora or {}).get("layers", {})
    shared_lora = (lora or {}).get("shared_attn")
    fill = cache is not None
    # training has no cache: the group's in-place cache writes never sit
    # in a checkpointed region
    remat = opts.get("remat", False) and not fill

    def group_body(gi: int, h: torch.Tensor, lb: torch.Tensor,
                   zl: torch.Tensor):
        gp = group_view(params["layers"], gi)
        gl = group_view(lora_layers, gi) if lora_layers else {}
        gc = group_view(cache, gi) if fill else {}
        gpre = group_view(prefix_kv, gi) if prefix_kv is not None else {}
        for p in range(period):
            kind = slot_kind(cfg, p)
            sp, lp = gp[f"slot{p}"], gl.get(f"slot{p}")
            if kind == "ssm":
                h = _ssm_slot_full(sp, lp, h, cfg, lora_mode,
                                   gc.get(f"slot{p}"), seq_mask, lengths)
            else:
                h = h + _attn_block_full(sp, lp, h, cfg, kind, positions,
                                         lora_mode, opts, gc.get(f"slot{p}"),
                                         prefix_kv=gpre.get(f"slot{p}"),
                                         prefix_positions=prefix_positions,
                                         attn_kernel=attn_kernel)
                y, slot_aux = _ffn_block_full(sp, lp, h, cfg, lora_mode)
                h = h + y
                if slot_aux:
                    lb = lb + slot_aux["load_balance"]
                    zl = zl + slot_aux["router_z"]
            h = logical_constraint(h, "batch", None, None)
        if shared_params is not None:
            h = _shared_attn_block(shared_params, shared_lora, h, cfg,
                                   positions, lora_mode, opts,
                                   gc.get("shared"), attn_kernel)
        return h, lb, zl

    h = x
    lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi in range(n_groups(cfg)):
        if remat:
            # recompute the group's forward in the backward pass instead of
            # keeping its activations (the reference's jax.checkpoint of
            # the scan body)
            h, lb, zl = torch.utils.checkpoint.checkpoint(
                group_body, gi, h, lb, zl, use_reentrant=False)
        else:
            h, lb, zl = group_body(gi, h, lb, zl)
    aux = {"load_balance": lb, "router_z": zl}
    if fill:
        return h, aux, cache
    return h, aux


# ---------------------------------------------------------------------------
# Cache init + decode step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device: Any = None) -> Dict:
    """Per attention slot a ring of ``cache_len_for`` entries (int8 with
    bf16 scales under ``kv_cache_quant``); per SSM slot its conv ring
    (model dtype) and f32 state; zamba2's shared block a ``max_len`` ring
    stacked over the groups (``cache['shared']``)."""
    ng = n_groups(cfg)
    cache: Dict[str, Any] = {}
    for p in range(stack_period(cfg)):
        kind = slot_kind(cfg, p)
        if kind == "ssm":
            cache[f"slot{p}"] = ssm_lib.init_ssm_cache(
                batch, cfg, dtype, stack=(ng,), device=device)
        else:
            cache[f"slot{p}"] = attn_lib.init_kv_cache(
                batch, cache_len_for(kind, cfg, max_len), cfg.n_kv_heads,
                cfg.resolved_head_dim, dtype, stack=(ng,), device=device,
                quant=cfg.attn.kv_cache_quant)
    if cfg.shared_attn_every:
        cache["shared"] = attn_lib.init_kv_cache(
            batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
            stack=(ng,), device=device, quant=cfg.attn.kv_cache_quant)
    return cache


def _attn_decode(sp: Dict, lp: Optional[Dict], h: torch.Tensor,
                 cache_p: Dict, cfg: ModelConfig, kind: str,
                 pos: torch.Tensor, lora_mode: LoRAMode,
                 attn_kernel: bool = False) -> torch.Tensor:
    """h: [B, d]; cache_p: one slot's KV cache (no group dim), updated in
    place before the attention reads it (both on the current stream);
    pos: [B] per-slot positions."""
    b = h.shape[0]
    x = rmsnorm(sp["ln1"], h, cfg.norm_eps)[:, None, :]            # [B, 1, d]
    q, k, v = attn_lib.project_qkv(sp["attn"], x, cfg, pos[:, None], lp,
                                   lora_mode)
    attn_lib.cache_update(cache_p, k, v, pos)
    o = attn_lib.decode_attention(q[:, 0], cache_p, pos, kind=kind, cfg=cfg,
                                  use_kernel=attn_kernel)
    o = linear({"w": sp["attn"]["wo"]}, o.reshape(b, 1, cfg.q_size),
               (lp or {}).get("o"), lora_mode)[:, 0]
    if cfg.post_norm:
        o = rmsnorm(sp["post1"], o, cfg.norm_eps)
    return o


def decode_stack(params: Dict, x: torch.Tensor, cache: Dict,
                 cfg: ModelConfig, pos: torch.Tensor,
                 lora: Optional[Dict] = None,
                 lora_mode: LoRAMode = LoRAMode(),
                 attn_kernel: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x: [B, d]; pos: scalar or [B] per-slot positions.
    Returns (h, cache); the cache is updated in place. ``attn_kernel``
    routes every layer's attention through the ``flash_decode`` kernel."""
    period = stack_period(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(x.shape[0])
    lora_layers = (lora or {}).get("layers", {})
    shared_lora = (lora or {}).get("shared_attn")
    shared_params = params.get("shared_attn")
    h = x
    for gi in range(n_groups(cfg)):
        gp = group_view(params["layers"], gi)
        gl = group_view(lora_layers, gi) if lora_layers else {}
        gc = group_view(cache, gi)
        for p in range(period):
            kind = slot_kind(cfg, p)
            sp, lp = gp[f"slot{p}"], gl.get(f"slot{p}")
            if kind == "ssm":
                cp = gc[f"slot{p}"]
                hn = rmsnorm(sp["ln1"], h, cfg.norm_eps)
                y, new = ssm_lib.ssm_block_decode(sp["ssm"], hn, cp, cfg, lp,
                                                  lora_mode)
                cp["conv"].copy_(new["conv"])
                cp["state"].copy_(new["state"])
                h = h + y
                if "mlp" in sp:
                    h = h + mlp(sp["mlp"], rmsnorm(sp["ln2"], h, cfg.norm_eps),
                                act=cfg.act, glu=cfg.glu, lora=lp,
                                lora_mode=lora_mode)
                continue
            h = h + _attn_decode(sp, lp, h, gc[f"slot{p}"], cfg, kind, pos,
                                 lora_mode, attn_kernel)
            hn = rmsnorm(sp["ln2"], h, cfg.norm_eps)[:, None, :]
            y = _ffn_block(sp, lp, hn, cfg, lora_mode)[0][:, 0]
            if cfg.post_norm:
                y = rmsnorm(sp["post2"], y, cfg.norm_eps)
            h = h + y
        if shared_params is not None:
            h = h + _attn_decode(shared_params, shared_lora, h,
                                 gc["shared"], cfg, "global", pos, lora_mode,
                                 attn_kernel)
            h = h + mlp(shared_params["mlp"],
                        rmsnorm(shared_params["ln2"], h, cfg.norm_eps),
                        act=cfg.act, glu=cfg.glu)
    return h, cache
