"""Decoder stack, dense subset (``repro.models.transformer``).

Layers are organised into **groups** of ``period`` pattern slots with
stacked params, as in the reference::

    params['layers']['slot{p}'][module_leaf]   # leading dim = n_groups

The reference scans over groups; here a Python loop walks them, taking
views of group ``i`` of every stacked leaf. LoRA params mirror the layout
under a separate tree (pool layout ``[ng, R, r, d]``); caches use the
same slot layout and are written in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAMode, init_lora_pair
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (init_device, linear, mlp, mlp_init,
                                      rmsnorm)


# ---------------------------------------------------------------------------
# Stack topology
# ---------------------------------------------------------------------------


def stack_period(cfg: ModelConfig) -> int:
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
    return cfg.attn.layer_pattern[p % len(cfg.attn.layer_pattern)]


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
    return {
        "ln1": {"scale": torch.zeros((ng, d), dtype=dtype, device=dev)},
        "attn": attn_lib.attention_init(generator, cfg, stack=(ng,),
                                        dtype=dtype),
        "ln2": {"scale": torch.zeros((ng, d), dtype=dtype, device=dev)},
        "mlp": mlp_init(generator, d, cfg.d_ff, glu=cfg.glu, dtype=dtype,
                        stack=(ng,)),
    }


def init_stack(generator: Optional[torch.Generator], cfg: ModelConfig,
               dtype: torch.dtype) -> Dict:
    ng = n_groups(cfg)
    return {"layers": {f"slot{p}": init_slot(generator, cfg, p, ng, dtype)
                       for p in range(stack_period(cfg))}}


_LORA_DIMS = {
    "q": lambda c: (c.d_model, c.q_size),
    "k": lambda c: (c.d_model, c.kv_size),
    "v": lambda c: (c.d_model, c.kv_size),
    "o": lambda c: (c.q_size, c.d_model),
    "up": lambda c: (c.d_model, c.d_ff),
    "gate": lambda c: (c.d_model, c.d_ff),
    "down": lambda c: (c.d_ff, c.d_model),
}

_ATTN_MODULES = ("q", "k", "v", "o")
_MLP_MODULES = ("up", "gate", "down")


def init_lora_stack(generator: torch.Generator, cfg: ModelConfig, *,
                    n_slots: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """LoRA tree mirroring the stack. n_slots=None -> single adapter
    (leaves [ng, r, d]); n_slots=R -> stacked pool ([ng, R, r, d])."""
    ng = n_groups(cfg)
    pool = () if n_slots is None else (n_slots,)
    targets = set(cfg.lora.target_modules)
    tree: Dict[str, Any] = {"layers": {}}
    for p in range(stack_period(cfg)):
        mods = tuple(m for m in _ATTN_MODULES if m in targets)
        mods += tuple(m for m in _MLP_MODULES
                      if m in targets and cfg.d_ff and (cfg.glu or m != "gate"))
        tree["layers"][f"slot{p}"] = {
            m: init_lora_pair(generator, *_LORA_DIMS[m](cfg), cfg.lora.rank,
                              stack=(ng, *pool), dtype=dtype)
            for m in mods}
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
    return linear({"w": slot_p["attn"]["wo"]}, o, (lora_p or {}).get("o"),
                  lora_mode)


def _ffn_block_full(slot_p: Dict, lora_p: Optional[Dict], x: torch.Tensor,
                    cfg: ModelConfig, lora_mode: LoRAMode) -> torch.Tensor:
    h = rmsnorm(slot_p["ln2"], x, cfg.norm_eps)
    return mlp(slot_p["mlp"], h, act=cfg.act, glu=cfg.glu, lora=lora_p,
               lora_mode=lora_mode)


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
    bulk-write their K/V into the ring caches (in place). ``seq_mask`` /
    ``lengths`` matter only to recurrent slots, which this slice does not
    run; right-padded rows are handled by the caller's last-token gather
    and cache invalidation, as in the reference.

    ``prefix_kv`` (suffix prefill over a cached prefix: the shared-prefix
    cache and chunked prefill): a tree mirroring the attention slots of
    ``cache`` with leaves [ng, B, P, ...] — per-layer K/V for positions
    ``prefix_positions`` [P]. Attention runs over prefix-then-fresh keys;
    only the fresh suffix is written to ``cache``.

    ``attn_kernel`` routes every layer's attention through the
    ``flash_prefill`` kernel instead of the plain blockwise loops.
    """
    del seq_mask, lengths  # attention-only stack: see docstring
    if prefix_kv is not None and cache is None:
        raise ValueError("prefix_kv requires the prefill path (a cache)")
    opts = opts or {}
    period = stack_period(cfg)
    lora_layers = (lora or {}).get("layers", {})
    fill = cache is not None
    h = x
    for gi in range(n_groups(cfg)):
        gp = group_view(params["layers"], gi)
        gl = group_view(lora_layers, gi) if lora_layers else {}
        gc = group_view(cache, gi) if fill else {}
        gpre = group_view(prefix_kv, gi) if prefix_kv is not None else {}
        for p in range(period):
            kind = slot_kind(cfg, p)
            sp, lp = gp[f"slot{p}"], gl.get(f"slot{p}")
            h = h + _attn_block_full(sp, lp, h, cfg, kind, positions,
                                     lora_mode, opts, gc.get(f"slot{p}"),
                                     prefix_kv=gpre.get(f"slot{p}"),
                                     prefix_positions=prefix_positions,
                                     attn_kernel=attn_kernel)
            h = h + _ffn_block_full(sp, lp, h, cfg, lora_mode)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"load_balance": zero, "router_z": zero}
    if fill:
        return h, aux, cache
    return h, aux


# ---------------------------------------------------------------------------
# Cache init + decode step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device: Any = None) -> Dict:
    ng = n_groups(cfg)
    return {f"slot{p}": attn_lib.init_kv_cache(
        batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
        stack=(ng,), device=device) for p in range(stack_period(cfg))}


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
    return linear({"w": sp["attn"]["wo"]}, o.reshape(b, 1, cfg.q_size),
                  (lp or {}).get("o"), lora_mode)[:, 0]


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
    h = x
    for gi in range(n_groups(cfg)):
        gp = group_view(params["layers"], gi)
        gl = group_view(lora_layers, gi) if lora_layers else {}
        gc = group_view(cache, gi)
        for p in range(period):
            kind = slot_kind(cfg, p)
            sp, lp = gp[f"slot{p}"], gl.get(f"slot{p}")
            h = h + _attn_decode(sp, lp, h, gc[f"slot{p}"], cfg, kind, pos,
                                 lora_mode, attn_kernel)
            hn = rmsnorm(sp["ln2"], h, cfg.norm_eps)[:, None, :]
            y = mlp(sp["mlp"], hn, act=cfg.act, glu=cfg.glu, lora=lp,
                    lora_mode=lora_mode)
            h = h + y[:, 0]
    return h, cache
