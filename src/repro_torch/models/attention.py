"""Attention, dense-global subset: GQA + RoPE (+ QKV bias) + blockwise
prefill + cached decode (``repro.models.attention``).

* Full-sequence attention is computed **blockwise with an online
  softmax** in plain PyTorch: the same query/KV block order and f32
  accumulation as the reference's scans, as two Python loops.
* Decode reads a ring-buffer cache whose stored-position array tracks
  validity. The port updates caches in place (the reference returns new
  arrays); every write is a pure function of the step's inputs, so
  repeating a step writes the same values.

Each attention function takes the route its caller chose
(``use_kernel``, the model's ``attn_kernel``): ``blockwise_attention``
the plain two-loop code above or the ``flash_prefill`` kernel,
``decode_attention`` the plain einsum code or the ``flash_decode``
kernel (through ``kernels/ops.py``; on CPU tensors each kernel wrapper
runs its plain version). Both kernel routes keep the softmax
probabilities in f32 where the plain code rounds them to V's dtype, so
in bf16 the two routes differ by rounding.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAMode
from repro_torch.kernels import ops
from repro_torch.models.layers import (init_device, linear,
                                      truncated_normal_init)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE (split-half convention, f32 angles)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: Any = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: a tensor made from it on the card would be a
    # host-to-device copy, which waits on the device (twice per layer)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # [hd/2]
    angles = positions[..., None].float() * freqs               # [..., S, hd/2]
    angles = angles[..., None, :]                                # [..., S, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attention_init(generator: Optional[torch.Generator], cfg: ModelConfig, *,
                   stack: Tuple[int, ...] = (),
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, qs, kvs = cfg.d_model, cfg.q_size, cfg.kv_size
    p = {
        "wq": truncated_normal_init(generator, (*stack, d, qs), 1.0, dtype),
        "wk": truncated_normal_init(generator, (*stack, d, kvs), 1.0, dtype),
        "wv": truncated_normal_init(generator, (*stack, d, kvs), 1.0, dtype),
        "wo": truncated_normal_init(generator, (*stack, qs, d), 1.0, dtype),
    }
    if cfg.attn.qkv_bias:  # zero at init, as in the reference
        dev = init_device(generator)
        for name, size in (("bq", qs), ("bk", kvs), ("bv", kvs)):
            p[name] = torch.zeros((*stack, size), dtype=dtype, device=dev)
    return p


def project_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, lora: Optional[Dict] = None,
                lora_mode: LoRAMode = LoRAMode()):
    """x: [B, S, d] -> q [B,S,H,hd], k,v [B,S,KH,hd] (post-RoPE)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    lget = (lora or {}).get

    def proj(name: str, w: torch.Tensor, bias: Optional[torch.Tensor],
             nheads: int) -> torch.Tensor:
        pr = {"w": w}
        if bias is not None:  # x·W + b, then the LoRA delta
            pr["b"] = bias
        return linear(pr, x, lget(name), lora_mode).reshape(b, s, nheads, hd)

    q = proj("q", params["wq"], params.get("bq"), cfg.n_heads)
    k = proj("k", params["wk"], params.get("bk"), cfg.n_kv_heads)
    v = proj("v", params["wv"], params.get("bv"), cfg.n_kv_heads)
    if cfg.attn.rope:
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def mask_fn(kind: str, cfg: ModelConfig):
    """(qpos, kpos) -> bool mask; qpos/kpos broadcast against each other.
    This slice runs global (full causal) layers only."""
    if kind != "global":
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (dense-global "
            "slice only; see ROADMAP.md)")

    def fn(qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
        return (kpos >= 0) & (kpos <= qpos)

    return fn


# ---------------------------------------------------------------------------
# Blockwise full-sequence attention (prefill)
# ---------------------------------------------------------------------------


def _fit_block(n: int, requested: int) -> int:
    """Largest divisor of n that is <= requested."""
    b = min(requested, n)
    while n % b:
        b -= 1
    return b


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor, *,
                        kind: str, cfg: ModelConfig, block_q: int = 512,
                        block_kv: int = 1024,
                        use_kernel: bool = False) -> torch.Tensor:
    """Flash-style attention in plain PyTorch, or with ``use_kernel``
    the ``flash_prefill`` kernel (which tiles on its own).

    q: [B, Sq, H, hd]; k, v: [B, Skv, KH, hd]; qpos: [Sq]; kpos: [Skv].
    Returns [B, Sq, H, hd]. Causal masking from positions.
    """
    mfn = mask_fn(kind, cfg)  # raises for layer kinds not ported
    softcap = cfg.attn.attn_logit_softcap
    if use_kernel:  # global layers: causal, no window
        return ops.flash_prefill(q, k, v, qpos=qpos, kpos=kpos, causal=True,
                                 softcap=softcap)
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    block_q = _fit_block(sq, block_q)
    block_kv = _fit_block(skv, block_kv)
    nq, nkv = sq // block_q, skv // block_kv
    scale = hd ** -0.5

    qb = q.reshape(b, nq, block_q, kh, g, hd)
    kb = k.reshape(b, nkv, block_kv, kh, hd)
    vb = v.reshape(b, nkv, block_kv, kh, hd)
    qposb = qpos.reshape(nq, block_q)
    kposb = kpos.reshape(nkv, block_kv)

    outs = []
    for qi in range(nq):
        qblk, qp = qb[:, qi], qposb[qi]
        acc = q.new_zeros((b, kh, g, block_q, hd), dtype=torch.float32)
        m = torch.full((b, kh, g, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = q.new_zeros((b, kh, g, block_q), dtype=torch.float32)
        for j in range(nkv):
            kj, vj, kp = kb[:, j], vb[:, j], kposb[j]
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kj).float() * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            mask = mfn(qp[:, None], kp[None, :])                 # [bq, bkv]
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vj.dtype), vj).float()
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))          # [b,kh,g,bq,hd]
    out = torch.stack(outs)                                      # [nq,b,kh,g,bq,hd]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd)


# ---------------------------------------------------------------------------
# Cached decode attention
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype, stack: Tuple[int, ...] = (),
                  device: Any = None) -> Dict[str, torch.Tensor]:
    shape = (*stack, batch, cache_len, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((*stack, batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def cache_update(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Dict:
    """Ring-buffer write of one token per sequence, in place.

    k_new/v_new: [B, 1, KH, hd]; pos: [B] per-slot positions."""
    b = cache["k"].shape[0]
    clen = cache["k"].shape[-3]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=cache["pos"].device).expand(b)
    idx = (pos % clen).long()
    rows = torch.arange(b, device=idx.device)
    cache["k"][rows, idx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, idx] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, idx] = pos
    return cache


def cache_fill(cache: Dict, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor) -> Dict:
    """Bulk ring-buffer write after prefill, in place.

    k, v: [B, S, KH, hd]; positions: [S]. If S exceeds the ring capacity
    only the last ``clen`` tokens are kept."""
    clen = cache["k"].shape[-3]
    if k.shape[1] > clen:
        k, v, positions = k[:, -clen:], v[:, -clen:], positions[-clen:]
    idx = (positions % clen).long()
    cache["k"][:, idx] = k.to(cache["k"].dtype)
    cache["v"][:, idx] = v.to(cache["v"].dtype)
    cache["pos"][:, idx] = positions.to(torch.int32).expand(
        cache["pos"].shape[0], idx.shape[0])
    return cache


def decode_attention(q: torch.Tensor, cache: Dict, qpos: torch.Tensor, *,
                     kind: str, cfg: ModelConfig,
                     use_kernel: bool = False) -> torch.Tensor:
    """Single-token attention over the ring cache, in plain PyTorch or
    with ``use_kernel`` through the ``flash_decode`` kernel.

    q: [B, H, hd]; cache k/v: [B, C, KH, hd]; cache pos: [B, C];
    qpos: [B] per-slot positions. Returns [B, H, hd].
    """
    mfn = mask_fn(kind, cfg)  # raises for layer kinds not ported
    softcap = cfg.attn.attn_logit_softcap
    if use_kernel:  # global layers: causal, no window
        return ops.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                    qpos, softcap=softcap)
    b, h, hd = q.shape
    kh = cache["k"].shape[-2]
    g = h // kh
    qg = q.reshape(b, kh, g, hd)
    k_cache = cache["k"].to(q.dtype)
    v_cache = cache["v"].to(q.dtype)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache).float() * hd ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.as_tensor(qpos, dtype=torch.int32, device=q.device).expand(b)
    mask = mfn(qpos[:, None], cache["pos"])                        # [B, C]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, hd)
