"""Attention: GQA + RoPE (+ QKV bias, QK-norm) + blockwise prefill +
cached decode over global, sliding-window or chunked-local rings, bf16 or
int8; the encoder's bidirectional self-attention and the decoder's cross
attention of the encoder-decoder family (``repro.models.attention``).

* Full-sequence attention is computed **blockwise with an online
  softmax** in plain PyTorch: the same query/KV block order and f32
  accumulation as the reference's scans, as two Python loops.
* Decode reads a ring-buffer cache whose stored-position array tracks
  validity: local layers keep ``window`` entries, global layers the whole
  context, so one mask from positions serves every kind. The port
  updates caches in place (the reference returns new arrays); every
  write is a pure function of the step's inputs, so repeating a step
  writes the same values.
* ``kv_cache_quant`` stores K/V as int8 with one bf16 scale per (token,
  kv head), quantized on write (``_quantize_kv``) and dequantized on
  read (``_dequant``), as the reference does.

Each attention function takes the route its caller chose
(``use_kernel``, the model's ``attn_kernel``): ``blockwise_attention``
the plain two-loop code above or the ``flash_prefill`` kernel,
``decode_attention`` the plain einsum code or the ``flash_decode``
kernel (through ``kernels/ops.py``; on CPU tensors each kernel wrapper
runs its plain version). Both kernel routes keep the softmax
probabilities in f32 where the plain code rounds them to V's dtype, and
``flash_decode`` dequantizes an int8 ring in f32 where the plain code
rounds it to q's dtype, so in bf16 the two routes differ by rounding.
Cross attention has one route, plain PyTorch, as the reference's einsums.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAMode
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.kernels import ops
from repro_torch.models.layers import (init_device, linear, repeats, rmsnorm,
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
    if cfg.attn.qk_norm:  # per-head RMSNorm of q and k, (1 + scale)
        hd = cfg.resolved_head_dim
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": torch.zeros((*stack, hd), dtype=dtype,
                                            device=init_device(generator))}
    return p


def _maybe_qk_norm(p: Dict, q: torch.Tensor, k: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, eps)
        k = rmsnorm(p["k_norm"], k, eps)
    return q, k


def project_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, lora: Optional[Dict] = None,
                lora_mode: LoRAMode = LoRAMode()):
    """x: [B, S, d] -> q [B,S,H,hd], k,v [B,S,KH,hd] (post-RoPE/qk-norm)."""
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
    q, k = _maybe_qk_norm(params, q, k, cfg.norm_eps)
    if cfg.attn.rope:
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    q = logical_constraint(q, "batch", None, "heads", None)
    k = logical_constraint(k, "batch", None, "kv_heads", None)
    v = logical_constraint(v, "batch", None, "kv_heads", None)
    return q, k, v


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def mask_fn(kind: str, cfg: ModelConfig):
    """(qpos, kpos) -> bool mask; qpos/kpos broadcast against each other.
    'global' is full causal, 'local' a sliding window of
    ``sliding_window`` positions (with ``chunked_local`` the same-chunk
    mask instead), 'bidir' (the encoder's) every written key."""
    if kind not in ("global", "local", "bidir"):
        raise NotImplementedError(f"attention kind {kind!r} is not ported")
    w = cfg.attn.sliding_window
    chunked = cfg.attn.chunked_local

    def fn(qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
        if kind == "bidir":
            return (kpos >= 0).expand(torch.broadcast_shapes(qpos.shape,
                                                             kpos.shape))
        valid = (kpos >= 0) & (kpos <= qpos)
        if kind == "local":
            if chunked:  # torch's // on integer tensors floors, as JAX's
                valid = valid & ((qpos // w) == (kpos // w))
            else:
                valid = valid & ((qpos - kpos) < w)
        return valid

    return fn


def kernel_window(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    """The window arguments of the attention kernels for a layer kind."""
    if kind == "local":
        return {"window": cfg.attn.sliding_window,
                "chunked": cfg.attn.chunked_local}
    return {"window": None, "chunked": False}


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
    the ``flash_prefill`` kernel (which tiles on its own; non-causal for
    'bidir').

    q: [B, Sq, H, hd]; k, v: [B, Skv, KH, hd]; qpos: [Sq]; kpos: [Skv].
    Returns [B, Sq, H, hd]. Causal/local/bidirectional masking from
    positions.
    """
    mfn = mask_fn(kind, cfg)  # raises for layer kinds not ported
    softcap = cfg.attn.attn_logit_softcap
    if use_kernel:
        return ops.flash_prefill(q, k, v, qpos=qpos, kpos=kpos,
                                 causal=kind != "bidir", softcap=softcap,
                                 **kernel_window(kind, cfg))
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
    with repeats(nq, q) as run_q:
        for qi in range(run_q):
            qblk, qp = qb[:, qi], qposb[qi]
            acc = q.new_zeros((b, kh, g, block_q, hd), dtype=torch.float32)
            m = torch.full((b, kh, g, block_q), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = q.new_zeros((b, kh, g, block_q), dtype=torch.float32)
            with repeats(nkv, k) as run_kv:
                for j in range(run_kv):
                    kj, vj, kp = kb[:, j], vb[:, j], kposb[j]
                    s = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                                     kj).float() * scale
                    if softcap is not None:
                        s = torch.tanh(s / softcap) * softcap
                    mask = mfn(qp[:, None], kp[None, :])         # [bq, bkv]
                    s = torch.where(mask[None, None, None], s, NEG_INF)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "bkgqs,bskd->bkgqd", p.to(vj.dtype), vj).float()
                    m = m_new
            l = torch.clamp_min(l, 1e-30)
            outs.append((acc / l[..., None]).to(q.dtype))      # [b,kh,g,bq,hd]
    out = torch.stack(outs * (nq // len(outs)))                  # [nq,b,kh,g,bq,hd]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd)


# ---------------------------------------------------------------------------
# Cached decode attention
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype, stack: Tuple[int, ...] = (),
                  device: Any = None,
                  quant: bool = False) -> Dict[str, torch.Tensor]:
    shape = (*stack, batch, cache_len, n_kv, head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=torch.int8 if quant else dtype,
                         device=device),
        "v": torch.zeros(shape, dtype=torch.int8 if quant else dtype,
                         device=device),
    }
    if quant:  # one bf16 scale per (token, kv head)
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                      device=device)
    cache["pos"] = torch.full((*stack, batch, cache_len), -1,
                              dtype=torch.int32, device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., hd] -> (int8 values, per-vector f32 scale). ``round`` is
    half-to-even, as ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequant(cache: Dict, name: str) -> torch.Tensor:
    if f"{name}_scale" in cache:
        return cache[name].float() * cache[f"{name}_scale"].float()[..., None]
    return cache[name]


def _write(cache: Dict, put: Any, k: torch.Tensor, v: torch.Tensor) -> None:
    """``put(leaf, values)`` for k and v, in place (quantized on write in
    an int8 cache, the scale stored in the scale leaf's dtype)."""
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            xq, xs = _quantize_kv(x)
            put(cache[name], xq)
            put(cache[f"{name}_scale"], xs)
    else:
        put(cache["k"], k)
        put(cache["v"], v)


def cache_update(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Dict:
    """Ring-buffer write of one token per sequence, in place.

    k_new/v_new: [B, 1, KH, hd]; pos: [B] per-slot positions. Each row
    writes its own ring entry (``scatter_`` along the ring dim, so a
    cache sharded on its batch dim is written shard by shard)."""
    b = cache["k"].shape[0]
    clen = cache["k"].shape[-3]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=cache["pos"].device).expand(b)
    idx = (pos % clen).long()

    def put(leaf: torch.Tensor, x: torch.Tensor) -> None:
        rest = x.shape[1:]
        index = idx.view(b, 1, *(1,) * len(rest)).expand(b, 1, *rest)
        leaf.scatter_(1, index, x[:, None].to(leaf.dtype))

    _write(cache, put, k_new[:, 0], v_new[:, 0])
    put(cache["pos"], pos)
    return cache


def cache_fill(cache: Dict, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor) -> Dict:
    """Bulk ring-buffer write after prefill, in place.

    k, v: [B, S, KH, hd]; positions: [S]. If S exceeds the ring capacity
    only the last ``clen`` tokens are kept (consecutive positions map to
    distinct ring slots, so the write is collision-free)."""
    clen = cache["k"].shape[-3]
    if k.shape[1] > clen:
        k, v, positions = k[:, -clen:], v[:, -clen:], positions[-clen:]
    idx = (positions % clen).long()

    def put(leaf: torch.Tensor, x: torch.Tensor) -> None:
        leaf.index_copy_(1, idx, x.to(leaf.dtype))

    _write(cache, put, k, v)
    put(cache["pos"], positions.to(torch.int32).expand(
        cache["pos"].shape[0], idx.shape[0]))
    return cache


def decode_attention(q: torch.Tensor, cache: Dict, qpos: torch.Tensor, *,
                     kind: str, cfg: ModelConfig,
                     use_kernel: bool = False) -> torch.Tensor:
    """Single-token attention over the ring cache, in plain PyTorch or
    with ``use_kernel`` through the ``flash_decode`` kernel (which reads
    an int8 ring and its scales as stored).

    q: [B, H, hd]; cache k/v: [B, C, KH, hd]; cache pos: [B, C];
    qpos: [B] per-slot positions. Returns [B, H, hd].
    """
    mfn = mask_fn(kind, cfg)  # raises for layer kinds not ported
    softcap = cfg.attn.attn_logit_softcap
    if use_kernel:
        return ops.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                    qpos, k_scale=cache.get("k_scale"),
                                    v_scale=cache.get("v_scale"),
                                    softcap=softcap,
                                    **kernel_window(kind, cfg))
    b, h, hd = q.shape
    kh = cache["k"].shape[-2]
    g = h // kh
    qg = q.reshape(b, kh, g, hd)
    k_cache = _dequant(cache, "k").to(q.dtype)
    v_cache = _dequant(cache, "v").to(q.dtype)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache).float() * hd ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.as_tensor(qpos, dtype=torch.int32, device=q.device).expand(b)
    mask = mfn(qpos[:, None], cache["pos"])                        # [B, C]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, hd)


# ---------------------------------------------------------------------------
# Cross-attention (whisper's decoder), plain PyTorch as in the reference
# ---------------------------------------------------------------------------


def cross_attention(params: Dict, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig, lora: Optional[Dict] = None,
                    lora_mode: LoRAMode = LoRAMode()) -> torch.Tensor:
    """x: [B, S, d]; enc_kv: precomputed (k, v) [B, Senc, KH, hd]. The
    scores are the product in the inputs' dtype, then cast to f32 and
    scaled (in bf16 they round before the scale, as the reference's);
    the softmax is in f32."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    lget = (lora or {}).get
    q = linear({"w": params["wq"]}, x, lget("q"), lora_mode)
    k, v = enc_kv
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, cfg.n_heads // kh, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * hd ** -0.5
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return linear({"w": params["wo"]}, out.reshape(b, s, cfg.q_size),
                  lget("o"), lora_mode)


def encode_cross_kv(params: Dict, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V [B, T, KH, hd] of the encoder output (no
    LoRA: the reference's cross block adapts q and o only)."""
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = linear({"w": params["wk"]}, enc_out).reshape(b, t, cfg.n_kv_heads, hd)
    v = linear({"w": params["wv"]}, enc_out).reshape(b, t, cfg.n_kv_heads, hd)
    return k, v
