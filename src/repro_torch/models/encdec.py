"""Whisper-style encoder-decoder backbone (``repro.models.encdec``).

The modality frontend (mel spectrogram + conv feature extractor) is a
stub, as in the reference: the caller gives precomputed frame embeddings
``frames`` [B, n_frames, d_model]. This module runs the transformer
encoder over them (LayerNorm, bidirectional self-attention, a plain MLP)
and the decoder that consumes them (causal self-attention, cross
attention, MLP). Positions are sinusoidal and parameter-free; there is
no RoPE.

Params are stacked over layers (``params['encoder']['layers'][leaf]``
has a leading ``n_layers`` axis, as the reference's scans take them) and
a Python loop walks the layers, taking views of layer ``i``. LoRA leaves
are ``[n_layers, (R,) r, d]``: the encoder and the decoder adapt q, k,
v, o, up and down where the config targets them, the cross block q and o
only. Caches are written in place: ``cache['self']`` is the decoder's
ring, ``cache['cross_k']``/``['cross_v']`` [n_layers, B, T, KH, hd] the
cross K/V, filled once from the encoder output.

``attn_kernel`` routes the encoder's self-attention through
``flash_prefill`` with ``causal=False`` and the decoder's through
``flash_prefill`` / ``flash_decode``, as the decoder-only stacks do.
Cross attention stays plain PyTorch, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAMode, init_lora_pair
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (init_device, layernorm, layernorm_init,
                                      linear, mlp, mlp_init)
from repro_torch.models.transformer import group_view


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """positions: [...] -> [..., d_model] sinusoidal embedding (f32)."""
    half = d_model // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _block_init(generator: Optional[torch.Generator], cfg: ModelConfig,
                n: int, dtype: torch.dtype, cross: bool) -> Dict:
    dev, d = init_device(generator), cfg.d_model
    layers: Dict[str, Any] = {
        "ln1": layernorm_init(d, dtype, stack=(n,), device=dev),
        "attn": attn_lib.attention_init(generator, cfg, stack=(n,),
                                        dtype=dtype)}
    if cross:
        layers["ln_x"] = layernorm_init(d, dtype, stack=(n,), device=dev)
        layers["cross"] = attn_lib.attention_init(generator, cfg, stack=(n,),
                                                  dtype=dtype)
    layers["ln2"] = layernorm_init(d, dtype, stack=(n,), device=dev)
    layers["mlp"] = mlp_init(generator, d, cfg.d_ff, glu=cfg.glu,
                             dtype=dtype, stack=(n,))
    return {"layers": layers,
            "ln_post": layernorm_init(d, dtype, device=dev)}


def init_encoder(generator: Optional[torch.Generator], cfg: ModelConfig,
                 dtype: torch.dtype) -> Dict:
    return _block_init(generator, cfg, cfg.encoder.n_layers, dtype,
                       cross=False)


def init_decoder(generator: Optional[torch.Generator], cfg: ModelConfig,
                 dtype: torch.dtype) -> Dict:
    return _block_init(generator, cfg, cfg.n_layers, dtype, cross=True)


def init_encdec_lora(generator: torch.Generator, cfg: ModelConfig, *,
                     n_slots: Optional[int] = None,
                     dtype: torch.dtype = torch.float32) -> Dict:
    """LoRA pairs of the encoder and the decoder (q, k, v, o, up, down
    where targeted) and of the cross block (q and o). n_slots=None: one
    adapter, leaves [n_layers, r, d]; n_slots=R: a pool, [n_layers, R, r,
    d]."""
    pool = () if n_slots is None else (n_slots,)
    targets = set(cfg.lora.target_modules)
    rank = cfg.lora.rank
    dims = {
        "q": (cfg.d_model, cfg.q_size), "k": (cfg.d_model, cfg.kv_size),
        "v": (cfg.d_model, cfg.kv_size), "o": (cfg.q_size, cfg.d_model),
        "up": (cfg.d_model, cfg.d_ff), "down": (cfg.d_ff, cfg.d_model),
    }

    def mods(names, n):
        return {m: init_lora_pair(generator, *dims[m], rank,
                                  stack=(n, *pool), dtype=dtype)
                for m in names if m in targets}

    return {"encoder": mods(dims, cfg.encoder.n_layers),
            "decoder": mods(dims, cfg.n_layers),
            "cross": mods(("q", "o"), cfg.n_layers)}


def _layer(tree: Dict, i: int) -> Dict:
    return group_view(tree, i) if tree else {}


# ---------------------------------------------------------------------------
# Encoder forward
# ---------------------------------------------------------------------------


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig,
           lora: Optional[Dict] = None, lora_mode: LoRAMode = LoRAMode(),
           opts: Optional[Dict] = None, *,
           attn_kernel: bool = False) -> torch.Tensor:
    """frames: [B, T, d] stub embeddings -> encoder states [B, T, d]."""
    opts = opts or {}
    b, t, d = frames.shape
    pos = torch.arange(t, device=frames.device)
    h = frames + sinusoidal_positions(pos, d).to(frames.dtype)
    enc_lora = (lora or {}).get("encoder", {})
    for i in range(cfg.encoder.n_layers):
        lp, ll = group_view(params["layers"], i), _layer(enc_lora, i)
        hn = layernorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = attn_lib.project_qkv(lp["attn"], hn, cfg, pos, ll,
                                       lora_mode)
        o = attn_lib.blockwise_attention(
            q, k, v, pos, pos, kind="bidir", cfg=cfg,
            block_q=opts.get("block_q", 512),
            block_kv=opts.get("block_kv", 512), use_kernel=attn_kernel)
        h = h + linear({"w": lp["attn"]["wo"]}, o.reshape(b, t, cfg.q_size),
                       ll.get("o"), lora_mode)
        h = h + mlp(lp["mlp"], layernorm(lp["ln2"], h, cfg.norm_eps),
                    act=cfg.act, glu=cfg.glu, lora=ll, lora_mode=lora_mode)
    return layernorm(params["ln_post"], h, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder forward (teacher-forced) and decode step
# ---------------------------------------------------------------------------


def decode_full(params: Dict, tokens_embedded: torch.Tensor,
                enc_out: torch.Tensor, cfg: ModelConfig,
                lora: Optional[Dict] = None,
                lora_mode: LoRAMode = LoRAMode(),
                opts: Optional[Dict] = None,
                self_cache: Optional[Dict] = None, *,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                attn_kernel: bool = False):
    """tokens_embedded: [B, S, d]; enc_out: [B, T, d] -> hidden [B, S, d].

    With ``self_cache`` (stacked [n_layers, ...]) the decoder K/V is also
    written into it, in place (the prefill path), and the result is
    (hidden, self_cache). ``cross_kv``: the cross K/V already projected
    from ``enc_out`` (``fill_cross_cache``'s leaves), read instead of
    projecting them again; the reference projects them a second time
    here, from the same input to the same values."""
    opts = opts or {}
    b, s, d = tokens_embedded.shape
    pos = torch.arange(s, device=tokens_embedded.device)
    h = tokens_embedded + sinusoidal_positions(pos, d).to(
        tokens_embedded.dtype)
    dec_lora = (lora or {}).get("decoder", {})
    cross_lora = (lora or {}).get("cross", {})
    for i in range(cfg.n_layers):
        lp = group_view(params["layers"], i)
        ll, cl = _layer(dec_lora, i), _layer(cross_lora, i)
        hn = layernorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = attn_lib.project_qkv(lp["attn"], hn, cfg, pos, ll,
                                       lora_mode)
        if self_cache is not None:
            attn_lib.cache_fill(group_view(self_cache, i), k, v, pos)
        o = attn_lib.blockwise_attention(
            q, k, v, pos, pos, kind="global", cfg=cfg,
            block_q=opts.get("block_q", 512),
            block_kv=opts.get("block_kv", 1024), use_kernel=attn_kernel)
        h = h + linear({"w": lp["attn"]["wo"]}, o.reshape(b, s, cfg.q_size),
                       ll.get("o"), lora_mode)
        hx = layernorm(lp["ln_x"], h, cfg.norm_eps)
        enc_kv = ((cross_kv[0][i], cross_kv[1][i]) if cross_kv is not None
                  else attn_lib.encode_cross_kv(lp["cross"], enc_out, cfg))
        h = h + attn_lib.cross_attention(lp["cross"], hx, enc_kv, cfg, cl,
                                         lora_mode)
        h = h + mlp(lp["mlp"], layernorm(lp["ln2"], h, cfg.norm_eps),
                    act=cfg.act, glu=cfg.glu, lora=ll, lora_mode=lora_mode)
    out = layernorm(params["ln_post"], h, cfg.norm_eps)
    if self_cache is not None:
        return out, self_cache
    return out


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       enc_frames: int, dtype: torch.dtype,
                       device: Any = None) -> Dict:
    nl, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (nl, batch, enc_frames, kh, hd)
    return {
        "self": attn_lib.init_kv_cache(batch, max_len, kh, hd, dtype,
                                       stack=(nl,), device=device),
        # the cross K/V, filled once from the encoder output
        "cross_k": torch.zeros(shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=dtype, device=device),
    }


def fill_cross_cache(params: Dict, enc_out: torch.Tensor, cfg: ModelConfig,
                     cache: Dict) -> Dict:
    """Every decoder layer's cross K/V of ``enc_out``, written into
    ``cache['cross_k']``/``['cross_v']`` in place."""
    for i in range(cfg.n_layers):
        k, v = attn_lib.encode_cross_kv(
            group_view(params["layers"], i)["cross"], enc_out, cfg)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    return cache


def decode_step(params: Dict, tok_embedded: torch.Tensor, cache: Dict,
                cfg: ModelConfig, pos: Any, lora: Optional[Dict] = None,
                lora_mode: LoRAMode = LoRAMode(), *,
                attn_kernel: bool = False) -> Tuple[torch.Tensor, Dict]:
    """tok_embedded: [B, d]; one decoder step over the self ring (updated
    in place) and the cross K/V. pos: scalar or [B] per-row positions."""
    b, d = tok_embedded.shape
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=tok_embedded.device).expand(b)
    h = tok_embedded + sinusoidal_positions(pos, d).to(tok_embedded.dtype)
    dec_lora = (lora or {}).get("decoder", {})
    cross_lora = (lora or {}).get("cross", {})
    for i in range(cfg.n_layers):
        lp, sc = group_view(params["layers"], i), group_view(cache["self"], i)
        ll, cl = _layer(dec_lora, i), _layer(cross_lora, i)
        hn = layernorm(lp["ln1"], h, cfg.norm_eps)[:, None, :]
        q, k, v = attn_lib.project_qkv(lp["attn"], hn, cfg, pos[:, None], ll,
                                       lora_mode)
        attn_lib.cache_update(sc, k, v, pos)
        o = attn_lib.decode_attention(q[:, 0], sc, pos, kind="global",
                                      cfg=cfg, use_kernel=attn_kernel)
        h = h + linear({"w": lp["attn"]["wo"]}, o.reshape(b, 1, cfg.q_size),
                       ll.get("o"), lora_mode)[:, 0]
        hx = layernorm(lp["ln_x"], h, cfg.norm_eps)[:, None, :]
        h = h + attn_lib.cross_attention(
            lp["cross"], hx, (cache["cross_k"][i], cache["cross_v"][i]), cfg,
            cl, lora_mode)[:, 0]
        h = h + mlp(lp["mlp"], layernorm(lp["ln2"], h, cfg.norm_eps),
                    act=cfg.act, glu=cfg.glu, lora=ll, lora_mode=lora_mode)
    return layernorm(params["ln_post"], h, cfg.norm_eps), cache
