"""Mamba-2 (SSD, state-space duality) block (``repro.models.ssm``)
[arXiv:2405.21060].

The *chunked dual form* for prefill and training — an intra-chunk
quadratic, attention-like term plus an inter-chunk recurrence over chunk
states (the blocked algorithm of the SSD paper, §6) — and the O(1)
recurrent step for decode. The recurrent state takes the place of the KV
cache: its size does not grow with the sequence.

As in the reference, none of this is a kernel: the reference computes the
SSD with ``jnp.einsum`` and ``lax.scan`` outside any Pallas call, so here
it is ``torch.einsum`` and a Python loop over the chunks. The SSD runs in
f32 whatever the model dtype (x, B and C cast, ``a = -exp(A_log)``); the
``dt_bias``, ``A_log`` and ``D`` params and the decode state are f32, the
conv ring keeps the model dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAMode
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models.layers import (init_device, linear, rmsnorm,
                                      truncated_normal_init)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    return s, d, di, h, s.n_groups, s.d_state, s.head_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no switch to the identity
    above a threshold, as ``F.softplus`` has)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _repeat_groups(x: torch.Tensor, rep: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=-2)``: each group of [..., G, N] repeated
    ``rep`` times in place, [..., G * rep, N] (an expand, so no host
    sync)."""
    *lead, g, n = x.shape
    return x.unsqueeze(-2).expand(*lead, g, rep, n).reshape(*lead, g * rep, n)


def ssm_init(generator: Optional[torch.Generator], cfg: ModelConfig, *,
             stack: Tuple[int, ...] = (), dtype: torch.dtype) -> Dict:
    s, d, di, h, g, n, p = _dims(cfg)
    dev = init_device(generator)
    conv_ch = di + 2 * g * n
    in_dim = 2 * di + 2 * g * n + h  # z, xBC, dt
    lo, hi = s.a_init_range
    a_init = torch.log(torch.linspace(lo, hi, h, dtype=torch.float32,
                                      device=dev))
    return {
        "in_proj": truncated_normal_init(generator, (*stack, d, in_dim), 1.0,
                                         dtype),
        "out_proj": truncated_normal_init(generator, (*stack, di, d), 1.0,
                                          dtype),
        "conv_w": truncated_normal_init(generator, (*stack, s.d_conv,
                                                    conv_ch), 1.0, dtype),
        "conv_b": torch.zeros((*stack, conv_ch), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((*stack, h), dtype=torch.float32, device=dev),
        "A_log": a_init.expand(*stack, h).contiguous(),
        "D": torch.ones((*stack, h), dtype=torch.float32, device=dev),
        "gate_norm": {"scale": torch.zeros((*stack, di), dtype=dtype,
                                           device=dev)},
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d, di, h, g, n, p = _dims(cfg)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, h], dim=-1)
    return z, xbc, dt


def _causal_conv_full(xbc: torch.Tensor, conv_w: torch.Tensor,
                      conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence. xbc: [B, S, C]."""
    d_conv = conv_w.shape[0]
    pads = F.pad(xbc, (0, 0, d_conv - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(d_conv):  # d_conv is 4: unrolled adds, as the reference
        out = out + pads[:, i:i + xbc.shape[1], :] * conv_w[i]
    return F.silu(out + conv_b)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., L] -> [..., L, L] lower-triangular pairwise cumulative sums:
    out[i, j] = sum_{k in (j, i]} x[k], -inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD blocked algorithm.

    x: [B, S, H, P]; dt: [B, S, H] (post-softplus); a: [H] (negative);
    b_mat, c_mat: [B, S, G, N]. Returns (y [B, S, H, P], final_state
    [B, H, P, N])."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    if s % chunk:
        raise ValueError(f"ssd_chunked: length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk

    # expand groups to heads; chunked views
    bm = _repeat_groups(b_mat, rep)                        # [B, S, H, N]
    cm = _repeat_groups(c_mat, rep)
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = bm.reshape(bsz, nc, chunk, h, n)
    cc = cm.reshape(bsz, nc, chunk, h, n)

    da = dtc * a                                   # [B, nc, L, H] (a < 0)
    da_cum = torch.cumsum(da, dim=2)               # within-chunk cumulative

    # ---- intra-chunk (diagonal blocks): quadratic attention-like term ----
    decay = torch.exp(segsum(da.permute(0, 1, 3, 2)))     # [B, nc, H, L, L]
    cb = torch.einsum("bclhn,bcshn->bchls", cc, bc)       # [B, nc, H, L, S]
    y_diag = torch.einsum("bchls,bcshp->bclhp", cb * decay,
                          xc * dtc[..., None])

    # ---- chunk-final states ----
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # [B, nc, L, H]
    states = torch.einsum("bclhn,bclhp->bchpn",
                          bc * (dtc * decay_to_end)[..., None], xc)

    # ---- inter-chunk recurrence over chunk states (the reference's scan):
    # the state *entering* each chunk ----
    chunk_decay = torch.exp(da_cum[:, :, -1, :])           # [B, nc, H]
    state = (x.new_zeros((bsz, h, p, n)) if initial_state is None
             else initial_state.to(x.dtype))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)             # [B, nc, H, P, N]

    # ---- off-diagonal contribution from the entering state ----
    state_decay = torch.exp(da_cum)                        # [B, nc, L, H]
    y_off = torch.einsum("bclhn,bchpn->bclhp", cc,
                         prev_states) * state_decay[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, state


def ssm_block_full(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                   lora: Optional[Dict] = None,
                   lora_mode: LoRAMode = LoRAMode(),
                   initial_state: Optional[torch.Tensor] = None,
                   return_state: bool = False,
                   seq_mask: Optional[torch.Tensor] = None,
                   lengths: Optional[torch.Tensor] = None):
    """Full-sequence Mamba-2 block. x: [B, S, d_model] -> same shape.

    seq_mask [B, S] (True = real token) zeroes dt at right-padding so the
    recurrent state ignores pad steps; ``lengths`` [B] makes the returned
    conv-tail state the last real tokens' (gathered at indices clipped to
    [0, S-1], as in the reference: a prompt shorter than d_conv - 1 tokens
    repeats position 0 where a true zero history would be).
    """
    s, d, di, h, g, n, p = _dims(cfg)
    lget = (lora or {}).get
    zxbcdt = linear({"w": params["in_proj"]}, x, lget("in_proj"), lora_mode)
    z, xbc_raw, dt = _split_in_proj(cfg, zxbcdt)
    if lengths is not None:
        # conv tail = xBC at positions [len-(d_conv-1), len) per sequence
        offs = torch.arange(s.d_conv - 1, device=x.device) - (s.d_conv - 1)
        idx = (lengths.to(x.device).long()[:, None] + offs[None, :]).clamp(
            0, x.shape[1] - 1)                              # [B, d_conv-1]
        conv_tail = torch.take_along_dim(xbc_raw, idx[..., None], dim=1)
    else:
        conv_tail = xbc_raw[:, -(s.d_conv - 1):, :]  # decode conv seam state
    xbc = _causal_conv_full(xbc_raw, params["conv_w"].to(x.dtype),
                            params["conv_b"].to(x.dtype))
    x_in, b_mat, c_mat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    bsz, sl, _ = x.shape
    x_heads = x_in.reshape(bsz, sl, h, p)
    x_heads = logical_constraint(x_heads, "batch", None, "ssm_heads", None)
    b_mat = b_mat.reshape(bsz, sl, g, n)
    c_mat = c_mat.reshape(bsz, sl, g, n)
    dt_f = softplus(dt.float() + params["dt_bias"].float())
    if seq_mask is not None:
        dt_f = dt_f.masked_fill(~seq_mask[..., None], 0.0)
    a = -torch.exp(params["A_log"].float())
    # pad to a chunk multiple; padded steps get dt=0 (identity transition,
    # zero input) so neither y at real positions nor the final state change
    chunk = min(s.chunk_size, sl)
    pad = (-sl) % chunk
    x_f = x_heads.float()
    b_f, c_f = b_mat.float(), c_mat.float()
    if pad:
        x_f = F.pad(x_f, (0, 0, 0, 0, 0, pad))
        dt_f = F.pad(dt_f, (0, 0, 0, pad))
        b_f = F.pad(b_f, (0, 0, 0, 0, 0, pad))
        c_f = F.pad(c_f, (0, 0, 0, 0, 0, pad))
    y, state = ssd_chunked(x_f, dt_f, a, b_f, c_f, chunk=chunk,
                           initial_state=initial_state)
    if pad:
        y = y[:, :sl]
    y = y + x_heads.float() * params["D"].float()[:, None]
    y = y.reshape(bsz, sl, di).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = linear({"w": params["out_proj"]}, y, lget("out_proj"), lora_mode)
    if return_state:
        return out, state, conv_tail
    return out


def init_ssm_cache(batch: int, cfg: ModelConfig, dtype: torch.dtype,
                   stack: Tuple[int, ...] = (), device: Any = None) -> Dict:
    s, d, di, h, g, n, p = _dims(cfg)
    conv_ch = di + 2 * g * n
    return {
        "conv": torch.zeros((*stack, batch, s.d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((*stack, batch, h, p, n), dtype=torch.float32,
                             device=device),
    }


def ssm_block_decode(params: Dict, x: torch.Tensor, cache: Dict,
                     cfg: ModelConfig, lora: Optional[Dict] = None,
                     lora_mode: LoRAMode = LoRAMode()):
    """One-token recurrent step. x: [B, d_model] -> ([B, d_model], new
    cache {conv, state}); ``cache`` itself is not written."""
    s, d, di, h, g, n, p = _dims(cfg)
    lget = (lora or {}).get
    zxbcdt = linear({"w": params["in_proj"]}, x[:, None, :],
                    lget("in_proj"), lora_mode)[:, 0]
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)

    # conv ring: window = concat(conv_state, xbc)
    window = torch.cat([cache["conv"].to(x.dtype), xbc[:, None, :]], dim=1)
    conv_w = params["conv_w"].to(x.dtype)
    xbc_out = F.silu(torch.einsum("bkc,kc->bc", window, conv_w)
                     + params["conv_b"].to(x.dtype))
    new_conv = window[:, 1:, :]

    x_in, b_mat, c_mat = torch.split(xbc_out, [di, g * n, g * n], dim=-1)
    bsz = x.shape[0]
    xh = x_in.reshape(bsz, h, p).float()
    bm = _repeat_groups(b_mat.reshape(bsz, g, n), h // g).float()
    cm = _repeat_groups(c_mat.reshape(bsz, g, n), h // g).float()
    dt_f = softplus(dt.float() + params["dt_bias"].float())       # [B, H]
    a = -torch.exp(params["A_log"].float())
    da = torch.exp(dt_f * a)                                        # [B, H]
    # state update: S = S·exp(dtA) + dt·x ⊗ B
    state = (cache["state"] * da[..., None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt_f, xh, bm))
    y = torch.einsum("bhpn,bhn->bhp", state, cm)
    y = y + xh * params["D"].float()[:, None]
    y = y.reshape(bsz, di).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = linear({"w": params["out_proj"]}, y[:, None, :],
                 lget("out_proj"), lora_mode)[:, 0]
    return out, {"conv": new_conv.to(cache["conv"].dtype), "state": state}
