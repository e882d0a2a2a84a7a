"""Mixture-of-Experts block with capacity-based dispatch
(``repro.models.moe``).

Top-k routing over f32 router logits; each (token, choice) takes the next
place in its expert's queue, token-major, and choices past the expert's
capacity drop. Dispatch is a scatter into an ``[E, C, d]`` expert buffer
and a gather back, as in the reference (which chose it over the classic
``[T, E, C]`` one-hot einsum for memory); small batches may take that
one-hot einsum instead (``MoEConfig.gather_threshold``). Experts are
stacked on a leading dim and computed as batched GEMMs. Sharding hints
(``logical_constraint``) sit where the reference's do: the identity off
a mesh, a redistribution of DTensors in the dry-run.

Every step is device-side and sync-free: no boolean-mask indexing, no
``nonzero``, no host reads; capacities come from Python ints of the
shapes. Returns aux losses (load-balance + router z-loss) for training.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.lora import LoRAMode
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models.layers import (activation, mlp, mlp_init,
                                      truncated_normal_init)


def moe_init(generator: Optional[torch.Generator], cfg: ModelConfig, *,
             stack: Tuple[int, ...] = (), dtype: torch.dtype) -> Dict:
    """Router ``[*stack, d, E]`` (f32 whatever ``dtype``), the experts'
    MLP stacked ``[*stack, E, ...]`` and, with ``shared_expert``, a
    shared MLP."""
    m = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "router": truncated_normal_init(generator, (*stack, d, m.n_experts),
                                        1.0, torch.float32),
        "experts": mlp_init(generator, d, f, glu=cfg.glu, dtype=dtype,
                            stack=(*stack, m.n_experts)),
    }
    if m.shared_expert:
        p["shared"] = mlp_init(generator, d, f, glu=cfg.glu, dtype=dtype,
                               stack=stack)
    return p


def _expert_ffn(experts: Dict, x: torch.Tensor, *, act: str,
                glu: bool) -> torch.Tensor:
    """x: [E, C, d] -> [E, C, d] through each expert's (gated) MLP."""
    fn = activation(act)
    x = logical_constraint(x, "expert", None, "fsdp")
    up = torch.bmm(x, experts["up"].to(x.dtype))
    if glu:
        h = fn(torch.bmm(x, experts["gate"].to(x.dtype))) * up
    else:
        h = fn(up)
    h = logical_constraint(h, "expert", None, "ff")
    return torch.bmm(h, experts["down"].to(x.dtype))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row (and,
    unlike ``F.one_hot``, nothing is checked on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params: Dict, xf: torch.Tensor, m: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """xf: [t, d] -> (gates [t, k] f32, expert ids [t, k] int64, aux).

    The top k by a stable descending sort: equal probabilities keep the
    lower expert first, as ``jax.lax.top_k`` does."""
    e, k = m.n_experts, m.top_k
    logits = torch.matmul(xf.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eids = vals[:, :k], idx[:, :k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
    # Switch-style aux losses
    me = probs.mean(0)                                    # [e]
    ce = _one_hot(eids[:, 0], e, torch.float32).mean(0)   # fraction routed
    aux = {"load_balance": e * (me * ce).sum() * m.load_balance_loss,
           "router_z": (torch.logsumexp(logits, -1) ** 2).mean()
           * m.router_z_loss}
    return gate_vals, eids, aux


def capacity(t: int, m: MoEConfig) -> int:
    """Per-expert capacity of the scatter dispatch for ``t`` tokens:
    ``t·k·cf / E`` rounded up to a multiple of 128 from 128 on, and the
    lossless ``t·k`` when ``t·k <= 4096`` (decode steps)."""
    k, e = m.top_k, m.n_experts
    cap = int(max(1, (t * k * m.capacity_factor) / e))
    cap = -(-cap // 128) * 128 if cap >= 128 else cap
    return t * k if t * k <= 4096 else cap


def queue_positions(flat_eids: torch.Tensor, e: int) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's queue, in the flat
    token-major order: [t·k] -> [t·k]."""
    onehot = _one_hot(flat_eids, e, torch.int64)              # [t·k, e]
    before = torch.cumsum(onehot, 0) - onehot
    return before.gather(1, flat_eids[:, None])[:, 0]


def moe_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              lora: Optional[Dict] = None,
              lora_mode: LoRAMode = LoRAMode(),
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> ([B, S, d], aux losses).

    Top-k routing with capacity ``capacity(t)``; over-capacity choices
    drop (to the shared expert, if any, and the residual)."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    xf = x.reshape(t, d)
    gate_vals, eids, aux = route(params, xf, m)
    flat_eids = eids.reshape(t * k)
    pos = queue_positions(flat_eids, e)
    x_rep = xf[:, None].expand(t, k, d).reshape(t * k, d)

    if 0 < t * k <= m.gather_threshold:
        # the reference's decode-scale one-hot dispatch: a tight 2x the
        # balanced load, through a dense [t·k, E, C] dispatch tensor
        cap_d = max(8, -(-2 * t * k // e))
        keep = pos < cap_d
        disp = torch.einsum(
            "te,tc->tec", _one_hot(flat_eids, e, x.dtype),
            _one_hot(pos, cap_d, x.dtype) * keep[:, None].to(x.dtype))
        buf = torch.einsum("tec,td->ecd", disp, x_rep)
        buf = logical_constraint(buf, "expert", None, None)
        hout = _expert_ffn(params["experts"], buf, act=cfg.act, glu=cfg.glu)
        gates = gate_vals.reshape(t * k).to(x.dtype)
        y = torch.einsum("tec,ecd->td", disp * gates[:, None, None], hout)
        y = y.reshape(t, k, d).sum(1) if k > 1 else y.reshape(t, d)
    else:
        cap = capacity(t, m)
        keep = pos < cap
        # (expert, pos) pairs are unique for kept choices: a collision-
        # free scatter-set; every dropped choice lands on row ``cap``,
        # which is cut off before the experts run
        buf = x.new_zeros((e, cap + 1, d))
        buf[flat_eids, torch.where(keep, pos, cap)] = x_rep
        buf = logical_constraint(buf[:, :cap], "expert", None, None)
        hout = _expert_ffn(params["experts"], buf, act=cfg.act, glu=cfg.glu)
        out_tok = hout[flat_eids, torch.where(keep, pos, 0)]     # [t·k, d]
        out_tok = torch.where(keep[:, None], out_tok, 0)
        gates = gate_vals.reshape(t * k).to(out_tok.dtype)
        y = (out_tok * gates[:, None]).reshape(t, k, d).sum(1)
    y = y.to(x.dtype).reshape(b, s, d)
    if "shared" in params:
        # the shared expert sees the un-flattened [B, S, d] batch, so the
        # per-request adapter ids of batched LoRA line up with its rows
        y = y + mlp(params["shared"], x, act=cfg.act, glu=cfg.glu,
                    lora=lora, lora_mode=lora_mode)
    return logical_constraint(y, "batch", None, None), aux
