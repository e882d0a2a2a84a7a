"""Plain PyTorch reference of a dense decoder with one LoRA adapter per
request, in f32 with TF32 off: the yardstick that decides a cell's
``correct``.

It imports torch alone: nothing of the program. It is handed the weights
and the adapter bank the harness made (``harness/weights.py``), laid out
as the served model takes them, and recomputes everything else.

The equations, per layer ``l`` (one sequence of positions ``0..S-1``):

    h = x + O(attn(Q(n1), K(n1), V(n1)))      n1 = rms(x) * (1 + ln1[l])
    x = h + Down(act(Up(n2)) [* act(Gate(n2))])   n2 = rms(h) * (1 + ln2[l])

with every projection ``P(u) = u W_P (+ b_P) + s * (u A_P^T) B_P^T`` (the
request's adapter, ``s = alpha / rank``), RoPE in the split-half
convention on q and k, grouped-query attention (head ``h`` reads kv head
``h // (H / KH)``), a causal mask, and on ``local`` layers a sliding
window: key ``j`` is seen from query ``i`` iff ``i - j < window``. The
logits are ``rms(x) * (1 + final_norm)`` times the head (the embedding,
transposed, when tied).

``matmul`` is the one product every projection goes through, and
``rnd`` is applied to every activation the served model holds in its own
dtype (projection and norm outputs, q, k, v, the attention output, the
MLP's hidden state, the residual stream): both are exact in f32 here.
The precision control (``perfbench/control.py``) swaps in fp8 ones.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]

SUPPORTED = ("dense",)


def check_config(cfg: Dict) -> None:
    """Raise for what this reference does not compute."""
    attn = cfg["attn"]
    bad = []
    if cfg.get("family") not in SUPPORTED:
        bad.append(f"family {cfg.get('family')!r}")
    if any(k not in ("global", "local") for k in attn["layer_pattern"]):
        bad.append(f"layer kinds {attn['layer_pattern']}")
    for key in ("chunked_local", "qk_norm", "kv_cache_quant"):
        if attn.get(key):
            bad.append(key)
    if attn.get("attn_logit_softcap") is not None:
        bad.append("attn_logit_softcap")
    if attn.get("rope", True) is not True:
        bad.append("no rope")
    for key in ("post_norm", "scale_embeddings"):
        if cfg.get(key):
            bad.append(key)
    if cfg.get("final_logit_softcap") is not None:
        bad.append("final_logit_softcap")
    if bad:
        raise NotImplementedError(
            f"{cfg['name']}: the dense reference does not compute "
            + ", ".join(bad))


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [S, H, hd]; pos: [S]."""
    hd = x.shape[-1]
    freqs = 1.0 / torch.pow(float(theta), torch.arange(
        0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos[:, None].float() * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _act(name: str, v: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(v)
    if name == "gelu":
        return torch.nn.functional.gelu(v, approximate="tanh")
    raise NotImplementedError(f"activation {name!r}")


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int], block: int = 512) -> torch.Tensor:
    """Causal (windowed) GQA attention over one sequence. q: [S, H, hd];
    k, v: [S, KH, hd]. Query blocks keep the score matrix small."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    kx = k.repeat_interleave(g, dim=1).transpose(0, 1)        # [H, S, hd]
    vx = v.repeat_interleave(g, dim=1).transpose(0, 1)
    kpos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, s, block):
        qb = q[q0:q0 + block].transpose(0, 1)                  # [H, b, hd]
        qpos = kpos[q0:q0 + block]
        sc = torch.matmul(qb, kx.transpose(1, 2)) * hd ** -0.5  # [H, b, S]
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        sc = sc.masked_fill(~mask[None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[q0:q0 + block] = torch.matmul(p, vx).transpose(0, 1)
    return out


def _layer_weights(weights: Dict, slot: str, group: int) -> Dict:
    """One layer's weights, in f32, on the weights' device."""
    def up(node):
        if isinstance(node, dict):
            return {k: up(v) for k, v in node.items()}
        return node[group].float()
    return up(weights["layers"][slot])


def served_logits(cfg: Dict, weights: Dict, adapters: Sequence[Dict],
                  seqs: Sequence[Tuple[torch.Tensor, Sequence[int]]], *,
                  matmul: Matmul = f32_matmul,
                  rnd: Round = exact) -> List[torch.Tensor]:
    """Logits [len(read), V] (f32) of each sequence at its positions
    ``read``. ``seqs[i] = (tokens [S] long, read)``; ``adapters[i]`` is
    the LoRA tree its request names (leaves ``[n_groups, r, d_in]`` /
    ``[n_groups, d_out, r]``, on the device). Layer by layer over all
    sequences, so one layer's f32 weights are made once."""
    check_config(cfg)
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _served_logits(cfg, weights, adapters, seqs, matmul,
                                  rnd)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32


def _served_logits(cfg, weights, adapters, seqs, matmul, rnd):
    attn_cfg, lora_cfg = cfg["attn"], cfg["lora"]
    pattern = attn_cfg["layer_pattern"]
    period = len(pattern)
    n_kv, n_heads = cfg["n_kv_heads"], cfg["n_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // n_heads
    eps = cfg["norm_eps"]
    scale = lora_cfg["alpha"] / lora_cfg["rank"]
    theta = attn_cfg["rope_theta"]
    embed = weights["embed"]
    xs = [rnd(embed[tok.long()].float()) for tok, _ in seqs]

    def proj(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             ad: Optional[Dict]) -> torch.Tensor:
        y = matmul(x, w)
        if b is not None:
            y = y + b
        if ad is not None:
            y = y + scale * matmul(matmul(x, ad["A"].t()), ad["B"].t())
        return rnd(y)

    for layer in range(cfg["n_layers"]):
        slot, group = f"slot{layer % period}", layer // period
        kind = pattern[layer % period]
        window = attn_cfg["sliding_window"] if kind == "local" else None
        w = _layer_weights(weights, slot, group)
        aw, mw = w["attn"], w["mlp"]
        for i, x in enumerate(xs):
            lad = {m: {k: t[group].float() for k, t in pair.items()}
                   for m, pair in adapters[i]["layers"][slot].items()}
            s = x.shape[0]
            pos = torch.arange(s, device=x.device)
            n1 = rnd(_rms(x, w["ln1"]["scale"], eps))
            q = proj(n1, aw["wq"], aw.get("bq"), lad.get("q"))
            k = proj(n1, aw["wk"], aw.get("bk"), lad.get("k"))
            v = proj(n1, aw["wv"], aw.get("bv"), lad.get("v"))
            q = rnd(_rope(q.view(s, n_heads, hd), pos, theta))
            k = rnd(_rope(k.view(s, n_kv, hd), pos, theta))
            o = rnd(_attention(q, k, v.view(s, n_kv, hd), window))
            h = rnd(x + proj(o.reshape(s, n_heads * hd), aw["wo"], None,
                             lad.get("o")))
            n2 = rnd(_rms(h, w["ln2"]["scale"], eps))
            up = proj(n2, mw["up"], None, lad.get("up"))
            if cfg["glu"]:
                act = _act(cfg["act"], proj(n2, mw["gate"], None,
                                            lad.get("gate"))) * up
            else:
                act = _act(cfg["act"], up)
            xs[i] = rnd(h + proj(rnd(act), mw["down"], None,
                                 lad.get("down")))
        del w
    head = (weights["embed"].float().t() if cfg["tie_embeddings"]
            else weights["lm_head"].float())
    fscale = weights["final_norm"]["scale"].float()
    out = []
    for x, (_, read) in zip(xs, seqs):
        rows = rnd(_rms(x[list(read)], fscale, eps))
        out.append(matmul(rows, head))
    return out


def widest_gap(logits: Sequence[torch.Tensor],
               served: Sequence[Sequence[int]]) -> Tuple[float, int]:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position, and how many tokens were read."""
    worst, n = 0.0, 0
    for lg, toks in zip(logits, served):
        idx = torch.as_tensor(list(toks), device=lg.device).long()
        gaps = lg.max(dim=-1).values - lg.gather(1, idx[:, None])[:, 0]
        worst = max(worst, float(gaps.max()))
        n += len(toks)
    return worst, n
