"""Model API, dense, MoE, SSM and hybrid decoders and the encoder-decoder
family (``repro.models.model``).

``Model`` is an ``nn.Module`` whose ``weights`` child mirrors the JAX
param tree path for path (``weights.layers.slot0.attn.wq`` is
``params['layers']['slot0']['attn']['wq']``, stacked ``[n_groups,
...]``), so weights carry across unchanged. The forward functions keep
the reference's signatures and take the params as a nested dict
(``Model.params`` is that view of the module's own parameters); the
serving engine calls ``prefill`` and ``decode_step`` (and, with the
paged KV arena, the prefix cache or chunked prefill, ``prefill_suffix``,
``prefill_suffix_dense`` and ``decode_step_paged``) with a ``LoRAMode``
carrying per-request adapter slots; training and the learned router
call ``forward``. ``attn_kernel`` (a field, set at construction) routes
every step's attention through the ``flash_prefill`` / ``flash_decode``
kernels instead of the plain PyTorch code; on CPU tensors the kernel
wrappers run their plain versions. An encoder-decoder config (whisper)
takes ``frames`` [B, n_frames, d_model] beside ``tokens`` in ``forward``
and ``prefill`` (``models/encdec.py``); it has no paged, suffix or chunk
step, as in the reference, and the serving engine refuses it
(``require_token_batches``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spans
from repro_torch.core.lora import LoRAMode
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (init_device, rmsnorm,
                                      truncated_normal_init, unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config features outside the ported slices: nothing
    degrades silently. Ported: dense decoder stacks of global or local
    (sliding-window, chunked-local) attention with RoPE, optional QKV
    bias, QK-norm, attention and final logit softcaps, an int8 KV cache,
    post-norms, scaled embeddings, gated or plain MLPs, tied or untied
    embeddings; the early-fusion VLM family (chameleon), whose image
    tokens share the vocabulary, so it is one token stream; the MoE
    family (dbrx, llama4: top-k capacity dispatch, a shared expert, MoE
    on every ``moe_layer_period``-th layer); the SSM family (mamba2:
    Mamba-2 blocks only, ``layer_pattern ('none',)``) and the hybrid
    family (zamba2: Mamba-2 slots with a weight-tied attention + MLP
    block after every ``shared_attn_every``); the encoder-decoder family
    (whisper: family ``audio``, an encoder over frame embeddings, no
    RoPE). Attention without RoPE skips it, as in the reference."""
    a = cfg.attn
    recurrent = cfg.family == "ssm" or bool(cfg.shared_attn_every)
    families = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
    unported = {
        f"family not in {families}": cfg.family not in families,
        "attention kinds other than global/local": any(
            k not in ("global", "local") for k in a.layer_pattern)
            and not (cfg.family == "ssm" and a.layer_pattern == ("none",)),
        "an encoder outside the audio family, or the audio family "
        "without one": (cfg.encoder is None) == (cfg.family == "audio"),
        "an ssm config outside the ssm/hybrid stacks": (
            (cfg.ssm is None) == recurrent),
        # the reference's shared block has no post-norms
        "post_norm with shared_attn": cfg.post_norm
            and bool(cfg.shared_attn_every),
    }
    found = [k for k, v in unported.items() if v]
    if found:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(found)} not ported to repro_torch")


def require_token_batches(cfg: ModelConfig, caller: str,
                          reference: str) -> None:
    """Raise for an encoder-decoder config where ``caller`` feeds batches
    of tokens alone: its encoder needs ``frames`` too. ``reference``
    says where the JAX package fails the same way."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: {caller} feeds token batches only, and an "
            f"encoder-decoder model also needs 'frames' [B, "
            f"{cfg.encoder.n_frames}, {cfg.d_model}] (the reference fails "
            f"the same way: {reference}, then its Model reads "
            f"batch['frames'])")


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: dict nodes become
    child modules and leaves frozen ``Parameter``s, so ``state_dict()``
    keys are the tree's paths joined by '.'."""

    def __init__(self, tree: Dict) -> None:
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict:
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def _shapes(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda", *,
                 attn_kernel: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.device = resolve_device(device)
        self.attn_kernel = attn_kernel

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def _param_tree(self, generator: Optional[torch.Generator]) -> Dict:
        """The reference's param tree drawn from ``generator``; shapes
        only (meta device) when it is None."""
        cfg, dt = self.cfg, self.dtype
        params: Dict[str, Any] = {
            "embed": truncated_normal_init(
                generator, (cfg.vocab_size, cfg.d_model), 1.0, dt),
            "final_norm": {"scale": torch.zeros(
                (cfg.d_model,), dtype=dt, device=init_device(generator))},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = truncated_normal_init(
                generator, (cfg.d_model, cfg.vocab_size), 1.0, dt)
        if cfg.encoder is not None:
            params["encoder"] = encdec.init_encoder(generator, cfg, dt)
            params["decoder"] = encdec.init_decoder(generator, cfg, dt)
        else:
            params.update(transformer.init_stack(generator, cfg, dt))
        return params

    def init(self, generator: torch.Generator) -> Dict:
        """Draw the reference's init distributions from ``generator``
        (on this model's device), register them as parameters and return
        the params tree."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        self.weights = ParamTree(self._param_tree(generator))
        return self.params

    def load_params(self, tree: Dict) -> Dict:
        """Register ``tree`` (the JAX param tree as tensors) as this
        model's parameters, moved to its device; raises unless every path
        and shape matches the config."""
        want = _shapes(self._param_tree(None))
        got = _shapes(tree)
        if want != got:
            raise ValueError(f"{self.cfg.name}: param tree mismatch:\n"
                             f"  expected {want}\n  got      {got}")

        def move(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: move(v) for k, v in node.items()}
            return node.to(self.device)

        self.weights = ParamTree(move(tree))
        return self.params

    @property
    def params(self) -> Dict:
        """Nested dict view (the JAX param tree) of the parameters."""
        return self.weights.tree()

    def init_lora(self, generator: torch.Generator,
                  n_slots: Optional[int] = None,
                  dtype: torch.dtype = torch.float32) -> Dict:
        if self.cfg.encoder is not None:
            return encdec.init_encdec_lora(generator, self.cfg,
                                           n_slots=n_slots, dtype=dtype)
        return transformer.init_lora_stack(generator, self.cfg,
                                           n_slots=n_slots, dtype=dtype)

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------

    def embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        sp = spans.wall
        if sp is not None:
            sp.open("embed")
        x = params["embed"][tokens.long()]
        if self.cfg.scale_embeddings:
            # sqrt(d) rounded to the param dtype first, as the reference
            # multiplies by it (59.75 in bf16 at d 3584); a Python scalar,
            # so no tensor is made on the device (a host sync)
            x = x * _round_to(math.sqrt(self.cfg.d_model), x.dtype)
        x = logical_constraint(x, "batch", *(None,) * (x.ndim - 1))
        if sp is not None:
            sp.close()
        return x

    def logits(self, params: Dict, h: torch.Tensor) -> torch.Tensor:
        """The head: RMSNorm ``final_norm``, then the unembedding. An
        encoder-decoder's hidden states come LayerNormed (the decoder's
        ``ln_post``) and are normed a second time here, as in the
        reference."""
        cfg = self.cfg
        sp = spans.wall
        if sp is not None:
            sp.open("head")
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        out = unembed(h, head, tied=cfg.tie_embeddings,
                      softcap=cfg.final_logit_softcap)
        if sp is not None:
            sp.close()
        return out

    # ------------------------------------------------------------------
    # full-sequence forward (training / scoring)
    # ------------------------------------------------------------------

    def forward(self, params: Dict, batch: Dict[str, torch.Tensor],
                lora: Optional[Dict] = None,
                lora_mode: LoRAMode = LoRAMode(),
                opts: Optional[Dict] = None, *, attn_kernel: bool
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens': [B, S]} (+ 'frames': [B, T, d] for an
        encoder-decoder). Returns (logits [B, S, V], aux losses; none for
        an encoder-decoder). ``attn_kernel`` is the caller's choice, not
        the model's field: training differentiates the plain attention
        (the kernels have no backward), scoring may take the kernel."""
        tokens = batch["tokens"]
        x = self.embed(params, tokens)
        if self.cfg.encoder is not None:
            enc_out = encdec.encode(params["encoder"], batch["frames"],
                                    self.cfg, lora, lora_mode, opts,
                                    attn_kernel=attn_kernel)
            h = encdec.decode_full(params["decoder"], x, enc_out, self.cfg,
                                   lora, lora_mode, opts,
                                   attn_kernel=attn_kernel)
            return self.logits(params, h), {}
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h, aux = transformer.forward_stack(params, x, self.cfg, positions,
                                           lora, lora_mode, opts,
                                           attn_kernel=attn_kernel)
        return self.logits(params, h), aux

    # ------------------------------------------------------------------
    # serving: cache, prefill, decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   enc_frames: Optional[int] = None) -> Dict:
        """An encoder-decoder's cache also holds the cross K/V of
        ``enc_frames`` frames (default: the config's ``n_frames``)."""
        cfg = self.cfg
        if cfg.encoder is not None:
            return encdec.init_decoder_cache(
                cfg, batch, max_len, enc_frames or cfg.encoder.n_frames,
                self.dtype, self.device)
        return transformer.init_cache(cfg, batch, max_len, self.dtype,
                                      self.device)

    def prefill(self, params: Dict, batch: Dict[str, torch.Tensor],
                cache: Dict, lora: Optional[Dict] = None,
                lora_mode: LoRAMode = LoRAMode(),
                opts: Optional[Dict] = None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Process the prompt, fill ``cache`` (in place). Returns
        (last-token logits [B, V], cache).

        ``lengths`` [B]: real prompt lengths of right-padded rows —
        logits come from position length-1 **per row**, and cache
        entries past each row's prompt are invalidated.

        An encoder-decoder encodes ``batch['frames']``, fills the cross
        K/V from the encoder output, then runs the decoder over the
        prompt into the self ring.
        """
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self.embed(params, tokens)
        if self.cfg.encoder is not None:
            enc_out = encdec.encode(params["encoder"], batch["frames"],
                                    self.cfg, lora, lora_mode, opts,
                                    attn_kernel=self.attn_kernel)
            encdec.fill_cross_cache(params["decoder"], enc_out, self.cfg,
                                    cache)
            h, _ = encdec.decode_full(
                params["decoder"], x, enc_out, self.cfg, lora, lora_mode,
                opts, self_cache=cache["self"],
                cross_kv=(cache["cross_k"], cache["cross_v"]),
                attn_kernel=self.attn_kernel)
        else:
            seq_mask = None
            if lengths is not None:
                seq_mask = (torch.arange(s, device=tokens.device)[None, :]
                            < lengths[:, None])
            positions = torch.arange(s, device=tokens.device)
            h, _, cache = transformer.forward_stack(
                params, x, self.cfg, positions, lora, lora_mode, opts,
                cache=cache, seq_mask=seq_mask, lengths=lengths,
                attn_kernel=self.attn_kernel)
        if lengths is not None:
            last = h[torch.arange(b, device=h.device), lengths.long() - 1]
            cache = _invalidate_past(cache, lengths)
        else:
            last = h[:, -1]
        return self.logits(params, last), cache

    def prefill_suffix(self, params: Dict, tokens: torch.Tensor,
                       cache: Dict, arena_cache: Dict, tables: torch.Tensor,
                       lengths: torch.Tensor, prefix_len: int,
                       lora: Optional[Dict] = None,
                       lora_mode: LoRAMode = LoRAMode(),
                       opts: Optional[Dict] = None, *,
                       meta: Any) -> Tuple[torch.Tensor, Dict]:
        """Prefill only the suffix of prompts whose first ``prefix_len``
        tokens are already in the page arena (a shared-prefix hit, or the
        earlier chunks of a chunked prefill).

        tokens: [B, S] suffix tokens (the padded prompt minus its first
        ``prefix_len`` columns); tables: [B, max_blocks] block tables
        already holding the prefix pages; lengths: [B] real *total*
        prompt lengths; ``prefix_len`` a Python int. Per layer, attention
        runs over the gathered prefix KV followed by the fresh suffix KV
        — the keys, positions and mask a cold prefill sees. The suffix KV
        lands in ``cache`` (a mini ring, in place; the engine scatters it
        with ``kvpool.scatter_suffix``). Returns (last-token logits
        [B, V], cache).
        """
        from repro_torch.serving import kvpool  # deferred: engine→models cycle

        self._refuse_encoder("prefill_suffix")
        b, s = tokens.shape
        x = self.embed(params, tokens)
        positions = prefix_len + torch.arange(s, device=tokens.device)
        prefix_kv = kvpool.gather_prefix(arena_cache, tables, prefix_len,
                                         meta)
        h, _, cache = transformer.forward_stack(
            params, x, self.cfg, positions, lora, lora_mode, opts,
            cache=cache, prefix_kv=prefix_kv,
            prefix_positions=torch.arange(prefix_len, dtype=torch.int32,
                                          device=tokens.device),
            attn_kernel=self.attn_kernel)
        last = h[torch.arange(b, device=h.device),
                 lengths.long() - prefix_len - 1]
        return self.logits(params, last), cache

    def prefill_suffix_dense(self, params: Dict, tokens: torch.Tensor,
                             cache: Dict, global_cache: Dict,
                             slot_idx: torch.Tensor, lengths: torch.Tensor,
                             prefix_len: int,
                             lora: Optional[Dict] = None,
                             lora_mode: LoRAMode = LoRAMode(),
                             opts: Optional[Dict] = None,
                             ) -> Tuple[torch.Tensor, Dict]:
        """Dense-backend sibling of ``prefill_suffix`` (chunked prefill):
        prefill positions [prefix_len, prefix_len + S) of prompts whose
        first ``prefix_len`` positions earlier chunks already wrote into
        the engine's per-slot rings.

        global_cache: the engine's dense cache ([ng, n_slots, clen, ...]
        leaves); slot_idx: [B] the rows' slots; lengths: [B] prompt
        lengths *clamped* to the chunk end (rows finishing in this chunk
        read their real first-token logits, continuing rows a position
        the engine ignores). Chunking is gated to full-length rings, so
        ring index == position and the prefix needs no validity mask.
        Returns (last-token logits [B, V], mini cache).
        """
        self._refuse_encoder("prefill_suffix_dense")
        b, s = tokens.shape
        x = self.embed(params, tokens)
        positions = prefix_len + torch.arange(s, device=tokens.device)
        rows = slot_idx.long()

        def walk(node: Dict) -> Dict:
            if isinstance(node, dict) and "k" in node and "pos" in node:
                return {key: leaf[:, rows, :prefix_len]
                        for key, leaf in node.items() if key != "pos"}
            return {k: walk(v) for k, v in node.items()}

        h, _, cache = transformer.forward_stack(
            params, x, self.cfg, positions, lora, lora_mode, opts,
            cache=cache, prefix_kv=walk(global_cache),
            prefix_positions=torch.arange(prefix_len, dtype=torch.int32,
                                          device=tokens.device),
            attn_kernel=self.attn_kernel)
        last = h[torch.arange(b, device=h.device),
                 lengths.long() - prefix_len - 1]
        return self.logits(params, last), cache

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    pos: torch.Tensor, lora: Optional[Dict] = None,
                    lora_mode: LoRAMode = LoRAMode()
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: [B] (the last generated token per sequence); pos: [B]
        per-slot positions. Returns (logits [B, V], cache); the cache is
        updated in place."""
        x = self.embed(params, tokens)
        if self.cfg.encoder is not None:
            h, cache = encdec.decode_step(params["decoder"], x, cache,
                                          self.cfg, pos, lora, lora_mode,
                                          attn_kernel=self.attn_kernel)
            return self.logits(params, h), cache
        h, cache = transformer.decode_stack(params, x, cache, self.cfg, pos,
                                            lora, lora_mode,
                                            attn_kernel=self.attn_kernel)
        return self.logits(params, h), cache

    def decode_step_paged(self, params: Dict, tokens: torch.Tensor,
                          cache: Dict, tables: torch.Tensor,
                          lengths: torch.Tensor, prompt_lens: torch.Tensor,
                          pad_lens: torch.Tensor, pos: torch.Tensor,
                          lora: Optional[Dict] = None,
                          lora_mode: LoRAMode = LoRAMode(), *,
                          meta: Any, page_gather: Any = None
                          ) -> Tuple[torch.Tensor, Dict]:
        """Decode step attending through per-sequence KV block tables.

        ``cache`` is the paged cache (attention nodes are page arenas,
        see ``serving/kvpool.py``). tables: [B, max_blocks] int32
        physical pages per row (-1 padded, all -1 for inactive rows);
        lengths: [B] tokens already written; prompt_lens/pad_lens: [B]
        real prompt length and padded prefill bucket; pos: [B] this
        step's write position. The step builds the dense ring view the
        block tables describe, runs the ordinary ``decode_step`` on it
        (so token streams equal ``kv_backend='dense'``), and writes the
        freshly written ring entries back into their pages (in place).
        ``page_gather`` (``kernels/ops.paged_gather``) routes the page
        fetch through the ``paged_gather_pages`` kernel.
        """
        from repro_torch.serving import kvpool  # deferred: engine→models cycle

        self._refuse_encoder("decode_step_paged")
        view = kvpool.paged_view(cache, tables, lengths, prompt_lens,
                                 pad_lens, meta, page_gather=page_gather)
        logits, view = self.decode_step(params, tokens, view, pos, lora,
                                        lora_mode)
        cache = kvpool.scatter_decode(cache, view, tables, pos, meta)
        return logits, cache

    def _refuse_encoder(self, step: str) -> None:
        """The paged, suffix and chunk steps are the decoder-only
        stacks': nothing in the reference reaches them with an
        encoder-decoder config."""
        if self.cfg.encoder is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: {step} has no encoder-decoder path")


def _round_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (on the host)."""
    return torch.tensor(value, dtype=dtype).item()  # el: allow[host-sync] -- host tensor


def _invalidate_past(cache: Dict, lengths: torch.Tensor) -> Dict:
    """Set stored cache positions >= length (right-pad writes) to -1, in
    place. Attention caches are dicts with a 'pos' leaf [..., B, C];
    ``lengths`` [B] broadcasts per row."""
    for node in cache.values():
        if isinstance(node, dict) and "pos" in node and "k" in node:
            pos = node["pos"]
            shape = [1] * pos.dim()
            shape[-2] = lengths.shape[0]
            lb = lengths.to(pos.device, pos.dtype).reshape(shape)
            pos.masked_fill_(pos >= lb, -1)
        elif isinstance(node, dict):
            _invalidate_past(node, lengths)
    return cache


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda", *,
                attn_kernel: bool = False) -> Model:
    return Model(cfg, device, attn_kernel=attn_kernel)
