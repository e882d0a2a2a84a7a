"""Configuration system of the PyTorch port (a copy of ``repro.configs.base``).

Every architecture is described by a ``ModelConfig``. Configs are plain
frozen dataclasses so they hash, compare, and serialize cleanly; no
framework is imported here. The dataclasses, their defaults and
``reduced_config`` are kept identical to the JAX package's so one config
object means the same model in both; ``get_config`` only resolves the
architectures the port already runs.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    n_experts: int
    top_k: int
    # capacity factor for dense (einsum) dispatch; tokens above capacity drop.
    capacity_factor: float = 1.25
    # a shared (always-on) expert in addition to routed ones (Llama-4 style).
    shared_expert: bool = False
    # MoE applied every `moe_layer_period` layers (Llama-4: every other
    # layer is MoE, the rest dense FFN). 1 = every layer.
    moe_layer_period: int = 1
    # §Perf lever: when t·k ≤ gather_threshold, compute experts by
    # gathering per-token expert weights instead of the capacity einsum —
    # the capacity path runs E×C GEMM rows for t real tokens (≈E× MXU
    # waste at decode scale). 0 = always capacity (paper-faithful
    # Switch-style dispatch).
    gather_threshold: int = 0
    # router jitter/z-loss knobs (training substrate).
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    # A is scalar-per-head in Mamba-2 (SSD).
    a_init_range: Tuple[float, float] = (1.0, 16.0)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for encoder-decoder models (whisper-style).

    The modality frontend (mel + conv) is a stub: ``input_specs`` provides
    precomputed frame embeddings of shape [batch, n_frames, d_model].
    """

    n_layers: int
    n_frames: int = 1500  # whisper: 30s of audio at 50 fps after conv stride 2


@dataclass(frozen=True)
class LoRAConfig:
    """Multi-tenant LoRA serving configuration (the paper's subject)."""

    rank: int = 16
    alpha: float = 32.0
    dropout: float = 0.05
    # Which projections carry adapters. Names resolve inside the model defs.
    target_modules: Tuple[str, ...] = ("q", "k", "v", "o", "up", "down")
    # Heterogeneous memory manager sizing: number of resident adapter slots
    # (the pre-allocated pool) and total registered adapters (on "disk").
    max_resident: int = 8
    n_adapters: int = 64

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class AttentionConfig:
    """Per-layer-pattern attention options."""

    # layer_pattern entries: "global", "local" (sliding window), "none"
    # (pure-SSM layer), "shared" (zamba2 weight-tied block applied between
    # backbone layers).  A pattern of length p repeats every p layers.
    layer_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 4096
    # Llama-4 style chunked local attention (chunk = sliding_window).
    chunked_local: bool = False
    attn_logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    qk_norm: bool = False  # chameleon-style query/key RMSNorm
    rope_theta: float = 10000.0
    # rope applied? (whisper decoder uses learned positions: rope=False)
    rope: bool = True
    # §Perf lever (and llama.cpp-parity: the paper serves Q8_0 caches):
    # store KV in int8 with per-(token, head) scales; decode dequantizes
    # in the fused attention kernel. Halves KV HBM traffic vs bf16.
    kv_cache_quant: bool = False


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // n_heads
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    final_logit_softcap: Optional[float] = None
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated MLP (up*gate) vs plain 2-layer MLP
    post_norm: bool = False  # gemma2-style post-block RMSNorm
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) embed scale

    attn: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid (zamba2): apply the weight-shared attention block after every
    # `shared_attn_every` backbone layers.
    shared_attn_every: int = 0

    lora: LoRAConfig = field(default_factory=LoRAConfig)
    # Batched-LoRA compute path: 'sgmv' (grouped Pallas kernels, the TPU
    # serving default), 'einsum' (gather-einsum reference, the CPU/ref
    # fallback), or 'auto' (sgmv on TPU, einsum elsewhere). Resolved by
    # ``repro.core.lora.resolve_lora_backend`` at engine/launch init.
    lora_backend: str = "auto"
    # Serving KV memory layout: 'dense' reserves a max_ctx ring per slot
    # (the reference path); 'paged' shares one block arena across slots
    # with per-sequence block tables (``serving/kvpool.py``), so short
    # contexts stop stranding long-context memory. EngineConfig can
    # override per engine; streams are bit-identical across the two.
    kv_backend: str = "dense"

    dtype: str = "bfloat16"

    # ---------------- derived ----------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_size(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_size(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can serve 500k-token decode sub-quadratically.

        SSM / hybrid: O(1) recurrent state. Dense/MoE: only if every global
        layer is interleaved with local ones (gemma2, starcoder2, llama4
        chunked) — see DESIGN.md §4 for the skip list.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.encoder is not None:
            return False  # enc-dec: out of family scope
        pat = self.attn.layer_pattern
        return "local" in pat  # sliding-window/chunked variants qualify

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no decode step; all assigned archs do."""
        return True

    def layer_kind(self, i: int) -> str:
        """Attention kind for backbone layer i ('global'|'local'|'none')."""
        pat = self.attn.layer_pattern
        return pat[i % len(pat)]

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        total = V * d  # embeddings
        if not self.tie_embeddings:
            total += V * d
        per_layer_attn = d * self.q_size + 2 * d * self.kv_size + self.q_size * d
        mlp_mult = 3 if self.glu else 2
        per_layer_mlp = mlp_mult * d * f
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj projects to [2*d_inner + 2*n_groups*d_state + n_heads]
            in_w = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            out_w = di * d
            conv = s.d_conv * (di + 2 * s.n_groups * s.d_state)
            ssm_layer = in_w + out_w + conv + 2 * nh  # + A_log, D
        else:
            ssm_layer = 0
        if self.family == "ssm":
            total += L * ssm_layer
        elif self.family == "hybrid":
            total += L * ssm_layer
            # one weight-tied shared attention block
            total += per_layer_attn + per_layer_mlp
        else:
            if self.moe is not None:
                dense_mlp = per_layer_mlp
                moe_mlp = self.moe.n_experts * mlp_mult * d * f + d * self.moe.n_experts
                if self.moe.shared_expert:
                    moe_mlp += mlp_mult * d * f
                n_moe = L // self.moe.moe_layer_period
                total += (L * per_layer_attn + n_moe * moe_mlp
                          + (L - n_moe) * dense_mlp)
            else:
                total += L * (per_layer_attn + per_layer_mlp)
        if self.encoder is not None:
            enc_layer = per_layer_attn + per_layer_mlp
            # decoder layers also carry cross-attention
            total += self.encoder.n_layers * enc_layer + L * per_layer_attn
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        mlp_mult = 3 if self.glu else 2
        n_moe = L // self.moe.moe_layer_period
        dense_total = self.param_count() - n_moe * self.moe.n_experts * mlp_mult * d * f
        active_mlp = n_moe * self.moe.top_k * mlp_mult * d * f
        return dense_total + active_mlp

    def lora_adapter_bytes(self, bytes_per_param: int = 2) -> int:
        """Size of ONE adapter (the paper's pool block size)."""
        r = self.lora.rank
        d = self.d_model
        n = 0
        dims = {
            "q": (d, self.q_size),
            "k": (d, self.kv_size),
            "v": (d, self.kv_size),
            "o": (self.q_size, d),
            "up": (d, self.d_ff),
            "gate": (d, self.d_ff),
            "down": (self.d_ff, d),
            "in_proj": (d, 2 * (self.ssm.d_inner(d) if self.ssm else 0)),
            "out_proj": ((self.ssm.d_inner(d) if self.ssm else 0), d),
        }
        layers = self.n_layers + (self.encoder.n_layers if self.encoder else 0)
        for m in self.lora.target_modules:
            if m not in dims:
                continue
            di, do = dims[m]
            n += layers * r * (di + do)
        return n * bytes_per_param


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = (
    "mamba2_130m",
    "chameleon_34b",
    "qwen1_5_110b",
    "llama4_maverick_400b_a17b",
    "whisper_medium",
    "dbrx_132b",
    "gemma2_9b",
    "starcoder2_7b",
    "qwen2_0_5b",
    "zamba2_2_7b",
)

# CLI ids (--arch <id>) use dashes, module names use underscores.
_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({a: a for a in ARCH_IDS})
_ALIAS.update({
    "mamba2-130m": "mamba2_130m",
    "chameleon-34b": "chameleon_34b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "whisper-medium": "whisper_medium",
    "dbrx-132b": "dbrx_132b",
    "gemma2-9b": "gemma2_9b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2-0.5b": "qwen2_0_5b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llama3-8b": "llama3_8b",
    "llama3.1-8b": "llama3_8b",
    "llama3-2-3b": "llama3_2_3b",
    "llama3.2-3b": "llama3_2_3b",
    "openelm-1.1b": "openelm_1_1b",
})


# Architectures the PyTorch port runs (one module each under
# repro_torch/configs/): every id of ARCH_IDS. Any other id raises
# ``NotImplementedError`` naming them, where the reference's import fails.
PORTED_ARCHS = ("llama3_8b", "qwen2_0_5b", "llama3_2_3b", "openelm_1_1b",
                "gemma2_9b", "starcoder2_7b", "chameleon_34b", "dbrx_132b",
                "llama4_maverick_400b_a17b", "qwen1_5_110b", "mamba2_130m",
                "zamba2_2_7b", "whisper_medium")


def get_config(arch: str) -> ModelConfig:
    """Load a ModelConfig by CLI id (dashes or underscores both work)."""
    key = _ALIAS.get(arch, arch.replace("-", "_").replace(".", "_"))
    if key not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not an architecture of repro_torch (ported: "
            f"{', '.join(PORTED_ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
                   vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (per assignment contract)."""
    import math as _math
    # keep n_layers a multiple of the stack period (layer-pattern × MoE
    # interleave) so the scanned-group layout stays intact
    period = len(cfg.attn.layer_pattern)
    if cfg.moe is not None:
        period = _math.lcm(period, cfg.moe.moe_layer_period)
    if cfg.family == "ssm":
        period = 1
    n_layers = max(n_layers, period)
    n_layers = -(-n_layers // period) * period
    d_model = min(d_model, cfg.d_model)
    head_dim = max(8, min(64, cfg.resolved_head_dim))
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    d_ff = min(512, cfg.d_ff) if cfg.d_ff else 0
    changes = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_ff,
        vocab_size=min(vocab, cfg.vocab_size),
        lora=dataclasses.replace(cfg.lora, rank=4, max_resident=4, n_adapters=8),
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk_size=32)
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(
            cfg.encoder, n_layers=n_layers, n_frames=64)
    if cfg.shared_attn_every:
        changes["shared_attn_every"] = 2
        changes["n_layers"] = 4
    return dataclasses.replace(cfg, **changes)
