"""whisper-medium — encoder-decoder, conv frontend (stub) [arXiv:2212.04356].

24L (decoder) d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096 vocab=51865.
Encoder: 24 layers over 1500 precomputed frame embeddings (mel+conv stubbed
via input_specs). GELU MLP (non-gated), learned positions (no RoPE).
"""
from repro_torch.configs.base import AttentionConfig, EncoderConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    citation="arXiv:2212.04356 (Robust Speech Recognition / Whisper)",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    glu=False,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("global",), rope=False),
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "v", "o", "up", "down"),
                    max_resident=16, n_adapters=128),
)
