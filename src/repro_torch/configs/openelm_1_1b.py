"""openelm-1.1b — the paper's setting S3 model [arXiv:2404.14619].

Simplified to uniform dims (the real OpenELM uses layer-wise scaling; the
serving system is insensitive to that detail): 28L d_model=2048 16H (kv=4)
d_ff=5632 vocab=32000. LoRA rank 16.
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="openelm-1.1b",
    family="dense",
    citation="arXiv:2404.14619 (OpenELM); EdgeLoRA Table 2 setting S3",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    tie_embeddings=True,
    norm_eps=1e-6,
    attn=AttentionConfig(layer_pattern=("global",), rope_theta=10000.0),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "up", "down"),
                    max_resident=10, n_adapters=200),
)
