"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The VQ-VAE image
tokenizer is a stub: image tokens share the 65536-entry vocabulary, so
input_specs provides plain token ids (early fusion = one token stream).
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    citation="arXiv:2405.09818 (Chameleon: Mixed-Modal Early-Fusion)",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("global",), rope_theta=10000.0,
                         qk_norm=True),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o", "up", "gate", "down"),
                    max_resident=8, n_adapters=128),
)
