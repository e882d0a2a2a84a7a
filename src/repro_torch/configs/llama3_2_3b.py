"""llama3.2-3b — the paper's setting S2 model.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256. LoRA rank 16.
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    citation="arXiv:2407.21783 (Llama 3 herd); EdgeLoRA Table 2 setting S2",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("global",), rope_theta=500000.0),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "up", "down"),
                    max_resident=50, n_adapters=500),
)
