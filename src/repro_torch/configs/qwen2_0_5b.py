"""qwen2-0.5b — GQA kv=2, QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936. The closest analog
of the paper's own edge-class models (OpenELM-1.1B / Llama3.2-3B).
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    citation="arXiv:2407.10671 (Qwen2)",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    tie_embeddings=True,
    norm_eps=1e-6,
    attn=AttentionConfig(layer_pattern=("global",), qkv_bias=True,
                         rope_theta=1000000.0),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o", "up", "gate", "down"),
                    max_resident=32, n_adapters=1024),
)
