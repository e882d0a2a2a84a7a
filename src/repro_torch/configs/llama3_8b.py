"""llama3.1-8b — the paper's primary evaluation model (setting S1).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. LoRA rank 32
(paper Table 2, S1).
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    citation="arXiv:2407.21783 (Llama 3 herd); EdgeLoRA Table 2 setting S1",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("global",), rope_theta=500000.0),
    lora=LoRAConfig(rank=32, alpha=64.0,
                    target_modules=("q", "k", "v", "up", "down"),
                    max_resident=20, n_adapters=1000),
)
