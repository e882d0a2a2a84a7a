"""qwen1.5-110b — dense, GQA kv=8, QKV bias [hf:Qwen/Qwen1.5-0.5B family].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    citation="hf:Qwen/Qwen1.5-0.5B (model card; 110B sibling)",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    norm_eps=1e-6,
    attn=AttentionConfig(layer_pattern=("global",), qkv_bias=True,
                         rope_theta=1000000.0),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o", "up", "gate", "down"),
                    max_resident=8, n_adapters=64),
)
