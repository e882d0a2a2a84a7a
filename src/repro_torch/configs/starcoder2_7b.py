"""starcoder2-7b — GQA kv=4, RoPE, sliding window 4096 [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152. Plain (non-gated)
GELU MLP per the released model; sliding-window attention enables the
long_500k decode shape.
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    citation="arXiv:2402.19173 (StarCoder 2)",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    act="gelu",
    glu=False,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("local",), sliding_window=4096,
                         qkv_bias=True, rope_theta=100000.0),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o", "up", "down"),
                    max_resident=8, n_adapters=64),
)
