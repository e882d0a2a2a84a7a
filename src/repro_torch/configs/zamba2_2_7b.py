"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54L d_model=2560 (32H kv=32 in the shared attention block) d_ff=10240
vocab=32000, ssm_state=64. One weight-tied attention+MLP block is applied
after every 6 Mamba2 layers (the Zamba "shared block" design).
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    citation="arXiv:2411.15242 (Zamba2)",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("global",)),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, n_groups=1,
                  chunk_size=256),
    shared_attn_every=6,
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("in_proj", "out_proj", "q", "k", "v", "o"),
                    max_resident=16, n_adapters=256),
)
