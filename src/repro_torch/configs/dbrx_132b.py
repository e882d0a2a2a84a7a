"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
"""
from repro_torch.configs.base import (AttentionConfig, LoRAConfig, MoEConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    citation="hf:databricks/dbrx-base (model card)",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("global",), rope_theta=500000.0),
    moe=MoEConfig(n_experts=16, top_k=4, capacity_factor=1.25),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o"),
                    max_resident=8, n_adapters=64),
)
