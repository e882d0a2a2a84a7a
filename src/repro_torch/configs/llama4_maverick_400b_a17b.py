"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion, chunked attn
[hf:meta-llama/Llama-4-Scout-17B-16E family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 + shared expert, on every other layer (interleaved MoE as in the
released Maverick -> ~400B total / ~17B active). Attention: 3 chunked-local
layers per 1 global (Llama-4 iRoPE pattern) -> long_500k is servable
(global layers hold the full cache, local layers a chunk-sized window).
"""
from repro_torch.configs.base import (AttentionConfig, LoRAConfig, MoEConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E (model card)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("local", "local", "local", "global"),
                         sliding_window=8192, chunked_local=True,
                         rope_theta=500000.0),
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                  shared_expert=True, moe_layer_period=2),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o"),
                    max_resident=8, n_adapters=64),
)
