"""gemma2-9b — local+global alternating attention, logit softcap
[arXiv:2408.00118].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
sliding window 4096 on local layers, attn softcap 50, final softcap 30,
GeGLU MLP, tied embeddings.
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    citation="arXiv:2408.00118 (Gemma 2)",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    tie_embeddings=True,
    act="gelu",
    post_norm=True,
    scale_embeddings=True,
    norm_eps=1e-6,
    final_logit_softcap=30.0,
    attn=AttentionConfig(layer_pattern=("local", "global"),
                         sliding_window=4096,
                         attn_logit_softcap=50.0,
                         rope_theta=10000.0),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("q", "k", "v", "o", "up", "gate", "down"),
                    max_resident=8, n_adapters=64),
)
