"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attention-free, d_ff=0, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import AttentionConfig, LoRAConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    citation="arXiv:2405.21060 (Transformers are SSMs: SSD)",
    n_layers=24,
    d_model=768,
    n_heads=24,        # SSD heads: d_inner / head_dim = 1536/64
    n_kv_heads=24,
    d_ff=0,            # attention-free, no MLP block (Mamba block only)
    vocab_size=50280,
    tie_embeddings=True,
    norm_eps=1e-5,
    attn=AttentionConfig(layer_pattern=("none",)),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, n_groups=1,
                  chunk_size=256),
    lora=LoRAConfig(rank=16, alpha=32.0,
                    target_modules=("in_proj", "out_proj"),
                    max_resident=16, n_adapters=256),
)
