"""MiniCPM3-4B — dense transformer with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B]
62L d_model=2560 40H d_ff=6400 vocab=73448; MLA: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v=64; scale_emb=12.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    emb_scale=12.0,
    mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
)
