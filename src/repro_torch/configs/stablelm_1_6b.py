"""StableLM-2 1.6B — dense MHA with partial rotary and LayerNorm.

[hf:stabilityai/stablelm-2-1_6b]
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352, rope_pct=0.25,
qkv biases, untied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    mlp_kind="swiglu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    rope_pct=0.25,
    qkv_bias=True,
)
