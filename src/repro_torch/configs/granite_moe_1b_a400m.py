"""IBM Granite 3.0 1B-A400M — fine-grained 32-expert top-8 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
24L d_model=1024 16H GQA(kv=8) d_ff=512/expert vocab=49155, tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    num_experts=32,
    num_experts_per_tok=8,
    router_softmax_order="softmax_then_topk",
)
