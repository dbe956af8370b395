"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf mistralai/Mixtral-8x7B-v0.1]
32L d_model=4096 32H GQA(kv=8) d_ff=14336 vocab=32000, SWA window 4096.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1e6,
    attention_kind="swa",
    window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    router_softmax_order="topk_then_softmax",
)
