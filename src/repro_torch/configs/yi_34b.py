"""Yi-34B — llama-arch dense GQA.

[arXiv:2403.04652; hf:01-ai/Yi-34B]
60L d_model=7168 56H GQA(kv=8) d_ff=20480 vocab=64000, rope_theta=5e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=5e6,
)
