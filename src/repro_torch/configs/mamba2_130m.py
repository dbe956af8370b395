"""Mamba2-130m — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; hf:state-spaces/mamba2-130m]
24L d_model=768 vocab=50280 ssm_state=128 headdim=64 expand=2, tied embeds.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,  # attention-free; SSM heads derived from d_inner/headdim
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
)
