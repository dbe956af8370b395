"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf:facebook/musicgen-medium]
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 per codebook, 4 EnCodec
codebooks (embeddings summed, per-codebook logit heads), sinusoidal PE,
GELU FFN, LayerNorm.  EnCodec itself is a stub: inputs are token ids.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_kind="gelu",
    norm_kind="layernorm",
    pos_kind="sinusoidal",
    rope_pct=0.0,
    num_codebooks=4,
)
