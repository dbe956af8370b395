"""RecurrentGemma-2B — Griffin hybrid: RG-LRU recurrent blocks with local
attention, 1 attention : 2 recurrent.

[arXiv:2402.19427; hf:google/recurrentgemma-2b]
26L d_model=2560 10H MQA(kv=1, head_dim=256) d_ff=7680 vocab=256000,
lru_width=2560, local window=2048, GeGLU, tied embeds, sqrt(d) emb scale.
"""

import math

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    rope_pct=0.5,
    emb_scale=math.sqrt(2560.0),
    tie_embeddings=True,
    logit_softcap=30.0,
    attention_kind="local",
    window=2048,
    block_pattern=("rg", "rg", "attn"),
    lru_width=2560,
    rglru_c=8.0,
)
