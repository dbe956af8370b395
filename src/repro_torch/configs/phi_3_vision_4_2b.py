"""Phi-3-Vision 4.2B — phi-3-mini backbone + CLIP patch-embedding frontend
(frontend is a STUB per assignment: input_specs provides precomputed
(B, 576, 1024) CLIP-L/14 patch embeddings; a trainable projection maps
them into d_model and they are prepended to the token stream).

[hf:microsoft/Phi-3-vision-128k-instruct]
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    num_image_tokens=576,
)
