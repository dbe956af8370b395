"""Tiny sizes of the benchmark's cells added after ``pb_tiny``'s tables
were written: each new configuration's cut and each new driver kind's
traffic cut, merged into ``pb_tiny``'s tables (``extend``) before any
test builds a tiny root, by ``portbench/conftest.py``."""

from __future__ import annotations

TINY_CONFIG = {
    # 1 dense + 2 expert layers, 4 of 8 experts held, top-3, YaRN on;
    # float32, as pb_tiny's LM
    "deepseek-v2-lite": {
        "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
        "moe_intermediate_size": 32, "n_routed_experts": 4,
        "published_n_routed_experts": 8, "num_experts_per_tok": 3,
        "n_shared_experts": 1, "vocab_size": 512, "dtype": "float32"},
}
TINY_TRAFFIC = {
    "lm_serve_deepseek": {"batch": 2, "prompt_len": 8, "new_tokens": 6,
                          "cache_len": 14, "judged": 2},
}


def extend(tiny) -> None:
    """Merge these tables into ``tiny`` (the ``pb_tiny`` module)."""
    for name, cut in TINY_CONFIG.items():
        tiny.TINY_CONFIG.setdefault(name, cut)
    for kind, cut in TINY_TRAFFIC.items():
        tiny.TINY_TRAFFIC.setdefault(kind, cut)
