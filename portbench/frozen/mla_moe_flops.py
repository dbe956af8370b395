"""The operations a DeepSeek-V2 forward needs, from its published shapes
and the card's share of its experts (the ``lm_decode.mfu_pct`` count of
the DeepSeek serving cell): 2 per weight per token through every product
the token runs, and attention's two products per (query, key) pair the
causal mask keeps.

Keys are the configuration file's (HF's ``config.json`` names).
"""

from __future__ import annotations

from typing import Dict


def token_params(c: Dict) -> float:
    """Weights one token multiplies through on this card: per layer the
    latent attention's four projections (``wq``, ``kv_a``, ``kv_b``,
    ``wo``); the dense layers' SwiGLU; each expert layer's router over
    all its experts, its shared experts' SwiGLU and the held experts'
    SwiGLU for the share of the token's top-k pairs that lands here on
    average (k x held / routed); then the LM head.  The embedding is a
    lookup, not a product."""
    E, H = c["hidden_size"], c["num_attention_heads"]
    r, dn = c["kv_lora_rank"], c["qk_nope_head_dim"]
    dr, dv = c["qk_rope_head_dim"], c["v_head_dim"]
    L, Ld = c["num_hidden_layers"], c["first_k_dense_replace"]
    Fe = c["moe_intermediate_size"]
    R = c["published_n_routed_experts"]
    attn = E * H * (dn + dr) + E * (r + dr) + r * H * (dn + dv) + H * dv * E
    dense = 3 * E * c["intermediate_size"]
    pairs = c["num_experts_per_tok"] * c["n_routed_experts"] / R
    expert = E * R + 3 * E * c["n_shared_experts"] * Fe + pairs * 3 * E * Fe
    return L * attn + Ld * dense + (L - Ld) * expert + E * c["vocab_size"]


def forward_flops(c: Dict, tokens: float, ctx_pairs: float) -> float:
    """Operations of ``tokens`` tokens whose queries meet ``ctx_pairs``
    (query, key) pairs in all: per pair, head and layer the scores over
    ``qk_nope + qk_rope`` dims and the weighted values over ``v`` dims."""
    per_pair = 2.0 * c["num_attention_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
    return (2.0 * tokens * token_params(c)
            + per_pair * c["num_hidden_layers"] * ctx_pairs)
