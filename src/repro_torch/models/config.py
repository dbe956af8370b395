"""Unified model configuration for the architecture zoo.

One dataclass covers dense / MoE / SSM / hybrid / VLM / audio backbones;
per-arch files in repro_torch/configs instantiate it with published
numbers.  A copy of the reference's dataclass, field for field;
``DeepSeekV2Config`` adds the fields of DeepSeek-V2's layers, which the
reference has not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # transformer backbone
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    qkv_bias: bool = False  # qwen1.5-style attention biases
    tie_embeddings: bool = False
    emb_scale: Optional[float] = None  # e.g. sqrt(d_model) for gemma-family
    logit_softcap: Optional[float] = None  # e.g. 30.0 recurrentgemma
    rope_theta: float = 10000.0
    rope_pct: float = 1.0  # partial rotary (stablelm2: 0.25)
    pos_kind: str = "rope"  # rope | sinusoidal (musicgen)

    # attention variants
    attention_kind: str = "full"  # full | swa (sliding window)
    window: Optional[int] = None  # SWA/local window length
    attn_impl: str = "auto"  # auto | full | chunked
    attn_chunk: int = 1024  # kv block for chunked attention
    # unroll the chunked-attention kv loop (dry-run cost extraction only:
    # XLA's cost_analysis counts while-loop bodies once, not x trip count)
    attn_chunk_unroll: bool = False
    attn_logit_softcap: Optional[float] = None

    # MLA (minicpm3 / deepseek-style) — set mla=True to replace GQA
    mla: bool = False
    q_lora_rank: Optional[int] = 768  # None: a direct q projection (wq)
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    # MoE
    num_experts: int = 0  # 0 = dense MLP
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    # topk_then_softmax (mixtral) | softmax_then_topk (granite: the top-k
    # renormalised) | softmax_then_topk_raw (deepseek: not renormalised)
    router_softmax_order: str = "topk_then_softmax"
    # tokens per dispatch group (Gshard): capacity C = Gs*k/E*cf, and the
    # dispatch einsum costs E*C*d per token — small groups keep it a few %
    # of expert FLOPs while preserving fixed shapes.
    moe_group_size: int = 512

    # SSM (mamba2)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma/griffin)
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rg", "rg", "local") per group
    lru_width: Optional[int] = None
    rglru_c: float = 8.0

    # modality frontend stubs
    num_image_tokens: int = 0  # vlm: patch-embedding positions per sample
    num_codebooks: int = 0  # audio: EnCodec codebooks (0 = plain LM)

    # training / numerics
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    # vocab padding: embedding/lm_head vocab dims are padded up to a
    # multiple of this so they shard cleanly over `model` (any multiple of
    # 128 divides the 16-way TP axis); padded logits are masked to -inf.
    vocab_pad_multiple: int = 128
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True

    # quantization (the paper's energy-aware mode)
    # q115 / q1_7      : fake-quant (QAT; float storage, grid-snapped)
    # q115_int / q1_7_int : TRUE int16/int8 weight storage, dequantized on
    #   the fly — halves/quarters weight HBM traffic (serving §Perf mode)
    quant: Optional[str] = None
    # int8 KV cache with per-(token, head) max-abs scales (the paper's
    # Q-format idea applied to attention state; serving memory-term win)
    kv_cache_quant: bool = False

    # DeepSeek-V2's settings (``DeepSeekV2Config``'s fields, which the
    # reference's dataclass has not): every other config reads these
    # class defaults, none of them a field, so ``asdict`` of a zoo config
    # stays the reference's, field for field
    moe_dropless = False
    router_experts = 0
    expert_offset = 0
    num_shared_experts = 0
    routed_scaling = 1.0
    first_k_dense = 0
    dense_d_ff = None
    yarn_factor = 0.0
    yarn_original_max_pos = 4096
    yarn_beta_fast = 32.0
    yarn_beta_slow = 1.0
    yarn_mscale = 1.0
    yarn_mscale_all_dim = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is runnable (bounded attention state)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.attention_kind == "swa"
        )

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_red = min(self.num_layers, 2)
        if self.family == "hybrid" and self.block_pattern:
            n_red = len(self.block_pattern)  # exercise the full pattern
        base = dict(
            num_layers=n_red,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            q_lora_rank=64,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            ssm_state=16,
            ssm_headdim=32,
            ssm_chunk=32,
            window=min(self.window, 64) if self.window else None,
            lru_width=128 if self.lru_width else None,
            num_image_tokens=16 if self.num_image_tokens else 0,
            block_pattern=self.block_pattern[:] if self.block_pattern else (),
            scan_layers=False,
            remat="none",
            dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """A ``ModelConfig`` with DeepSeek-V2's layers
    (hf:deepseek-ai/DeepSeek-V2-Lite): latent attention, YaRN, leading
    dense blocks, and expert blocks that hold a share of the routed
    experts beside shared experts.

    The expert layer (``moe.dropless_forward``) has no capacity, so no token
    is dropped and a token's output never depends on its neighbours; it
    holds the ``num_experts`` experts from ``expert_offset`` on of the
    ``router_experts`` the router scores (one card's share under expert
    parallelism)."""

    moe_dropless = True  # not a field: DeepSeek-V2's expert layer
    router_experts: int = 0  # 0: num_experts
    expert_offset: int = 0
    num_shared_experts: int = 0  # one MLP of width n * d_ff
    routed_scaling: float = 1.0
    # leading dense blocks before the MoE blocks, with their own MLP width
    first_k_dense: int = 0
    dense_d_ff: Optional[int] = None  # None: d_ff

    # YaRN rope scaling of the MLA rotary dims (factor 0: none)
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
