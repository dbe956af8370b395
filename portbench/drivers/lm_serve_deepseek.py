"""Batch completion of DeepSeek-V2 through ``ServeEngine.generate``, closed
loop, on one card's share of its experts.

Traffic keys as ``lm_serve``'s, whose prompts and window this driver
runs: static batches of ``batch`` prompts of ``prompt_len`` tokens of the
frozen Markov stream asking for ``new_tokens`` greedy tokens each, on an
engine of ``cache_len`` positions, the next batch when the last returns;
``judged`` requests judged by the plain reference's full forward
(``refs/deepseek_v2_ref.py``) over their prompt and served tokens: the
served tokens' logit gap, and, since the held experts weigh too little
in a token's output for a fault in them to move the served tokens, the
program's expert layer held to the reference's on each expert layer's
input of those requests.  The model is built from the configuration
file's HF keys; a program without the DeepSeek-V2 layers stops in
set-up, at once, with no result.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.cellbase import generator_seed
from portbench.drivers import lm_serve
from portbench.frozen import bounds, mla_moe_flops
from portbench.frozen.tokens import MarkovTokenStream
from portbench.refs import deepseek_v2_ref as ref
from portbench.refs.precision import matmul_precision

# what the configuration may say that the program computes as published
PUBLISHED = {"hidden_act": "silu", "scoring_func": "softmax",
             "topk_method": "greedy", "norm_topk_prob": False,
             "moe_layer_freq": 1, "n_group": 1, "topk_group": 1,
             "attention_bias": False, "q_lora_rank": None}
# the program's fields of these layers (a program without them stops)
NEEDS = ("router_experts", "expert_offset", "num_shared_experts",
         "first_k_dense", "dense_d_ff", "yarn_factor")


def model_config(cfg):
    """The program's ``DeepSeekV2Config`` of the configuration file
    ``cfg``."""
    try:
        from repro_torch.models.config import DeepSeekV2Config
        have = {f.name for f in dataclasses.fields(DeepSeekV2Config)}
    except ImportError:
        have = set()
    missing = [n for n in NEEDS if n not in have]
    if missing:
        raise SystemExit(f"portbench: this program has no DeepSeekV2Config "
                         f"with {missing}: it cannot build {cfg['name']}'s "
                         f"layers, no result")
    for k, v in PUBLISHED.items():
        if cfg[k] != v:
            raise ValueError(f"{cfg['name']}: {k} {cfg[k]!r}, the program "
                             f"computes {v!r}")
    y = cfg["rope_scaling"]
    if y["type"] != "yarn":
        raise ValueError(f"{cfg['name']}: rope_scaling {y['type']!r}")
    first, held = ref.held_experts(cfg)
    H = cfg["num_attention_heads"]
    return DeepSeekV2Config(
        name=cfg["name"], family="moe",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=H, num_kv_heads=H,
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_kind="swiglu", norm_kind="rmsnorm", norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        mla=True, q_lora_rank=None, kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        num_experts=held, num_experts_per_tok=cfg["num_experts_per_tok"],
        router_softmax_order="softmax_then_topk_raw",
        router_experts=cfg["published_n_routed_experts"],
        expert_offset=first, num_shared_experts=cfg["n_shared_experts"],
        routed_scaling=float(cfg["routed_scaling_factor"]),
        first_k_dense=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        yarn_factor=float(y["factor"]),
        yarn_original_max_pos=y["original_max_position_embeddings"],
        yarn_beta_fast=float(y["beta_fast"]),
        yarn_beta_slow=float(y["beta_slow"]),
        yarn_mscale=float(y["mscale"]),
        yarn_mscale_all_dim=float(y["mscale_all_dim"]),
        dtype=cfg["dtype"], param_dtype=cfg["param_dtype"])


def weights(cfg, seed, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    return ref.init_params(cfg, gen, device)


def _widest(a: float, b: float) -> float:
    """The larger of two gaps, a NaN read as infinite (never lost)."""
    return max(a, math.inf if math.isnan(b) else b)


class _Probe(ref.DeepSeekV2):
    """The reference, which at each expert layer also holds ``other``
    (tokens (T, E) in the program's compute dtype, layer -> the held
    experts' part of them, (T, E)) to its own held experts' part of the
    same tokens, computed in float32 from the same rounded values: same
    scores, so both route alike.  ``widest`` keeps the largest max |gap| /
    max |reference part| of any layer."""

    def __init__(self, params, c, other, dtype):
        super().__init__(params, c)
        self.other, self.dtype, self.widest = other, dtype, 0.0

    def _moe(self, h, f, l):
        x = h.reshape(-1, h.shape[-1]).to(self.dtype)
        want = self.routed(x.float(), f, l, *self.route(x.float(), f, l))
        gap = float((self.other(x, l).float() - want).abs().max())
        top = float(want.abs().max())
        self.widest = _widest(self.widest, gap / top if top > 0 else
                              (0.0 if gap == 0 else math.inf))
        return super()._moe(h, f, l)


def program_routed(cfg, params):
    """The program's expert layer, its held experts alone, on the weights
    ``params``: (tokens (T, E), layer) -> (T, E)."""
    from repro_torch.models import moe

    mcfg = model_config(cfg)
    f = params["main"]["b0"]["ffn"]

    def run(x, l):
        held = {k: f[k][l] for k in ("router", "w_gate", "w_up", "w_down")}
        return moe.dropless_forward(held, x[None], mcfg)[0][0]

    return run


def judge_gaps(cfg, seed, device, seqs, prompt_len, quant=None):
    """Over every served position of ``seqs``, float32: the widest
    ``served_logit_gap`` (``lm_serve.judge_gaps``), and the widest
    ``moe_routed_gap``, the program's expert layer (its held experts) on
    each expert layer's input of the reference's forward against the
    reference's.  With ``quant``: the token a forward in that precision
    puts first, and that forward's held experts (the control)."""
    import torch

    params = weights(cfg, seed, device)
    low = ref.DeepSeekV2(params, cfg, quant) if quant else None
    if low is None:
        other = program_routed(cfg, params)
    else:
        def other(x, l):
            f = params["main"]["b0"]["ffn"]
            return low.routed(x.float(), f, l, *low.route(x.float(), f, l))
    dtype = getattr(torch, cfg["dtype"])
    model = _Probe(params, cfg, other, dtype)
    widest = 0.0
    with torch.no_grad(), matmul_precision(tf32=False):
        for s in seqs:
            ids = torch.as_tensor(np.asarray(s)[None, :-1]).to(device)
            logits = model.logits(model.hidden(ids)[0, prompt_len - 1:])
            served = torch.as_tensor(np.asarray(s)[prompt_len:]).to(device)
            if low is not None:
                served = low.logits(low.hidden(ids)[0, prompt_len - 1:]
                                    ).argmax(-1)
            widest = _widest(widest, float(
                lm_serve.served_gaps(logits, served).max()))
            del logits
    return {"served_logit_gap": widest, "moe_routed_gap": model.widest}


class Cell(lm_serve.Cell):
    def setup(self) -> None:
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import ServeEngine

        mix = self.mix
        self.model = Model(model_config(self.cfg), self.device)
        params = weights(self.cfg, self.seed, self.device)
        self.engine = ServeEngine(self.model, params, batch_size=mix["batch"],
                                  cache_len=mix["cache_len"],
                                  seed=generator_seed(self.seed, 1))
        self.prompts = lm_serve.prompts(self.cfg, mix, self.seed)
        # warm-up: each signature's first call runs eagerly, then is
        # captured
        self.engine.generate(self._requests(next(self.prompts), 2))
        self.sync()
        self.log(f"warm-up: prefill captures "
                 f"{self.engine._prefill._cache_size()}, decode captures "
                 f"{self.engine._decode._cache_size()} | batch {mix['batch']}"
                 f" x {mix['prompt_len']} + {mix['new_tokens']} tokens, cache "
                 f"{mix['cache_len']}")

    def window(self, seconds: float) -> dict:
        """``lm_serve``'s window; the routed pairs each held expert took in
        it read after it through ``obs.metrics`` (the warm-up's published
        before it)."""
        from repro_torch.models import moe
        from repro_torch.obs.metrics import MetricsRegistry

        moe.publish_expert_load(MetricsRegistry(), self.device)
        out = super().window(seconds)
        self.expert_pairs = moe.publish_expert_load(MetricsRegistry(),
                                                    self.device)
        self.log(f"routed pairs per held expert in the window: "
                 f"{self.expert_pairs}")
        return out

    def layer_ctx(self) -> dict:
        c, mix = self.cfg, self.mix
        B, P, N = mix["batch"], mix["prompt_len"], mix["new_tokens"]
        prefill = mla_moe_flops.forward_flops(c, B * P,
                                              bounds.causal_pairs(B, P))
        ctx_pairs = B * sum(P + i + 1 for i in range(N - 1))
        decode = mla_moe_flops.forward_flops(c, B * (N - 1), ctx_pairs)
        return {"lm_decode": {"batches": self.batches,
                              "flops_per_batch": prefill + decode,
                              "peak_flops": bounds.BF16_FLOPS},
                "dsv2_decode": {"expert_pairs": self.expert_pairs}}

    def judge(self) -> dict:
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32])
        pick = rng.choice(len(self.served), size=min(self.mix["judged"],
                                                     len(self.served)),
                          replace=False)
        seqs = [np.concatenate([self.served[i][0], self.served[i][1]])
                for i in sorted(pick)]
        return self.checks(judge_gaps(self.cfg, self.seed, self.device,
                                      seqs, self.mix["prompt_len"]))


def control(cfg, mix, seed, device) -> dict:
    """The control: at each position of ``judged`` prompts continued by
    the stream, the gap under the float32 reference of the token that a
    forward with every product's operands in float8 e4m3 (the precision
    below the bfloat16 the configuration computes in) puts first."""
    for x, _ in MarkovTokenStream(cfg["vocab_size"],
                                  mix["prompt_len"] + mix["new_tokens"],
                                  mix["judged"], seed=seed).batches():
        seqs = list(x)
        break
    return judge_gaps(cfg, seed, device, seqs, mix["prompt_len"],
                      quant=ref.fp8)


def _routed_dropped():
    """Every routed pair weighs nothing: only the shared experts add.
    Returns the undo."""
    from repro_torch.models import moe

    real = moe.router_weights

    def route(logits, cfg):
        w, idx = real(logits, cfg)
        return w * 0, idx

    moe.router_weights = route
    return lambda: setattr(moe, "router_weights", real)


def _experts_permuted():
    """Each held expert's pairs run on the next held expert's weights."""
    from repro_torch.models import moe

    real = moe._routed

    def routed(xt, router, w_gate, w_up, w_down, cfg):
        return real(xt, router, *(None if w is None else w.roll(1, 0)
                                  for w in (w_gate, w_up, w_down)), cfg)

    moe._routed = routed
    return lambda: setattr(moe, "_routed", real)


def _share_misplaced():
    """The layer takes the next card's share of the router's experts for
    its own (a wrong expert offset)."""
    from repro_torch.models import moe

    real = moe._routed

    def routed(xt, router, w_gate, w_up, w_down, cfg):
        cfg = dataclasses.replace(cfg, expert_offset=cfg.expert_offset
                                  + cfg.num_experts)
        return real(xt, router, w_gate, w_up, w_down, cfg)

    moe._routed = routed
    return lambda: setattr(moe, "_routed", real)


# faults of the held experts planted under the timed path, each read on
# the card by ``control.py --fault``: the upper readings of
# ``moe_routed_gap`` (the served tokens do not see them)
FAULTS = {
    "routed_dropped": _routed_dropped,
    "experts_permuted": _experts_permuted,
    "share_misplaced": _share_misplaced,
}
