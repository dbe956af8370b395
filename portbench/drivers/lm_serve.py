"""Batch completion through ``ServeEngine.generate``, closed loop.

Traffic keys: static batches of ``batch`` requests, each a prompt of
``prompt_len`` tokens of the frozen Markov stream (one stream batch an
engine batch, drawn from the seed) asking for ``new_tokens`` greedy
tokens, on an engine of ``cache_len`` positions; the next batch starts
when the last returns.  ``judged`` requests, drawn from the seed among
those finished, are judged by the reference's full forward over their
prompt and served tokens; ``checks`` each compared number's limit.
"""

from __future__ import annotations

import numpy as np

from portbench.cellbase import CellBase, generator_seed, now
from portbench.drivers import lm_train
from portbench.frozen import bounds
from portbench.frozen.tokens import MarkovTokenStream
from portbench.refs import lm_ref
from portbench.refs.precision import matmul_precision


def prompts(cfg, mix, seed):
    """Endless (batch, prompt_len) int32 prompt batches from the seed."""
    for x, _ in MarkovTokenStream(cfg["vocab_size"], mix["prompt_len"],
                                  mix["batch"], seed=seed).batches():
        yield x


def served_gaps(logits: "torch.Tensor", served: "torch.Tensor"):
    """Per position, how far the served token's logit lies below the
    reference's best: (positions,) float."""
    import torch

    best = logits.max(-1).values
    return best - torch.gather(logits, -1, served.long()[:, None])[:, 0]


def judge_gaps(cfg, seed, device, seqs, prompt_len, quant=None):
    """The widest gap over every served position of ``seqs`` ([(prompt
    + served tokens)], each (prompt_len + n,) ids), reference float32.
    With ``quant`` the token at each position is the one a forward in
    that precision puts first (the control), not the served one."""
    import torch

    params = lm_train.weights(cfg, seed, device)
    ref = lm_ref.StableLM(params, cfg)
    low = lm_ref.StableLM(params, cfg, quant) if quant else None
    widest = 0.0
    with torch.no_grad(), matmul_precision(tf32=False):
        for s in seqs:
            ids = torch.as_tensor(np.asarray(s)[None, :-1]).to(device)
            h = ref.hidden(ids)[0, prompt_len - 1:]
            logits = ref.logits(h)
            served = torch.as_tensor(np.asarray(s)[prompt_len:]).to(device)
            if low is not None:
                served = low.logits(low.hidden(ids)[0, prompt_len - 1:]
                                    ).argmax(-1)
            widest = max(widest, float(served_gaps(logits, served).max()))
            del h, logits
    return widest


class Cell(CellBase):
    def setup(self) -> None:
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import ServeEngine

        mix = self.mix
        self.model = Model(lm_train.model_config(self.cfg), self.device)
        params = lm_train.weights(self.cfg, self.seed, self.device)
        self.engine = ServeEngine(self.model, params, batch_size=mix["batch"],
                                  cache_len=mix["cache_len"],
                                  seed=generator_seed(self.seed, 1))
        self.prompts = prompts(self.cfg, mix, self.seed)
        # warm-up: the prefill and decode signatures of a batch (each
        # signature's first call runs eagerly, then is captured)
        self.engine.generate(self._requests(next(self.prompts), 2))
        self.sync()
        self.log(f"warm-up: prefill captures "
                 f"{self.engine._prefill._cache_size()}, decode captures "
                 f"{self.engine._decode._cache_size()} | batch {mix['batch']}"
                 f" x {mix['prompt_len']} + {mix['new_tokens']} tokens, cache "
                 f"{mix['cache_len']}")

    def _requests(self, x, new_tokens):
        from repro_torch.serving.engine import Request

        return [Request(prompt=row, max_new_tokens=new_tokens,
                        temperature=0.0) for row in x]

    def captures(self) -> int:
        return (self.engine._prefill._cache_size()
                + self.engine._decode._cache_size())

    def window(self, seconds: float) -> dict:
        mix = self.mix
        self.served = []  # (prompt, tokens) of each finished request
        tokens, batches = 0, 0
        with self.spans.span("measured"):
            t0 = now()
            while True:
                with self.spans.span("prompts"):
                    x = next(self.prompts)
                with self.spans.span("generate"):
                    outs = self.engine.generate(
                        self._requests(x, mix["new_tokens"]))
                batches += 1
                for row, out in zip(x, outs):
                    self.attempted += 1
                    if len(out) != mix["new_tokens"]:
                        self.failed += 1
                    tokens += len(out)
                    self.served.append((row, out))
                if now() - t0 >= seconds:
                    break
            t = now()
        self.window_s = t - t0
        self.batches = batches
        self.log(f"served: {batches} batches, {tokens} tokens in "
                 f"{self.window_s:.3f} s")
        return {"decode_tokens_per_s": tokens / self.window_s}

    def layer_ctx(self) -> dict:
        c, mix = self.cfg, self.mix
        B, P, N = mix["batch"], mix["prompt_len"], mix["new_tokens"]
        shape = (c["d_model"], c["num_heads"], c["num_kv_heads"],
                 c["head_dim"], c["d_ff"], c["num_layers"], c["vocab_size"])
        # prefill: every prompt position through the products, causal
        # attention over the prompt; decode: one token a row and step,
        # attending to every position before it
        prefill = bounds.lm_forward_flops(B * P, bounds.causal_pairs(B, P),
                                          *shape)
        ctx_pairs = B * sum(P + i + 1 for i in range(N - 1))
        decode = bounds.lm_forward_flops(B * (N - 1), ctx_pairs, *shape)
        return {"lm_decode": {"batches": self.batches,
                              "flops_per_batch": prefill + decode,
                              "peak_flops": bounds.BF16_FLOPS}}

    def release(self) -> None:
        del self.engine, self.model
        self.free_card()

    def judge(self) -> dict:
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32])
        pick = rng.choice(len(self.served), size=min(self.mix["judged"],
                                                     len(self.served)),
                          replace=False)
        seqs = [np.concatenate([self.served[i][0], self.served[i][1]])
                for i in sorted(pick)]
        gap = judge_gaps(self.cfg, self.seed, self.device, seqs,
                         self.mix["prompt_len"])
        return self.checks({"served_logit_gap": gap})


def control(cfg, mix, seed, device) -> dict:
    """The control: at each position of ``judged`` prompts continued by
    the stream, the gap under the float32 reference of the token that a
    forward with every product's operands in float8 e4m3 (the precision
    below the bfloat16 the configuration computes in) puts first."""
    seqs = []
    for x, _ in MarkovTokenStream(cfg["vocab_size"],
                                  mix["prompt_len"] + mix["new_tokens"],
                                  mix["judged"], seed=seed).batches():
        seqs = list(x)
        break
    return {"served_logit_gap": judge_gaps(cfg, seed, device, seqs,
                                           mix["prompt_len"], quant=lm_ref.fp8)}
