"""Training an LM of the zoo through the trainer's graphed step.

Traffic keys: ``batch`` sequences of ``seq`` tokens of the frozen Markov
stream a step, fed as the LM launcher feeds them (host numpy, then to the
card); ``optimizer`` (AdamW on a warm-up cosine, global-norm clip) as the
launcher chains it; ``judged_steps`` first steps the reference follows;
``planned_peak_bytes`` (the dry run's plan of this step, printed beside
the card's peak); ``checks`` each compared number's limit.

Set-up builds one ``Trainer`` (``jit=True``: a ``StaticStep`` captured
into a CUDA graph at its first call), drives it through the judged steps
with the window's own call and feed, and hands that same object to the
window.
"""

from __future__ import annotations

import dataclasses

from portbench import trainjudge
from portbench.cellbase import CellBase, generator_seed
from portbench.frozen import bounds
from portbench.frozen.tokens import MarkovTokenStream
from portbench.refs import lm_ref
from portbench.refs.precision import matmul_precision

MODEL_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "mlp_kind",
              "norm_kind", "norm_eps", "qkv_bias", "tie_embeddings",
              "rope_theta", "rope_pct", "dtype", "param_dtype", "remat")


def model_config(cfg):
    from repro_torch.models.config import ModelConfig

    return dataclasses.replace(
        ModelConfig(), **{k: cfg[k] for k in MODEL_KEYS if k in cfg})


def weights(cfg, seed, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    return lm_ref.init_params(cfg, gen, device)


def stream(cfg, mix, seed):
    return MarkovTokenStream(cfg["vocab_size"], mix["seq"], mix["batch"],
                             seed=seed).batches()


def step_flops(cfg, batch: int, seq: int) -> float:
    """Model operations of one step: the forward's products and causal
    attention, three times (forward and backward; recompute not
    counted)."""
    return 3.0 * bounds.lm_forward_flops(
        batch * seq, bounds.causal_pairs(batch, seq), cfg["d_model"],
        cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"],
        cfg["num_layers"], cfg["vocab_size"])


def reference(cfg, mix, seed, device, quant=None, rows=None) -> dict:
    """The reference's first ``judged_steps`` from the seed's weights on
    the seed's batches (``rows``: only those rows of each batch, the
    planted half-batch fault)."""
    import torch

    params = weights(cfg, seed, device)
    batches = []
    for _, (x, y) in zip(range(mix["judged_steps"]), stream(cfg, mix, seed)):
        if rows is not None:
            x, y = x[rows], y[rows]
        batches.append((torch.as_tensor(x).to(device),
                        torch.as_tensor(y).to(device)))
    with matmul_precision(tf32=False):
        return lm_ref.train_steps(params, cfg, batches, mix["optimizer"],
                                  quant=quant, keep=mix["judged_steps"])


class Cell(CellBase):
    def setup(self) -> None:
        import torch
        from repro_torch.models.model import Model
        from repro_torch.optim import adamw, chain_clip, warmup_cosine
        from repro_torch.train.loop import Trainer, TrainState

        hp = self.mix["optimizer"]
        self.model = Model(model_config(self.cfg), self.device)
        opt = chain_clip(adamw(warmup_cosine(hp["lr"], hp["warmup"],
                                             hp["decay"]),
                               b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                               weight_decay=hp["weight_decay"]), hp["clip"])
        self.trainer = Trainer(self.model, opt)
        params = weights(self.cfg, self.seed, self.device)
        self.state = TrainState(params, opt.init(params), 0)
        self.batches = stream(self.cfg, self.mix, self.seed)

        def read_first():
            mu = lm_ref.leaves(self.state.opt_state.mu)
            self.first["grad"] = {
                n: float(torch.linalg.vector_norm(v)) / (1 - hp["b1"])
                for n, v in mu.items()}

        self.judged_steps(read_first)
        self.record_change(
            lambda: lm_ref.leaves(weights(self.cfg, self.seed, self.device)),
            lm_ref.leaves(self.state.params))
        step = self.trainer.step_fn
        self.log(f"set-up steps: {self.mix['judged_steps']} (captures "
                 f"{step.captures}, replays {step.replays}) | losses "
                 f"{self.first['loss']} | planned peak (dry run) "
                 f"{self.mix['planned_peak_bytes']} B")

    def _step(self):
        """The window's call and feed: one batch of the stream to the card,
        then one step of the trainer."""
        import torch

        with self.spans.span("feed"):
            x, y = next(self.batches)
            batch = {"tokens": torch.as_tensor(x).to(self.device),
                     "targets": torch.as_tensor(y).to(self.device)}
        with self.spans.span("step"):
            self.state, m = self.trainer.step_fn(self.state, batch)
        return m

    def captures(self) -> int:
        return self.trainer.step_fn.captures

    def memory_note(self) -> str:
        return (f" | planned by the dry run {self.mix['planned_peak_bytes']}"
                f" B")

    def window(self, seconds: float) -> dict:
        return self.train_window(seconds, "train_step_ms")

    def layer_ctx(self) -> dict:
        return {"train": {
            "steps": self.steps,
            "flops_per_step": step_flops(self.cfg, self.mix["batch"],
                                         self.mix["seq"]),
            "peak_flops": bounds.BF16_FLOPS}}

    def release(self) -> None:
        del self.trainer, self.state, self.model
        self.free_card()

    def judge(self) -> dict:
        ref = reference(self.cfg, self.mix, self.seed, self.device)
        got = trainjudge.readings(self.first, ref)
        told = {k: v for k, v in got.items() if k not in self.mix["checks"]}
        self.log(f"judged: not compared {told} | losses {self.first['loss']}"
                 f" | reference losses {ref['loss']}")
        return self.checks(got)


def control(cfg, mix, seed, device) -> dict:
    """The control (the reference with every product's operands in
    float8 e4m3, the precision below the bfloat16 the configuration
    computes in) and the planted faults, each read against the float32
    reference."""
    ref = reference(cfg, mix, seed, device)
    out = {"excluded": trainjudge.excluded(ref)}
    out["control_fp8"] = trainjudge.readings(
        reference(cfg, mix, seed, device, quant=lm_ref.fp8), ref)
    half = list(range(mix["batch"] // 2))
    out["half_batch"] = trainjudge.readings(
        reference(cfg, mix, seed, device, rows=half), ref)
    still = dict(ref, change={n: 0.0 for n in ref["change"]})
    out["state_unchanged"] = trainjudge.readings(still, ref)
    return out

