"""StableLM-2 (hf:stabilityai/stablelm-2-1_6b) in plain PyTorch, float32.

Pre-norm blocks with LayerNorm (scale and bias), multi-head attention
with q/k/v biases and rotary embedding on the first quarter of each
head's dims (the rotated dims taken as two halves), a causal softmax,
the SwiGLU MLP, a final LayerNorm and an untied LM head.  Params are a
nested dict in the layout the benchmark hands the program (the layer
leaves stacked over the 24 layers).  With ``quant`` every product's two
operands are rounded first (the control's lower precision); the
gradient passes such a rounding unchanged.

Also AdamW on a linear warm-up with global-norm clipping, as the LM
trainer is configured, and the benchmark's own weights from the seed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tree = Dict
FP8_MAX = 448.0  # largest float8 e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at 448), forward only."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x.detach())


# ---------------------------------------------------------------- weights
def leaf_specs(c: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, draw, scale) of every leaf, in the order they are
    drawn: ``normal`` times scale, ``uniform`` in [-scale, scale), or
    ``full`` of scale."""
    L, E, H, D, F_ = (c["num_layers"], c["d_model"], c["num_heads"],
                      c["head_dim"], c["d_ff"])
    Kv, V = c["num_kv_heads"], c["vocab_size"]
    u = 1.0 / math.sqrt(E)
    return [
        ("embed/table", (V, E), "normal", 0.02),
        ("main/b0/norm1/scale", (L, E), "full", 1.0),
        ("main/b0/norm1/bias", (L, E), "full", 0.0),
        ("main/b0/mixer/wq", (L, E, H, D), "uniform", u),
        ("main/b0/mixer/wk", (L, E, Kv, D), "uniform", u),
        ("main/b0/mixer/wv", (L, E, Kv, D), "uniform", u),
        ("main/b0/mixer/wo", (L, H, D, E), "uniform", 1.0 / math.sqrt(H * D)),
        ("main/b0/mixer/bq", (L, H, D), "full", 0.0),
        ("main/b0/mixer/bk", (L, Kv, D), "full", 0.0),
        ("main/b0/mixer/bv", (L, Kv, D), "full", 0.0),
        ("main/b0/norm2/scale", (L, E), "full", 1.0),
        ("main/b0/norm2/bias", (L, E), "full", 0.0),
        ("main/b0/ffn/w_gate", (L, E, F_), "uniform", u),
        ("main/b0/ffn/w_up", (L, E, F_), "uniform", u),
        ("main/b0/ffn/w_down", (L, F_, E), "uniform", 1.0 / math.sqrt(F_)),
        ("final_norm/scale", (E,), "full", 1.0),
        ("final_norm/bias", (E,), "full", 0.0),
        ("lm_head", (E, V), "uniform", u),
    ]


def init_params(c: Dict, gen: torch.Generator, device) -> Tree:
    """The benchmark's float32 weights from ``gen`` (on ``device``), one
    draw a leaf, as a nested dict."""
    tree: Tree = {}
    for name, shape, draw, scale in leaf_specs(c):
        if draw == "normal":
            t = torch.randn(shape, generator=gen, device=device) * scale
        elif draw == "uniform":
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * scale
        else:
            t = torch.full(shape, scale, device=device)
        node = tree
        *path, last = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def leaves(tree: Tree) -> Dict[str, torch.Tensor]:
    """``{"a/b/c": tensor}`` of a nested dict."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = v

    walk(tree, "")
    return out


# ---------------------------------------------------------------- forward
def _norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rope(x, pos, theta, pct):
    """x (B, L, H, D); rotary on the first ``int(D * pct) // 2 * 2`` dims,
    as two halves, at positions ``pos`` (B, L)."""
    D = x.shape[-1]
    rot = int(D * pct) // 2 * 2
    inv = 1.0 / torch.pow(torch.tensor(theta, device=x.device),
                          torch.arange(0, rot, 2, device=x.device).float() / rot)
    ang = pos[..., None].float() * inv
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2, rest = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


class StableLM:
    def __init__(self, params: Tree, c: Dict,
                 quant: Optional[Callable] = None):
        self.p, self.c = params, c
        self.q = quant or (lambda x: x)

    def _mm(self, a, b):
        return self.q(a) @ self.q(b)

    def _layer(self, x, l, pos):
        c, b = self.c, self.p["main"]["b0"]
        B, L, E = x.shape
        H, D = c["num_heads"], c["head_dim"]
        m = b["mixer"]
        h = _norm(x, b["norm1"]["scale"][l], b["norm1"]["bias"][l],
                  c["norm_eps"])
        q = self._mm(h, m["wq"][l].reshape(E, -1)).view(B, L, H, D) + m["bq"][l]
        k = self._mm(h, m["wk"][l].reshape(E, -1)).view(B, L, -1, D) + m["bk"][l]
        v = self._mm(h, m["wv"][l].reshape(E, -1)).view(B, L, -1, D) + m["bv"][l]
        q = _rope(q, pos, c["rope_theta"], c["rope_pct"])
        k = _rope(k, pos, c["rope_theta"], c["rope_pct"])
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, 2)
        v = v.repeat_interleave(rep, 2)
        s = self._mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(D)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        w = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = self._mm(w, v.transpose(1, 2)).transpose(1, 2).reshape(B, L, H * D)
        x = x + self._mm(o, m["wo"][l].reshape(H * D, E))
        f = b["ffn"]
        h = _norm(x, b["norm2"]["scale"][l], b["norm2"]["bias"][l],
                  c["norm_eps"])
        up = self._mm(h, f["w_up"][l])
        g = F.silu(self._mm(h, f["w_gate"][l]))
        return x + self._mm(g * up, f["w_down"][l])

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> the final norm's output (B, L, E); each layer
        recomputed in the backward when gradients are taken."""
        B, L = tokens.shape
        pos = torch.arange(L, device=tokens.device).expand(B, L)
        x = self.p["embed"]["table"][tokens.long()]
        for l in range(self.c["num_layers"]):
            if torch.is_grad_enabled():
                x = checkpoint(self._layer, x, l, pos, use_reentrant=False)
            else:
                x = self._layer(x, l, pos)
        fn = self.p["final_norm"]
        return _norm(x, fn["scale"], fn["bias"], self.c["norm_eps"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self._mm(h, self.p["lm_head"])

    def loss(self, tokens, targets) -> torch.Tensor:
        logits = self.logits(self.hidden(tokens))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())


# ---------------------------------------------------------------- training
def lr_at(count: int, lr: float, warmup: int, decay: int,
          alpha: float = 0.1) -> float:
    """Linear warm-up to ``lr`` over ``warmup`` steps, then cosine decay
    to ``alpha * lr`` over ``decay`` steps (step ``count`` from 1)."""
    if count < warmup:
        return lr * count / max(warmup, 1)
    t = min(count - warmup, decay) / decay
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def train_steps(params: Tree, c: Dict, batches, hp: Dict,
                quant: Optional[Callable] = None, keep: int = 3) -> Dict:
    """``len(batches)`` steps of AdamW with global-norm clipping from
    ``params`` (updated in place).  Returns each step's loss, each leaf's
    gradient norm as the optimizer gets it at step 1 (after the clip),
    each leaf's raw gradient norm at step 1, and each leaf's change after
    the steps."""
    flat = leaves(params)
    names = sorted(flat)
    start = {n: flat[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(flat[n]) for n in names}
    nu = {n: torch.zeros_like(flat[n]) for n in names}
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    out = {"loss": []}
    model = StableLM(params, c, quant)
    for step, (tokens, targets) in enumerate(batches, start=1):
        for n in names:
            flat[n].requires_grad_(True)
        loss = model.loss(tokens, targets)
        grads = torch.autograd.grad(loss, [flat[n] for n in names])
        with torch.no_grad():
            out["loss"].append(float(loss))
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(hp["clip"] / (norm + 1e-9), max=1.0)
            lr = lr_at(step, hp["lr"], hp["warmup"], hp["decay"])
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            if step == 1:
                out["grad_raw"] = {n: float(torch.linalg.vector_norm(g))
                                   for n, g in zip(names, grads)}
                out["grad"] = {n: float(torch.linalg.vector_norm(g * scale))
                               for n, g in zip(names, grads)}
            for n, g in zip(names, grads):
                p = flat[n].detach()
                g = g * scale
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g * g)
                u = -lr * (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
                u = u - lr * wd * p
                p.add_(u)
            del grads
        for n in names:
            flat[n].requires_grad_(False)
        if step == keep:
            break
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm(flat[n] - start[n]))
                         for n in names}
    return out
