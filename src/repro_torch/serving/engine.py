"""Batched LM serving engine: prefill + step-synchronous batched decode.

Serves up to B sequences together: requests are chunked into batches of
B, their prompts right-padded to the batch's longest, one prefill runs
the padded prompts, then every row decodes one token a step from
position ``Lmax``.  Greedy or per-request temperature sampling.  Prefill
and decode run eagerly.

The reference's right-padding simplification is kept on purpose: a row
shorter than the batch's longest prompt takes its first token from the
logits at position ``Lmax - 1``, which follow its padding (token 0), not
from its own last prompt token.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

Tree = Any


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (L,) or (L, K) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: Optional[List[int]] = None
    # (num_image_tokens, CLIP_EMBED_DIM) CLIP patch embeddings: a vlm
    # model's requests need them, other models' ignore them
    img_embeds: Optional[np.ndarray] = None


class ServeEngine:
    def __init__(self, model: Model, params: Tree, batch_size: int,
                 cache_len: int, seed: int = 0):
        self.model = model
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.device = tree_leaves(params)[0].device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor,
                any_sampling: bool) -> torch.Tensor:
        """Per-request sampling: row i uses requests[i]'s temperature.

        ``logits`` is (B, V) or (B, K, V) (codebook heads); ``temps`` is
        (B,).  Rows with temperature <= 0 decode greedily, others sample
        from their own temperature-scaled distribution (Gumbel-max over
        uniforms from the engine's generator).  ``any_sampling`` is
        hoisted by the caller so the all-greedy path draws nothing.
        """
        greedy = torch.argmax(logits, dim=-1)
        if not any_sampling:
            return greedy
        t = temps.reshape((-1,) + (1,) * (logits.ndim - 1))
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        expo = -torch.log(u.clamp_min(1e-20))  # Exp(1) draws, > 0
        gumbel = -torch.log(expo.clamp_min(1e-20))
        sampled = torch.argmax(logits / torch.clamp(t, min=1e-6) + gumbel,
                               dim=-1)
        cond = (temps > 0.0).reshape((-1,) + (1,) * (greedy.ndim - 1))
        return torch.where(cond, sampled, greedy)

    def generate(self, requests: List[Request]) -> List[np.ndarray]:
        """Batched generation; requests are chunked into engine batches."""
        outs: List[np.ndarray] = []
        for s in range(0, len(requests), self.B):
            outs.extend(self._generate_batch(requests[s: s + self.B]))
        return outs

    @torch.no_grad()
    def _generate_batch(self, reqs: List[Request]) -> List[np.ndarray]:
        cfg = self.model.cfg
        Lmax = max(len(r.prompt) for r in reqs)

        def pad_to(t):
            return np.pad(t, [(0, Lmax - len(t))] + [(0, 0)] * (t.ndim - 1))

        tokens = np.stack([pad_to(np.asarray(r.prompt)) for r in reqs])
        batch = {"tokens": torch.as_tensor(tokens).to(self.device)}
        if cfg.num_image_tokens:
            if any(r.img_embeds is None for r in reqs):
                raise ValueError(f"{cfg.name} serves requests with "
                                 "img_embeds (its image tokens)")
            batch["img_embeds"] = torch.as_tensor(
                np.stack([np.asarray(r.img_embeds, np.float32)
                          for r in reqs])).to(self.device)
        logits, cache = self.model.prefill(self.params, batch, self.cache_len)
        steps = max(r.max_new_tokens for r in reqs)
        # absolute position of the first generated token: after the image
        # tokens the prefill prepended and the padded prompt
        pos = torch.full((len(reqs),), Lmax + cfg.num_image_tokens,
                         dtype=torch.long, device=self.device)
        temps = torch.tensor([r.temperature for r in reqs],
                             dtype=torch.float32, device=self.device)
        any_sampling = any(r.temperature > 0.0 for r in reqs)
        tok = self._sample(logits, temps, any_sampling)
        out = [tok]
        for _ in range(steps - 1):
            logits, cache = self.model.decode_step(
                self.params, tok[:, None], pos, cache)
            tok = self._sample(logits, temps, any_sampling)
            pos = pos + 1
            out.append(tok)
        # one device read for the whole batch
        gen = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        return [gen[i, : r.max_new_tokens] for i, r in enumerate(reqs)]
