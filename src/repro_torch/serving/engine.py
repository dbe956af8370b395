"""Batched LM serving engine: prefill + step-synchronous batched decode.

Serves up to B sequences together: requests are chunked into batches of
B, their prompts right-padded to the batch's longest, one prefill runs
the padded prompts, then every row decodes one token a step from
position ``Lmax``.  Greedy or per-request temperature sampling.

**Prefill and decode as CUDA graphs over a static cache**, the port's
form of the reference's ``jax.jit(model.prefill)`` and
``jax.jit(model.decode_step)``.  ``engine._prefill`` and
``engine._decode`` set up each signature once, as a jitted function
compiles once per input shape: a prefill per (B, Lmax, trailing token
shape, image tokens or not), a decode per (B, trailing token shape).
For each batch size B the engine allocates, once and outside any
capture, the decode cache (``model.init_cache``) and a position (B,);
for each signature its static inputs (the padded prompts and image
embeddings, or the step's token (B, 1[, K])).  A batch is never padded
up to the engine's batch size: MoE decode groups the batch's own tokens,
so a ragged last batch is another B.

A signature's first call is its real run, eager, over the static
buffers; on the card it is then captured into a ``torch.cuda.CUDAGraph``
(a capture executes nothing, so no recurrent state advances twice), and
every later call copies its input into the static one and replays.  The
prefill graph copies ``model.prefill``'s whole cache into the static
cache of its B (the first run checks that tree against ``init_cache``'s);
the decode graph writes the static cache in place; the position advances
in place on the device.  Sampling stays outside the graphs, as the
reference's ``_sample`` is outside its jit, so the tokens equal the eager
engine's.  All of an engine's graphs share one memory pool: they replay
one after another on one stream, everything that crosses them is
allocated outside any capture, and each graph's outputs are held for its
lifetime and read before the next replay.  A failed capture or replay
raises; the eager path never runs in its place.  The CPU has no graphs:
there the same bodies run uncaptured over the same static buffers.
``cuda_graph=False`` runs prefill and decode eagerly, a fresh cache a
batch.

Each prefill and each decode step is bracketed on the card by phase
markers (``kernels.markers``: ``prefill_begin``/``prefill_end``,
``decode_begin``/``decode_end``), recorded into the graphs with the rest
of the body, so the profiler's trace splits the two phases' device time.

The reference's right-padding simplification is kept on purpose: a row
shorter than the batch's longest prompt takes its first token from the
logits at position ``Lmax - 1``, which follow its padding (token 0), not
from its own last prompt token.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.kernels import markers
from repro_torch.models.model import Model
from repro_torch.tree import tree_flatten_with_names, tree_leaves

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


class Compiled:
    """One of the engine's two compiled functions (``_prefill``,
    ``_decode``): its signatures, each set up once (a CUDA graph capture on
    the card), and the replays.  ``_cache_size()`` is the capture count,
    as a ``jax.jit`` object's cache size is its compile count, so
    ``RecompileDetector.track`` reads it."""

    def __init__(self, call: Callable):
        # a weak reference to the engine's method: no reference cycle, so
        # an engine dropped by its caller frees its graphs at once
        self._call = weakref.WeakMethod(call)
        self.entries: Dict[Tuple, Dict[str, Any]] = {}
        self.replays = 0
        self.capture_s: List[float] = []  # host seconds of each capture

    def _cache_size(self) -> int:
        return len(self.entries)

    def __call__(self, *args):
        return self._call()(self, *args)


def _check_like(static: Tree, tree: Tree, what: str) -> None:
    """Raise unless ``tree`` has ``static``'s leaf names, shapes and
    dtypes."""
    names, want = tree_flatten_with_names(static)
    got_names, got = tree_flatten_with_names(tree)
    if names != got_names:
        raise ValueError(f"{what}: leaves {got_names} where init_cache has "
                         f"{names}")
    for name, w, g in zip(names, want, got):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(
                f"{what}: leaf {name} is {tuple(g.shape)} {g.dtype}, "
                f"init_cache's {tuple(w.shape)} {w.dtype}")


class ServeEngine:
    def __init__(self, model: Model, params: Tree, batch_size: int,
                 cache_len: int, seed: int = 0, cuda_graph: bool = True):
        self.model = model
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.device = tree_leaves(params)[0].device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # static buffers; graphs on the card only
        self.cuda_graph = bool(cuda_graph)
        self.graphed = self.cuda_graph and self.device.type == "cuda"
        self._pool = None  # one memory pool for all of the engine's graphs
        self._states: Dict[int, Dict[str, Tree]] = {}  # B -> cache, pos
        self._prefill = Compiled(self._prefill_call)
        self._decode = Compiled(self._decode_call)

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

    # ------------------------------------------------ the compiled steps
    def _prefill_body(self, batch: Dict[str, torch.Tensor], cache: Tree, *,
                      check: bool = False) -> torch.Tensor:
        """``model.prefill``, its cache copied into the static ``cache``
        leaf by leaf (checked against it first with ``check``); returns the
        logits."""
        markers.mark("prefill_begin", self.device)
        logits, new = self.model.prefill(self.params, batch, self.cache_len)
        if check:
            _check_like(cache, new, f"{self.model.cfg.name} prefill cache")
        for dst, src in zip(tree_leaves(cache), tree_leaves(new)):
            dst.copy_(src)
        markers.mark("prefill_end", self.device)
        return logits

    def _decode_body(self, token: torch.Tensor, pos: torch.Tensor,
                     cache: Tree) -> torch.Tensor:
        """``model.decode_step``, writing the static ``cache`` in place;
        returns the logits."""
        markers.mark("decode_begin", self.device)
        logits, _ = self.model.decode_step(self.params, token, pos, cache)
        markers.mark("decode_end", self.device)
        return logits

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture_prefill(self, batch, cache):
        graph = torch.cuda.CUDAGraph()
        with contracts.no_collection(), torch.cuda.graph(
                graph, pool=self._graph_pool()):
            logits = self._prefill_body(batch, cache)
        return graph, logits

    def _capture_decode(self, token, pos, cache):
        graph = torch.cuda.CUDAGraph()
        with contracts.no_collection(), torch.cuda.graph(
                graph, pool=self._graph_pool()):
            logits = self._decode_body(token, pos, cache)
        return graph, logits

    def _state(self, B: int) -> Dict[str, Tree]:
        """The static cache and position of batch size ``B``."""
        st = self._states.get(B)
        if st is None:
            st = self._states[B] = {
                "cache": self.model.init_cache(B, self.cache_len,
                                               self.device),
                "pos": torch.zeros((B,), dtype=torch.long,
                                   device=self.device),
            }
        return st

    def _setup(self, fn: Compiled, sig: Tuple, entry: Dict[str, Any],
               capture: Callable) -> None:
        """Register a signature set up by its first run; on the card,
        capture it."""
        if self.graphed:
            t0 = time.perf_counter()
            entry["graph"], entry["logits"] = capture()
            fn.capture_s.append(time.perf_counter() - t0)
        fn.entries[sig] = entry
        contracts.note_capture()

    def _replay(self, fn: Compiled, entry: Dict[str, Any]) -> torch.Tensor:
        entry["graph"].replay()
        fn.replays += 1
        return entry["logits"]

    def _prefill_call(self, fn: Compiled,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill ``batch`` into the static cache of its B and set the
        position after its prompts; returns the last position's logits."""
        tokens = batch["tokens"]
        st = self._state(tokens.shape[0])
        sig = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        entry = fn.entries.get(sig)
        if entry is None:
            inputs = {k: v.clone() for k, v in batch.items()}
            entry = {"inputs": inputs, "graph": None, "logits": None}
            logits = self._prefill_body(inputs, st["cache"], check=True)
            self._setup(fn, sig, entry,
                        lambda: self._capture_prefill(inputs, st["cache"]))
        else:
            for k, buf in entry["inputs"].items():
                buf.copy_(batch[k])
            if entry["graph"] is None:
                logits = self._prefill_body(entry["inputs"], st["cache"])
            else:
                logits = self._replay(fn, entry)
        # absolute position of the first generated token: after the image
        # tokens the prefill prepended and the padded prompt
        st["pos"].fill_(tokens.shape[1] + self.model.cfg.num_image_tokens)
        return logits

    def _decode_call(self, fn: Compiled, tok: torch.Tensor) -> torch.Tensor:
        """One step of every row from its sampled token ``tok`` (B[, K])
        over the static cache of its B; the position advances by one."""
        st = self._states[tok.shape[0]]
        sig = tuple(tok.shape)
        entry = fn.entries.get(sig)
        if entry is None:
            token = tok[:, None].clone()
            entry = {"token": token, "graph": None, "logits": None}
            logits = self._decode_body(token, st["pos"], st["cache"])
            self._setup(fn, sig, entry, lambda: self._capture_decode(
                token, st["pos"], st["cache"]))
        else:
            entry["token"].copy_(tok[:, None])
            if entry["graph"] is None:
                logits = self._decode_body(entry["token"], st["pos"],
                                           st["cache"])
            else:
                logits = self._replay(fn, entry)
        st["pos"].add_(1)
        return logits

    # ------------------------------------------------------------ a batch
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
        steps = max(r.max_new_tokens for r in reqs)
        temps = torch.tensor([r.temperature for r in reqs],
                             dtype=torch.float32, device=self.device)
        any_sampling = any(r.temperature > 0.0 for r in reqs)
        if self.cuda_graph:
            logits = self._prefill(batch)
            decode = self._decode
        else:
            markers.mark("prefill_begin", self.device)
            logits, cache = self.model.prefill(self.params, batch,
                                               self.cache_len)
            markers.mark("prefill_end", self.device)
            pos = torch.full((len(reqs),), Lmax + cfg.num_image_tokens,
                             dtype=torch.long, device=self.device)

            def decode(tok):
                nonlocal cache, pos
                markers.mark("decode_begin", self.device)
                logits, cache = self.model.decode_step(
                    self.params, tok[:, None], pos, cache)
                markers.mark("decode_end", self.device)
                pos = pos + 1
                return logits

        tok = self._sample(logits, temps, any_sampling)
        out = [tok]
        for _ in range(steps - 1):
            tok = self._sample(decode(tok), temps, any_sampling)
            out.append(tok)
        # one device read for the whole batch
        gen = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        return [gen[i, : r.max_new_tokens] for i, r in enumerate(reqs)]
