"""Unified Model API: init / loss / prefill / decode for every arch of the zoo.

Handles the modality frontends (stubs, as in the reference):
  - vlm   : precomputed CLIP patch embeddings (B, n_img, 1024) are projected
            by a linear map into d_model and prepended to the token
            embeddings; labels cover only the text positions.
  - audio : EnCodec token streams (B, L, K codebooks); embeddings are the
            sum over K codebook tables (MusicGen), logits are per-codebook.

Params are nested dicts of tensors in the reference's layout (groups
stacked over their repeat dimension) and every method is a function of
them.  ``Model.abstract()`` returns the params as ``meta`` tensors: shapes
and dtypes without allocation (``param_count`` of a 34B config);
``Model.logical_axes()`` the tree of the same structure naming each
leaf's dims for ``distributed.partitioning``, and ``abstract_cache`` the
decode cache on ``meta`` (the dry run, ``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.distributed.partitioning import (block_start, constrain,
                                                  is_sharded, project,
                                                  run_local,
                                                  unshard_batch_axes)
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.serving.snn_engine import resolve_device
from repro_torch.tree import tree_flatten_with_names, tree_leaves, tree_map

Tree = Any

CLIP_EMBED_DIM = 1024  # frozen CLIP-L/14 output width (stub frontend)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _round(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the reference's scalars are arrays
    of the compute dtype.  Kept a Python number, so no copy reaches the
    card."""
    return float(torch.tensor(value, dtype=dtype))


def _sinusoidal_pe(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(B, L) -> (B, L, d_model) classic transformer PE (musicgen)."""
    half = d_model // 2
    log_base = _round(math.log(10000.0), torch.float32)
    freq = torch.exp(
        -log_base * torch.arange(half, dtype=torch.float32,
                                 device=positions.device) / half
    )
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Tree:
    """The reference's params tree (nested dicts of numpy arrays, groups
    stacked over layers) as the port's, on ``device`` (None: the card).

    Each leaf keeps its dtype, so the int16 and int8 codes of ``*_int``
    storage are carried exactly.  The tree must be the one ``cfg``'s
    model has: same keys and shapes.
    """
    dev = resolve_device(device)
    want = Model(cfg).abstract()
    got = tree_map(lambda a: torch.as_tensor(np.array(a)).to(dev), tree)
    names, leaves = tree_flatten_with_names(got)
    want_names, want_leaves = tree_flatten_with_names(want)
    if names != want_names:
        raise ValueError(f"params tree differs from {cfg.name}'s: "
                         f"{sorted(set(names) ^ set(want_names))}")
    for n, a, w in zip(names, leaves, want_leaves):
        if a.shape != w.shape or a.dtype != w.dtype:
            raise ValueError(f"{n}: {tuple(a.shape)} {a.dtype}, want "
                             f"{tuple(w.shape)} {w.dtype}")
    return got


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; over DTensors each device looks up the rows its
    block of the table holds (zeros for the others; a split vocab makes
    the result a partial sum over that split).  DTensor's own indexing
    rules fail here in some torch builds."""
    if not (is_sharded(table) or is_sharded(tokens)):
        return table[tokens]
    axes = ("vocab", None)
    start = block_start(table, axes, 0)

    def rows(t, ids):
        ids = ids - start
        hit = (ids >= 0) & (ids < t.shape[0])
        got = F.embedding(torch.clamp(ids, 0, t.shape[0] - 1), t)
        return got * hit[..., None].to(t.dtype)

    batch = ("batch",) + (None,) * (tokens.ndim - 1)
    return run_local(rows, (table, tokens), (axes, batch),
                     (*tokens.shape, table.shape[1]), batch + (None,),
                     summed=(0, 0))


def _target_logp(logp: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``logp`` at each target along its last dim: a gather.  Over a
    DTensor the same values come from a mask over the vocab, whose
    backward keeps ``logp``'s sharding (a gather's backward scatters into
    zeros of the global shape, which DTensor replicates on every
    device)."""
    if is_sharded(logp):
        vocab = torch.arange(logp.shape[-1], device=tgt.device)
        return torch.sum(torch.where(vocab == tgt[..., None], logp, 0.0), -1)
    return torch.gather(logp, -1, tgt[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    #: where ``init`` draws the params when it is not told (None: the card)
    device: Any = None

    # ------------------------------------------------------------ init
    def init(self, seed: int = 0, device=None) -> Tree:
        """Random params drawn on ``device`` (None: the model's) from the
        port's own generator, in the reference's layout, distributions
        and scales; a full-width model never passes through host memory."""
        dev = resolve_device(self.device if device is None else device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return self._build(Init(gen, dev, _dtype(self.cfg.param_dtype)))

    def abstract(self) -> Tree:
        """The params as ``meta`` tensors: shapes and dtypes, no storage."""
        return self._build(Init(None, torch.device("meta"),
                                _dtype(self.cfg.param_dtype)))

    def logical_axes(self) -> Tree:
        """The params' logical axes: a tree of ``abstract()``'s structure
        whose leaves name each dim (``("layers", "embed", "mlp")``), the
        reference's ``Model.abstract()[1]``.  Integer storage
        (``q115_int``, ``q1_7_int``) keeps the float leaves' axes."""
        return self._build(Init.logical_axes())

    def _build(self, init: Init) -> Tree:
        cfg = self.cfg
        Vp = cfg.padded_vocab
        p = {}
        if cfg.num_codebooks:
            p["embed"] = {"table": init.normal(
                (cfg.num_codebooks, Vp, cfg.d_model), 0.02,
                axes=("codebook", "vocab", "embed"))}
        else:
            p["embed"] = layers.embedding_init(init, Vp, cfg.d_model)
        if cfg.num_image_tokens:
            p["img_proj"] = layers.dense_init(
                init, (CLIP_EMBED_DIM, cfg.d_model), ("clip", "embed"))
        for gname, pattern, repeats in transformer.layer_plan(cfg):
            p[gname] = transformer.group_init(init, cfg, pattern, repeats)
        p["final_norm"] = layers.norm_init(init, cfg.d_model, cfg.norm_kind)
        if not cfg.tie_embeddings:
            if cfg.num_codebooks:
                p["lm_head"] = layers.dense_init(
                    init, (cfg.d_model, cfg.num_codebooks, Vp),
                    ("embed", "codebook", "vocab"))
            else:
                p["lm_head"] = layers.dense_init(init, (cfg.d_model, Vp),
                                                 ("embed", "vocab"))
        if cfg.quant in ("q115_int", "q1_7_int") and not init.names:
            p = self._quantize_storage(p)
        return p

    # ------------------------------------------------------------ embed
    def _embed_tokens(self, p, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = _dtype(cfg.dtype)
        tokens = tokens.long()
        if cfg.num_codebooks:
            # tokens (B, L, K) -> sum of per-codebook embeddings
            table = unshard_batch_axes(p["embed"]["table"])
            x = torch.zeros((*tokens.shape[:2], cfg.d_model), dtype=cdt,
                            device=table.device)
            for k in range(cfg.num_codebooks):
                x = x + _lookup(table[k], tokens[..., k]).to(cdt)
        else:
            x = _lookup(unshard_batch_axes(p["embed"]["table"]),
                        tokens).to(cdt)
        if cfg.emb_scale is not None:
            x = x * _round(cfg.emb_scale, cdt)
        return x

    def _inputs(self, p, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token (+ frontend) embeddings -> (B, L_total, E)."""
        x = self._embed_tokens(p, batch["tokens"])
        if self.cfg.num_image_tokens:
            img = (batch["img_embeds"].to(x.dtype)
                   @ unshard_batch_axes(p["img_proj"]).to(x.dtype))
            x = torch.cat([img, x], dim=1)
        return x

    # ------------------------------------------------------------ body
    def _quantize_storage(self, p):
        """True-int storage (serving mode): matmul weights (ndim>=2) are
        kept as Q-format integer codes; norms/biases stay float.  The rule
        reads the stored (layer-stacked) shapes, as the reference's does."""
        fmt = quant.Q1_15 if self.cfg.quant == "q115_int" else quant.Q1_7

        def leaf(x):
            if x.ndim >= 2 and x.is_floating_point():
                return quant.quantize(x, fmt)
            return x

        return tree_map(leaf, p)

    def _maybe_quant(self, p):
        cfg = self.cfg
        if cfg.quant == "q115":
            return quant.quant_params(p, quant.Q1_15)
        if cfg.quant == "q1_7":
            return quant.quant_params(p, quant.Q1_7)
        if cfg.quant in ("q115_int", "q1_7_int"):
            # dequantize only the top-level (non-group) params here; the
            # layer-stacked groups are dequantized per layer in the block
            # functions (transformer.dequant_block_params)
            group_names = {g for g, _, _ in transformer.layer_plan(cfg)}
            return {
                k: (v if k in group_names
                    else transformer.dequant_block_params(v))
                for k, v in p.items()
            }
        return p

    def _add_pe(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        if self.cfg.pos_kind == "sinusoidal":
            x = x + _sinusoidal_pe(positions, self.cfg.d_model).to(x.dtype)
        return x

    def backbone(self, p, x: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self._add_pe(x, positions)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for gname, pattern, _ in transformer.layer_plan(cfg):
            x, aux = transformer.group_forward(p[gname], x, positions, cfg,
                                               pattern)
            aux_total = aux_total + aux
        x = layers.apply_norm(unshard_batch_axes(p["final_norm"]), x,
                              cfg.norm_kind, cfg.norm_eps)
        return x, aux_total

    def _head(self, p, h: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocab; padded entries masked to -1e30."""
        cfg = self.cfg
        if cfg.num_codebooks:
            w = (p["embed"]["table"].permute(2, 0, 1) if cfg.tie_embeddings
                 else p["lm_head"])  # (E, K, Vp)
            logits = project(h, unshard_batch_axes(w).to(h.dtype),
                             ("batch", "act_seq", "codebook", "vocab"))
            if cfg.logit_softcap is not None:
                logits = cfg.logit_softcap * torch.tanh(
                    logits.float() / cfg.logit_softcap)
        else:
            w = p["embed"]["table"].T if cfg.tie_embeddings else p["lm_head"]
            logits = layers.unembed(unshard_batch_axes(w), h,
                                    cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            valid = torch.arange(cfg.padded_vocab,
                                 device=logits.device) < cfg.vocab_size
            logits = torch.where(valid, logits, _round(-1e30, logits.dtype))
        return logits

    def _forward(self, p, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits at every text position in the compute dtype, the summed
        MoE aux loss): ``backbone`` then ``_head``."""
        p = self._maybe_quant(p)
        x = self._inputs(p, batch)
        B, L = x.shape[0], x.shape[1]
        positions = torch.arange(L, device=x.device).expand(B, L)
        h, aux = self.backbone(p, x, positions)
        if self.cfg.num_image_tokens:  # only text positions produce logits
            h = h[:, self.cfg.num_image_tokens:]
        return self._head(p, h), aux

    def forward_logits(self, p, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Teacher-forced logits at every text position (``backbone`` then
        ``_head``), in the compute dtype."""
        return self._forward(p, batch)[0]

    # ------------------------------------------------------------ train
    def loss(self, p, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B, L[, K]) integer, targets the same shape (-1 =
        masked), img_embeds for the vlm.  Cross-entropy over the padded
        vocab in float32 plus the MoE aux term; reads the host nowhere.
        Metrics are 0-dim tensors on the device, detached."""
        logits, aux = self._forward(p, batch)
        cb = ("codebook",) if self.cfg.num_codebooks else ()
        logits = constrain(logits.float(),
                           ("batch", "act_seq") + cb + ("vocab",))
        targets = batch["targets"]
        mask = (targets >= 0).float()
        logp = torch.log_softmax(logits, dim=-1)
        tgt = torch.clamp(targets, min=0).long()
        nll = -_target_logp(logp, tgt)
        tokens = torch.sum(mask)
        ce = torch.sum(nll * mask) / torch.clamp(tokens, min=1.0)
        loss = ce + 0.01 * aux / max(self.cfg.num_layers, 1)
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "moe_aux": aux.detach(), "tokens": tokens}
        return loss, metrics

    # ---------------------------------------------------------- serving
    def prefill(self, p, batch: Dict[str, torch.Tensor],
                cache_len: int) -> Tuple[torch.Tensor, Tree]:
        """Run the prompt; returns (last-position logits (B, ...) float32,
        cache)."""
        cfg = self.cfg
        p = self._maybe_quant(p)
        x = self._inputs(p, batch)
        B, L = x.shape[0], x.shape[1]
        positions = torch.arange(L, device=x.device).expand(B, L)
        x = self._add_pe(x, positions)
        cache = {}
        for gname, pattern, _ in transformer.layer_plan(cfg):
            x, cache[gname] = transformer.group_prefill(
                p[gname], x, positions, cfg, pattern, cache_len
            )
        x = layers.apply_norm(unshard_batch_axes(p["final_norm"]), x,
                              cfg.norm_kind, cfg.norm_eps)
        logits = self._head(p, x[:, -1:])[:, 0]
        return logits.float(), cache

    def decode_step(self, p, token: torch.Tensor, pos: torch.Tensor,
                    cache: Tree) -> Tuple[torch.Tensor, Tree]:
        """token: (B, 1[,K]); pos: (B,) absolute position of token.

        Writes the step into ``cache`` in place and returns it with the
        float32 logits."""
        cfg = self.cfg
        p = self._maybe_quant(p)
        x = self._embed_tokens(p, token)
        x = self._add_pe(x, pos[:, None])
        for gname, pattern, _ in transformer.layer_plan(cfg):
            x, _ = transformer.group_decode(p[gname], x, pos, cache[gname],
                                            cfg, pattern)
        x = layers.apply_norm(unshard_batch_axes(p["final_norm"]), x,
                              cfg.norm_kind, cfg.norm_eps)
        logits = self._head(p, x)[:, 0]
        return logits.float(), cache

    def init_cache(self, batch: int, cache_len: int, device=None) -> Tree:
        cfg = self.cfg
        dev = resolve_device(self.device if device is None else device)
        return {
            gname: transformer.group_cache_init(
                cfg, pattern, repeats, batch, cache_len, _dtype(cfg.dtype), dev)
            for gname, pattern, repeats in transformer.layer_plan(cfg)
        }

    def abstract_cache(self, batch: int, cache_len: int) -> Tree:
        """The decode cache as ``meta`` tensors: ``init_cache``'s shapes
        and dtypes, no storage."""
        return self.init_cache(batch, cache_len, device="meta")

    def param_count(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.abstract()))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.num_experts:
            return total
        names, leaves = tree_flatten_with_names(self.abstract())
        expert_leaves = sum(
            t.numel() for n, t in zip(names, leaves)
            if "ffn" in n.split("/")
            and n.split("/")[-1] in ("w_gate", "w_up", "w_down")
        )
        inactive = expert_leaves * (
            1 - cfg.num_experts_per_tok / cfg.num_experts
        )
        return int(total - inactive)

