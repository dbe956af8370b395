"""Logical-axis partitioning rules (MaxText-style) -> partition specs.

The counterpart of the reference's ``repro.distributed.partitioning``, with
its rule table and its ``spec_for`` logic unchanged.  Every param or
activation dim carries a logical name; rules map names to mesh axes.
``spec_for`` walks a shape's logical axes in order, assigning mesh axes
when (a) the rule's axes exist in the mesh, (b) the dim is divisible by
their total size, and (c) no axis is used twice in one spec, so the same
rule table serves one-device runs and large meshes alike, degrading
gracefully (a dim that does not divide falls back to a shorter prefix of
its axes, or to replicated).

Parallelism profiles:
  pod   : pure data parallel
  data  : FSDP (embed-dim sharding of params/optimizer) + batch DP
  model : tensor parallel (heads / mlp / experts / vocab)

PyTorch has no mesh or sharding types of its own in one process, so this
module carries small ones:

- :class:`Mesh`: a numpy object array of ``torch.device`` with axis names,
  ``devices.shape`` as in JAX.  A device may repeat: a mesh of one card
  (or of ``cpu``) repeated is how 2 or 4 shards run on one device.
- :class:`P`: a partition spec that compares the way JAX's
  ``PartitionSpec`` does (a one-name tuple equals the bare name).
- :class:`NamedSharding`: a spec over a mesh that says which index range
  of each dim a mesh position holds.

``activation_sharding``/``constrain`` keep the reference's API.  A plain
tensor holds every element on one device, so ``constrain`` returns it
unchanged; a ``DTensor`` (the dry run's partitioned step, whose trees
``distribute`` places) is redistributed to the spec the logical axes name,
each move issued as the collective it is.  The reference's ``shard_map``
shim is not carried: the port's serving engine keeps each slot shard's
buffers resident on its own device instead (``serving.snn_engine``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Any

# logical dim name -> mesh axes (applied together, in order)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),  # FSDP shard of params + optimizer
    "vocab": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "inner": ("model",),
    "lru": ("model",),
    "lru_in": (),
    "state": ("model",),
    "q_rank": (),
    "kv_rank": (),
    "clip": (),
    "codebook": (),
    "groups": (),
    "layers": (),
    "seq": ("model",),  # decode-cache seq dim: context parallel over model
    "head_dim": (),
    "conv_w": (),
    # activation-only logical dims
    "act_seq": (),  # set to ("data",) for sequence-parallel profiles
    "embed_act": (),  # activation feature dim stays replicated
    "cap": (),  # MoE expert-capacity dim
    # streaming-SNN serving dims (serving/snn_engine device-resident state)
    "slot": ("pod", "data"),  # engine micro-batch slot axis (like batch)
    "ring_steps": (),  # per-slot event-ring time axis: stays with its slot
    "event_cap": (),  # packed per-step event-list capacity: replicated
}


# ----------------------------------------------------------------- types
class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` whose dims are ``axis_names``.  Devices may
    repeat."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                f"got {names}"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        out = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            out[idx] = torch.device(arr[idx])
        self.devices = out
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def _canon(part):
    """A spec entry in JAX's comparison form: a one-name tuple is the
    name."""
    if isinstance(part, tuple) and len(part) == 1:
        return part[0]
    return part


class P(tuple):
    """A partition spec: one entry per leading dim, each ``None``
    (replicated), a mesh axis name, or a tuple of them (applied together,
    major first).  Compares as JAX's ``PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return (tuple(_canon(p) for p in self)
                == tuple(_canon(p) for p in other))

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(tuple(_canon(p) for p in self))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` laid over ``mesh``: dim ``i`` of an array is split into
    equal blocks over the mesh axes of ``spec[i]`` (major first); mesh
    axes a spec does not name hold replicas."""

    mesh: Mesh
    spec: P

    def _axes(self, i: int) -> Tuple[str, ...]:
        part = self.spec[i] if i < len(self.spec) else None
        if part is None:
            return ()
        return tuple(part) if isinstance(part, tuple) else (part,)

    def shard_count(self, i: int) -> int:
        """How many blocks dim ``i`` is split into."""
        sizes = self.mesh.shape
        return int(np.prod([sizes[a] for a in self._axes(i)], dtype=np.int64))

    def indices(self, shape: Sequence[int],
                position: Sequence[int]) -> Tuple[slice, ...]:
        """The index range of each dim of a ``shape`` array that the mesh
        position ``position`` (one index per mesh axis) holds.  Raises
        ValueError when a sharded dim does not divide."""
        if len(position) != len(self.mesh.axis_names):
            raise ValueError(
                f"position {tuple(position)} does not address a mesh of "
                f"axes {self.mesh.axis_names}"
            )
        where = dict(zip(self.mesh.axis_names, position))
        sizes = self.mesh.shape
        out = []
        for i, dim in enumerate(shape):
            block = 0
            for a in self._axes(i):
                block = block * sizes[a] + int(where[a])
            n = self.shard_count(i)
            if dim % n:
                raise ValueError(
                    f"dim {i} of size {dim} does not divide over {n} shards "
                    f"of {self.spec}"
                )
            step = dim // n
            out.append(slice(block * step, (block + 1) * step))
        return tuple(out)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        """Every mesh position, in row-major order of the mesh axes."""
        return np.ndindex(self.mesh.devices.shape)

    def placements(self, ndim: int) -> list:
        """The DTensor placements of an ``ndim`` array, one per mesh axis:
        ``Shard(i)`` on each mesh axis that ``spec[i]`` names, ``Replicate()``
        elsewhere.  An axis of one position holds the whole dim either way
        and gets ``Replicate()``.  Blocks follow the mesh's axis order, so a
        spec that names axes against it holds blocks of the same sizes in
        another order."""
        from torch.distributed.tensor import Replicate, Shard

        sizes = self.mesh.shape
        out = [Replicate() for _ in self.mesh.axis_names]
        for i in range(ndim):
            for a in self._axes(i):
                if sizes[a] > 1:
                    out[self.mesh.axis_names.index(a)] = Shard(i)
        return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  A DTensor exists only once its module
    is loaded, so a plain run never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor split or partially summed over its
    device mesh.  A plain tensor is not, nor is a DTensor replicated on
    every device (a mesh of one position holds only those): its ops run
    as a plain tensor's would."""
    return is_dtensor(x) and not all(p.is_replicate()
                                      for p in x.placements)


def distribute(t: torch.Tensor, sharding: NamedSharding, device_mesh):
    """``t``'s shape laid out by ``sharding`` as a DTensor over
    ``device_mesh`` (a ``DeviceMesh`` with ``sharding.mesh``'s shape and
    axis names): the local shard is a new ``meta`` tensor of the block
    ``NamedSharding.indices`` gives mesh position 0, so nothing is
    allocated; ``t`` itself is not read."""
    from torch.distributed.tensor import DTensor

    block = sharding.indices(t.shape, (0,) * len(sharding.mesh.axis_names))
    local = torch.empty([s.stop - s.start for s in block], dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, device_mesh, sharding.placements(t.ndim),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


# ----------------------------------------------------------------- rules
@dataclasses.dataclass(frozen=True)
class PartitionRules:
    table: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )

    def override(self, **kw) -> "PartitionRules":
        t = dict(self.table)
        for k, v in kw.items():
            t[k] = tuple(v) if v else ()
        return PartitionRules(t)


def spec_for(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh: Mesh,
    rules: Optional[PartitionRules] = None,
) -> P:
    """Build a partition spec for one array."""
    rules = rules or PartitionRules()
    mesh_sizes = mesh.shape
    used = set()
    parts = []
    for dim, name in zip(shape, axes):
        assigned: Tuple[str, ...] = ()
        if name is not None:
            cand = tuple(
                ax
                for ax in rules.table.get(name, ())
                if ax in mesh_sizes and ax not in used
            )
            if cand:
                total = int(np.prod([mesh_sizes[ax] for ax in cand]))
                if dim % total == 0:
                    assigned = cand
                else:
                    # try progressively shorter prefixes (e.g. just "pod")
                    for k in range(len(cand) - 1, 0, -1):
                        total = int(np.prod([mesh_sizes[ax] for ax in cand[:k]]))
                        if dim % total == 0:
                            assigned = cand[:k]
                            break
        used.update(assigned)
        if len(assigned) == 0:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(assigned)
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


# ------------------------------------------------------------ tree walks
def _is_axes(t) -> bool:
    """A logical-axes leaf: a plain tuple of names (or None)."""
    return (type(t) is tuple
            and all(isinstance(x, (str, type(None))) for x in t))


def _map_axes(fn, shapes: Tree, axes: Tree) -> Tree:
    """Map ``fn(shape_leaf, axes_leaf)`` over a tree of logical axes and
    the matching tree of arrays (anything with ``.shape``)."""
    if _is_axes(axes):
        return fn(shapes, axes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, shapes[k], v) for k, v in axes.items()}
    if isinstance(axes, (list, tuple)):
        out = [_map_axes(fn, s, a) for s, a in zip(shapes, axes)]
        if hasattr(axes, "_fields"):
            return type(axes)(*out)
        return type(axes)(out)
    raise TypeError(f"not a logical-axes tree: {type(axes)}")


def _map_leaves(fn, tree: Tree, is_leaf) -> Tree:
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_leaves(fn, v, is_leaf) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree)


def tree_specs(
    shapes: Tree, axes: Tree, mesh: Mesh,
    rules: Optional[PartitionRules] = None,
) -> Tree:
    """Map spec_for over matching (shapes, logical-axes) trees."""
    return _map_axes(lambda s, a: spec_for(s.shape, a, mesh, rules),
                     shapes, axes)


def tree_shardings(shapes, axes, mesh, rules=None) -> Tree:
    specs = tree_specs(shapes, axes, mesh, rules)
    return _map_leaves(lambda sp: NamedSharding(mesh, sp), specs,
                       lambda t: isinstance(t, P))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def slot_axis(num_slots: int, mesh: Mesh,
              rules: Optional[PartitionRules] = None):
    """Mesh axes the serving engine's slot dimension shards over.

    Everything slot-indexed in the stream engine (neuron states, the
    per-slot event rings ((S, ring_steps, event_cap), via the
    ``slot``/``ring_steps``/``event_cap`` rules), scheduling metadata and
    the per-chunk stats) shards along this one axis.  Raises loudly when
    ``num_slots`` does not divide the mesh's slot axes: a silently
    replicated slot axis would run every slot on every device, which is
    exactly the misconfiguration sharded serving exists to avoid.
    """
    spec = spec_for((num_slots,), ("slot",), mesh, rules)
    if len(spec) == 0 or spec[0] is None:
        raise ValueError(
            f"num_slots={num_slots} is not shardable over mesh axes "
            f"{mesh.shape}; pick a slot count divisible by the mesh's batch "
            f"axes"
        )
    return spec[0]


# ------------------------------------------------- activation constraints
# The reference's model code calls ``constrain(x, logical_axes)`` at key
# activation points so that XLA's propagation keeps the intended layout
# inside an ``activation_sharding`` context.  The port's models call it at
# the same points: a plain tensor passes unchanged, a DTensor is
# redistributed.

_act_ctx = threading.local()


@contextmanager
def activation_sharding(mesh: Mesh, rules: Optional[PartitionRules] = None):
    prev = getattr(_act_ctx, "val", None)
    _act_ctx.val = (mesh, rules or PartitionRules())
    try:
        yield
    finally:
        _act_ctx.val = prev


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` laid out as its logical ``axes`` name under the
    ``activation_sharding`` context's mesh and rules when ``x`` is a
    DTensor (redistributed over its own device mesh); ``x`` itself when it
    is a plain tensor or outside a context."""
    ctx = getattr(_act_ctx, "val", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    sharding = NamedSharding(mesh, spec_for(x.shape, axes, mesh, rules))
    return x.redistribute(x.device_mesh, sharding.placements(x.ndim))


def unshard_batch_axes(tree: Tree) -> Tree:
    """``tree`` with each DTensor leaf gathered over the mesh axes of the
    ``batch`` rule (the FSDP split of params over ``data``, and ``pod``):
    what one block holds while it runs, as the reference's sharded params
    are gathered for their layer.  Its backward reduce-scatters the
    gradients back.  Plain leaves, or no ``activation_sharding`` context,
    pass unchanged."""
    ctx = getattr(_act_ctx, "val", None)
    if ctx is None:
        return tree
    mesh, rules = ctx
    dp = [mesh.axis_names.index(a) for a in rules.table.get("batch", ())
          if a in mesh.axis_names]

    def gather(x):
        if not is_sharded(x) or not any(x.placements[d].is_shard()
                                         for d in dp):
            return x
        from torch.distributed.tensor import Replicate

        pl = [Replicate() if d in dp else p for d, p in enumerate(x.placements)]
        return x.redistribute(x.device_mesh, pl)

    return _map_leaves(gather, tree, lambda t: isinstance(t, torch.Tensor))


def constrain_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s placements when both are DTensors (a gradient
    reduced into its parameter's layout, as the reference's sharded
    parameters pull their gradients); ``x`` itself otherwise."""
    if not (is_dtensor(x) and is_dtensor(like)):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x`` with dim ``dim`` split into ``sizes``.  A DTensor first
    gathers that dim over each mesh axis whose split its leading size
    does not divide (DTensor has no rule to unflatten it: 24 heads over 16
    devices); a plain tensor is reshaped as it is."""
    dim %= x.ndim
    if is_sharded(x):
        from torch.distributed.tensor import Replicate

        placements, split = list(x.placements), 1
        for d, pl in enumerate(placements):
            if pl.is_shard(dim):
                split *= x.device_mesh.size(d)
                if sizes[0] % split:
                    placements[d] = Replicate()
        if placements != list(x.placements):
            x = x.redistribute(x.device_mesh, placements)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def merge_dims(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x`` with dims ``start`` .. ``end`` (inclusive) flattened into one.
    A DTensor split along ``start`` keeps that split on the merged dim
    (each block is contiguous in it), done shard by shard: DTensor's own
    flatten marks such a split strided, and every later op over a strided
    split plans its redistributions by a search that grows with the
    mesh's rank.  A split of an inner dim is gathered first."""
    shape = (*x.shape[:start], math.prod(x.shape[start:end + 1]),
             *x.shape[end + 1:])
    if not is_sharded(x):
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cut = end - start
    placements = [Replicate() if p.is_shard() and start < p.dim <= end
                  else p for p in x.placements]
    if placements != list(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    local = x.to_local()
    local = local.reshape(*local.shape[:start], -1, *local.shape[end + 1:])
    merged = [Shard(p.dim - cut) if p.is_shard() and p.dim > end else p
              for p in placements]
    return DTensor.from_local(local, x.device_mesh, merged, run_check=False)


def pad(x: torch.Tensor, widths: Sequence[int], value: float = 0.0
        ) -> torch.Tensor:
    """``F.pad(x, widths, value=value)``; a DTensor is padded shard by
    shard, each padded dim first gathered whole, its other splits kept
    (DTensor's own pad rule is missing or wrong in some torch builds)."""
    if not is_dtensor(x):
        return torch.nn.functional.pad(x, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate

    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    placements = [Replicate() if p.is_shard() and p.dim in padded else p
                  for p in x.placements]
    if placements != list(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    local = torch.nn.functional.pad(x.to_local(), widths, value=value)
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False)


def block_start(x: torch.Tensor, axes: Sequence[Optional[str]],
                dim: int) -> int:
    """Where this device's block of dim ``dim`` starts when ``x`` (a
    DTensor) is laid out as its logical ``axes`` name under the
    ``activation_sharding`` context."""
    mesh, rules = _act_ctx.val
    sharding = NamedSharding(mesh, spec_for(x.shape, axes, mesh, rules))
    return sharding.indices(x.shape, x.device_mesh.get_coordinate())[dim].start


def project(x: torch.Tensor, w: torch.Tensor,
            axes: Sequence[Optional[str]]) -> torch.Tensor:
    """x's last dim contracted with w's first, w's other dims appended
    (``einsum("ble,ehd->blhd")``), as a matmul with w's other dims
    flattened; ``axes`` names the result's dims.  Over DTensors that
    result is laid out as ``constrain`` lays out ``axes`` (a split of the
    flattened dim's inner factors is dropped) before it unflattens: the
    unflatten fails whenever DTensor has sharded the flattened dim over
    more devices than its leading factor has rows (56 heads over 16).  A
    3-d w split along its last dim runs one product a row of its middle
    dim, as flattening it would gather w whole."""
    if is_dtensor(w) and w.ndim == 3 and any(pl.is_shard(2)
                                             for pl in w.placements):
        return torch.stack([x @ w[:, i] for i in range(w.shape[1])], -2)
    out = tuple(w.shape[1:])
    y = x @ w.reshape(w.shape[0], -1)
    ctx = getattr(_act_ctx, "val", None)
    if ctx is not None and is_dtensor(y):
        from torch.distributed.tensor import Replicate

        mesh, rules = ctx
        lead = y.ndim - 1
        full = (*y.shape[:-1], *out)
        placements = [
            Replicate() if pl.is_shard() and pl.dim > lead else pl
            for pl in NamedSharding(mesh, spec_for(full, axes, mesh, rules)
                                    ).placements(len(full))]
        y = y.redistribute(y.device_mesh, placements)
    return y.reshape(*y.shape[:-1], *out)


def local_leaves(tree: Tree) -> Tree:
    """``tree`` with each DTensor leaf replaced by its local shard (other
    leaves as they are): for work that runs on each device's block alone,
    such as an elementwise update of tensors laid out alike."""
    return _map_leaves(lambda x: x.to_local() if is_dtensor(x) else x, tree,
                       lambda t: isinstance(t, torch.Tensor))


def laid_out_like(make, like: torch.Tensor) -> torch.Tensor:
    """``make(like.shape)``, a plain tensor made for ``like`` (a fill or a
    draw); when ``like`` is a DTensor, ``make`` of its local shape as a
    DTensor of its placements instead, so what the step makes per element
    of ``like`` is sharded as ``like`` is and not replicated whole on
    every device (a partial sum's layout counts as replicated)."""
    if not is_sharded(like):
        return make(like.shape)
    from torch.distributed.tensor import DTensor, Replicate

    placements = [Replicate() if p.is_partial() else p
                  for p in like.placements]
    return DTensor.from_local(make(like.to_local().shape), like.device_mesh,
                              placements, run_check=False, shape=like.shape,
                              stride=like.stride())


def run_local(fn, args: Sequence[Any], axes: Sequence[Any],
              out_shape: Sequence[Any], out_axes: Sequence[Any],
              summed: Optional[Tuple[int, int]] = None):
    """``fn(*args)``, one device's share of it when an arg is a DTensor:
    each tensor arg is laid out as its logical ``axes`` name (a plain one
    counts as replicated; ``None`` leaves an arg as it is), ``fn`` runs on
    the local shards, and its result, of global shape ``out_shape``, is a
    DTensor laid out as ``out_axes`` (a ``fn`` that returns a tuple takes
    a shape and axes for each result).  ``summed`` = (arg, dim): ``fn``
    sums over that dim of that arg, so its result is a partial sum over
    the mesh axes that split the dim.  For a computation whose sharded
    dims are independent (attention over batch and heads), so each device
    computes its block alone: DTensor would otherwise plan its batched
    products over a flattened dim split two ways, a strategy search that
    grows with the mesh's rank.  Without a DTensor arg or an
    ``activation_sharding`` context, ``fn(*args)``."""
    ctx = getattr(_act_ctx, "val", None)
    dtensors = [a for a in args if is_dtensor(a)]
    if ctx is None or not dtensors:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, rules = ctx
    dm = dtensors[0].device_mesh
    arg_placements = [
        None if ax is None else NamedSharding(
            mesh, spec_for(a.shape, ax, mesh, rules)).placements(a.ndim)
        for a, ax in zip(args, axes)]
    # the mesh axes the work is split over: an arg whole on one of them
    # gets a partial sum of its gradient from each device
    split = {d for pl in arg_placements if pl is not None
             for d, p in enumerate(pl) if p.is_shard()}
    local = []
    for a, pl in zip(args, arg_placements):
        if pl is None:
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        grad_pl = [Partial() if p.is_replicate() and d in split else p
                   for d, p in enumerate(pl)]
        local.append(a.redistribute(dm, pl).to_local(
            grad_placements=grad_pl))
    out = fn(*local)

    def wrap(t, shape, axes):
        pl = NamedSharding(mesh, spec_for(shape, axes, mesh, rules)
                           ).placements(t.ndim)
        if summed is not None:
            pl = [Partial() if p.is_shard(summed[1]) else q for p, q in
                  zip(arg_placements[summed[0]], pl)]
        # the global shape and strides follow from the even split
        out = DTensor.from_local(t, dm, pl, run_check=False)
        assert out.shape == torch.Size(shape), (out.shape, shape)
        return out

    if isinstance(out, tuple):
        return tuple(wrap(*o) for o in zip(out, out_shape, out_axes))
    return wrap(out, out_shape, out_axes)


def local_rows(cache: torch.Tensor, bidx: torch.Tensor, slot: torch.Tensor,
               new: torch.Tensor):
    """The pieces of the row write ``cache[b, slot[b]] = new[b]`` that one
    device does on a DTensor ``cache`` (B, S, ...): its local shard, the
    local batch index (``bidx``, an arange, cut to the shard's rows), the
    slots (moved to the shard's rows when the cache's rows are split, a
    slot outside them moved to its end, where the write drops it), and
    ``new`` (B, 1, ...) laid out like the cache but whole along the
    rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    rows = [Replicate() if p == Shard(1) else p for p in cache.placements]
    batch = [p if p == Shard(0) else Replicate() for p in cache.placements]

    def local(x, placements):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, placements).to_local()

    part = cache.to_local()
    slot = local(slot, batch)
    if rows != list(cache.placements):
        n = part.shape[1]
        coord = mesh.get_coordinate()
        start = 0
        for d, p in enumerate(cache.placements):
            if p == Shard(1):
                start = start * mesh.size(d) + coord[d]
        start *= n
        slot = torch.where((slot >= start) & (slot < start + n),
                           slot - start, n)
    return part, bidx[:part.shape[0]], slot, local(new, rows)


# ----------------------------------------------------------- cache axes
_CACHE_LEAF_AXES: Dict[str, Tuple[str, ...]] = {
    "k": ("batch", "seq", "kv", "head_dim"),
    "v": ("batch", "seq", "kv", "head_dim"),
    "k_scale": ("batch", "seq", "kv"),
    "v_scale": ("batch", "seq", "kv"),
    "c_kv": ("batch", "seq", "kv_rank"),
    "k_rope": ("batch", "seq", "head_dim"),
    "state": ("batch", "heads", "head_dim", "state"),
    "conv_x": ("batch", "conv_w", "inner"),
    "conv_B": ("batch", "conv_w", "state"),
    "conv_C": ("batch", "conv_w", "state"),
    "h": ("batch", "lru"),
    "conv": ("batch", "conv_w", "lru"),
}


def cache_logical_axes(cache: Tree) -> Tree:
    """Logical axes for a decode-cache tree (the port's nested dicts of
    tensors, or of anything with ``.shape``), from each leaf's dict key.

    Stacked layer dims (from scan groups) are detected by ndim mismatch
    and get a leading 'layers' axis."""

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        base = _CACHE_LEAF_AXES[name]
        extra = len(node.shape) - len(base)
        return ("layers",) * extra + base

    return walk(cache, None)


# ----------------------------------------------------------- optimizer
def _structure(tree: Tree):
    """A comparable skeleton of a tree; specs and shardings are leaves."""
    if isinstance(tree, (P, NamedSharding)):
        return "*"
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(x) for x in tree))
    return "*"


def opt_state_specs(opt_state, param_specs, mesh) -> Tree:
    """Optimizer states shard like their params (``mu``/``nu`` mirror
    params); scalar counts are replicated.  ``opt_state`` is a NamedTuple
    (``AdamState``/``SGDState``) of counts and param-shaped trees."""
    rep = NamedSharding(mesh, P())

    def map_state(state):
        if isinstance(state, tuple) and hasattr(state, "_fields"):
            return type(state)(*[map_state(s) for s in state])
        # a tree shaped like params
        if _structure(state) == _structure(param_specs):
            return param_specs
        if hasattr(state, "ndim"):
            return rep
        return _map_leaves(lambda _: rep, state, lambda t: False)

    return map_state(opt_state)


def slot_shards(num_slots: int, mesh: Mesh,
                rules: Optional[PartitionRules] = None
                ) -> List[Tuple[int, int, torch.device]]:
    """The serving engine's slot shards over ``mesh``: ``(lo, hi, device)``
    for each block of consecutive slots, in slot order.  A block's device
    is the first device of the mesh positions that hold it: mesh axes
    outside the slot rule hold replicas, and each block is computed once.
    Raises ValueError (naming ``num_slots``) as :func:`slot_axis` does."""
    sharding = NamedSharding(mesh, P(slot_axis(num_slots, mesh, rules)))
    blocks: Dict[Tuple[int, int], torch.device] = {}
    for pos in sharding.positions():
        sl = sharding.indices((num_slots,), pos)[0]
        blocks.setdefault((sl.start, sl.stop), mesh.devices[pos])
    return [(lo, hi, dev) for (lo, hi), dev in sorted(blocks.items())]
