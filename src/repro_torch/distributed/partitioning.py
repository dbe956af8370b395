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

``activation_sharding``/``constrain`` keep the reference's API: one process
places no activation, so ``constrain`` returns its input under any mesh.
The reference's ``shard_map`` shim is not carried: the port's serving
engine keeps each slot shard's buffers resident on its own device instead
(``serving.snn_engine``).
"""

from __future__ import annotations

import dataclasses
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
# inside an ``activation_sharding`` context.  One PyTorch process places
# no activation: ``constrain`` is the identity under any mesh, and the
# port's models make no such calls.

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
    """``x`` itself, in and outside an ``activation_sharding`` context."""
    return x


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
