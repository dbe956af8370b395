"""Dry run: plan every (arch x shape x mesh) cell of the LM zoo, and the
paper's SNN at scale, with every tensor on ``meta``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # 40 cells x 2 meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch collision-snn
  ... --variant q115            # quantized variant (q115_int, q1_7_int, kvq, combo:a+b)
  ... --override heads=         # partitioning-rule override (empty: replicate)
  ... --mesh-shape 32,8 --mesh-axes data,model   # a remapped mesh

The planner needs no card and allocates no storage: params, optimizer
state, inputs, caches and every intermediate live on ``meta``, which
carries shapes and dtypes only, so a 34B model's step at 256 x 4096
tokens is planned on any host.  PyTorch has no compiler that partitions
and costs a step, so a cell runs the step itself on ``meta``, op by op:

- train   : ``train.loop.make_step_parts``' device part with
            ``chain_clip(adam(5e-4), 1.0)``, writing the new state into
            the state's own buffers;
- prefill : ``Model.prefill`` of the prompt, which returns the cache;
- decode  : ``Model.decode_step`` over ``Model.abstract_cache``.

The step runs partitioned, the counterpart of the reference's
``jax.jit(step, in_shardings=..., out_shardings=...).lower().compile()``:
inside ``plan_group``, a ``fake`` process group of the mesh's size (this
process its rank 0) under a ``DeviceMesh`` of the mesh's shape and axis
names, params, optimizer state, inputs and cache are ``DTensor`` s placed
by their ``NamedSharding`` (``partitioning.distribute``), and the step
runs over them under ``implicit_replication`` (a plain tensor the model
makes counts as replicated, as GSPMD treats a constant).  DTensor
propagates each op's sharding and issues the redistributions it needs as
``_c10d_functional`` collectives on the local shards, which the counting
modes see one by one; an op with no sharding rule makes the cell an
error, never an unsharded count.

Each cell writes ``<outdir>/<arch>__<shape>__<mesh>[__<tag>].json``
(existing files are kept unless ``--force``).  Every number in it says
how it was obtained (``how``):

- ``exact``: per-device resident bytes of params, optimizer state,
  inputs and cache, from ``partitioning.tree_shardings`` over the params'
  logical axes and ``NamedSharding.indices``;
- ``counted_partitioned``: what rank 0 did when the partitioned step ran
  on ``meta``: its flops (``torch.utils.flop_counter``'s formulas on the
  local shards), its bytes (each dispatched local op's input and output
  bytes: unfused op traffic, not HBM traffic after fusion), its peak of
  live local storages (``LiveBytes``) and its collectives (kind, result
  bytes, group), priced by ``ring_traffic``;
- ``counted`` / ``even_split`` (``partitioned=False`` only): the step run
  unsharded, at the global batch for flops and bytes split evenly over
  the devices, at the per-device batch for the peak.

The roofline uses the NVIDIA H100 SXM5's spec-sheet constants, NVLink 4
for every mesh axis; its three terms are compute, memory and collective.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import sys
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.distributed import partitioning
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adam, chain_clip
from repro_torch.optim.adam import update_into
from repro_torch.train.loop import TrainState, make_step_parts
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any

# ----------------------------------------------------------- constants
# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, NVIDIA's spec sheet
PEAK_FLOPS = 989e12  # dense bfloat16 FLOP/s (tensor cores, no sparsity)
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s a direction: NVLink 4, 900 GB/s bidirectional
CONSTANTS = ("NVIDIA H100 80GB HBM3 (SXM5), 700 W, spec sheet: 989 TFLOP/s "
             "dense bfloat16, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s "
             "bidirectional (450 GB/s a direction)")
LINK_NOTE = ("every mesh axis is priced at NVLink 4's 450 GB/s a direction; "
             "axes that span nodes (InfiniBand) are not modelled")
NO_COLLECTIVES = ("not planned: the step ran unsharded (partitioned=False), "
                  "so it issued no collective")
NOT_MODELLED = ("the step runs at the per-device batch with params, gradients "
                "and optimizer temporaries unsharded; tensor-parallel and FSDP "
                "splits of its transients are not modelled")
BYTES_NOTE = ("unfused op traffic: each dispatched op's input and output "
              "bytes (views move none)")

# the collectives a partitioned step issues, by the reference's HLO names
COLLECTIVE_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
# ops of those namespaces that move nothing between devices
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def ring_traffic(kind: str, result_bytes: float, group: int) -> float:
    """Bytes one device moves over its links for a collective of ``kind``
    with ``result_bytes`` of result over a group of ``group`` devices,
    under the ring algorithms of the reference's ``parse_collectives``:
    all-gather b(g-1)/g, reduce-scatter b(g-1) (about its input), all-reduce
    2b(g-1)/g (reduce-scatter then all-gather), all-to-all b(g-1)/g,
    collective-permute b; a group of one moves nothing but a permute."""
    if group <= 1:
        return float(result_bytes) if kind == "collective-permute" else 0.0
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (group - 1) / group
    if kind == "reduce-scatter":
        return float(result_bytes * (group - 1))
    if kind == "all-reduce":
        return 2.0 * result_bytes * (group - 1) / group
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"no traffic model for collective {kind!r}")


def collectives_record(issued: List[Tuple[str, int, int, str]]
                       ) -> Dict[str, Any]:
    """Per-kind ``count``, ``result_bytes`` and ``traffic_bytes`` (and the
    total) of ``issued`` (kind, result bytes, group size, mesh axis), as
    the reference's ``parse_collectives`` aggregates them, with the same
    split by mesh axis under ``by_axis``."""
    ops: Dict[str, Dict[str, float]] = {}
    by_axis: Dict[str, Dict[str, Dict[str, float]]] = {}
    total = 0.0
    for kind, size, group, axis in issued:
        traffic = ring_traffic(kind, size, group)
        for rec in (ops.setdefault(kind, {}),
                    by_axis.setdefault(axis, {}).setdefault(kind, {})):
            rec["count"] = rec.get("count", 0) + 1
            rec["result_bytes"] = rec.get("result_bytes", 0.0) + size
            rec["traffic_bytes"] = rec.get("traffic_bytes", 0.0) + traffic
        total += traffic
    return {"ops": ops, "traffic_bytes": total, "by_axis": by_axis}


# ------------------------------------------------------------ counting
def _is_dtensor_op(types) -> bool:
    """Whether a dispatched op's tensor types include a ``DTensor``: a
    counting mode then returns NotImplemented, so DTensor's own dispatch
    runs it and the local ops it issues come back through the modes."""
    return any(t.__name__ == "DTensor" for t in types)


def _in_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is active: DTensor's sharding
    propagation runs each new op once on fake global-shape tensors to read
    its output's metadata; that run is not the step's and counts for
    nothing."""
    return any(type(m).__name__ == "FakeTensorMode"
               for m in _get_current_dispatch_mode_stack())


def _local(t: torch.Tensor) -> torch.Tensor:
    """The tensor a device holds: a DTensor's local shard, else ``t``."""
    return getattr(t, "_local_tensor", t)


class LiveBytes(TorchDispatchMode):
    """Counts what the ops dispatched under it do: ``ops``, ``traffic``
    (each op's input and output bytes; a view, which writes nothing new
    and mutates nothing, moves none), and the live storages' bytes:
    ``start`` (the ``resident`` tensors'), ``peak`` and ``cur``.

    A storage is live from the op that first returns it until its last
    reference goes, however it is held (a tensor, a view, autograd's
    saved tensors): each is tracked by a weak reference to the storage
    itself, which cannot be reused while the reference is held.  Dead
    storages are swept only when the count could pass the peak, so
    ``peak`` is exact and ``cur`` may hold storages that have died since
    (``sweep()`` makes it exact).

    Over DTensors it counts one device: each DTensor's local shard, the
    local ops DTensor's dispatch issues, and in ``collectives`` each
    collective among them as (kind, result bytes, group size, mesh axis),
    the group named through ``group_axes`` ({group name: (axis, size)})."""

    def __init__(self, resident=(), group_axes=None):
        super().__init__()
        self._live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.cur = 0
        self.ops = 0
        self.traffic = 0
        self.collectives: List[Tuple[str, int, int, str]] = []
        self._groups = group_axes or {}
        for t in resident:
            self._add(t)
        self.start = self.peak = self.cur

    def _add(self, t: torch.Tensor) -> bool:
        st = _local(t).untyped_storage()
        key = st._cdata
        old = self._live.get(key)
        if old is not None:
            if not old[0].expired():
                return False
            self.cur -= old[1]
        n = st.nbytes()
        self._live[key] = (StorageWeakRef(st), n)
        self.cur += n
        return True

    def sweep(self) -> int:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.cur -= self._live.pop(k)[1]
        return self.cur

    def _collective(self, func, args, kwargs, outs) -> None:
        name = func._schema.name.replace("::", ".")
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            if func._overloadpacket.__name__ in _NOT_COLLECTIVES:
                return
            raise NotImplementedError(
                f"the plan has no traffic model for collective {name}")
        bound = dict(zip((a.name for a in func._schema.arguments), args))
        bound.update(kwargs)
        group = bound["group_name"]
        group = group if isinstance(group, str) else group.group_name
        if group not in self._groups:
            raise NotImplementedError(
                f"{name} over group {group!r}, which is no axis of the mesh")
        axis, size = self._groups[group]
        self.collectives.append(
            (kind, sum(t.numel() * t.element_size() for t in outs), size, axis))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        if _in_fake_mode():
            return func(*args, **(kwargs or {}))
        ins = [t for t in _pytree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops += 1
        if func.namespace in ("_c10d_functional", "_dtensor"):
            if func._overloadpacket.__name__ == "_wrap_tensor_autograd":
                # on a device the wrapper holds its input's buffer; on
                # meta it is a new storage, which takes that buffer's
                # bytes over and moves none
                old = self._live.pop(args[0].untyped_storage()._cdata, None)
                if old is not None:
                    self.cur -= old[1]
                self._add(out)
                return out
            self._collective(func, args, kwargs or {}, outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        if func._schema.is_mutable or any(
                t.untyped_storage()._cdata not in seen for t in outs):
            self.traffic += sum(t.numel() * t.element_size()
                                for t in ins + outs)
        grew = False
        for t in outs:
            grew |= self._add(t)
        if grew and self.cur > self.peak:
            self.peak = max(self.peak, self.sweep())
        return out


class Flops(TorchDispatchMode):
    """``torch.utils.flop_counter.FlopCounterMode``'s count (its formulas,
    its decomposition of ops it has none for) of the ops that run on one
    device: DTensor ops go on to DTensor's dispatch, whose local ops come
    back here, and the sharding propagation's fake runs count nothing."""

    _SKIP = {torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default,
             torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default, torch.ops.prim.layout.default}

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._SKIP or _is_dtensor_op(types):
            return NotImplemented
        if _in_fake_mode():
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.total += flop_registry[packet](*args, **kwargs, out_val=out)
        return out


def count_step(fn: Callable[[], Any], resident: Tree,
               group_axes=None) -> Dict[str, Any]:
    """Run ``fn`` (a step on ``meta``) under ``Flops`` and ``LiveBytes``;
    ``resident``: the tensors live before it (its state and inputs).
    ``end_bytes`` holds the step's outputs.  Over DTensors every count is
    one device's, and ``collectives`` lists what it issued."""
    with Flops() as fc, LiveBytes(tree_leaves(resident), group_axes) as lb:
        out = fn()
        end = lb.sweep()
    del out
    return {"flops": float(fc.total), "bytes": float(lb.traffic),
            "ops": lb.ops, "start_bytes": lb.start, "peak_bytes": lb.peak,
            "end_bytes": end, "collectives": lb.collectives}


def per_device_bytes(tree: Tree, shardings: Tree) -> int:
    """Bytes of ``tree``'s leaves that one device holds under
    ``shardings`` (a tree of ``NamedSharding`` of the same structure):
    the block ``NamedSharding.indices`` gives mesh position 0.  Sharded
    dims divide evenly (``indices`` raises otherwise), so every position
    holds a block of the same size."""
    total = 0
    for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        block = sh.indices(t.shape, (0,) * len(sh.mesh.axis_names))
        total += math.prod(s.stop - s.start for s in block) * t.element_size()
    return total


def batch_shards(batch: int, mesh, rules) -> int:
    """How many blocks the ``batch`` logical axis splits ``batch`` into."""
    spec = partitioning.spec_for((batch,), ("batch",), mesh, rules)
    return partitioning.NamedSharding(mesh, spec).shard_count(0)


# ----------------------------------------------------------- cell build
def model_flops(cfg, shape: Union[str, shp.ShapeSpec]) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (fwd-only)."""
    sp = shp.spec(shape)
    n_active = Model(cfg).active_param_count()
    if sp.kind == "train":
        return 6.0 * n_active * sp.global_batch * sp.seq_len
    if sp.kind == "prefill":
        return 2.0 * n_active * sp.global_batch * sp.seq_len
    return 2.0 * n_active * sp.global_batch  # one token per sequence


def build_step(cfg, shape: Union[str, shp.ShapeSpec], accum_steps: int = 1,
               layout: Optional["Layout"] = None):
    """The cell's step over ``meta`` trees at ``shape``'s batch (the
    counterpart of the reference's ``build_lowered``).  Returns ``(kind,
    fn, trees)``: ``fn()`` runs the step once; ``trees`` holds its
    ``params`` and ``inputs``, ``opt_state`` (train) and the ``cache``
    (decode: the step's input, written in place; prefill: the shape of
    the cache the step returns).  ``layout``: the trees placed as DTensors
    (``Layout.place``) and a prefill's returned cache put in the cache's
    placements (``Layout.reshard``), as the reference's ``in_shardings``
    and ``out_shardings`` do; a prefill's ``cache`` tree is then left
    out."""
    sp = shp.spec(shape)
    model = Model(cfg)
    abstract = model.abstract()
    kind, inputs, _ = shp.batch_specs(cfg, sp)
    place = layout.place if layout is not None else (lambda _, t: t)
    trees = {"params": place("params", abstract),
             "inputs": place("inputs", inputs)}
    params, inputs = trees["params"], trees["inputs"]
    if kind == "train":
        opt = chain_clip(adam(5e-4), 1.0)
        trees["opt_state"] = opt_state = place("opt_state",
                                               opt.init(abstract))
        _, device = make_step_parts(model, opt, accum_steps=accum_steps)
        state = TrainState(params, opt_state, 0)

        def fn():
            return device(state, inputs, (params, opt_state))

        return kind, fn, trees

    if kind == "prefill":
        if layout is None:
            trees["cache"] = model.abstract_cache(sp.global_batch, sp.seq_len)

        def fn():
            with torch.no_grad():
                logits, cache = model.prefill(params, inputs, sp.seq_len)
                if layout is not None:
                    cache = layout.reshard("cache", cache)
                return logits, cache
        return kind, fn, trees

    trees["cache"] = cache = place(
        "cache", model.abstract_cache(sp.global_batch, sp.seq_len))

    def fn():
        with torch.no_grad():
            return model.decode_step(params, inputs["token"], inputs["pos"],
                                     cache)
    return kind, fn, trees


def tree_shardings_of(cfg, trees: Dict[str, Tree], in_axes: Tree, mesh,
                      rules):
    """``NamedSharding`` trees of ``build_step``'s trees: params by
    ``Model.logical_axes``, optimizer state like its params, inputs by
    ``in_axes``, the cache by ``cache_logical_axes``."""
    out = {"params": partitioning.tree_shardings(
        trees["params"], Model(cfg).logical_axes(), mesh, rules)}
    out["inputs"] = partitioning.tree_shardings(trees["inputs"], in_axes,
                                                mesh, rules)
    if "opt_state" in trees:
        out["opt_state"] = partitioning.opt_state_specs(
            trees["opt_state"], out["params"], mesh)
    if "cache" in trees:
        out["cache"] = partitioning.tree_shardings(
            trees["cache"], partitioning.cache_logical_axes(trees["cache"]),
            mesh, rules)
    return out


class Layout:
    """Where each tree of a cell lives on a ``DeviceMesh``: ``shardings``
    ({tree name: tree of ``NamedSharding``}) over ``device_mesh``."""

    def __init__(self, device_mesh, shardings: Dict[str, Tree]):
        self.device_mesh = device_mesh
        self.shardings = shardings

    def place(self, name: str, tree: Tree) -> Tree:
        """``tree``'s leaves as DTensors of their shardings, nothing
        allocated."""
        return tree_unflatten(tree, [
            partitioning.distribute(t, sh, self.device_mesh)
            for t, sh in zip(tree_leaves(tree),
                             tree_leaves(self.shardings[name]))])

    def reshard(self, name: str, tree: Tree) -> Tree:
        """``tree``'s DTensor leaves redistributed to their shardings."""
        return tree_unflatten(tree, [
            t.redistribute(self.device_mesh, sh.placements(t.ndim))
            for t, sh in zip(tree_leaves(tree),
                             tree_leaves(self.shardings[name]))])


def _torch_attr(module: str, name: str):
    """``module.name`` of this torch, or a RuntimeError that names it."""
    try:
        return getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError) as e:
        raise RuntimeError(f"the partitioned plan needs {module}.{name}, "
                           f"which this torch lacks: {e}") from e


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's resharding from dim ``gather_dim`` to ``shard_dim`` over
    one mesh axis as the all-to-all a card's mesh issues."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextmanager
def plan_group(mesh):
    """A ``fake`` process group of ``mesh.size`` ranks, this process rank 0,
    and a ``DeviceMesh`` of ``mesh``'s shape and axis names over it (device
    type ``cpu`` on any host: tensors stay on ``meta``, nothing is
    allocated and no collective runs; the fake backend answers each at
    once).  Yields ``(device_mesh, group_axes)``, ``group_axes`` naming
    each axis's group ({group name: (axis, size)}); the group is destroyed
    on exit.  Only the dry run's planning opens it, and it raises when a
    process group is already initialised."""
    import torch.distributed as dist

    fake_store = _torch_attr("torch.testing._internal.distributed.fake_pg",
                             "FakeStore")  # importing it registers "fake"
    init_device_mesh = _torch_attr("torch.distributed.device_mesh",
                                   "init_device_mesh")
    _torch_attr("torch.distributed.tensor", "DTensor")
    _torch_attr("torch.distributed.tensor.placement_types",
                "shard_dim_alltoall")
    placement_types = importlib.import_module(
        "torch.distributed.tensor.placement_types")
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised; the partitioned plan "
            "opens a fake group of its own and runs only outside one")
    try:
        dist.init_process_group("fake", store=fake_store(), rank=0,
                                world_size=mesh.size)
    except (ValueError, RuntimeError) as e:
        raise RuntimeError(f"the partitioned plan needs the fake process "
                           f"group backend: {e}") from e
    cpu_alltoall = placement_types.shard_dim_alltoall
    # a CPU mesh's resharding between two dims would all-gather and chunk
    # (gloo has no all-to-all); the plan prices the card's all-to-all
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        dm = init_device_mesh("cpu", tuple(mesh.devices.shape),
                              mesh_dim_names=tuple(mesh.axis_names))
        groups = {}
        for i, (axis, size) in enumerate(mesh.shape.items()):
            groups[dm.get_group(i).group_name] = (axis, size)
        yield dm, groups
    finally:
        placement_types.shard_dim_alltoall = cpu_alltoall
        dist.destroy_process_group()


def count_partitioned(build: Callable[[Layout], Tuple[Callable, Tree]],
                      shardings: Dict[str, Tree], mesh, rules
                      ) -> Dict[str, Any]:
    """The step ``build(layout) -> (fn, resident)`` run partitioned over
    ``mesh`` and counted for one device (``count_step``), inside
    ``plan_group``, the ``activation_sharding`` context and
    ``implicit_replication``."""
    implicit_replication = _torch_attr(
        "torch.distributed.tensor.experimental", "implicit_replication")
    with plan_group(mesh) as (dm, groups), \
            partitioning.activation_sharding(mesh, rules), \
            implicit_replication():
        fn, resident = build(Layout(dm, shardings))
        run = count_step(fn, resident, groups)
        del fn, resident
    return run


def _variant_cfg(cfg, variant: Optional[str]):
    if variant in ("q115", "q115_int", "q1_7_int"):
        return dataclasses.replace(cfg, quant=variant)
    if variant == "kvq":
        return dataclasses.replace(cfg, kv_cache_quant=True)
    if variant and variant.startswith("combo:"):
        # e.g. combo:q1_7_int+kvq
        kw = {}
        for part in variant.split(":", 1)[1].split("+"):
            if part == "kvq":
                kw["kv_cache_quant"] = True
            else:
                kw["quant"] = part
        return dataclasses.replace(cfg, **kw)
    return cfg


def _plan_partitioned(run, batch_dev, resident, step_inputs, n_chips,
                      model_flops_global):
    """The cell's ``memory``, ``cost``, ``collectives`` and ``roofline``
    records from the partitioned step counted for one device."""
    transient = run["peak_bytes"] - run["start_bytes"]
    colls = collectives_record(run["collectives"])
    flops_dev, bytes_dev = run["flops"], run["bytes"]
    terms = {"compute_s": flops_dev / PEAK_FLOPS, "memory_s": bytes_dev / HBM_BW,
             "collective_s": colls["traffic_bytes"] / LINK_BW}
    mf_dev = model_flops_global / n_chips
    how = "counted_partitioned"
    return {
        "memory": {
            "how": {"resident_per_device": "exact", "step": how,
                    "peak_live_bytes": how},
            "resident_per_device": resident,
            "step": {"batch_per_device": batch_dev}
            | {k: run[k] for k in ("start_bytes", "peak_bytes", "end_bytes")}
            | {"transient_peak_bytes": transient},
            # the step's own inputs resident per device, plus the most it
            # adds to them while it runs
            "peak_live_bytes": step_inputs + transient,
        },
        "cost": {
            "how": {"flops_per_device": how, "bytes_per_device": how,
                    "ops": how, "flops_global": f"{how} x chips",
                    "bytes_global": f"{how} x chips"},
            # every device runs the same local shapes (sharded dims divide)
            "flops_global": flops_dev * n_chips,
            "bytes_global": bytes_dev * n_chips,
            "ops": run["ops"],
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "bytes_note": BYTES_NOTE,
        },
        "collectives": {"how": how, **colls},
        "roofline": {
            **terms,
            "dominant": max(terms, key=terms.get),
            "bound_s": max(terms.values()),
            "model_flops_global": model_flops_global,
            "model_flops_per_device": mf_dev,
            "useful_flops_ratio": (mf_dev / flops_dev) if flops_dev else 0.0,
            "peak_flops": PEAK_FLOPS,
            "hbm_bw": HBM_BW,
            "link_bw": LINK_BW,
            "constants": CONSTANTS,
            "link_note": LINK_NOTE,
        },
    }


def _plan(run_global, run_device, resident, step_inputs, n_chips,
          model_flops_global):
    """The cell's ``memory``, ``cost`` and ``roofline`` records from the
    step counted at the global batch and at the per-device batch."""
    transient = run_device["peak_bytes"] - run_device["start_bytes"]
    flops_dev = run_global["flops"] / n_chips
    bytes_dev = run_global["bytes"] / n_chips
    terms = {"compute_s": flops_dev / PEAK_FLOPS, "memory_s": bytes_dev / HBM_BW}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops_global / n_chips
    return {
        "memory": {
            "how": {"resident_per_device": "exact", "step": "counted",
                    "peak_live_bytes": "counted"},
            "resident_per_device": resident,
            "step": {k: run_device[k] for k in (
                "batch_per_device", "start_bytes", "peak_bytes", "end_bytes")}
            | {"transient_peak_bytes": transient},
            # the step's own inputs resident per device, plus the most it
            # adds to them while it runs
            "peak_live_bytes": step_inputs + transient,
            "not_modelled": NOT_MODELLED,
        },
        "cost": {
            "how": {"flops_global": "counted", "bytes_global": "counted",
                    "ops": "counted", "flops_per_device": "even_split",
                    "bytes_per_device": "even_split"},
            "flops_global": run_global["flops"],
            "bytes_global": run_global["bytes"],
            "ops": run_global["ops"],
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "bytes_note": BYTES_NOTE,
        },
        "collectives": None,
        "collectives_note": NO_COLLECTIVES,
        "roofline": {
            **terms,
            "collective_s": None,
            "dominant": dominant,
            "bound_s": max(terms.values()),
            "model_flops_global": model_flops_global,
            "model_flops_per_device": mf_dev,
            "useful_flops_ratio": (mf_dev / flops_dev) if flops_dev else 0.0,
            "peak_flops": PEAK_FLOPS,
            "hbm_bw": HBM_BW,
            "constants": CONSTANTS,
        },
    }


def _count_both(build, batch: int, batch_dev: int) -> Tuple[Dict, Dict]:
    """The step counted at the global batch and at the per-device one
    (one run when they are equal); ``build(batch) -> (fn, resident)``."""
    fn, resident = build(batch)
    run_global = count_step(fn, resident)
    if batch_dev != batch:
        fn, resident = build(batch_dev)
        run_device = count_step(fn, resident)
    else:
        run_device = dict(run_global)
    run_device["batch_per_device"] = batch_dev
    return run_global, run_device


def run_cell(
    arch: str,
    shape: Union[str, shp.ShapeSpec],
    mesh_kind: str,
    *,
    variant: Optional[str] = None,
    rule_overrides: Optional[Dict[str, tuple]] = None,
    mesh_override=None,
    cfg_override=None,
    accum_steps: int = 1,
    partitioned: bool = True,
) -> Dict[str, Any]:
    """Plan one cell.  ``shape`` is a name in ``shapes.SHAPES`` or a
    ``ShapeSpec`` of its own (a cell the CLI does not list).
    ``partitioned=False``: the step unsharded (``counted``/``even_split``,
    no collectives), the plan before the partitioned one existed."""
    sp = shp.spec(shape)
    cfg = _variant_cfg(cfg_override or configs.get(arch), variant)
    ok, reason = shp.runnable(cfg, sp)
    if not ok:
        return {"arch": arch, "shape": sp.name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}

    mesh = (mesh_override if mesh_override is not None
            else make_production_mesh(multi_pod=(mesh_kind == "multi")))
    n_chips = mesh.size
    rules = partitioning.PartitionRules()
    if rule_overrides:
        rules = rules.override(**rule_overrides)

    t0 = time.time()
    kind, _, trees = build_step(cfg, sp, accum_steps)
    shardings = tree_shardings_of(cfg, trees, shp.batch_specs(cfg, sp)[2],
                                  mesh, rules)
    resident = {k: per_device_bytes(trees[k], shardings[k])
                for k in ("params", "opt_state", "inputs", "cache")
                if k in trees}
    resident["total"] = sum(resident.values())
    # a prefill's cache is its output, which the counted step allocates
    step_inputs = resident["total"] - (resident["cache"]
                                       if kind == "prefill" else 0)
    del trees
    B = sp.global_batch
    batch_dev = B // batch_shards(B, mesh, rules)
    if partitioned:
        def build_placed(layout):
            _, fn, t = build_step(cfg, sp, accum_steps, layout)
            return fn, t

        plan = _plan_partitioned(
            count_partitioned(build_placed, shardings, mesh, rules),
            batch_dev, resident, step_inputs, n_chips, model_flops(cfg, sp))
    else:
        def build(batch):
            _, fn, t = build_step(
                cfg, dataclasses.replace(sp, global_batch=batch), accum_steps)
            return fn, {k: v for k, v in t.items()
                        if not (kind == "prefill" and k == "cache")}

        run_global, run_device = _count_both(build, B, batch_dev)
        plan = _plan(run_global, run_device, resident, step_inputs, n_chips,
                     model_flops(cfg, sp))
    result = {
        "arch": arch,
        "shape": sp.name,
        "mesh": mesh_kind,
        "variant": variant,
        "accum_steps": accum_steps,
        "status": "ok",
        "chips": n_chips,
        "mesh_shape": mesh.shape,
        "plan_s": round(time.time() - t0, 2),
        **plan,
    }
    if kind == "prefill":
        result["memory"]["resident_per_device"]["cache_is_output"] = True
    return result


ALL_SHAPES = list(shp.SHAPES)


# ------------------------------------------------- paper's own SNN at scale
SNN_BATCH = 16384


def _snn_abstract(cfg) -> Tuple[Tree, Tree]:
    """The SNN's params on ``meta`` and their logical axes: ``w``
    (fan_in, fan_out), the hidden dims tensor parallel over ``model``."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    params, axes = {}, {}
    for i, (fan_in, fan_out) in enumerate(zip(cfg.layer_sizes[:-1],
                                              cfg.layer_sizes[1:])):
        a_in = "snn_in" if i == 0 else "snn_hidden"
        a_out = "snn_hidden" if i == 0 else "snn_out"
        params[f"layer{i}"] = {"w": meta(fan_in, fan_out), "b": meta(fan_out),
                               "beta_raw": meta(fan_out),
                               "threshold": meta(fan_out)}
        axes[f"layer{i}"] = {"w": (a_in, a_out), "b": (a_out,),
                             "beta_raw": (a_out,), "threshold": (a_out,)}
    return params, axes


def run_snn_cell(mesh_kind: str, mesh_override=None,
                 partitioned: bool = True) -> Dict[str, Any]:
    """The paper's 4096-512-2 LIF SNN train step (surrogate-gradient
    BPTT of ``core.snn.loss_fn`` with dropout, then the optimizer written
    into the state's own buffers) planned on the production mesh: batch DP
    over (pod, data), the hidden layer tensor parallel over model.

    Global batch 16384 rate-coded 64x64 images x 25 time steps; all 25
    steps are counted."""
    from repro_torch.configs.collision_snn import CONFIG as cfg
    from repro_torch.core import snn as snn_mod

    mesh = (mesh_override if mesh_override is not None
            else make_production_mesh(multi_pod=(mesh_kind == "multi")))
    n_chips = mesh.size
    rules = partitioning.PartitionRules().override(
        snn_in=("data",), snn_hidden=("model",), snn_out=())
    opt = chain_clip(adam(5e-4), 1.0)
    t0 = time.time()

    def trees_at(batch):
        params, axes = _snn_abstract(cfg)
        inputs = {
            "spikes": torch.empty((cfg.num_steps, batch, cfg.layer_sizes[0]),
                                  dtype=torch.float32, device="meta"),
            "labels": torch.empty((batch,), dtype=torch.int32, device="meta"),
        }
        return {"params": params, "opt_state": opt.init(params),
                "inputs": inputs}, axes

    def step(trees):
        params, opt_state = trees["params"], trees["opt_state"]
        spikes, labels = trees["inputs"]["spikes"], trees["inputs"]["labels"]
        gen = torch.Generator().manual_seed(0)

        def fn():
            live = [p.detach().requires_grad_(True)
                    for p in tree_leaves(params)]
            with torch.enable_grad():
                loss, _ = snn_mod.loss_fn(tree_unflatten(params, live),
                                          spikes, labels, cfg, train=True,
                                          generator=gen)
                grads = [partitioning.constrain_like(g, p) for g, p in
                         zip(torch.autograd.grad(loss, live), live)]
            with torch.no_grad():
                update_into(opt, grads, opt_state, params,
                            (params, opt_state))
            return loss.detach()

        return fn, trees

    def build(batch):
        return step(trees_at(batch)[0])

    trees, axes = trees_at(SNN_BATCH)
    param_sh = partitioning.tree_shardings(trees["params"], axes, mesh, rules)
    shardings = {
        "params": param_sh,
        "opt_state": partitioning.opt_state_specs(trees["opt_state"],
                                                  param_sh, mesh),
        "inputs": partitioning.tree_shardings(
            trees["inputs"], {"spikes": ("act_seq", "batch", "snn_in"),
                              "labels": ("batch",)}, mesh, rules),
    }
    resident = {k: per_device_bytes(trees[k], shardings[k]) for k in shardings}
    resident["total"] = sum(resident.values())
    batch_dev = SNN_BATCH // batch_shards(SNN_BATCH, mesh, rules)
    n_params = sum(t.numel() for t in tree_leaves(trees["params"]))
    # T steps x (fwd 2*N*B) x 3 (train)
    mf = 6.0 * n_params * SNN_BATCH * cfg.num_steps
    if partitioned:
        def build_placed(layout):
            return step({k: layout.place(k, v) for k, v in trees.items()})

        plan = _plan_partitioned(
            count_partitioned(build_placed, shardings, mesh, rules),
            batch_dev, resident, resident["total"], n_chips, mf)
    else:
        run_global, run_device = _count_both(build, SNN_BATCH, batch_dev)
        plan = _plan(run_global, run_device, resident, resident["total"],
                     n_chips, mf)
    return {
        "arch": "collision-snn", "shape": "train_16k_batch",
        "mesh": mesh_kind, "status": "ok", "chips": n_chips,
        "mesh_shape": mesh.shape,
        "plan_s": round(time.time() - t0, 2),
        **plan,
    }


def cell_path(outdir, arch, shape, mesh_kind, tag):
    suffix = f"__{tag}" if tag else ""
    return os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def _summary(res) -> str:
    r = res["roofline"]
    coll = ("-" if r["collective_s"] is None
            else f"{r['collective_s'] * 1e3:.2f}ms")
    return (f"plan={res['plan_s']}s compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms coll={coll} "
            f"dom={r['dominant']} "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"peak={res['memory']['peak_live_bytes'] / 2**30:.2f}GiB")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Plan the LM zoo's cells, and the paper's SNN, on meta.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=ALL_SHAPES + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument(
        "--variant", default=None,
        help="q115: fake-quant QAT; q115_int/q1_7_int: true int weight "
        "storage; kvq: int8 KV cache; combo:<a>+<b> to compose",
    )
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 32,8: a mesh remap within the pod")
    ap.add_argument("--mesh-axes", default="data,model")
    ap.add_argument(
        "--override", action="append", default=[],
        help="logical=axis1+axis2 partitioning-rule override (axis empty -> replicate)",
    )
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes_ = ALL_SHAPES if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = tuple(a for a in v.split("+") if a)
    tag = args.tag or (args.variant if args.variant else None)
    if overrides and not tag:
        tag = "override"
    mesh_override = None
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        mesh_override = make_production_mesh(
            shape=shape, axes=tuple(args.mesh_axes.split(",")))
        if not tag:
            tag = f"mesh{'x'.join(map(str, shape))}"

    os.makedirs(args.outdir, exist_ok=True)
    failures = []
    if args.arch == "collision-snn":
        for mesh_kind in meshes:
            res = run_snn_cell(mesh_kind, mesh_override)
            path = os.path.join(args.outdir,
                                f"collision-snn__train__{mesh_kind}.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"collision-snn x {mesh_kind}: ok {_summary(res)}")
        return
    for arch in archs:
        for shape_name in shapes_:
            for mesh_kind in meshes:
                path = cell_path(args.outdir, arch, shape_name, mesh_kind, tag)
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {path}")
                    continue
                print(f"[cell] {arch} x {shape_name} x {mesh_kind}", flush=True)
                try:
                    res = run_cell(
                        arch, shape_name, mesh_kind,
                        variant=args.variant,
                        rule_overrides=overrides or None,
                        mesh_override=mesh_override,
                    )
                except Exception as e:  # noqa: BLE001 - recorded per cell
                    traceback.print_exc()
                    res = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                    }
                    failures.append((arch, shape_name, mesh_kind, str(e)))
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "ok":
                    print(f"   ok: {_summary(res)}", flush=True)
                elif res["status"] == "skipped":
                    print(f"   {res['reason']}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        sys.exit(1)
    print("\ndry-run complete")


if __name__ == "__main__":
    main()
