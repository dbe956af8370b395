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

Each cell writes ``<outdir>/<arch>__<shape>__<mesh>[__<tag>].json``
(existing files are kept unless ``--force``).  Every number in it says
how it was obtained (``how``):

- ``exact``: per-device resident bytes of params, optimizer state,
  inputs and cache, from ``partitioning.tree_shardings`` over the params'
  logical axes and ``NamedSharding.indices``;
- ``counted``: what the step did when it ran on ``meta``: its flops
  (``torch.utils.flop_counter``), its bytes (each dispatched op's input
  and output bytes: unfused op traffic, not HBM traffic after fusion)
  and its peak of live storages (``LiveBytes``), the last at the
  per-device batch with params, gradients and optimizer temporaries
  unsharded (tensor-parallel and FSDP splits of the step's transients are
  not modelled);
- ``even_split``: a counted global total over the mesh's devices.

The roofline uses the NVIDIA H100 80GB HBM3's constants.  One process on
``meta`` runs no collective and there is no compiled program to parse,
so ``collectives`` is null and the dominant term is taken over compute
and memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

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
CONSTANTS = ("NVIDIA H100 80GB HBM3 (SXM5), 700 W, spec sheet: 989 TFLOP/s "
             "dense bfloat16, 3.35 TB/s HBM3")
NO_COLLECTIVES = ("not planned: one process on meta runs no collective and "
                  "the port has no compiled program to parse")
NOT_MODELLED = ("the step runs at the per-device batch with params, gradients "
                "and optimizer temporaries unsharded; tensor-parallel and FSDP "
                "splits of its transients are not modelled")
BYTES_NOTE = ("unfused op traffic: each dispatched op's input and output "
              "bytes (views move none)")


# ------------------------------------------------------------ counting
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
    (``sweep()`` makes it exact)."""

    def __init__(self, resident=()):
        super().__init__()
        self._live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.cur = 0
        self.ops = 0
        self.traffic = 0
        for t in resident:
            self._add(t)
        self.start = self.peak = self.cur

    def _add(self, t: torch.Tensor) -> bool:
        st = t.untyped_storage()
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ins = [t for t in _pytree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops += 1
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


def count_step(fn: Callable[[], Any], resident: Tree) -> Dict[str, Any]:
    """Run ``fn`` (a step on ``meta``) under the flop counter and
    ``LiveBytes``; ``resident``: the tensors live before it (its state and
    inputs).  ``end_bytes`` holds the step's outputs."""
    with FlopCounterMode(display=False) as fc, \
            LiveBytes(tree_leaves(resident)) as lb:
        out = fn()
        end = lb.sweep()
    del out
    return {"flops": float(fc.get_total_flops()), "bytes": float(lb.traffic),
            "ops": lb.ops, "start_bytes": lb.start, "peak_bytes": lb.peak,
            "end_bytes": end}


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


def build_step(cfg, shape: Union[str, shp.ShapeSpec], accum_steps: int = 1):
    """The cell's step over ``meta`` trees at ``shape``'s batch (the
    counterpart of the reference's ``build_lowered``).  Returns ``(kind,
    fn, trees)``: ``fn()`` runs the step once; ``trees`` holds its
    ``params`` and ``inputs``, ``opt_state`` (train) and the ``cache``
    (decode: the step's input, written in place; prefill: the shape of
    the cache the step returns)."""
    sp = shp.spec(shape)
    model = Model(cfg)
    params = model.abstract()
    kind, inputs, _ = shp.batch_specs(cfg, sp)
    trees = {"params": params, "inputs": inputs}
    if kind == "train":
        opt = chain_clip(adam(5e-4), 1.0)
        trees["opt_state"] = opt_state = opt.init(params)
        _, device = make_step_parts(model, opt, accum_steps=accum_steps)
        state = TrainState(params, opt_state, 0)

        def fn():
            return device(state, inputs, (params, opt_state))

        return kind, fn, trees

    trees["cache"] = cache = model.abstract_cache(sp.global_batch, sp.seq_len)
    if kind == "prefill":
        def fn():
            with torch.no_grad():
                return model.prefill(params, inputs, sp.seq_len)
    else:
        def fn():
            with torch.no_grad():
                return model.decode_step(params, inputs["token"],
                                         inputs["pos"], cache)
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
) -> Dict[str, Any]:
    """Plan one cell.  ``shape`` is a name in ``shapes.SHAPES`` or a
    ``ShapeSpec`` of its own (a cell the CLI does not list)."""
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

    def build(batch):
        _, fn, t = build_step(
            cfg, dataclasses.replace(sp, global_batch=batch), accum_steps)
        return fn, {k: v for k, v in t.items()
                    if not (kind == "prefill" and k == "cache")}

    B = sp.global_batch
    run_global, run_device = _count_both(build, B,
                                         B // batch_shards(B, mesh, rules))
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
        **_plan(run_global, run_device, resident, step_inputs, n_chips,
                model_flops(cfg, sp)),
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


def run_snn_cell(mesh_kind: str, mesh_override=None) -> Dict[str, Any]:
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

    def build(batch):
        trees, _ = trees_at(batch)
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
                grads = list(torch.autograd.grad(loss, live))
            with torch.no_grad():
                update_into(opt, grads, opt_state, params,
                            (params, opt_state))
            return loss.detach()

        return fn, trees

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
    run_global, run_device = _count_both(
        build, SNN_BATCH, SNN_BATCH // batch_shards(SNN_BATCH, mesh, rules))
    n_params = sum(t.numel() for t in tree_leaves(trees["params"]))
    # T steps x (fwd 2*N*B) x 3 (train)
    mf = 6.0 * n_params * SNN_BATCH * cfg.num_steps
    return {
        "arch": "collision-snn", "shape": "train_16k_batch",
        "mesh": mesh_kind, "status": "ok", "chips": n_chips,
        "mesh_shape": mesh.shape,
        "plan_s": round(time.time() - t0, 2),
        **_plan(run_global, run_device, resident, resident["total"], n_chips,
                mf),
    }


def cell_path(outdir, arch, shape, mesh_kind, tag):
    suffix = f"__{tag}" if tag else ""
    return os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def _summary(res) -> str:
    r = res["roofline"]
    return (f"plan={res['plan_s']}s compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms dom={r['dominant']} "
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
