"""The dry run's partitioned step (``repro_torch.launch.dryrun``, the
default ``partitioned=True``): each cell runs as DTensors over a fake
process group of the mesh's size, every tensor on ``meta``, and counts
one device's flops, bytes, live-storage peak and collectives.  Small
meshes, reduced configs; each cell opens and destroys its own group."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed import partitioning
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

ARCH = "stablelm-1.6b"
KINDS = ("train", "prefill", "decode")
ROOT = Path(__file__).resolve().parents[1]


def _mesh(*shape):
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]
    return make_production_mesh(shape=shape, axes=axes)


_PLANS = {}


def _cell(arch, kind, mesh, seq=128, batch=8, **kw):
    """The reduced ``arch``'s ``kind`` cell planned on ``mesh``; a plan
    asked for twice in this module is made once (its record is only
    read)."""
    key = (arch, kind, tuple(mesh.devices.shape), seq, batch, repr(kw))
    if key not in _PLANS:
        cfg = configs.get(arch).reduced()
        sp = shapes.ShapeSpec(f"{kind}_{batch}x{seq}", seq, batch, kind)
        _PLANS[key] = dryrun.run_cell(arch, sp, "test", mesh_override=mesh,
                                      cfg_override=cfg, **kw)
    return _PLANS[key]


def _reference_parse_collectives():
    # the reference's dry run sets XLA_FLAGS for 512 host devices when it
    # is imported; this process keeps its own
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import parse_collectives
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return parse_collectives


# ---------------------------------------------------------- ring traffic
HLO_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
             "collective-permute")


@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", HLO_KINDS)
def test_ring_traffic_matches_reference_parse_collectives(kind, group):
    parse = _reference_parse_collectives()
    lines, issued = [], []
    for i, (dt, dims, nbytes) in enumerate((("f32", (8, 128), 4096),
                                            ("bf16", (3, 5, 7), 210))):
        shape = f"{dt}[{','.join(map(str, dims))}]"
        lines.append(f"  %c{i} = {shape}{{1,0}} {kind}({shape} %p{i}), "
                     f"replica_groups=[{32 // group},{group}]<=[32]")
        issued.append((kind, nbytes, group, "data"))
    ref = parse("\n".join(lines))
    got = dryrun.collectives_record(issued)
    assert got["ops"] == ref["ops"]
    assert got["traffic_bytes"] == ref["traffic_bytes"]
    for line, (_, nbytes, _, _) in zip(lines, issued):
        assert dryrun.ring_traffic(kind, nbytes, group) == parse(
            line)["traffic_bytes"]
    assert got["by_axis"] == {"data": got["ops"]}


def test_ring_traffic_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="broadcast"):
        dryrun.ring_traffic("broadcast", 8, 4)


# ------------------------------------------------ one device: unchanged
@pytest.mark.parametrize("kind", KINDS)
def test_one_device_mesh_equals_the_unsharded_plan(kind):
    mesh = _mesh(1, 1)
    part = _cell(ARCH, kind, mesh)
    plain = _cell(ARCH, kind, mesh, partitioned=False)
    for key in ("flops_per_device", "bytes_per_device"):
        assert part["cost"][key] == plain["cost"][key], key
    # the per-device blocks add only views (to and from the local shards)
    assert part["cost"]["ops"] >= plain["cost"]["ops"]
    assert part["memory"]["peak_live_bytes"] == plain["memory"]["peak_live_bytes"]
    for key in ("start_bytes", "peak_bytes", "end_bytes"):
        assert part["memory"]["step"][key] == plain["memory"]["step"][key]
    assert all(op["traffic_bytes"] == 0
               for op in part["collectives"]["ops"].values())
    assert part["collectives"]["traffic_bytes"] == 0
    assert part["roofline"]["collective_s"] == 0.0
    assert part["cost"]["how"]["flops_per_device"] == "counted_partitioned"
    assert plain["collectives"] is None
    assert plain["roofline"]["collective_s"] is None
    assert plain["cost"]["how"]["flops_per_device"] == "even_split"
    assert not dist.is_initialized()  # the plan's group is gone


def test_one_device_snn_cell_equals_the_unsharded_plan():
    mesh = _mesh(1, 1)
    part = dryrun.run_snn_cell("one", mesh)
    plain = dryrun.run_snn_cell("one", mesh, partitioned=False)
    assert part["cost"]["flops_per_device"] == plain["cost"]["flops_per_device"]
    assert part["memory"]["peak_live_bytes"] == plain["memory"]["peak_live_bytes"]
    # DTensor runs the accuracy's argmax as max.dim, which also writes the
    # batch's float32 maxima
    assert part["cost"]["bytes_per_device"] - plain["cost"]["bytes_per_device"] \
        == dryrun.SNN_BATCH * 4
    assert part["collectives"]["traffic_bytes"] == 0


# ------------------------------------------------------ data parallelism
def test_pure_data_parallelism_all_reduces_each_gradient():
    """(4,) data mesh with the params replicated (``embed=`` override):
    each gradient is all-reduced once over the four devices, 2(g-1)/g of
    its bytes each, and nothing else moves but the loss's token count."""
    rec = _cell(ARCH, "train", _mesh(4), seq=64,
                rule_overrides={"embed": ()})
    n = Model(configs.get(ARCH).reduced()).param_count()
    ops = rec["collectives"]["ops"]
    assert set(ops) == {"all-reduce"}
    ar = ops["all-reduce"]
    scalars = ar["result_bytes"] - 4 * n  # float32 gradients of every leaf
    assert 0 <= scalars <= 16
    assert ar["traffic_bytes"] == pytest.approx(2 * 3 / 4 * ar["result_bytes"])
    assert rec["collectives"]["by_axis"].keys() == {"data"}
    # the params are resident whole on every device
    assert rec["memory"]["resident_per_device"]["params"] == 4 * n


def test_pod_axis_carries_gradient_all_reduces_only():
    """(2, 2, 2) pod, data, model: the pod axis is pure data parallelism,
    so it carries all-reduces, every gradient leaf's at least at its size
    a device."""
    mesh = _mesh(2, 2, 2)
    rec = _cell(ARCH, "train", mesh, seq=64)
    pod = rec["collectives"]["by_axis"]["pod"]
    assert set(pod) == {"all-reduce"}
    model = Model(configs.get(ARCH).reduced())
    leaves = tree_leaves(model.abstract())
    shardings = tree_leaves(partitioning.tree_shardings(
        model.abstract(), model.logical_axes(), mesh))
    # each gradient's block a device holds, which the pod reduces whole
    # or, when it is reduced over data first, the block that leaves
    reckoned = sum(dryrun.per_device_bytes({"g": t}, {"g": sh})
                   for t, sh in zip(leaves, shardings))
    assert pod["all-reduce"]["result_bytes"] >= reckoned
    # a group of two: the ring moves each all-reduce's bytes once
    assert pod["all-reduce"]["traffic_bytes"] == pod["all-reduce"]["result_bytes"]


# ------------------------------------------------------------ the errors
def test_op_without_a_sharding_rule_makes_the_cell_an_error(
        tmp_path, monkeypatch):
    import torch

    from repro_torch.models import layers

    real_get, real_norm = configs.get, layers.apply_norm
    monkeypatch.setattr(dryrun.configs, "get",
                        lambda a: real_get(a).reduced())

    def renormed(p, x, kind, eps):  # aten.renorm has no DTensor rule
        return real_norm(p, torch.renorm(x, 2, 0, 1.0), kind, eps)

    monkeypatch.setattr(layers, "apply_norm", renormed)
    argv = ["--arch", ARCH, "--shape", "train_4k", "--mesh", "single",
            "--mesh-shape", "2,4", "--outdir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 1
    with open(dryrun.cell_path(str(tmp_path), ARCH, "train_4k", "single",
                               "mesh2x4")) as f:
        rec = json.load(f)
    assert rec["status"] == "error"
    assert "aten.renorm" in rec["error"]
    assert "collectives" not in rec  # no unsharded count in its place
    assert not dist.is_initialized()


def test_plan_group_refuses_a_live_process_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.plan_group(_mesh(2)):
                pass
    finally:
        dist.destroy_process_group()


def test_plan_group_prices_a_reshard_between_dims_as_one_all_to_all():
    """Inside ``plan_group`` a split moved from one dim to another is the
    card's one all-to-all, not the CPU mesh's all-gather and chunk."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    with dryrun.plan_group(_mesh(4)) as (dm, groups):
        x = DTensor.from_local(torch.empty(2, 8, device="meta"), dm,
                               [Shard(0)], run_check=False)
        with dryrun.LiveBytes(group_axes=groups) as lb:
            y = x.redistribute(dm, [Shard(1)])
        assert tuple(y.placements) == (Shard(1),)
        assert tuple(y.to_local().shape) == (8, 2)
    assert lb.collectives == [("all-to-all", 8 * 2 * 4, 4, "data")]
    assert not dist.is_initialized()


def test_placements_from_named_sharding():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(2, 1, 4)
    sh = partitioning.NamedSharding(mesh, partitioning.P(("pod", "data"),
                                                         None, "model"))
    # an axis of one position holds the whole dim: replicated
    assert sh.placements(3) == [Shard(0), Replicate(), Shard(2)]
    assert partitioning.NamedSharding(mesh, partitioning.P()).placements(2) \
        == [Replicate()] * 3


# -------------------------------------------------------- every arch
def _largest_layer_bytes(tree, axes, mesh):
    """The most bytes one device holds of one layer of ``tree`` (a params
    or cache tree) laid out on ``mesh``: a layer of a stacked group under
    ``main``, or a whole top-level entry (the embedding, the head)."""
    sh = partitioning.tree_shardings(tree, axes, mesh)
    sizes = [dryrun.per_device_bytes(tree[k], sh[k])
             for k in tree if k != "main"]
    for k, group in tree["main"].items():
        n = tree_leaves(group)[0].shape[0]
        sizes.append(dryrun.per_device_bytes(group, sh["main"][k]) // n)
    return max(sizes)


def _decode_gathers(arch, batch=8, seq=128):
    """What a decode step on a (2, 4) data, model mesh may hold gathered
    at once beyond the unsharded plan: one layer's params gathered over
    data (FSDP, their model split kept), and one layer's cache gathered
    over model (the context-parallel cache, its batch split kept) twice,
    a gather along an inner dim holding its buffer and the copy in
    order."""
    model = Model(configs.get(arch).reduced())
    params = _largest_layer_bytes(model.abstract(), model.logical_axes(),
                                  _mesh(1, 4))
    cache = model.abstract_cache(batch, seq)
    cache = _largest_layer_bytes(cache, partitioning.cache_logical_axes(cache),
                                 _mesh(2, 1))
    return params + 2 * cache


def _plan_sharded(arch, kind):
    """The cell on a (2, 4) data, model mesh: ok, with the records the
    partitioned plan writes, its peak within bounds."""
    mesh = _mesh(2, 4)
    rec = _cell(arch, kind, mesh)
    assert rec["status"] == "ok"
    mem, roof = rec["memory"], rec["roofline"]
    assert mem["how"]["peak_live_bytes"] == "counted_partitioned"
    assert set(rec["collectives"]["ops"]) <= set(HLO_KINDS)
    assert rec["collectives"]["traffic_bytes"] > 0
    assert roof["collective_s"] == pytest.approx(
        rec["collectives"]["traffic_bytes"] / dryrun.LINK_BW)
    assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])
    assert mem["peak_live_bytes"] >= mem["resident_per_device"]["total"] - (
        mem["resident_per_device"].get("cache", 0) if kind == "prefill"
        else 0)
    # the unsharded plan on the same mesh: its transients are the whole
    # per-device batch's with every weight whole
    bound = _cell(arch, kind, mesh, partitioned=False)["memory"][
        "peak_live_bytes"]
    if kind == "decode":
        # one token a sequence: the step's activations are small beside
        # the params and cache it gathers a layer at a time
        bound += _decode_gathers(arch)
    assert mem["peak_live_bytes"] <= bound
    json.dumps(rec)
    return rec


SHARDED_ARCHS = ("stablelm-1.6b", "codeqwen1.5-7b", "yi-34b",
                 "phi-3-vision-4.2b", "musicgen-medium", "mixtral-8x7b",
                 "granite-moe-1b-a400m", "mamba2-130m", "minicpm3-4b",
                 "recurrentgemma-2b")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_arch_plans_sharded(arch, kind):
    _plan_sharded(arch, kind)


def test_snn_cell_plans_sharded():
    mesh = _mesh(2, 4)
    rec = dryrun.run_snn_cell("test", mesh)
    plain = dryrun.run_snn_cell("test", mesh, partitioned=False)
    mem = rec["memory"]
    assert rec["status"] == "ok"
    assert mem["resident_per_device"]["total"] <= mem["peak_live_bytes"] \
        <= plain["memory"]["peak_live_bytes"]
    assert rec["collectives"]["traffic_bytes"] > 0
    # the hidden layer is tensor parallel over model: its weight's
    # gradient is reduce-scattered there
    assert "model" in rec["collectives"]["by_axis"]


# ------------------------------------------- against the reference's plan
# (arch, kind, mesh shape, rule overrides, seq): cells the reference's dry
# run compiles with GSPMD on as many host devices, the same reduced
# configs and shapes as the port plans above
REFERENCE_CELLS = (
    ("stablelm-1.6b", "train", (4,), {"embed": ()}, 64),
    ("stablelm-1.6b", "train", (2, 4), {}, 128),
    ("mixtral-8x7b", "train", (2, 4), {}, 128),
    ("stablelm-1.6b", "decode", (2, 4), {}, 128),
)
_REFERENCE_SCRIPT = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
# the backend starts with 8 devices: the reference's dry run, imported
# below, asks for 512 too late to change it
assert len(jax.devices()) == 8
from repro import configs
from repro.distributed import partitioning
from repro.launch import dryrun, shapes
from repro.launch.mesh import make_production_mesh

out = []
for arch, kind, mesh_shape, over, seq in json.loads(sys.argv[1]):
    name = f"{kind}_8x{seq}"
    shapes.SHAPES[name] = shapes.ShapeSpec(name, seq, 8, kind)
    axes = ("data", "model")[:len(mesh_shape)]
    mesh = make_production_mesh(shape=tuple(mesh_shape), axes=axes)
    rules = partitioning.PartitionRules().override(
        **{k: tuple(v) for k, v in over.items()})
    with partitioning.activation_sharding(mesh, rules):
        lowered = dryrun.build_lowered(configs.get(arch).reduced(), name,
                                       mesh, rules)
    compiled = lowered.compile()
    issued = []
    for line in compiled.as_text().splitlines():
        m = dryrun._COLL_RE.search(line)
        if m:  # one collective: kind, result bytes, group size
            gm = dryrun._GROUPS_RE.search(line)
            gb = dryrun._GROUPS_BRACE_RE.search(line)
            size = (int(gm.group(2)) if gm else
                    len(gb.group(1).split(",")) if gb else 1)
            issued.append((m.group(2), dryrun._shape_bytes(m.group(1)), size))
    out.append({"argument_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
                "issued": issued})
print(json.dumps(out))
"""
_REFERENCE_RUN = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_dry_run(request):
    """The reference's dry run of ``REFERENCE_CELLS``, started in a process
    of its own (8 host devices for JAX) when this module starts, so it
    compiles while the port's cells are planned; torn down with it."""
    wanted = any("reference_dry_run" in item.name
                 and item.module is request.module
                 for item in request.session.items)
    if wanted:
        _REFERENCE_RUN["proc"] = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_SCRIPT,
             json.dumps(REFERENCE_CELLS)], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "JAX_PLATFORMS": "cpu"})
    yield
    proc = _REFERENCE_RUN.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def _reference_plans():
    if "plans" not in _REFERENCE_RUN:
        out, err = _REFERENCE_RUN["proc"].communicate(timeout=600)
        assert _REFERENCE_RUN["proc"].returncode == 0, err[-3000:]
        _REFERENCE_RUN["plans"] = json.loads(out.strip().splitlines()[-1])
    return _REFERENCE_RUN["plans"]


def _traffic_by_axis(issued, axes):
    """{axis: {kind: traffic}} of (kind, result bytes, group size) over
    ``axes`` ({group size: axis}); a group of one device is no axis."""
    out = {}
    for kind, nbytes, group in issued:
        if group == 1:
            continue
        by_kind = out.setdefault(axes[group], {})
        by_kind[kind] = by_kind.get(kind, 0.0) + dryrun.ring_traffic(
            kind, nbytes, group)
    return out


REDUCTIONS = {"all-reduce", "reduce-scatter"}
GATHERS = {"all-gather", "all-to-all"}


@pytest.mark.parametrize("i", range(len(REFERENCE_CELLS)),
                         ids=[f"{a}-{k}-{'x'.join(map(str, m))}"
                              for a, k, m, _, _ in REFERENCE_CELLS])
def test_sharded_plan_against_reference_dry_run(i):
    """The port's partitioned plan against the reference's GSPMD program
    of the same cell: one device's argument bytes exactly, and on each
    mesh axis the classes of collective (reductions, gathers) GSPMD
    issues and ring traffic within a band.  DTensor departs from GSPMD in where it
    reduces: pure data parallelism moves the same bytes; on a (2, 4) mesh
    the port reduces each partial activation gradient on its own where
    GSPMD sums them first, and a decode step lays the context-parallel
    cache out by heads with one all-to-all a layer where GSPMD combines
    the split attention (PERF.md §7)."""
    arch, kind, mesh_shape, over, seq = REFERENCE_CELLS[i]
    ref = _reference_plans()[i]
    mesh = _mesh(*mesh_shape)
    rec = _cell(arch, kind, mesh, seq=seq, rule_overrides=over or None)
    resident = rec["memory"]["resident_per_device"]
    # the reference's train state also holds the int32 step count, which
    # the port keeps on the host
    assert ref["argument_bytes"] == resident["total"] + (
        4 if kind == "train" else 0)
    axes = {size: axis for axis, size in mesh.shape.items()}
    assert len(axes) == len(mesh_shape)  # each axis known by its size
    want = _traffic_by_axis(ref["issued"], axes)
    got = {axis: {k: op["traffic_bytes"] for k, op in by_kind.items()}
           for axis, by_kind in rec["collectives"]["by_axis"].items()}
    assert set(got) == set(want)
    for axis in want:
        for cls in (REDUCTIONS, GATHERS):
            # where GSPMD reduces or gathers, so does the port (which may
            # also split an all-reduce into a reduce-scatter and a gather)
            assert not cls & set(want[axis]) or cls & set(got[axis]), (
                axis, got[axis], want[axis])
        g, w = sum(got[axis].values()), sum(want[axis].values())
        if len(mesh_shape) == 1:
            # one gradient all-reduce of every leaf on each side; the
            # reference's loss adds a few scalars
            assert set(got[axis]) == set(want[axis]) == {"all-reduce"}
            assert abs(g - w) <= dryrun.ring_traffic("all-reduce", 16, 4)
        elif kind == "decode" and axis == "model":
            cache = dryrun.ring_traffic("all-to-all", resident["cache"],
                                        mesh.shape["model"])
            assert 0.75 * w <= g <= 1.25 * (w + cache), (g, w, cache)
        else:
            assert 0.75 * w <= g <= 1.5 * w, (axis, g, w)
