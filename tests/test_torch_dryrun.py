"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.mesh``):
meshes of ``meta`` devices, the live-storage counter on hand-sized
sequences, per-device resident bytes against ``NamedSharding.indices``,
counted flops against the model's, and the CLI's cells, cache and
``--force``; every leaf stays on ``meta``."""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import partitioning
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
META = torch.device("meta")


def _bytes(n):
    return torch.empty(n, dtype=torch.uint8, device=META)


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("multi,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh(multi, shape, axes):
    mesh = make_production_mesh(multi_pod=multi)
    assert mesh.devices.shape == shape and mesh.axis_names == axes
    assert mesh.size == math.prod(shape)
    assert {d.type for d in mesh.devices.ravel()} == {"meta"}


def test_production_mesh_override_and_host_mesh():
    mesh = make_production_mesh(shape=(32, 8), axes=("data", "model"))
    assert mesh.shape == {"data": 32, "model": 8}
    with pytest.raises(ValueError):
        make_production_mesh(shape=(4, 2), axes=("data",))
    host = make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices[0, 0] == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_host_mesh()


# ----------------------------------------------------------- live storages
def test_live_bytes_allocations_views_and_frees():
    with dryrun.LiveBytes() as lb:
        a = _bytes(100)
        b = _bytes(200)
        v = a.view(10, 10)  # a view: no new storage
        assert (lb.cur, lb.peak) == (300, 300)
        del a  # the view keeps its storage
        c = _bytes(50)
        assert (lb.sweep(), lb.peak) == (350, 350)
        del v  # now a's storage goes
        d = _bytes(80)
        assert (lb.sweep(), lb.peak) == (330, 350)
        b.add_(1)  # in place: nothing new
        assert lb.sweep() == 330
    assert lb.ops == 4 + 1 + 1  # 4 empties, the view, add_
    del b, c, d


def test_live_bytes_counts_what_autograd_saves():
    x = torch.empty(1000, dtype=torch.float32, device=META).requires_grad_(True)
    with dryrun.LiveBytes([x]) as lb:
        assert lb.start == 4000
        # exp saves its output for the backward: it outlives its tensor
        loss = x.exp().sum()
        assert lb.sweep() == 4000 + 4000 + 4
        (g,) = torch.autograd.grad(loss, [x])
        # the backward held x, exp's output, the loss and a product of
        # the output's size (the grad of the sum is a view of a scalar)
        assert lb.peak == 4000 + 4000 + 4 + 4 + 4000
        assert lb.sweep() == 4000 + 4 + 4000  # the graph is freed
        del loss
        assert lb.sweep() == 8000
        del g
        assert lb.sweep() == 4000


def test_live_bytes_traffic():
    a = torch.empty((8, 16), dtype=torch.float32, device=META)
    b = torch.empty((16, 4), dtype=torch.float32, device=META)
    with dryrun.LiveBytes([a, b]) as lb:
        a.t()  # a view moves nothing
        assert lb.traffic == 0
        a @ b
        assert lb.traffic == (8 * 16 + 16 * 4 + 8 * 4) * 4
        a.mul_(2.0)  # read and written in place
        assert lb.traffic == (8 * 16 + 16 * 4 + 8 * 4) * 4 + 2 * 8 * 16 * 4


# --------------------------------------------------------- resident bytes
def test_per_device_bytes_against_indices():
    mesh = make_production_mesh(shape=(2, 2), axes=("data", "model"))
    rules = partitioning.PartitionRules()
    cfg = configs.get("stablelm-1.6b").reduced()
    model = Model(cfg)
    params, axes = model.abstract(), model.logical_axes()
    sh = partitioning.tree_shardings(params, axes, mesh, rules)
    per_pos = []
    for pos in [(i, j) for i in range(2) for j in range(2)]:
        total = 0
        for t, s in zip(tree_leaves(params), tree_leaves(sh)):
            block = s.indices(t.shape, pos)
            total += math.prod(x.stop - x.start for x in block) * t.element_size()
        per_pos.append(total)
    assert len(set(per_pos)) == 1
    got = dryrun.per_device_bytes(params, sh)
    assert got == per_pos[0]
    full = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert full / 4 <= got < full
    # one leaf by hand: (8, 6) float32 on (embed, mlp) -> (4, 3) a device
    leaf = {"w": torch.empty((8, 6), device=META)}
    lsh = partitioning.tree_shardings(leaf, {"w": ("embed", "mlp")}, mesh,
                                      rules)
    assert dryrun.per_device_bytes(leaf, lsh) == 4 * 3 * 4


def test_batch_shards():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    rules = partitioning.PartitionRules()
    assert dryrun.batch_shards(256, single, rules) == 16
    assert dryrun.batch_shards(256, multi, rules) == 32
    assert dryrun.batch_shards(1, multi, rules) == 1


# ------------------------------------------------------------------ cells
def test_dense_train_cell_counts_flops_between_one_and_two_model_flops():
    sp = shapes.ShapeSpec("train_2x512", 512, 2, "train")
    mesh = make_production_mesh(shape=(2, 1), axes=("data", "model"))
    rec = dryrun.run_cell("stablelm-1.6b", sp, "tiny", mesh_override=mesh)
    assert rec["status"] == "ok" and rec["chips"] == 2
    mf = dryrun.model_flops(configs.get("stablelm-1.6b"), sp)
    counted = rec["cost"]["flops_global"]
    assert mf <= counted <= 2 * mf  # remat's recompute plus attention
    assert rec["cost"]["flops_per_device"] == counted / 2
    assert rec["cost"]["how"]["flops_per_device"] == "counted_partitioned"
    assert rec["memory"]["how"]["resident_per_device"] == "exact"
    mem = rec["memory"]
    assert mem["step"]["batch_per_device"] == 1
    # the partitioned step starts from its local shards: what is resident
    assert mem["step"]["start_bytes"] == mem["resident_per_device"]["total"]
    # written into its own buffers, the step leaves only its 0-dim metrics
    assert 0 < mem["step"]["end_bytes"] - mem["step"]["start_bytes"] <= 64
    assert mem["peak_live_bytes"] == (mem["resident_per_device"]["total"]
                                      + mem["step"]["transient_peak_bytes"])
    # two data-parallel devices: the gradients are reduced between them
    colls = rec["collectives"]
    assert colls["traffic_bytes"] > 0 and set(colls["by_axis"]) == {"data"}
    assert rec["roofline"]["collective_s"] == colls["traffic_bytes"] / 450e9
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert rec["roofline"]["peak_flops"] == 989e12
    json.dumps(rec)
    # per device: half of every float32 param the embed rule splits over
    # data (small vectors stay whole), Adam's mu and nu like them and its
    # count, the per-device batch's tokens and targets
    res = mem["resident_per_device"]
    n = Model(configs.get("stablelm-1.6b")).param_count()
    assert 4 * n / 2 <= res["params"] < 4 * n / 2 * 1.001
    assert res["opt_state"] == 2 * res["params"] + 4
    assert res["inputs"] == 2 * 512 * 4


def test_prefill_cell_counts_its_cache_once():
    sp = shapes.ShapeSpec("prefill_2x64", 64, 2, "prefill")
    mesh = make_production_mesh(shape=(1,), axes=("data",))
    cfg = configs.get("mamba2-130m").reduced()
    rec = dryrun.run_cell("mamba2-130m", sp, "one", mesh_override=mesh,
                          cfg_override=cfg)
    mem = rec["memory"]
    res = mem["resident_per_device"]
    cache = Model(cfg).abstract_cache(2, 64)
    assert res["cache"] == sum(t.numel() * t.element_size()
                               for t in tree_leaves(cache))
    assert res["cache_is_output"] is True
    # the step's end holds its output cache beside its inputs
    assert mem["step"]["end_bytes"] - mem["step"]["start_bytes"] >= res["cache"]
    assert mem["peak_live_bytes"] == (res["total"] - res["cache"]
                                      + mem["step"]["transient_peak_bytes"])


def test_variant_and_skip_records():
    rec = dryrun.run_cell("yi-34b", "long_500k", "single")
    assert rec == {"arch": "yi-34b", "shape": "long_500k", "mesh": "single",
                   "status": "skipped", "reason": shapes.runnable(
                       configs.get("yi-34b"), "long_500k")[1]}
    cfg = dryrun._variant_cfg(configs.get("stablelm-1.6b"), "combo:q1_7_int+kvq")
    assert cfg.quant == "q1_7_int" and cfg.kv_cache_quant is True
    assert dryrun._variant_cfg(cfg, None) is cfg


def test_main_snn_cells_caching_and_force(tmp_path, capsys):
    out = str(tmp_path)
    dryrun.main(["--arch", "collision-snn", "--outdir", out])
    for mesh, chips in (("single", 256), ("multi", 512)):
        with open(os.path.join(out, f"collision-snn__train__{mesh}.json")) as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["chips"] == chips
        assert rec["memory"]["step"]["batch_per_device"] == 16384 // (
            16 if mesh == "single" else 32)
        assert rec["cost"]["flops_global"] > 0
    argv = ["--arch", "mamba2-130m", "--shape", "long_500k", "--mesh",
            "single", "--outdir", out]
    dryrun.main(argv)
    path = dryrun.cell_path(out, "mamba2-130m", "long_500k", "single", None)
    with open(path) as f:
        assert json.load(f)["status"] == "ok"
    os.utime(path, (0, 0))
    capsys.readouterr()
    dryrun.main(argv)  # cached: kept
    assert "[skip cached]" in capsys.readouterr().out
    assert os.stat(path).st_mtime == 0
    dryrun.main(argv + ["--force"])
    assert os.stat(path).st_mtime > 0
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "long_500k",
                 "--outdir", out, "--tag", "t"])
    for mesh in ("single", "multi"):
        with open(dryrun.cell_path(out, "stablelm-1.6b", "long_500k", mesh,
                                   "t")) as f:
            assert json.load(f)["status"] == "skipped"


def test_cli_process_stays_small_and_loads_no_jax(tmp_path):
    """A 34B model's decode cell in a process of its own: no JAX, no
    reference package, and a peak RSS far below the params' bytes."""
    code = (
        "import resource, sys\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'yi-34b', '--shape', 'decode_32k', "
        f"'--mesh', 'single', '--outdir', {str(tmp_path)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('maxrss_kb', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rss = int(out.stdout.split("maxrss_kb")[-1]) * 1024
    params = Model(configs.get("yi-34b")).param_count() * 4
    assert rss < 4e9 and rss < params / 30
    with open(dryrun.cell_path(str(tmp_path), "yi-34b", "decode_32k",
                               "single", None)) as f:
        rec = json.load(f)
    assert rec["status"] == "ok"
    assert rec["memory"]["resident_per_device"]["params"] < params / 16


def test_decode_cell_writes_its_cache_in_place():
    cfg = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                              kv_cache_quant=True)
    sp = shapes.ShapeSpec("decode_4x64", 64, 4, "decode")
    kind, fn, trees = dryrun.build_step(cfg, sp)
    assert kind == "decode"
    run = dryrun.count_step(fn, trees)
    # the cache is the step's input, written in place: nothing of its
    # size is left behind
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(trees["cache"]))
    assert run["end_bytes"] - run["start_bytes"] < cache_bytes / 4
    assert all(t.device.type == "meta" for t in tree_leaves(trees))
