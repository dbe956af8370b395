"""The port's partitioning rules (``repro_torch.distributed.partitioning``)
against the reference's: the reference's own cases ported onto the
port's ``Mesh`` of one device repeated, ``spec_for`` spec for spec over a
seeded grid of shapes, logical axes, meshes and rule overrides,
``cache_logical_axes`` on each arch's reduced decode cache, the serving
engine's slot axis, optimizer-state specs and ``constrain``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as RefP

import repro.configs as ref_configs
from repro.distributed import partitioning as ref_pt
from repro.models.model import Model as RefModel
import repro_torch.configs as configs
from repro_torch.distributed import partitioning as pt
from repro_torch.models.model import Model
from repro_torch.optim.adam import AdamState, SGDState

CPU = torch.device("cpu")


def _mesh(shape, axes):
    return pt.Mesh(np.array([CPU] * int(np.prod(shape))).reshape(shape), axes)


def _ref_mesh(shape, axes):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return RefMesh(devs, axes)


MESH = _mesh((2, 4), ("data", "model"))
POD = _mesh((2, 2, 2), ("pod", "data", "model"))
MESHES = {
    "data2_model4": ((2, 4), ("data", "model")),
    "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
    "one": ((1,), ("data",)),
}
OVERRIDES = {
    "default": {},
    "seq_parallel": {"act_seq": ("data",)},
    "heads_unsharded": {"heads": (), "batch": ("data",)},
}
LOGICAL = sorted(pt.DEFAULT_RULES) + ["not_a_rule"]


# ---------------------------------------- the reference's own cases
def test_basic_tp_fsdp_spec():
    spec = pt.spec_for((64, 16, 128), ("embed", "heads", "head_dim"), MESH)
    assert spec == pt.P("data", "model")


def test_divisibility_fallback_replicates():
    # 7 heads not divisible by model=4 -> replicated
    spec = pt.spec_for((64, 7, 128), ("embed", "heads", "head_dim"), MESH)
    assert spec == pt.P("data")


def test_axis_never_used_twice():
    # expert and mlp both want "model"; expert wins (first dim)
    spec = pt.spec_for((8, 64, 32), ("expert", "embed", "mlp"), MESH)
    assert spec == pt.P("model", "data")


def test_batch_uses_pod_and_data():
    spec = pt.spec_for((32, 128), ("batch", "act_seq"), POD)
    assert spec == pt.P(("pod", "data"))


def test_batch_prefix_fallback():
    # batch=2 divisible by pod(2) but not pod*data(4) -> prefix ("pod",)
    spec = pt.spec_for((2, 128), ("batch", "act_seq"), POD)
    assert spec == pt.P("pod")


def test_batch_one_replicated():
    spec = pt.spec_for((1, 128), ("batch", "act_seq"), POD)
    assert spec == pt.P()


def test_rules_override():
    rules = pt.PartitionRules().override(act_seq=("data",))
    spec = pt.spec_for((4, 64), ("batch", "act_seq"), MESH, rules)
    # batch falls back: 4 % data(2) == 0 -> data taken; act_seq wants data
    # but it is used -> replicated
    assert spec == pt.P("data")


def test_cache_logical_axes_detects_stacked_layers():
    shapes = {"main": {"b0": {
        "k": torch.empty((4, 2, 8, 2, 16), device="meta"),
        "v": torch.empty((4, 2, 8, 2, 16), device="meta"),
    }}}
    axes = pt.cache_logical_axes(shapes)
    assert axes["main"]["b0"]["k"] == (
        "layers", "batch", "seq", "kv", "head_dim",
    )


def test_tree_specs_on_param_tree():
    shapes = {"w": torch.empty((64, 16, 32), device="meta")}
    axes = {"w": ("embed", "heads", "head_dim")}
    specs = pt.tree_specs(shapes, axes, MESH)
    assert specs["w"] == pt.P("data", "model")
    shard = pt.tree_shardings(shapes, axes, MESH)["w"]
    assert shard.spec == specs["w"] and shard.mesh is MESH


def test_constrain_noop_outside_context():
    x = torch.ones((4, 4))
    assert pt.constrain(x, ("batch", "embed_act")) is x


# ------------------------------------------------ against the reference
def _grid(seed, n=150):
    """Seeded (shape, logical axes) pairs: 1-4 dims, each a divisor-rich
    or awkward size, each named by any rule (or none, or no rule)."""
    rng = np.random.default_rng(seed)
    sizes = [1, 2, 3, 4, 6, 7, 8, 12, 16, 56, 64]
    out = []
    for _ in range(n):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(sizes)) for _ in range(nd))
        axes = tuple(None if rng.random() < 0.15
                     else str(rng.choice(LOGICAL)) for _ in range(nd))
        out.append((shape, axes))
    return out


@pytest.mark.parametrize("override", sorted(OVERRIDES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_equals_the_reference(mesh, override):
    shape_m, axes_m = MESHES[mesh]
    port_mesh, ref_mesh = _mesh(shape_m, axes_m), _ref_mesh(shape_m, axes_m)
    port_rules = pt.PartitionRules().override(**OVERRIDES[override])
    ref_rules = ref_pt.PartitionRules().override(**OVERRIDES[override])
    assert port_rules.table == ref_rules.table
    for shape, axes in _grid(sorted(MESHES).index(mesh) * 10
                             + sorted(OVERRIDES).index(override)):
        got = pt.spec_for(shape, axes, port_mesh, port_rules)
        want = ref_pt.spec_for(shape, axes, ref_mesh, ref_rules)
        assert tuple(got) == tuple(want), (shape, axes)
        assert got == want and RefP(*got) == want


def test_rule_table_is_the_reference_table():
    assert pt.DEFAULT_RULES == ref_pt.DEFAULT_RULES
    assert pt._CACHE_LEAF_AXES == ref_pt._CACHE_LEAF_AXES


def test_spec_compares_as_jax_does():
    pairs = [(("a",), (("a",),)), (("a", None), ("a",)), ((), ()),
             ((("a", "b"),), (("a", "b"),)), ((None,), ()),
             (("a", ("b", "c")), ("a", ("b", "c")))]
    for x, y in pairs:
        assert (pt.P(*x) == pt.P(*y)) == (RefP(*x) == RefP(*y)), (x, y)
        assert (pt.P(*x) == tuple(y)) == (RefP(*x) == tuple(y)), (x, y)
    assert hash(pt.P(("a",))) == hash(pt.P("a"))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_logical_axes_equal_the_reference(arch):
    """On each arch's reduced decode cache: the same logical axes leaf for
    leaf, and the same specs over a (data, model) mesh."""
    ref_cfg = ref_configs.get(arch).reduced()
    port_cfg = configs.get(arch).reduced()
    ref_cache = RefModel(ref_cfg).abstract_cache(2, 16)
    cache = Model(port_cfg, "cpu").init_cache(2, 16, "meta")
    want = ref_pt.cache_logical_axes(ref_cache)
    got = pt.cache_logical_axes(cache)
    assert got == want
    specs = pt.tree_specs(cache, got, MESH)
    ref_specs = ref_pt.tree_specs(ref_cache, want,
                                  _ref_mesh((2, 4), ("data", "model")))
    flat = jax.tree_util.tree_leaves(
        ref_specs, is_leaf=lambda x: isinstance(x, RefP))
    mine = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, pt.P):
            mine.append(t)
        else:
            for x in t:
                walk(x)

    walk(specs)
    assert [tuple(s) for s in mine] == [tuple(s) for s in flat]


# ------------------------------------------------------ the slot axis
def test_slot_axis_and_its_error():
    assert pt.slot_axis(8, _mesh((4,), ("data",))) == "data"
    assert pt.slot_axis(8, POD) == ("pod", "data")
    assert pt.slot_axis(2, POD) == "pod"
    for n, mesh in ((3, _mesh((2,), ("data",))),
                    (8, _mesh((2,), ("model",))),
                    (1, POD)):
        with pytest.raises(ValueError, match=f"num_slots={n}"):
            pt.slot_axis(n, mesh)
        with pytest.raises(ValueError, match=f"num_slots={n}"):
            ref_pt.slot_axis(n, _ref_mesh(mesh.devices.shape,
                                          mesh.axis_names))
    for n, mesh in ((8, POD), (4, MESH), (2, POD), (6, _mesh((2,), ("data",)))):
        ref = ref_pt.slot_axis(n, _ref_mesh(mesh.devices.shape,
                                            mesh.axis_names))
        assert pt.slot_axis(n, mesh) == ref


def test_named_sharding_indices_and_slot_shards():
    sh = pt.NamedSharding(POD, pt.P(("pod", "data"), "model"))
    # position (pod, data, model) = (1, 0, 1): block 2 of 4 rows, 1 of 2 cols
    assert sh.indices((8, 6), (1, 0, 1)) == (slice(4, 6), slice(3, 6))
    assert sh.indices((8, 6), (0, 1, 0)) == (slice(2, 4), slice(0, 3))
    with pytest.raises(ValueError, match="does not divide"):
        sh.indices((6, 6), (0, 0, 0))
    devs = [torch.device("cpu"), torch.device("meta")]
    mixed = pt.Mesh(np.array(devs * 2).reshape(2, 2), ("data", "model"))
    # each block on the first device of its replica group (model index 0)
    assert pt.slot_shards(4, mixed) == [(0, 2, devs[0]), (2, 4, devs[0])]
    col = pt.Mesh(np.array(devs * 2).reshape(2, 2).T, ("data", "model"))
    assert pt.slot_shards(4, col) == [(0, 2, devs[0]), (2, 4, devs[1])]
    assert pt.replicated(MESH).spec == pt.P()


# --------------------------------------------------- optimizer states
def test_opt_state_specs_on_an_adam_state():
    params = {"w": torch.zeros(64, 16), "b": torch.zeros(16)}
    specs = {"w": pt.P("data", "model"), "b": pt.P("model")}
    state = AdamState(count=torch.zeros((), dtype=torch.int32),
                      mu=dict(params), nu=dict(params))
    got = pt.opt_state_specs(state, specs, MESH)
    assert isinstance(got, AdamState)
    assert got.count == pt.NamedSharding(MESH, pt.P())
    assert got.mu is specs and got.nu is specs
    # the reference on its own AdamState-shaped NamedTuple, same layout
    ref_mesh = _ref_mesh((2, 4), ("data", "model"))
    ref_specs = {"w": RefP("data", "model"), "b": RefP("model")}
    jparams = {k: jax.numpy.zeros(tuple(v.shape)) for k, v in params.items()}
    ref = ref_pt.opt_state_specs(
        AdamState(count=jax.numpy.zeros((), jax.numpy.int32), mu=jparams,
                  nu=jparams), ref_specs, ref_mesh)
    assert tuple(ref.count.spec) == tuple(got.count.spec)
    assert ref.mu is ref_specs and ref.nu is ref_specs
    sgd = pt.opt_state_specs(SGDState(momentum=dict(params)), specs, MESH)
    assert sgd.momentum is specs
    # a state tree that is not shaped like the params replicates leafwise
    odd = pt.opt_state_specs(SGDState(momentum=[params["b"]]), specs, MESH)
    assert odd.momentum == [pt.NamedSharding(MESH, pt.P())]


# ------------------------------------------------- activation placement
def test_constrain_is_the_identity_under_a_context():
    x = torch.arange(12.0).reshape(3, 4)
    with pt.activation_sharding(MESH):
        assert pt._act_ctx.val[0] is MESH
        assert pt.constrain(x, ("batch", "embed_act")) is x
        with pt.activation_sharding(POD, pt.PartitionRules()):
            assert pt._act_ctx.val[0] is POD
        assert pt._act_ctx.val[0] is MESH
    assert getattr(pt._act_ctx, "val", None) is None
    assert pt.constrain(x, ("batch",)) is x


def test_mesh_validates_its_axes():
    with pytest.raises(ValueError, match="axis names"):
        pt.Mesh([CPU, CPU], ("data", "model"))
    with pytest.raises(ValueError, match="repeat"):
        pt.Mesh(np.array([CPU] * 4).reshape(2, 2), ("data", "data"))
    m = pt.Mesh(["cpu", "cpu"], ("data",))
    assert m.shape == {"data": 2} and m.size == 2
    assert all(isinstance(d, torch.device) for d in m.devices.ravel())
    assert dataclasses.is_dataclass(pt.NamedSharding(m, pt.P()))
