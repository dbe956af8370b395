"""The DeepSeek serving cell's per-layer readers on hand-built ``ctx``es:
an inner phase's marker pairs summed within each decode pair, pairs
outside a decode step (in a prefill) left out, None where the markers
are not (a program without them); the expert load's max over mean."""

import pytest

from portbench import phases, registry

MS = 1_000_000  # ns


def _read(name, ctx):
    return registry.metric_reader(name).read(ctx)


def _pair(phase, b, e):
    return [(f"{phases.PREFIX}{phase}_begin", b, 1000),
            (f"{phases.PREFIX}{phase}_end()", e - 1000, 1000)]


def _trace(inner):
    """A prefill of 10 ms holding one ``inner`` pair of 4 ms, then two
    decode steps of 10 ms, each holding two ``inner`` pairs of 1 and 2 ms."""
    ks = _pair("prefill", 0, 10 * MS) + _pair(inner, 2 * MS, 6 * MS)
    for t in (20 * MS, 40 * MS):
        ks += _pair("decode", t, t + 10 * MS)
        ks += _pair(inner, t + 1 * MS, t + 2 * MS)
        ks += _pair(inner, t + 5 * MS, t + 7 * MS)
    ks.append(("sm90_xmma_gemm", 3 * MS, MS))
    return {"kernels": sorted(ks, key=lambda k: k[1]), "busy_s": 1.0,
            "window_s": 1.0}


@pytest.mark.parametrize("name,inner", [("dsv2_decode.moe_ms", "moe"),
                                        ("dsv2_decode.mla_ms", "mla")])
def test_inner_pairs_are_summed_within_each_decode_step(name, inner):
    assert _read(name, {"trace": _trace(inner)}) == pytest.approx(3.0)
    other = {"moe": "mla", "mla": "moe"}[inner]
    assert _read(name, {"trace": _trace(other)}) is None
    no_decode = _trace(inner)
    no_decode["kernels"] = [k for k in no_decode["kernels"]
                            if "decode" not in k[0]]
    assert _read(name, {"trace": no_decode}) is None
    assert _read(name, {"trace": None}) is None and _read(name, {}) is None


def test_expert_load_is_the_busiest_over_the_mean():
    name = "dsv2_decode.expert_load_max_over_mean"
    assert _read(name, {"dsv2_decode": {"expert_pairs": [10, 20, 30]}}) \
        == pytest.approx(1.5)
    assert _read(name, {"dsv2_decode": {"expert_pairs": [0, 0]}}) is None
    assert _read(name, {}) is None
