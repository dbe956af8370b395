"""The readers of the program's phase markers, each on a hand-built
``ctx``: the right number where marker pairs are, None where they are not
(a program without the markers)."""

import pytest

from portbench import phases, registry

MS = 1_000_000  # ns


def _read(name, ctx):
    return registry.metric_reader(name).read(ctx)


def _marks(phase, pairs, other=()):
    """Kernels of a trace: ``phase``'s markers around (begin, end) ns, a
    product kernel between each pair, and ``other`` kernels."""
    ks = []
    for b, e in pairs:
        ks.append((f"{phases.PREFIX}{phase}_begin", b, 2000))
        ks.append(("sm90_xmma_gemm", b + 2000, e - b - 4000))
        ks.append((f"{phases.PREFIX}{phase}_end()", e - 2000, 2000))
    return {"kernels": sorted(ks + list(other), key=lambda k: k[1]),
            "busy_s": 1.0, "window_s": 1.0}


@pytest.mark.parametrize("name,phase", [
    ("lm_decode.prefill_ms", "prefill"),
    ("lm_decode.decode_step_ms", "decode"),
    ("lm_train.optimizer_ms", "update"),
    ("snn_train.optimizer_ms", "update"),
])
def test_marker_readers_pair_begin_and_end(name, phase):
    trace = _marks(phase, [(0, 10 * MS), (20 * MS, 24 * MS)])
    assert _read(name, {"trace": trace}) == pytest.approx(7.0)
    # a pair cut by the window's edges counts only where whole
    cut = _marks(phase, [(0, 10 * MS)])
    cut["kernels"] = ([(f"{phases.PREFIX}{phase}_end", -MS, 2000)]
                      + cut["kernels"]
                      + [(f"{phases.PREFIX}{phase}_begin", 30 * MS, 2000)])
    assert _read(name, {"trace": cut}) == pytest.approx(10.0)
    # another phase's markers are not this one's
    others = {"prefill": "decode", "decode": "update", "update": "prefill"}
    assert _read(name, {"trace": _marks(others[phase], [(0, MS)])}) is None
    assert _read(name, {"trace": None}) is None
    assert _read(name, {}) is None
