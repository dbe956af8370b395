"""The harness's arithmetic: exact tails, histogram deltas, the trace's
reduction, the import guard, and the operation and byte counts."""

import sys

import pytest

from portbench import harness
from portbench.frozen import bounds


def test_p95_is_exact_over_all_requests_and_a_stall_moves_it():
    lat = [0.010] * 100
    assert harness.nearest_rank(lat, 95) == 0.010
    stalled = list(lat)
    for i in range(90, 100):  # a stall holds the last ten answers
        stalled[i] = 0.250
    assert harness.nearest_rank(stalled, 95) == 0.250
    assert harness.nearest_rank(list(range(1, 101)), 95) == 95
    assert harness.nearest_rank([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        harness.nearest_rank([], 95)


def test_histogram_delta_reads_the_window_alone():
    from repro_torch.obs.metrics import Histogram

    h, fresh = Histogram("h", lo=1e-6, hi=1e3), Histogram("f", lo=1e-6,
                                                          hi=1e3)
    for v in (0.5, 0.6, 7.0):  # before the window
        h.record(v)
    before = h.snapshot()
    window = [0.001 * (i + 1) for i in range(200)]
    for v in window:
        h.record(v)
        fresh.record(v)
    d = harness.histogram_delta(before, h.snapshot())
    assert d["count"] == 200 and d["sum"] == pytest.approx(sum(window))
    # the program's own estimate also clamps to the values' min and max,
    # which a delta does not know: the two agree within one bucket
    ratio = 10.0 ** (1.0 / d["buckets_per_decade"])
    for q in (50, 95, 99):
        got, want = harness.histogram_percentile(d, q), fresh.percentile(q)
        assert want / ratio <= got <= want * ratio
    empty = harness.histogram_delta(before, before)
    assert harness.histogram_percentile(empty, 95) is None


class _Ev:
    def __init__(self, name, start, dur, kind):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k


def test_trace_reduction_counts_overlap_once_and_names_gaps():
    evs = [
        _Ev("pb.window", 0, 1_000, "user_annotation"),
        _Ev("pb.measured", 100, 800, "user_annotation"),
        _Ev("pb.poll", 100, 300, "user_annotation"),
        _Ev("pb.submit", 500, 200, "user_annotation"),
        _Ev("k1", 150, 100, "kernel"),
        _Ev("k2", 200, 100, "kernel"),  # overlaps k1: 150..300 busy
        _Ev("Memcpy HtoD", 600, 50, "gpu_memcpy"),
        _Ev("k1", 950, 10, "kernel"),  # outside the measured window
        _Ev("aten::mm", 120, 10, "cpu_op"),
    ]
    r = harness.reduce_trace(evs)
    assert r["window_s"] == pytest.approx(800e-9)
    assert r["busy_s"] == pytest.approx(200e-9)  # 150..300 and 600..650
    assert [k[0] for k in r["kernels"]] == ["k1", "k2", "Memcpy HtoD"]
    # a gap is named by what the host was in where it starts: 100..150
    # and 300..600 start in poll, 650..900 in submit
    assert dict(r["idle_gaps"]) == {"poll": pytest.approx(350e-9),
                                    "submit": pytest.approx(250e-9)}
    assert harness.kernel_stats(r, "k") == (2, pytest.approx(200e-9))
    assert harness.kernel_stats(r, "nothing") is None
    assert harness.kernel_stats(None, "k") is None


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    fine = ["repro_torch", "repro_torch.serving", "reproducible",
            "jaxtyping", "flaxen.x", "torch"]
    assert harness.forbidden_loaded(fine) == []
    assert harness.forbidden_loaded(fine + ["repro.core", "jax.numpy",
                                            "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]
    # by default it reads the process's own modules
    monkeypatch.setitem(sys.modules, "repro.planted", object())
    assert "repro" in harness.forbidden_loaded()


def test_operation_and_byte_counts_at_hand_computed_shapes():
    # 2 events on 2 W0 rows of a (4, 3, 2) net, one slot, one step
    got = bounds.snn_chunk_bytes(1, 1, (4, 3, 2), events=2, w0_rows=2)
    want = (2 * 3 * 4  # W0 rows
            + 3 * 2 * 4  # W1
            + 3 * 5 * 4  # bias, beta, threshold
            + 2 * 3  # events
            + 1 * 1 * 4 + 1 * 4  # counts, active
            + 2 * 1 * 5 * 8  # state in and out
            + 2 * 1 * 1 * 2 * 4 + 1 * 2 * 1 * 4)  # mem, spk, events
    assert got == want
    assert bounds.snn_forward_flops((4, 3, 2), 2, [5, 1]) == (
        2 * 5 * 3 + 2 * 1 * 2 + 4 * 2 * 5)
    assert bounds.snn_train_flops((4, 3, 2), 2, 3, [5, 1]) == (
        bounds.snn_forward_flops((4, 3, 2), 6, [5, 1])
        + 2 * 4 * 3 * 6 + 2 * 2 * 3 * 2 * 6)
    assert bounds.causal_pairs(1, 4) == 10
    assert bounds.causal_pairs(2, 3) == 12
    # one layer, E 4, 2 heads of 2, kv 2, ff 8, vocab 5
    assert bounds.lm_matmul_params(4, 2, 2, 2, 8, 1, 5) == (
        4 * 6 * 2 + 4 * 4 + 3 * 4 * 8 + 4 * 5)
    assert bounds.lm_forward_flops(3, 6, 4, 2, 2, 2, 8, 1, 5) == (
        2 * 3 * bounds.lm_matmul_params(4, 2, 2, 2, 8, 1, 5) + 4 * 2 * 2 * 6)
    assert bounds.aer_gather_bytes(3, 4, 5, 2) == 3 * 4 * 4 + 5 * 8 + 2 * 4 * 4


def test_the_aer_bound_counts_each_w0_row_once_a_step():
    """Layer 0's rows are counted once a training step, however many time
    steps or recordings touch them: its inputs need no earlier state."""
    import torch

    from portbench import registry

    spikes = torch.zeros((2, 3, 5))  # (B, T, K)
    spikes[0, 0, 1] = 1.0
    spikes[1, 0, 1] = -1.0  # row 1 again, another recording
    spikes[0, 1, 1] = 1.0  # row 1 again, another time step
    spikes[1, 2, 3] = 1.0
    got = registry.driver("snn_train").events_and_rows({"spikes": spikes})
    assert got == {"events0": 4.0, "rows0": 2.0}


def test_shares_need_device_time_and_stay_within_their_peaks():
    from portbench import registry

    roof = registry.metric_reader("snn_chunk_roofline")
    mfu = registry.metric_reader("snn.mfu_pct")
    ctx = {"snn_serve": {"bytes_per_launch": 3.35e6, "flops": 67e9},
           "window_s": 2.0,
           "trace": {"kernels": [("snn_chunk_kernel", 0, 4000),
                                 ("snn_chunk_kernel", 0, 6000)],
                     "busy_s": 1e-5, "window_s": 2.0}}
    # 3.35 MB at 3.35 TB/s is 1 us; the mean launch took 5 us
    assert roof.read(ctx) == pytest.approx(20.0)
    assert mfu.read(ctx) == pytest.approx(0.05)
    for reader in (roof, mfu):
        assert reader.read(dict(ctx, trace=None)) is None
    cpu = dict(ctx, trace={"kernels": [], "busy_s": 0.0, "window_s": 2.0})
    assert roof.read(cpu) is None and mfu.read(cpu) is None
