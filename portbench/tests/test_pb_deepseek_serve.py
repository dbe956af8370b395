"""The DeepSeek-V2 serving cell at a tiny size on the CPU: a sound run is
correct and reports its metrics, a program without the DeepSeek-V2
layers stops in set-up with no result, and each fault planted under the
timed path turns ``correct`` false."""

import pytest

import pb_tiny

CELL = "deepseek-v2-lite-serve-b128-p1024-n512"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(tmp_path_factory.mktemp("pb_dsv2"))


def test_sound_run_is_correct_and_reports_its_metrics(root):
    res, checks = pb_tiny.run(root, CELL, seconds=0.3)
    assert res["correct"], checks
    assert checks["served_logit_gap"]["value"] < 1e-3
    assert checks["moe_routed_gap"]["value"] < 1e-4
    mix = pb_tiny.TINY_TRAFFIC["lm_serve_deepseek"]
    assert res["attempted"] % mix["batch"] == 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"decode_tokens_per_s", "setup_s"}


def test_traced_run_reads_the_expert_counter(root):
    """On the CPU no marker is launched, so the phase metrics are silent;
    the routed-pairs counter is read."""
    res, _ = pb_tiny.run(root, CELL, seconds=0.3, trace=True)
    got = res["metrics"]
    assert got["dsv2_decode.expert_load_max_over_mean"]["value"] >= 1.0
    assert not {"dsv2_decode.moe_ms", "dsv2_decode.mla_ms",
                "lm_decode.decode_step_ms"} & set(got)


def test_a_program_without_the_layers_stops_at_once(monkeypatch):
    from portbench import registry

    drv = registry.driver("lm_serve_deepseek")
    monkeypatch.setattr(drv, "NEEDS", drv.NEEDS + ("no_such_field",))
    with pytest.raises(SystemExit, match="no result"):
        drv.model_config(registry.config("deepseek-v2-lite"))


def _cache_unchanged():
    from repro_torch.models import attention

    real = attention._write_rows
    attention._write_rows = lambda *a, **k: None
    return lambda: setattr(attention, "_write_rows", real)


def _plant(name):
    from portbench import registry

    return {"state_unchanged": _cache_unchanged,
            **registry.driver("lm_serve_deepseek").FAULTS}[name]


@pytest.mark.parametrize("fault", ["routed_dropped", "experts_permuted",
                                   "share_misplaced", "state_unchanged"])
def test_a_fault_under_the_timed_path_is_not_correct(root, fault):
    undo = _plant(fault)()
    try:
        res, checks = pb_tiny.run(root, CELL, seconds=0.2)
    finally:
        undo()
    assert not res["correct"], checks
    if fault != "state_unchanged":
        # read by the held experts' own comparison, whether or not the
        # fault moves the served tokens
        assert checks["moe_routed_gap"]["value"] > 0.5, checks


def test_a_nan_gap_is_never_lost():
    import math

    from portbench import registry

    widest = registry.driver("lm_serve_deepseek")._widest
    assert widest(0.5, float("nan")) == math.inf
    assert widest(0.5, 0.25) == 0.5
