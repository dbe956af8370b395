"""The two training cells at a tiny size on the CPU: a sound run is
correct, its step time covers the whole window, and each fault a
training cell can have, planted under the timed path, turns ``correct``
false."""

import pytest

import pb_tiny

CELLS = ["stablelm-train-b2-s4096", "snn-train-dvs-b256"]
STEP_MS = {"stablelm-train-b2-s4096": "train_step_ms",
           "snn-train-dvs-b256": "snn_train_step_ms"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(tmp_path_factory.mktemp("pb_train"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_over_the_whole_window(root, cell):
    res, checks = pb_tiny.run(root, cell, seconds=0.3)
    assert res["correct"], checks
    m = res["metrics"]
    name = STEP_MS[cell]
    assert set(m) == {name, "setup_s"}
    steps = res["attempted"]
    # every step the window ran, and all of its time: at least the
    # window's seconds over its steps
    assert steps >= 1 and res["failed"] == 0
    assert m[name]["value"] * steps >= 0.3e3


def _state_unchanged(monkeypatch):
    from repro_torch.train import loop

    monkeypatch.setattr(loop, "update_into",
                        lambda opt, grads, state, params, out: None)


def _half_the_batch(monkeypatch):
    from repro_torch.models import model
    from repro_torch.sparse_train import trainer

    for cls in (model.Model, trainer.EventSNNModel):
        real = cls.loss

        def loss(self, params, batch, real=real):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return real(self, params, half)

        monkeypatch.setattr(cls, "loss", loss)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_batch],
                         ids=["state_unchanged", "half_the_batch"])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch,
                                                      cell, plant):
    plant(monkeypatch)
    res, checks = pb_tiny.run(root, cell, seconds=0.2)
    assert not res["correct"], checks


@pytest.mark.parametrize("within_rounding", [True, False])
def test_the_judge_follows_a_flip_only_within_float32_rounding(
        root, monkeypatch, within_rounding):
    """A program whose step-1 gradient is the reference's with one hidden
    crossing on its threshold's other side reads as the reference where
    float32's sum order could decide that crossing either way, and as
    far off as it is where it could not."""
    import torch

    from portbench import registry

    drv = registry.driver("snn_train", root)
    bench = registry.load_benchmark(registry.ROOT.parent / "BENCHMARK.json")
    w = registry.cell(bench, "snn-train-dvs-b256")
    cfg = registry.config(w["config"], root)
    mix = registry.traffic(w["traffic"], root)
    dev = torch.device("cpu")
    # every crossing counts as near its threshold while the flip is chosen
    monkeypatch.setattr(drv, "KAPPA", 1e12)
    monkeypatch.setattr(drv, "MAX_CROSSINGS", 10**6)
    full = drv.reference(cfg, mix, 5, dev)
    flipped = raw = None
    for a in full["crossings"]:
        g = full["variant"]([a])
        prog = dict(full, grads=g)
        raw = drv.readings(prog, dict(full, crossings=[]))["first_grad_diff"]
        if raw > 1e-3:
            flipped = a
            break
    assert flipped is not None
    monkeypatch.setattr(drv, "KAPPA", 1e12 if within_rounding else 1e-12)
    ref = drv.reference(cfg, mix, 5, dev)
    g = full["variant"]([flipped])
    got = drv.readings(dict(ref, grads=g, grad={
        n: float(torch.linalg.vector_norm(v)) for n, v in g.items()}), ref)
    if within_rounding:
        assert flipped in ref["crossings"]
        assert got["first_grad_diff"] <= 1e-6 < got["first_grad_diff_raw"]
        assert got["grad_norm_gap"] <= 1e-6
    else:
        assert ref["crossings"] == []
        assert got["first_grad_diff"] == got["first_grad_diff_raw"] == raw
