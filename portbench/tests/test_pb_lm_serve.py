"""The LM serving cell at a tiny size on the CPU: a sound run is correct
and counts whole batches over the whole window, and each fault the cell
can have, planted under the timed path, turns ``correct`` false."""

import pytest
import torch

import pb_tiny

CELL = "stablelm-serve-b32-p1024"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(tmp_path_factory.mktemp("pb_lm_serve"))


def test_sound_run_is_correct_over_whole_batches(root):
    res, checks = pb_tiny.run(root, CELL, seconds=0.3)
    assert res["correct"], checks
    mix = pb_tiny.TINY_TRAFFIC["lm_serve"]
    assert res["attempted"] % mix["batch"] == 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"decode_tokens_per_s", "setup_s"}
    tokens = res["attempted"] * mix["new_tokens"]
    # the window's tokens over at least its seconds
    assert res["metrics"]["decode_tokens_per_s"]["value"] <= tokens / 0.3


def _cache_unchanged(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_write_rows", lambda *a, **k: None)


def _half_the_batch(monkeypatch):
    from repro_torch.serving import engine

    real = engine.ServeEngine._generate_batch

    def generate(self, reqs):
        half = real(self, reqs[: max(1, len(reqs) // 2)])
        return (half * 2)[: len(reqs)]

    monkeypatch.setattr(engine.ServeEngine, "_generate_batch", generate)


def _token_altered(monkeypatch):
    from repro_torch.serving import engine

    real = engine.ServeEngine._sample

    def sample(self, logits, temps, any_sampling):
        tok = real(self, logits, temps, any_sampling)
        return torch.remainder(tok + 1, logits.shape[-1])

    monkeypatch.setattr(engine.ServeEngine, "_sample", sample)


@pytest.mark.parametrize("plant", [_cache_unchanged, _half_the_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_the_batch",
                              "token_altered"])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch,
                                                      plant):
    plant(monkeypatch)
    res, checks = pb_tiny.run(root, CELL, seconds=0.2)
    assert not res["correct"], checks
