"""The port's dry-run shapes (``repro_torch.launch.shapes``) against the
reference's ``repro.launch.shapes``: the skip policy, every cell's input
specs and the decode cache, all on ``meta``."""

import jax
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import shapes as ref_shp
from repro_torch import configs
from repro_torch.launch import shapes as shp
from repro_torch.tree import tree_leaves


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_long500k_skip_policy():
    skips = {a: shp.runnable(configs.get(a), "long_500k")[0]
             for a in configs.ARCH_IDS}
    assert skips["mamba2-130m"] is True  # SSM
    assert skips["recurrentgemma-2b"] is True  # hybrid
    assert skips["mixtral-8x7b"] is True  # SWA
    for full_attn in ("yi-34b", "stablelm-1.6b", "codeqwen1.5-7b",
                      "minicpm3-4b", "phi-3-vision-4.2b", "musicgen-medium",
                      "granite-moe-1b-a400m"):
        assert skips[full_attn] is False, full_attn
    for a in configs.ARCH_IDS:
        for s in shp.SHAPES:
            assert (shp.runnable(configs.get(a), s)
                    == ref_shp.runnable(ref_configs.get(a), s)), (a, s)


def test_shapes_table_is_the_reference_table():
    assert list(shp.SHAPES) == list(ref_shp.SHAPES)
    for name, sp in shp.SHAPES.items():
        ref = ref_shp.SHAPES[name]
        assert (sp.name, sp.seq_len, sp.global_batch, sp.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("shape", list(shp.SHAPES))
def test_input_specs_shapes(shape):
    cfg = configs.get("stablelm-1.6b")
    kind, inputs, axes = shp.batch_specs(cfg, shape)
    sp = shp.SHAPES[shape]
    if kind == "train":
        assert inputs["tokens"].shape == (sp.global_batch, sp.seq_len)
        assert inputs["tokens"].dtype == torch.int32
    elif kind == "decode":
        assert inputs["token"].shape == (sp.global_batch, 1)
        assert inputs["pos"].shape == (sp.global_batch,)
    assert set(inputs) == set(axes)
    assert all(t.device.type == "meta" for t in inputs.values())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    for shape in shp.SHAPES:
        kind, inputs, axes = shp.batch_specs(configs.get(arch), shape)
        rkind, rinputs, raxes = ref_shp.batch_specs(ref_configs.get(arch),
                                                    shape)
        assert kind == rkind and axes == raxes
        assert list(inputs) == list(rinputs)
        for k, t in inputs.items():
            assert tuple(t.shape) == tuple(rinputs[k].shape), (arch, shape, k)
            assert _dtype_name(t.dtype) == str(rinputs[k].dtype), (arch, k)


def test_vlm_input_specs_include_image_embeds():
    cfg = configs.get("phi-3-vision-4.2b")
    _, inputs, axes = shp.batch_specs(cfg, "train_4k")
    assert "img_embeds" in inputs
    assert inputs["img_embeds"].shape == (256, 576, 1024)
    assert inputs["img_embeds"].dtype == torch.bfloat16
    assert axes["img_embeds"] == ("batch", "act_seq", "clip")
    # text + image positions == assigned seq_len
    assert inputs["tokens"].shape[1] + 576 == 4096


def test_audio_input_specs_have_codebooks():
    cfg = configs.get("musicgen-medium")
    _, inputs, axes = shp.batch_specs(cfg, "train_4k")
    assert inputs["tokens"].shape == (256, 4096, 4)
    assert axes["tokens"] == ("batch", "act_seq", "codebook")


def test_abstract_cache_no_allocation():
    cfg = configs.get("mixtral-8x7b")
    cache = shp.abstract_cache(cfg, "long_500k")
    leaves = tree_leaves(cache)
    assert leaves and all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                          for t in leaves)
    # SWA ring cache is bounded by the window, not 500k
    k = cache["main"]["b0"]["k"]
    assert k.shape[2] == cfg.window
    ref = ref_shp.abstract_cache(ref_configs.get("mixtral-8x7b"), "long_500k")
    assert tuple(k.shape) == tuple(ref["main"]["b0"]["k"].shape)
    assert isinstance(jax.tree_util.tree_leaves(ref)[0], jax.ShapeDtypeStruct)


def test_shape_spec_of_its_own():
    cfg = configs.get("stablelm-1.6b")
    sp = shp.ShapeSpec("train_4x128", 128, 4, "train")
    kind, inputs, _ = shp.batch_specs(cfg, sp)
    assert kind == "train" and inputs["targets"].shape == (4, 128)
    assert shp.runnable(cfg, sp) == (True, "")
