"""The port's token stream (``repro_torch.data.tokens``) and gradient
compression (``repro_torch.distributed.compression``) against the
reference's on the CPU: the stream's batches array for array for every
(seed, host_id, num_hosts) tried, int8 codes, scales and error-feedback
residuals bit for bit on the same float32 arrays; the reference's own
cases of both modules, ported."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.data import tokens as ref_tokens
from repro.distributed import compression as ref_compression
from repro_torch.data import tokens
from repro_torch.distributed import compression
from repro_torch.optim import adam, sgd
from repro_torch.optim.adam import apply_updates
from repro_torch.tree import tree_leaves, tree_map


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------------ tokens
STREAMS = [  # (vocab, seq, batch, seed, host_id, num_hosts)
    (97, 32, 2, 0, 0, 1),
    (97, 32, 2, 0, 1, 2),
    (32000, 16, 4, 3, 0, 2),
    (100352, 8, 3, 7, 5, 8),
    (2048, 64, 1, 1, 0, 1),
]


@pytest.mark.parametrize("case", STREAMS, ids=str)
def test_markov_stream_equals_the_reference_array_for_array(case):
    vocab, seq, batch, seed, host, hosts = case
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed,
              host_id=host, num_hosts=hosts)
    port = tokens.MarkovTokenStream(tokens.TokenStreamConfig(**kw)).batches()
    ref = ref_tokens.MarkovTokenStream(
        ref_tokens.TokenStreamConfig(**kw)).batches()
    for _ in range(3):
        (x, y), (rx, ry) = next(port), next(ref)
        assert x.dtype == rx.dtype and y.dtype == ry.dtype
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])


@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_equals_the_reference(seed):
    x, y = tokens.make_batch(50, 3, 12, seed=seed)
    rx, ry = ref_tokens.make_batch(50, 3, 12, seed=seed)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def test_markov_stream_host_sharding():
    c0 = tokens.TokenStreamConfig(vocab_size=97, seq_len=32, batch_size=2,
                                  host_id=0, num_hosts=2)
    c1 = tokens.TokenStreamConfig(vocab_size=97, seq_len=32, batch_size=2,
                                  host_id=1, num_hosts=2)
    x0, _ = next(tokens.MarkovTokenStream(c0).batches())
    x1, _ = next(tokens.MarkovTokenStream(c1).batches())
    assert not np.array_equal(x0, x1)  # disjoint host feeds
    assert x0.max() < 97


def test_markov_stream_is_learnable_structure():
    """Transitions are deterministic 85% of the time -> entropy below
    uniform; a model can learn it (used by the train-loop tests)."""
    cfg = tokens.TokenStreamConfig(vocab_size=31, seq_len=512, batch_size=1)
    x, y = next(tokens.MarkovTokenStream(cfg).batches())
    pairs = {}
    for a, b in zip(x[0], y[0]):
        pairs.setdefault(int(a), []).append(int(b))
    agree = [
        max(np.bincount(v).max() / len(v), 0)
        for v in pairs.values() if len(v) >= 5
    ]
    assert np.mean(agree) > 0.6


# ------------------------------------------------------------- compression
def _arrays(kind):
    rng = np.random.default_rng(11)
    if kind == "normal":
        return rng.normal(0, 1, (257,)).astype(np.float32)
    if kind == "tiny":
        return (rng.normal(0, 1, (64, 3)) * 1e-5).astype(np.float32)
    if kind == "wide":
        return (rng.normal(0, 1, (33, 17))
                * 10.0 ** rng.integers(-6, 4, (33, 17))).astype(np.float32)
    if kind == "zeros":
        return np.zeros((8,), np.float32)
    # halves of the scale: values that land on .5 steps of the grid
    return (np.arange(-20, 21, dtype=np.float32) * 0.5) / 20.0


KINDS = ["normal", "tiny", "wide", "zeros", "half_steps"]


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_int8_codes_and_scales_bit_exact(kind):
    x = _arrays(kind)
    codes, scale = compression.quantize_int8(torch.from_numpy(x))
    rcodes, rscale = ref_compression.quantize_int8(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), _np(rcodes))
    assert scale.numpy().tobytes() == _np(rscale).astype(np.float32).tobytes()
    back = compression.dequantize_int8(codes, scale).numpy()
    rback = _np(ref_compression.dequantize_int8(rcodes, rscale))
    assert back.tobytes() == rback.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_compress_tree_deq_and_residual_bit_exact(kind):
    rng = np.random.default_rng(3)
    g = {"a": _arrays(kind), "b": {"w": rng.normal(0, 1e-3, (5, 4))
                                        .astype(np.float32)}}
    e = {"a": (rng.normal(0, 1e-3, g["a"].shape)).astype(np.float32),
         "b": {"w": np.zeros((5, 4), np.float32)}}
    deq, err = compression.compress_tree(tree_map(torch.from_numpy, g),
                                         tree_map(torch.from_numpy, e))
    rdeq, rerr = ref_compression.compress_tree(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, e))
    for port, ref in ((deq, rdeq), (err, rerr)):
        assert port["a"].numpy().tobytes() == _np(ref["a"]).tobytes()
        assert port["b"]["w"].numpy().tobytes() == _np(ref["b"]["w"]).tobytes()


def test_int8_quant_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (128,)))
    codes, scale = compression.quantize_int8(x)
    back = compression.dequantize_int8(codes, scale)
    assert float(torch.max(torch.abs(back - x))) <= float(scale) / 2 + 1e-6


def test_error_feedback_carries_residual():
    g = {"w": torch.tensor([1e-4, 2e-4, -1e-4])}  # tiny grads -> coarse grid
    e0 = {"w": torch.zeros(3)}
    deq, err = compression.compress_tree(g, e0)
    # whatever was lost is carried
    np.testing.assert_allclose((deq["w"] + err["w"]).numpy(), g["w"].numpy(),
                               rtol=1e-6)


def _quadratic(seed, n):
    t = torch.from_numpy(
        np.random.default_rng(seed).normal(0, 1, (n,)).astype(np.float32))

    def grad(x):
        return 2 * (x - t)

    return t, grad


def test_compressed_sgd_converges_on_quadratic():
    """min ||x - t||^2: EF-compressed SGD reaches the optimum."""
    t, grad = _quadratic(1, 32)
    opt_c = compression.compressed(sgd(0.05, momentum=0.0))
    x = torch.zeros(32)
    state = opt_c.init(x)
    for _ in range(200):
        upd, state = opt_c.update(grad(x), state)
        x = apply_updates(x, upd)
    assert float(torch.sum((x - t) ** 2)) < 1e-3


def test_compression_tracks_uncompressed_trajectory():
    t, grad = _quadratic(2, 16)
    xs = {}
    for name, opt in [
        ("plain", sgd(0.1, momentum=0.0)),
        ("ef", compression.compressed(sgd(0.1, momentum=0.0))),
    ]:
        x = torch.zeros(16)
        state = opt.init(x)
        for _ in range(50):
            upd, state = opt.update(grad(x), state)
            x = apply_updates(x, upd)
        xs[name] = x
    np.testing.assert_allclose(xs["ef"].numpy(), xs["plain"].numpy(),
                               atol=5e-2)


def _run_compressed(opt, steps=4):
    rng = np.random.default_rng(9)
    params = {"w": torch.from_numpy(rng.normal(0, 1, (6, 5)).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(0, 1, (5,)).astype(np.float32))}
    state = opt.init(params)
    for _ in range(steps):
        grads = {k: torch.from_numpy(rng.normal(0, 1e-2, v.shape)
                                     .astype(np.float32))
                 for k, v in params.items()}
        upd, state = opt.update(grads, state, params)
        params = apply_updates(params, upd)
    return params, state


def test_compressed_over_a_one_process_gloo_group_equals_no_group(tmp_path):
    """``group``'s all-reduce and division by its size: over one process
    the mean is the value itself, so the run equals ``group=None``'s."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with_group = _run_compressed(
            compression.compressed(adam(1e-2), group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    alone = _run_compressed(compression.compressed(adam(1e-2)))
    for a, b in zip(tree_leaves(with_group), tree_leaves(alone)):
        assert torch.equal(a, b)


def test_compressed_adam_follows_the_reference():
    """Four steps of compressed Adam on the same grads: the residuals and
    params stay within float32 rounding of the reference's."""
    from repro.optim import adam as ref_adam

    rng = np.random.default_rng(4)
    p0 = rng.normal(0, 1, (7, 3)).astype(np.float32)
    gs = [rng.normal(0, 1e-2, (7, 3)).astype(np.float32) for _ in range(4)]
    port_opt = compression.compressed(adam(1e-2))
    ref_opt = ref_compression.compressed(ref_adam(1e-2))
    p, rp = {"w": torch.from_numpy(p0)}, {"w": jnp.asarray(p0)}
    s, rs = port_opt.init(p), ref_opt.init(rp)
    for g in gs:
        u, s = port_opt.update({"w": torch.from_numpy(g)}, s, p)
        p = apply_updates(p, u)
        ru, rs = ref_opt.update({"w": jnp.asarray(g)}, rs, rp)
        rp = jax.tree_util.tree_map(lambda a, b: a + b, rp, ru)
    np.testing.assert_allclose(p["w"].numpy(), _np(rp["w"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(s.error["w"].numpy(), _np(rs.error["w"]),
                               rtol=1e-6, atol=1e-9)


def test_static_step_with_compression_equals_the_eager_step():
    """``compressed`` is a leaf rule (the residual one more slot), and
    ``chain_clip`` wraps it: the static step writes it leaf by leaf into
    its buffers, equal bit for bit to the eager step over 3 steps."""
    from repro_torch.optim import chain_clip
    from repro_torch.train.loop import Trainer

    class Quadratic:
        def init(self, seed):
            g = torch.Generator().manual_seed(seed)
            return {"w": torch.randn((6, 3), generator=g),
                    "b": torch.randn((3,), generator=g)}

        def loss(self, params, batch):
            err = batch["x"] @ params["w"] + params["b"] - batch["y"]
            value = torch.mean(err * err)
            return value, {"loss": value.detach()}

    rng = np.random.default_rng(1)
    batches = [{"x": torch.from_numpy(rng.normal(0, 1, (8, 6)).astype(np.float32)),
                "y": torch.from_numpy(rng.normal(0, 1, (8, 3)).astype(np.float32))}
               for _ in range(3)]
    runs = []
    for jit in (True, False):
        tr = Trainer(Quadratic(), chain_clip(compression.compressed(adam(1e-2)),
                                             0.5), jit=jit)
        state = tr.init_state(0)
        for b in batches:
            state, m = tr.step_fn(state, b)
        runs.append((tree_leaves((state.params, state.opt_state)), m))
    (a, ma), (b, mb) = runs
    assert len(a) == len(b) == 2 + 1 + 2 + 2 + 2  # params, count, mu, nu, error
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_a_clip_inside_compressed_is_refused():
    """The clip's norm is of the whole gradient, which a leaf-by-leaf
    rule inside ``compressed`` never sees: it goes outside."""
    from repro_torch.optim import chain_clip

    opt = compression.compressed(chain_clip(adam(1e-2), 1.0))
    params = {"w": torch.ones((3, 2))}
    with pytest.raises(ValueError, match="chain_clip inside"):
        opt.update({"w": torch.ones((3, 2))}, opt.init(params), params)


def test_compressed_update_into_equals_its_update():
    """``update_into`` runs ``compressed``'s leaf rule into buffers (the
    static step's path): the same params, Adam state and residuals as
    ``update`` then ``apply_updates``, bit for bit."""
    from repro_torch.optim import chain_clip
    from repro_torch.optim.adam import update_into

    rng = np.random.default_rng(5)
    opt = chain_clip(compression.compressed(adam(1e-2)), 0.5)
    p = {"w": torch.from_numpy(rng.normal(0, 1, (6, 5)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(0, 1, (5,)).astype(np.float32))}
    state = opt.init(p)
    bp, bstate = tree_map(torch.clone, (p, state))
    for _ in range(3):
        g = {k: torch.from_numpy(rng.normal(0, 1e-1, v.shape)
                                 .astype(np.float32)) for k, v in p.items()}
        upd, state = opt.update(g, state, p)
        p = apply_updates(p, upd)
        update_into(opt, tree_leaves(g), bstate, bp, (bp, bstate))
    for a, b in zip(tree_leaves((p, state)), tree_leaves((bp, bstate))):
        assert torch.equal(a, b)
