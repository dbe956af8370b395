"""Launch planning of the port's two redesigned kernels, on the CPU: the
tiles and split-K of ``spike_matmul`` and the columns, step block and
shared memory of ``snn_chunk``, at the collision shapes and at the
edges; and the int8 weight split the ``spike_matmul`` kernel runs on its
tensor cores (w = 256 * hi + lo), held in numpy against the reference's
``spike_matmul_ref`` (JAX) and the port's plain version.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_plans.py
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as ref_kernels
from repro_torch.kernels import snn_chunk as chunk_mod
from repro_torch.kernels import spike_matmul as smm_mod

COLLISION = (4096, 512, 2)


# ------------------------------------------------------- spike_matmul plan
@pytest.mark.parametrize("shape,want", [
    # (M, K, N): (m_tiles, n_tiles, slabs, split, slabs_per_split, ctas)
    ((200, 4096, 512), (2, 8, 64, 8, 8, 128)),  # hardware path, layer 0
    ((200, 512, 2), (2, 1, 8, 8, 1, 16)),  # hardware path, layer 1
    ((1, 1, 1), (1, 1, 1, 1, 1, 1)),
    ((37, 513, 129), (1, 3, 9, 9, 1, 27)),
    ((200, 0, 5), (2, 1, 0, 1, 0, 2)),  # K = 0: zeros, one pass
    ((4096, 4096, 4096), (32, 64, 64, 1, 64, 2048)),  # a full grid: no split
])
def test_spike_matmul_plan_at_known_shapes(shape, want):
    geo = smm_mod.plan(*shape)
    got = (geo.m_tiles, geo.n_tiles, geo.slabs, geo.split,
           geo.slabs_per_split, geo.ctas)
    assert got == want


@pytest.mark.parametrize("M", [1, 37, 128, 200, 1000])
@pytest.mark.parametrize("K", [1, 31, 64, 100, 4096, 9999])
@pytest.mark.parametrize("N", [2, 64, 129, 512])
def test_spike_matmul_plan_covers_k_without_an_empty_split(M, K, N):
    geo = smm_mod.plan(M, K, N)
    assert geo.m_tiles * smm_mod.TILE_M >= M > (geo.m_tiles - 1) * smm_mod.TILE_M
    assert geo.n_tiles * smm_mod.TILE_N >= N > (geo.n_tiles - 1) * smm_mod.TILE_N
    assert geo.slabs * smm_mod.TILE_K >= K > (geo.slabs - 1) * smm_mod.TILE_K
    assert geo.split * geo.slabs_per_split >= geo.slabs
    assert (geo.split - 1) * geo.slabs_per_split < geo.slabs  # none empty
    # the launcher's own split of the slabs agrees with the plan's
    assert -(-geo.slabs // geo.split) == geo.slabs_per_split
    assert geo.ctas <= max(smm_mod.SMS, geo.m_tiles * geo.n_tiles)


@pytest.mark.parametrize("shape", [(-1, 4, 4), (4, 4, 2**31),
                                   (smm_mod.TILE_M * 65535 + 1, 8, 8)])
def test_spike_matmul_plan_rejects_what_the_grid_cannot_hold(shape):
    with pytest.raises(ValueError, match="spike_matmul"):
        smm_mod.plan(*shape)


# ---------------------------------------------------------- snn_chunk plan
@pytest.mark.parametrize("widths,steps,batch,want", [
    # (cols, step_block, threads, ctas)
    (COLLISION, 5, 8, ((64, 1), 5, 320, 64)),  # serving chunk
    (COLLISION, 25, 32, ((64, 1), 7, 448, 256)),  # evaluate
    (COLLISION, 1, 1, ((64, 1), 1, 64, 8)),
    (COLLISION, 16, 8, ((64, 1), 8, 512, 64)),  # threads cap the block
    ((4096, 500, 2), 5, 8, ((63, 1), 5, 320, 64)),  # 500 % 8 != 0
    ((256, 300, 40, 2), 5, 9, ((38, 5, 1), 5, 192, 72)),
    ((256, 300, 40, 2), 25, 8, ((38, 5, 1), 13, 512, 64)),
    ((64, 16), 3, 2, ((2,), 3, 32, 16)),
])
def test_snn_chunk_plan_at_known_shapes(widths, steps, batch, want):
    geo = chunk_mod.plan(widths, steps, batch)
    assert (geo.cols, geo.step_block, geo.threads, geo.ctas) == want
    assert geo.smem <= chunk_mod.SMEM_LIMIT


@pytest.mark.parametrize("steps,want", [
    # a CTA of the 4096-512-2 network: 64 + 1 columns of state, the
    # layer-0 plane, 512 gathered hidden inputs and 512 staged events a step
    (1, 7448),
    (5, 35160),  # serving chunk
    (25, 49016),  # evaluate: step block 7
])
def test_snn_chunk_shared_memory_at_collision_shapes(steps, want):
    assert chunk_mod.plan(COLLISION, steps, 8).smem == want


@pytest.mark.parametrize("steps", [0, 1, 2, 5, 13, 16, 17, 25, 100])
@pytest.mark.parametrize("widths", [COLLISION, (256, 300, 40, 2)])
def test_snn_chunk_step_blocks_are_balanced(steps, widths):
    geo = chunk_mod.plan(widths, steps, 4)
    blocks = -(-max(steps, 1) // geo.step_block)
    assert 1 <= geo.step_block <= chunk_mod.STEP_BLOCK
    assert (blocks - 1) * geo.step_block < max(steps, 1)  # no empty block
    # every block but the last is full and the last is at most one shorter
    assert max(steps, 1) - (blocks - 1) * geo.step_block >= geo.step_block - blocks
    assert geo.threads <= chunk_mod.MAX_THREADS and geo.threads % 32 == 0


def test_snn_chunk_step_block_shrinks_to_fit_shared_memory():
    # a 30,000-wide hidden layer: its gathered input plane is 120 KB a step
    widths = (64, 512, 30000, 2)
    geo = chunk_mod.plan(widths, 16, 1)
    assert geo.step_block == 1 and geo.smem <= chunk_mod.SMEM_LIMIT
    assert chunk_mod.smem_bytes(widths, geo.step_block + 1) > chunk_mod.SMEM_LIMIT


@pytest.mark.parametrize("widths,match", [
    ((64, 600000), "shared memory"),  # state of 75,000 columns a CTA
    ((64, 512, 60000, 2), "shared memory"),  # 240 KB gathered for one step
    ((70000, 40000), "int32"),  # row offsets past 2^31
    ((64,), "layers"),
    ((4,) * 130, "layers"),
])
def test_snn_chunk_plan_rejects_what_cannot_launch(widths, match):
    with pytest.raises(ValueError, match=match):
        chunk_mod.plan(widths, 5, 8)


# --------------------------------------------------- the int8 weight split
def _split_product(s, w):
    """(256 * (s @ hi) + s @ lo) mod 2^32 as int32, each product wrapped to
    32 bits as the tensor cores' int32 accumulators wrap."""
    hi = (w.astype(np.int32) >> 8).astype(np.int8)  # -128..127
    lo = (w.astype(np.int32) & 0xFF).astype(np.uint8)  # 0..255
    assert np.array_equal(256 * hi.astype(np.int32) + lo, w)
    wrap = np.uint64(2**32)
    acc_hi = (s.astype(np.int64) @ hi.astype(np.int64)).astype(np.uint64) % wrap
    acc_lo = (s.astype(np.int64) @ lo.astype(np.int64)).astype(np.uint64) % wrap
    out = ((acc_hi << np.uint64(8)) + acc_lo) % wrap
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("kind", ["binary", "signed", "extremes", "overflow"])
@pytest.mark.parametrize("shape", [(16, 64, 8), (37, 513, 129), (200, 512, 2)])
def test_weight_split_equals_both_references(kind, shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N + len(kind))
    s = (rng.random((M, K)) < 0.3).astype(np.int8)
    w = rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)
    w[0, 0], w[-1, -1] = -(2**15), 2**15 - 1
    if kind == "signed":
        s = rng.integers(-128, 128, (M, K)).astype(np.int8)
    elif kind == "extremes":
        s[rng.random((M, K)) < 0.2] = -128
        w[rng.random((K, N)) < 0.3] = -(2**15)
    elif kind == "overflow":  # 127 * -32768 * K passes -2^31 for K >= 517
        s[:], w[:] = 127, -(2**15)
    got = _split_product(s, w)
    jax_ref = np.asarray(ref_kernels.spike_matmul_ref(jnp.asarray(s), jnp.asarray(w)))
    port_ref = smm_mod.spike_matmul_ref(torch.from_numpy(s), torch.from_numpy(w))
    assert np.array_equal(got, jax_ref)
    assert np.array_equal(got, port_ref.numpy())
    if kind == "overflow":
        want = (K * 127 * -(2**15) + 2**31) % 2**32 - 2**31
        assert (got == want).all()
