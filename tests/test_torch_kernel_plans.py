"""Launch planning of the port's redesigned kernels, on the CPU: the
tiles and split-K of ``spike_matmul`` and ``q115_matmul``, the columns,
step block and shared memory of ``snn_chunk``, the variant, columns,
E-split and shared memory of the aer kernel, at the collision shapes and
at the edges; the int8 weight split the ``spike_matmul`` kernel runs on
its tensor cores (w = 256 * hi + lo), held in numpy against the
reference's ``spike_matmul_ref`` (JAX) and the port's plain version; and
the ``q115_matmul`` split-K sums, added in any order, against the
reference's ``q115_matmul_ref``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_plans.py
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as ref_kernels
from repro_torch.kernels import _build
from repro_torch.kernels import aer_matmul as aer_mod
from repro_torch.kernels import lif_fused as lif_mod
from repro_torch.kernels import q115_matmul as q115_mod
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


# ---------------------------------------------------------------- aer plan
@pytest.mark.parametrize("shape,want", [
    # (B, E, K, N, int16): (variant, cols, threads, streams, e_chunk,
    # slices, splits, ctas, smem)
    ((32, 4096, 4096, 512, False),  # training layer 0
     ("merged", 32, 512, 4, 4096, 16, 1, 128, 217088)),
    ((32, 512, 512, 2, False),  # training layer 1
     ("narrow", 2, 128, 1, 512, 1, 1, 32, 11264)),
    ((1, 4096, 4096, 512, True),  # aer_spike_matmul, hardware path
     ("split", 32, 128, 1, 128, 16, 32, 512, 29696)),
    ((32, 4096, 4096, 512, True), ("split", 32, 128, 1, 2048, 16, 2, 1024, 29696)),
    ((32, 512, 512, 2, True), ("split", 2, 128, 1, 128, 1, 4, 128, 11264)),
    ((4, 0, 3, 5, False), ("narrow", 5, 128, 1, 0, 1, 1, 4, 17408)),  # E = 0
    ((4, 0, 3, 5, True), ("split", 5, 128, 1, 0, 1, 1, 4, 11264)),
    ((3, 100, 7, 1, False), ("narrow", 1, 128, 1, 128, 1, 1, 3, 11264)),  # N = 1
    ((3, 100, 1, 31, False), ("narrow", 31, 128, 1, 128, 1, 1, 3, 54272)),  # K = 1
    ((3, 100, 9, 32, False), ("merged", 32, 384, 3, 100, 1, 1, 1, 162816)),
    ((2, 70, 9, 129, False), ("merged", 32, 256, 2, 70, 5, 1, 5, 108544)),
    ((5, 300, 77, 200, False), ("merged", 32, 512, 4, 300, 7, 1, 14, 217088)),
    # fewer streams a CTA where four planes do not fit; the CTA ring where
    # not even one does
    ((8, 10, 20000, 64, False), ("merged", 32, 256, 2, 10, 2, 1, 8, 227328)),
    ((1, 10, 60000, 64, False), ("rows", 32, 128, 1, 128, 2, 1, 2, 54272)),
    ((1, 4101, 4096, 129, True), ("split", 32, 128, 1, 128, 5, 33, 165, 29696)),
    ((70000, 10, 3, 1, False), ("narrow", 1, 128, 1, 128, 1, 1, 70000, 11264)),
    ((2**31 - 1, 1, 1, 64, True),
     ("split", 32, 128, 1, 128, 2, 1, 2 * (2**31 - 1), 29696)),
])
def test_aer_plan_at_known_shapes(shape, want):
    geo = aer_mod.plan(*shape)
    got = (geo.variant, geo.cols, geo.threads, geo.streams, geo.e_chunk,
           geo.slices, geo.splits, geo.ctas, geo.smem)
    assert got == want


@pytest.mark.parametrize("B", [1, 3, 32, 200])
@pytest.mark.parametrize("E", [1, 65, 4096, 9999])
@pytest.mark.parametrize("K", [1, 4096, 20000, 60000])
@pytest.mark.parametrize("N", [1, 2, 31, 32, 33, 512])
@pytest.mark.parametrize("int16", [False, True])
def test_aer_plan_covers_the_shape_as_the_launcher_checks(B, E, K, N, int16):
    geo = aer_mod.plan(B, E, K, N, int16)
    wsize = 2 if int16 else 4
    # float32 keeps each (b, n) sum in one thread; only int16 splits E
    assert (geo.variant == "split") == int16
    assert geo.splits == 1 or int16
    if not int16:
        assert geo.variant in (("narrow",) if N < aer_mod.NARROW_N
                               else ("merged", "rows"))
    # the checks of aer_matmul_launch in csrc/aer_matmul.cu
    assert geo.threads == aer_mod.GROUP * geo.streams
    assert geo.cols == min(32, N)
    assert geo.slices * geo.cols >= N > (geo.slices - 1) * geo.cols
    assert geo.slices <= aer_mod.GRID_YZ_MAX
    assert geo.smem <= aer_mod.SMEM_LIMIT
    assert geo.ctas == -(-B // geo.streams) * geo.slices * geo.splits
    if geo.variant == "merged":
        assert 1 <= geo.streams <= min(aer_mod.MERGE_MAX, B)
        # room for the plane and tiles, and for a ring a stream
        assert geo.smem >= aer_mod.walk_bytes(geo.streams, K, geo.cols)
        assert geo.smem >= geo.streams * aer_mod.ring_bytes(aer_mod.GROUP, 32, 4)
        assert geo.e_chunk == E
        # no fewer streams than the plane allows
        more = geo.streams + 1
        assert more > min(aer_mod.MERGE_MAX, B) or (
            aer_mod.walk_bytes(more, K, 32) > aer_mod.SMEM_LIMIT)
    else:
        assert geo.streams == 1
        assert geo.smem >= aer_mod.ring_bytes(geo.threads, geo.cols, wsize)
        assert geo.e_chunk % geo.threads == 0 and geo.splits * geo.e_chunk >= E
        assert (geo.splits - 1) * geo.e_chunk < E  # no empty E-chunk
    if geo.variant == "rows":  # only where one plane does not fit
        assert aer_mod.walk_bytes(1, K, 32) > aer_mod.SMEM_LIMIT
    if int16:  # enough chunks to fill the card, unless E runs out first
        # (evening out the chunks costs at most half the target)
        blocks = -(-E // geo.threads)
        assert 2 * geo.ctas >= min(aer_mod.SPLIT_CTAS, B * geo.slices * blocks)


def test_aer_plan_picks_narrow_for_layer1_and_splits_the_single_stream():
    layer1 = aer_mod.plan(32, 512, 512, 2, False)
    assert layer1.variant == "narrow" and layer1.cols == 2
    layer0 = aer_mod.plan(32, 4096, 4096, 512, False)
    assert layer0.variant == "merged" and layer0.streams == 4
    single = aer_mod.plan(1, 4096, 4096, 512, True)
    assert single.variant == "split" and single.splits > 1
    # the 1,296 live events of the hardware path's busiest step alone span
    # 11 E-chunks of each of the 16 column slices: 176 CTAs where one
    # stream had 4 before
    assert -(-1296 // single.e_chunk) * single.slices == 176


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 8, 64 * 65535 + 1, False), "grid"),  # column slices past 65535
    ((1, 8, 8, 64 * 65535 + 1, True), "grid"),
    ((2**31, 8, 8, 8, False), "out of range"),
    ((-1, 8, 8, 8, False), "out of range"),
    ((1, 8, 0, 8, True), "out of range"),  # K = 0: no row to read
])
def test_aer_plan_rejects_what_the_grid_cannot_hold(shape, match):
    with pytest.raises(ValueError, match=match):
        aer_mod.plan(*shape)


def test_aer_launcher_takes_the_plan_as_the_source_declares_it():
    """The wrapper passes each plan field to the C launcher: the variant
    codes, the smem formula's constants and the argument count agree with
    ``csrc/aer_matmul.cu`` (which no compiler reads on this machine)."""
    src = (_build.CSRC / "aer_matmul.cu").read_text()
    assert ("enum { AER_ROWS = 0, AER_NARROW = 1, AER_SPLIT = 2, "
            "AER_MERGED = 3 };") in src
    assert aer_mod.VARIANTS == {"rows": 0, "narrow": 1, "split": 2, "merged": 3}
    assert f"#define AER_SMEM_MAX {aer_mod.SMEM_LIMIT}" in src
    decl = src[src.index('extern "C" int aer_matmul_launch('):]
    params = decl[:decl.index(")")].count(",") + 1
    assert params == len(_build.SIGNATURES["aer_matmul"][1]) == 18
    assert "static_cast<size_t>(2 * AER_LEAD + 1) * threads * 8" in src
    assert "streams * kp * 4 + 2ull * AER_TILE_ROWS * row_pitch(cols, 4) * 4" in src
    for name, value in (("AER_TILE_ROWS", aer_mod.TILE_ROWS),
                        ("AER_MERGE_MAX", aer_mod.MERGE_MAX),
                        ("AER_GROUP", aer_mod.GROUP),
                        ("AER_LEAD", aer_mod.LEAD)):
        assert f"#define {name} {value} " in src


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


# ------------------------------------------------------- q115_matmul plan
@pytest.mark.parametrize("shape,saturate,want", [
    # (M, K, N): (warps, m_tiles, n_tiles, split, k_per_split, cluster, ctas)
    ((200, 4096, 512), False, (8, 4, 4, 16, 256, 1, 256)),  # hardware path
    ((200, 4096, 512), True, (8, 4, 4, 8, 512, 8, 128)),
    ((128, 512, 128), True, (4, 4, 1, 8, 64, 8, 32)),  # kernel_bench
    ((128, 512, 128), False, (4, 4, 1, 16, 32, 1, 64)),
    ((1, 1, 1), True, (4, 1, 1, 1, 8, 1, 1)),
    ((33, 129, 65), False, (4, 2, 1, 5, 32, 1, 10)),
    ((33, 129, 65), True, (4, 2, 1, 5, 32, 5, 10)),
    ((16, 4096, 8), False, (4, 1, 1, 128, 32, 1, 128)),
    ((16, 4096, 8), True, (4, 1, 1, 8, 512, 8, 8)),
    ((5, 0, 7), False, (4, 1, 1, 1, 8, 1, 1)),  # K = 0: zeros, one pass
    ((4096, 4096, 4096), True, (8, 64, 32, 1, 4096, 1, 2048)),  # no split
])
def test_q115_plan_at_known_shapes(shape, saturate, want):
    geo = q115_mod.plan(*shape, saturate)
    got = (geo.warps, geo.m_tiles, geo.n_tiles, geo.split, geo.k_per_split,
           geo.cluster, geo.ctas)
    assert got == want
    assert geo.atomic == (geo.split > 1 and not saturate)


@pytest.mark.parametrize("M", [1, 31, 64, 128, 200, 1000])
@pytest.mark.parametrize("K", [0, 1, 7, 31, 33, 100, 512, 4096, 9999])
@pytest.mark.parametrize("N", [1, 8, 129, 512])
@pytest.mark.parametrize("saturate", [False, True])
def test_q115_plan_covers_k_without_an_empty_split(M, K, N, saturate):
    geo = q115_mod.plan(M, K, N, saturate)
    rows = q115_mod.ROWS_PER_WARP * geo.warps
    assert geo.warps in (4, 8)
    assert geo.m_tiles * rows >= M > (geo.m_tiles - 1) * rows
    assert geo.n_tiles * q115_mod.TILE_N >= N > (geo.n_tiles - 1) * q115_mod.TILE_N
    assert geo.k_per_split % q115_mod.K_STEP == 0
    if geo.k_per_split > q115_mod.TILE_K:
        assert geo.k_per_split % q115_mod.TILE_K == 0  # whole slabs
    # the launcher's split (ceil(K / k_per_split)) covers K, none empty
    assert geo.split == max(1, -(-K // geo.k_per_split))
    assert (geo.split - 1) * geo.k_per_split < max(K, 1)
    assert geo.split % geo.cluster == 0 and geo.cluster <= q115_mod.CLUSTER_MAX
    if saturate:  # one cluster holds the whole sum
        assert geo.cluster == geo.split
    assert geo.split <= max(1, q115_mod.TARGET_CTAS, -(-K // q115_mod.TILE_K))


@pytest.mark.parametrize("shape", [(-1, 4, 4), (4, 4, 2**31),
                                   (64 * 65535 + 1, 4096, 8)])
def test_q115_plan_rejects_what_the_grid_cannot_hold(shape):
    with pytest.raises(ValueError, match="q115_matmul"):
        q115_mod.plan(*shape)


def test_q115_launcher_takes_the_plan_as_the_source_declares_it():
    """The wrapper passes warps and k_per_split to the C launcher, which
    recomputes split = ceil(K / k_per_split) and the plan's cluster (every
    split of a saturating product, else 1): the tile, slab, step and
    cluster constants and the argument count agree with
    ``csrc/q115_matmul.cu`` (which no compiler reads on this machine)."""
    src = (_build.CSRC / "q115_matmul.cu").read_text()
    for name, value in (("Q_BN", q115_mod.TILE_N), ("Q_BK", q115_mod.TILE_K),
                        ("Q_KSTEP", q115_mod.K_STEP),
                        ("Q_TM", q115_mod.ROWS_PER_WARP),
                        ("Q_CLUSTER_MAX", q115_mod.CLUSTER_MAX)):
        assert f"#define {name} {value} " in src
    assert "(warps != 4 && warps != 8)" in src
    assert "(saturate && split > Q_CLUSTER_MAX)" in src
    assert "const int cluster = saturate ? static_cast<int>(split) : 1;" in src
    assert "(static_cast<long long>(K) + k_per_split - 1) / k_per_split" in src
    decl = src[src.index('extern "C" int q115_matmul_launch('):]
    params = decl[:decl.index(")")].count(",") + 1
    assert params == len(_build.SIGNATURES["q115_matmul"][1]) == 10


@pytest.mark.parametrize("shape,saturate", [((200, 4096, 512), False),
                                            ((128, 512, 128), True),
                                            ((37, 1000, 65), False),
                                            ((16, 4096, 8), True)])
def test_q115_split_sums_in_any_order_equal_the_reference(shape, saturate):
    """The kernel's arithmetic in numpy: each K split's partial of rounded
    products wraps to int32, the partials add in a shuffled order (the
    atomics' or the cluster's), and only the whole sum saturates."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-(2**15), 2**15, (M, K)).astype(np.int16)
    w = rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)
    x[0], w[:, 0] = -(2**15), -(2**15)
    geo = q115_mod.plan(M, K, N, saturate)
    prods = (x.astype(np.int64)[:, :, None] * w.astype(np.int64)[None] + 2**14) >> 15
    parts = [prods[:, k0:k0 + geo.k_per_split].sum(1)
             for k0 in range(0, K, geo.k_per_split)]
    assert len(parts) == geo.split
    total = np.zeros((M, N), np.int64)
    for i in rng.permutation(len(parts)):
        total = (total + parts[i] + 2**31) % 2**32 - 2**31  # int32 wrap
    if saturate:
        total = np.clip(total, -(2**15), 2**15 - 1)
    fn = ref_kernels.q115_matmul_ref if saturate else ref_kernels.q115_matmul_acc_ref
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(total, want)


# --------------------------------------------------- lif_fused launcher
def test_lif_launcher_takes_the_wrapper_arguments_as_the_source_declares():
    """The wrapper's CTA size and argument count agree with
    ``csrc/lif_fused.cu``: one warp a CTA, so the hardware path's 4,096
    neurons spread over 128 CTAs."""
    src = (_build.CSRC / "lif_fused.cu").read_text()
    assert f"#define LIF_THREADS {lif_mod.THREADS} " in src
    assert lif_mod.THREADS == 32 and -(-8 * 512 // lif_mod.THREADS) == 128
    decl = src[src.index('extern "C" int lif_fused_launch('):]
    params = decl[:decl.index(")")].count(",") + 1
    assert params == len(_build.SIGNATURES["lif_fused"][1]) == 12


@pytest.mark.parametrize("widths,steps,batch", [
    ((8192, 512, 2), 5, 8),  # two-channel DVS serving
    ((8192, 512, 2), 25, 48),  # measure_step_counts over 48 recordings
    ((4096, 512, 2), 25, 48),
])
def test_snn_chunk_plans_the_dvs_input_widths(widths, steps, batch):
    """The chunk's plan does not depend on K0: the two-channel layer plans
    as the signed one does, and its int16 addresses hold 8192."""
    geo = chunk_mod.plan(widths, steps, batch)
    assert geo == chunk_mod.plan((4096,) + widths[1:], steps, batch)
    assert geo.ctas == batch * chunk_mod.CLUSTER


@pytest.mark.parametrize("E", [1, 588, 4068, 4096])
def test_aer_plan_takes_event_forward_aer_windows(E):
    """``event_forward_aer``'s layer-0 tables (B = 32 streams, E the
    longest step window of a 64x64 DVS batch) and its hidden tables."""
    geo = aer_mod.plan(32, E, 4096, 512, False)
    assert (geo.variant, geo.streams, geo.e_chunk) == ("merged", 4, E)
    assert aer_mod.plan(32, 512, 512, 2, False).variant == "narrow"
