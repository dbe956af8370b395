"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) on CPU
meshes of 1, 2 and 4 stages, against the sequential composition that the
reference's ``tests/test_pipeline.py`` holds its pipeline to, computed
with ``jnp`` from the same numpy arrays; within 1e-5.  The ``cuda`` case
imports no JAX and runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pipeline.py
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed import partitioning as pt
from repro_torch.distributed.pipeline import make_pipe_mesh, pipeline_forward


def _arrays(S, M, mb=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.5, (S, d, d)).astype(np.float32)
    xs = rng.normal(0, 1, (M, mb, d)).astype(np.float32)
    return w, xs


def _sequential(w, xs):
    jnp = pytest.importorskip("jax.numpy")
    want = jnp.asarray(xs)
    for s in range(w.shape[0]):
        want = jnp.tanh(want @ jnp.asarray(w[s]))
    return np.asarray(want)


@pytest.mark.parametrize("S,M", [(1, 1), (1, 4), (2, 1), (2, 5), (4, 1),
                                 (4, 2), (4, 8)])
def test_pipeline_matches_sequential(S, M):
    """M + S - 1 ticks, microbatches fewer than stages included."""
    w, xs = _arrays(S, M, seed=S * 10 + M)
    mesh = make_pipe_mesh(S, "cpu")
    pipe = pipeline_forward(lambda p, x: torch.tanh(x @ p), mesh, "pipe")
    got = pipe(torch.from_numpy(w), torch.from_numpy(xs))
    assert got.shape == xs.shape and got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - _sequential(w, xs))))
    assert err < 1e-5, err


def test_pipeline_over_a_param_tree_on_a_named_axis():
    """Stage params are a tree (each leaf stacked over stages); the pipe
    axis is one of several, and the stages sit along it."""
    S, M, d = 2, 3, 8
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.5, (S, d, d)).astype(np.float32)
    b = rng.normal(0, 0.1, (S, d)).astype(np.float32)
    xs = rng.normal(0, 1, (M, 4, d)).astype(np.float32)
    mesh = pt.Mesh(np.array([torch.device("cpu")] * 4).reshape(2, 2),
                   ("data", "pipe"))
    pipe = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                            mesh, "pipe")
    got = pipe({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
               torch.from_numpy(xs))
    jnp = pytest.importorskip("jax.numpy")
    want = jnp.asarray(xs)
    for s in range(S):
        want = jnp.tanh(want @ jnp.asarray(w[s]) + jnp.asarray(b[s]))
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-5


def test_pipeline_gradients_equal_the_sequential_ones():
    """The pipeline is ordinary autograd: its gradients are the
    sequential composition's."""
    w, xs = _arrays(4, 3, d=8, seed=7)
    mesh = make_pipe_mesh(4, "cpu")
    pipe = pipeline_forward(lambda p, x: torch.tanh(x @ p), mesh)
    wp = torch.from_numpy(w).requires_grad_()
    pipe(wp, torch.from_numpy(xs)).square().sum().backward()
    ws = torch.from_numpy(w).requires_grad_()
    y = torch.from_numpy(xs)
    for s in range(4):
        y = torch.tanh(y @ ws[s])
    y.square().sum().backward()
    assert torch.allclose(wp.grad, ws.grad, atol=1e-5, rtol=1e-5)


def test_pipe_mesh_and_its_errors():
    mesh = make_pipe_mesh(3, "cpu")
    assert mesh.axis_names == ("pipe",) and mesh.devices.shape == (3,)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="2 CUDA devices"):
            make_pipe_mesh(2)
    with pytest.raises(ValueError, match="no 'pipe'"):
        pipeline_forward(lambda p, x: x, pt.Mesh(["cpu"], ("data",)))
    pipe = pipeline_forward(lambda p, x: x, mesh)
    with pytest.raises(ValueError, match="at least one microbatch"):
        pipe(torch.zeros(3, 2), torch.zeros(0, 2))


@pytest.mark.cuda
def test_pipeline_over_the_cards_on_card():
    """Four stages over the cards there are (one card repeated when there
    is one): within 1e-5 of the composition on the first card, computed
    microbatch by microbatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    mesh = (make_pipe_mesh(4) if n >= 4 else
            pt.Mesh([torch.device("cuda", i % n) for i in range(4)],
                    ("pipe",)))
    w, xs = _arrays(4, 6, mb=4, d=256, seed=11)
    first = torch.device("cuda", 0)
    wt, xt = torch.from_numpy(w).to(first), torch.from_numpy(xs).to(first)
    got = pipeline_forward(lambda p, x: torch.tanh(x @ p), mesh)(wt, xt)
    assert got.device == first
    want = []
    for m in range(xs.shape[0]):
        y = xt[m]
        for s in range(4):
            y = torch.tanh(y @ wt[s])
        want.append(y)
    assert float((got - torch.stack(want)).abs().max()) <= 1e-5
