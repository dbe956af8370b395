"""Event-driven linear layer with a surrogate-gradient-compatible backward.

``event_linear`` is one ``torch.autograd.Function``:

- **forward**: extract the step's event list (``runtime.step_events``) and
  integrate only the gathered weight rows, through the hand-written
  ``aer_spike_matmul_batched`` kernel (``use_kernel=True``; its plain
  version on a CPU tensor) or the plain ``runtime.gather_current``.
- **backward**:
    * ``w_bar = H^T @ g``, with ``H`` the dense (B, K) plane of the events
      the forward integrated (padding and out-of-range addresses masked
      out before the scatter).  It equals the reference's scatter of
      ``values * g`` through the same event set, but as a product with a
      fixed summation order: no float atomics, so two runs give
      bit-identical gradients.  Valid addresses within one row are
      distinct (``step_events`` packs each active position once), so the
      scatter into ``H`` never writes one element twice.
    * ``h_bar = g @ w^T`` keeps dense support (surrogate VJPs upstream
      need cotangents at silent positions); with ``needs_input_grad=False``
      (the input layer, whose ``h`` is data) it is not computed at all.
    * ``b_bar = sum_b g``.

Gradient parity with dense ``core.snn`` BPTT is the correctness anchor
(``tests/test_torch_sparse_train.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import neuron, snn
from repro_torch.events import runtime
from repro_torch.kernels import aer_matmul

Tensor = torch.Tensor


class _EventLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, capacity, use_kernel, needs_input_grad):
        addrs, values, _ = runtime.step_events(h, capacity)
        if use_kernel:
            # looked up at call time, so a caller may swap in the plain
            # version on the card to compare the two routes
            cur = aer_matmul.aer_spike_matmul_batched(addrs, values, w) + b
        else:
            cur = runtime.gather_current(w, b, addrs, values)
        ctx.save_for_backward(addrs, values, w)
        ctx.input_grad = needs_input_grad
        return cur

    @staticmethod
    def backward(ctx, g):
        addrs, values, w = ctx.saved_tensors
        K = w.shape[0]
        h_bar = w_bar = b_bar = None
        if ctx.input_grad and ctx.needs_input_grad[0]:
            h_bar = g @ w.T
        if ctx.needs_input_grad[1]:
            live = (values != 0) & (addrs >= 0) & (addrs < K)
            cols = torch.where(live, addrs.long(), K)  # dead -> spare column
            plane = torch.zeros(
                (addrs.shape[0], K + 1), dtype=g.dtype, device=g.device
            )
            plane.scatter_(1, cols, torch.where(live, values, 0.0))
            w_bar = plane[:, :K].T @ g
        if ctx.needs_input_grad[2]:
            b_bar = torch.sum(g, dim=0)
        return h_bar, w_bar, b_bar, None, None, None


def event_linear(
    h: Tensor,  # (B, K) spike plane (float; {0,1} or signed polarity)
    w: Tensor,  # (K, N) float weights
    b: Tensor,  # (N,) float bias
    *,
    capacity: Optional[int] = None,
    use_kernel: bool = False,
    needs_input_grad: bool = True,
) -> Tensor:
    """Event-driven ``h @ w + b`` whose backward is event-sparse for ``w``.

    ``capacity`` bounds the per-step event list (default: full fan-in, so
    nothing is truncated and parity with the dense layer is exact).
    ``needs_input_grad=False`` skips the dense ``g @ w^T`` input
    cotangent; set it when ``h`` is data, i.e. the input layer.
    """
    if capacity is None:
        capacity = h.shape[-1]
    return _EventLinear.apply(
        h, w, b, int(capacity), bool(use_kernel), bool(needs_input_grad)
    )


def event_bptt_forward(
    params: Dict[str, Dict[str, Tensor]],
    spikes: Tensor,  # (T, B, K) input spike planes ({0,1} or signed)
    cfg: snn.SNNConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    capacity: Optional[int] = None,
    use_kernel: bool = False,
    prepared: bool = False,
    dropout_u: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Differentiable event-driven analog of ``core.snn.forward``.

    Same step structure (event_linear -> neuron_step -> dropout after the
    first layer in train mode), unrolled over time so autograd composes
    the per-layer event backward with the surrogate spike backward.
    ``prepared=True`` is for callers holding already fake-quantized
    params; QAT must re-quantize live params every step.

    Dropout's uniforms are ``dropout_u`` (T, B, hidden), drawn ahead of
    time (a captured step draws nothing), or else ``dropout_planes`` drawn
    from ``generator`` here: the two give the same masks.

    Returns:
      out_mem:    (T, B, C) output membrane trace (for the loss)
      out_spikes: (T, B, C) output spikes
      events:     (n_layers, B) measured input-event counts per layer
                  (no gradient; feeds the energy model)
      act:        (n_layers,) differentiable mean spike count per layer
                  output per inference (feeds the energy regularizer)
    """
    ncfg = cfg.neuron_cfg
    p = params if prepared else runtime.prepare_params(params, cfg)
    B = spikes.shape[1]
    L = cfg.num_layers
    drop = train and cfg.dropout_rate > 0.0
    if drop and generator is None and dropout_u is None:
        raise ValueError("a generator or dropout_u is required when train=True")
    if drop and dropout_u is None:
        dropout_u = dropout_planes(generator, spikes.shape[0], B,
                                   cfg.layer_sizes[1])
    dev = spikes.device
    layers = [p[f"layer{i}"] for i in range(L)]
    betas = [snn.effective_beta(lp) for lp in layers]
    states = [
        neuron.init_state((B, cfg.layer_sizes[i + 1]), device=dev)
        for i in range(L)
    ]
    ev = [torch.zeros((B,), device=dev) for _ in range(L)]
    act = [torch.zeros((), device=dev) for _ in range(L)]
    mems, spks = [], []
    for t, x_t in enumerate(spikes):
        h = x_t
        for i, lp in enumerate(layers):
            cap = capacity if (capacity is not None and i == 0) else None
            cur = event_linear(
                h, lp["w"], lp["b"], capacity=cap, use_kernel=use_kernel,
                needs_input_grad=i > 0,  # layer-0 input is data
            )
            ev[i] = ev[i] + torch.sum(h.detach() != 0, dim=-1).to(torch.float32)
            states[i], spk = neuron.neuron_step(
                ncfg, states[i], cur, beta=betas[i], threshold=lp["threshold"]
            )
            act[i] = act[i] + torch.sum(spk) / B
            h = spk
            if i == 0 and drop:
                h = snn.apply_dropout(spk, dropout_u[t], cfg.dropout_rate)
        mems.append(states[-1].u)
        spks.append(h)
    return torch.stack(mems), torch.stack(spks), torch.stack(ev), torch.stack(act)


def dropout_planes(
    generator: torch.Generator, num_steps: int, batch: int, hidden: int
) -> Tensor:
    """(T, batch, hidden) float32 uniforms on the generator's device: the
    T draws ``snn.dropout`` would make step by step, in its order and
    shapes (one (batch, hidden) plane a step), so the masks they give
    equal the step-by-step draw bit for bit."""
    return torch.stack([
        torch.rand((batch, hidden), generator=generator, dtype=torch.float32,
                   device=generator.device)
        for _ in range(num_steps)
    ])


def event_eval_forward(
    params: Dict[str, Dict[str, Tensor]],
    spikes: Tensor,  # (T, B, K) input spike planes
    cfg: snn.SNNConfig,
    *,
    backend: str = "auto",
    capacities=None,
    prepared: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Inference on the serving hot path: ``runtime.event_forward``, which
    with ``backend="auto"`` runs the fused ``snn_chunk`` kernel on a CUDA
    tensor and the plain runtime on the CPU.  Params are prepared
    (fake-quantized) once.  Returns (out_mem, out_spikes, events
    (n_layers, B)), as ``event_bptt_forward``'s inference outputs."""
    p = params if prepared else runtime.prepare_params(params, cfg)
    with torch.no_grad():
        return runtime.event_forward(
            p, spikes, cfg, capacities=capacities, prepared=True,
            backend=backend,
        )
