"""The paper's own architecture: 4096-512-2 spiking MLP, 25 time steps
(Fig. 4), LIF neurons with learnable beta/threshold, optional 5-step
refractory period and Lapicque dynamics."""

from repro_torch.core.snn import SNNConfig

CONFIG = SNNConfig(
    layer_sizes=(4096, 512, 2),
    num_steps=25,
    neuron_kind="lif",
    reset="zero",
    surrogate="atan",
    refractory_steps=0,
    dropout_rate=0.2,
)

CONFIG_REFRACTORY = SNNConfig(
    layer_sizes=(4096, 512, 2),
    num_steps=25,
    refractory_steps=5,
    dropout_rate=0.2,
)

CONFIG_LAPICQUE = SNNConfig(
    layer_sizes=(4096, 512, 2),
    num_steps=25,
    neuron_kind="lapicque",
    dropout_rate=0.2,
)
