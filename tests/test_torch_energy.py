"""Port parity: the energy model's baselines and the paper's headline
(``core.energy``, ``core.bcnn.conv_shapes_for_energy``) against the
reference, value for value, and the 86 % checks of
``tests/test_energy.py`` made on the port."""

import dataclasses

import pytest

from repro.core import bcnn as ref_bcnn
from repro.core import energy as ref_energy
from repro_torch.core import bcnn, energy

SIZES = [(4096, 512, 2), (1024, 128, 2), (64, 24, 16, 2)]


def _same(got, ref):
    assert got.ops == ref.ops
    assert got.energy_pj() == ref.energy_pj()
    assert got.total_ops() == ref.total_ops()
    assert got.gops_per_watt() == ref.gops_per_watt()


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("dense", [False, True])
def test_snn_train_ops_from_events_equal(sizes, dense):
    events = [1234.0 * (i + 1) for i in range(len(sizes) - 1)]
    _same(energy.snn_train_ops_from_events(sizes, 25, events, dense=dense),
          ref_energy.snn_train_ops_from_events(sizes, 25, events, dense=dense))


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("bits", [16, 32])
def test_dense_fcn_inference_ops_equal(sizes, bits):
    _same(energy.dense_fcn_inference_ops(sizes, bits=bits),
          ref_energy.dense_fcn_inference_ops(sizes, bits=bits))


@pytest.mark.parametrize("channels,hw", [((16, 32, 64), 64), ((4, 8), 16)])
def test_bcnn_inference_ops_equal(channels, hw):
    cfg = bcnn.BCNNConfig(input_hw=hw, channels=channels)
    ref_cfg = ref_bcnn.BCNNConfig(**dataclasses.asdict(cfg))
    conv, fc = bcnn.conv_shapes_for_energy(cfg)
    assert (conv, fc) == ref_bcnn.conv_shapes_for_energy(ref_cfg)
    _same(energy.bcnn_inference_ops(conv, fc),
          ref_energy.bcnn_inference_ops(conv, fc))


def test_paper_constants_and_bcnn36_equal():
    assert energy.PAPER_TABLE2 == ref_energy.PAPER_TABLE2
    assert energy.BCNN36_OPS_PER_FRAME == ref_energy.BCNN36_OPS_PER_FRAME
    _same(energy.bcnn36_inference_ops(), ref_energy.bcnn36_inference_ops())
    for model in (900.0, 1093.0, 1500.0):
        assert energy.gopsw_deviation(model, 1093.0) == (
            ref_energy.gopsw_deviation(model, 1093.0))


@pytest.mark.parametrize("rates", [(0.35, 0.02, 0.02), (0.1, 0.05, 0.02)])
def test_efficiency_gain_and_energy_reduction_equal(rates):
    snn = energy.snn_inference_ops((4096, 512, 2), 25, rates)
    ref_snn = ref_energy.snn_inference_ops((4096, 512, 2), 25, rates)
    for base, ref_base in (
        (energy.bcnn36_inference_ops(), ref_energy.bcnn36_inference_ops()),
        (energy.dense_fcn_inference_ops((4096, 512, 2)),
         ref_energy.dense_fcn_inference_ops((4096, 512, 2))),
    ):
        assert energy.efficiency_gain(snn, base) == (
            ref_energy.efficiency_gain(ref_snn, ref_base))
        assert energy.energy_reduction(snn, base) == (
            ref_energy.energy_reduction(ref_snn, ref_base))


def test_measured_events_priced_against_the_bcnn():
    """The comparison chip_smoke.py prints: counted DVS events against the
    BCNN baselines, on both packages."""
    events = [27_000.0, 1_500.0]
    sizes = (4096, 512, 2)
    snn = energy.snn_ops_from_events(sizes, 25, events)
    ref_snn = ref_energy.snn_ops_from_events(sizes, 25, events)
    small = energy.bcnn_inference_ops(
        *bcnn.conv_shapes_for_energy(bcnn.BCNNConfig()))
    ref_small = ref_energy.bcnn_inference_ops(
        *ref_bcnn.conv_shapes_for_energy(ref_bcnn.BCNNConfig()))
    assert energy.energy_reduction(snn, small) == (
        ref_energy.energy_reduction(ref_snn, ref_small))
    assert energy.energy_reduction(snn, energy.bcnn36_inference_ops()) == (
        ref_energy.energy_reduction(ref_snn, ref_energy.bcnn36_inference_ops()))


# ----------------------- tests/test_energy.py:26-84, made on the port
def _snn_ops(rates=(0.35, 0.02, 0.02)):
    return energy.snn_inference_ops((4096, 512, 2), 25, rates)


def test_snn_beats_bcnn_baseline_energy_per_inference():
    reduction = energy.energy_reduction(_snn_ops(),
                                        energy.bcnn36_inference_ops())
    assert reduction > 0.75, reduction  # paper: 0.86


def test_energy_reduction_tracks_paper_magnitude():
    red = energy.energy_reduction(_snn_ops(), energy.bcnn36_inference_ops())
    assert 0.75 < red < 0.98


def test_event_driven_saves_energy():
    dense = energy.snn_inference_ops(
        (4096, 512, 2), 25, (1.0, 1.0, 1.0), event_driven=False)
    sparse = energy.snn_inference_ops(
        (4096, 512, 2), 25, (0.1, 0.05, 0.02), event_driven=True)
    assert sparse.energy_pj() < 0.2 * dense.energy_pj()


def test_add_cheaper_than_mac_per_op():
    e = energy.ENERGY_PJ
    assert e["add_i32"] < (e["mul_i16"] + e["add_i32"]) / 3


def test_rate_coding_traffic_caveat():
    """At input rate ~0.35 over 25 steps the SNN re-fetches weights more
    than one dense 16-bit pass of the same network does."""
    fcn = energy.dense_fcn_inference_ops((4096, 512, 2))
    assert fcn.energy_pj() < _snn_ops().energy_pj()


def test_paper_86pct_claim_shape():
    """(1093 - 143) / 1093 = 86.9 %: the gain formula on the paper's own
    Table 2 numbers."""

    class Fake:
        def __init__(self, gopsw):
            self._g = gopsw

        def gops_per_watt(self):
            return self._g

    t2 = energy.PAPER_TABLE2
    gain = energy.efficiency_gain(Fake(t2["snn"]["gops_per_w"]),
                                  Fake(t2["bcnn36"]["gops_per_w"]))
    assert abs(gain - 0.869) < 1e-2


def test_small_bcnn_op_model_consistent():
    ops = energy.bcnn_inference_ops(
        *bcnn.conv_shapes_for_energy(bcnn.BCNNConfig()))
    assert ops.total_ops() > 0
    assert ops.energy_pj() > 0
