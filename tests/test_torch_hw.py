"""The port's hardware-spec layer against the reference ``repro.hw``: every
preset's JSON round-trips through the port's ``Hardware`` byte for byte,
the legacy views are equal field by field, and a calibration folds back
into the same spec.  Exact equality throughout: these are copies of data."""
import dataclasses
import types

import pytest

import repro
import repro_torch as rt
from repro.core import validate as V

PRESETS = ("stratix10_ddr4_1866", "stratix10_ddr4_2666", "tpu_v5e", "tpu_v4")


@pytest.mark.parametrize("name", PRESETS)
def test_reference_json_round_trips(name):
    text = repro.hw.get(name).to_json()
    spec = rt.hw.Hardware.from_json(text)
    assert spec.to_json() == text
    assert rt.hw.get(name).to_json() == text


@pytest.mark.parametrize("name", PRESETS)
def test_views_equal_field_by_field(name):
    ref, port = repro.hw.get(name), rt.hw.get(name)
    for view in ("dram_params", "bsp_params", "tpu_params"):
        assert dataclasses.asdict(getattr(port, view)()) == \
            dataclasses.asdict(getattr(ref, view)()), view
    assert port.dram_params().bw_mem == ref.dram_params().bw_mem
    assert port.bsp_params().max_transaction_bytes(port.dram_params()) == \
        ref.bsp_params().max_transaction_bytes(ref.dram_params())


def test_derived_spec_round_trips_both_ways():
    ref = (repro.hw.get("tpu_v5e").with_name("derived")
           .with_efficiencies(k_gather=0.5).with_host_factor(1.7))
    port = (rt.hw.get("tpu_v5e").with_name("derived")
            .with_efficiencies(k_gather=0.5).with_host_factor(1.7))
    assert port.to_json() == ref.to_json()
    assert repro.hw.Hardware.from_json(port.to_json()) == ref


def test_from_calibration_matches_reference():
    def report(DramParams):
        dram = DramParams(**dataclasses.asdict(V.calibrate_dram(5e9)))
        rows = [types.SimpleNamespace(name=n, measured_s=m, predicted_s=p)
                for n, m, p in (("membench_aligned", 1.0, 1.0),
                                ("membench_strided", 1.0, 0.8),
                                ("membench_gather", 2.0, 1.0))]
        return types.SimpleNamespace(results=rows, dram=dram,
                                     measured_bw=5e9, calibration_factor=1.7)

    ref = repro.hw.Hardware.from_calibration(
        report(repro.DramParams), name="cal")
    port = rt.hw.Hardware.from_calibration(
        report(rt.DramParams), name="cal")
    assert port.to_json() == ref.to_json()


def test_registry_register_lookup_unregister():
    custom = rt.hw.get("tpu_v5e").with_name("test-torch-custom")
    try:
        assert rt.hw.register(custom) is custom
        assert rt.hw.get("test-torch-custom") is custom
        with pytest.raises(ValueError, match="already registered"):
            rt.hw.register(custom)
    finally:
        rt.hw.unregister("test-torch-custom")
    with pytest.raises(KeyError, match="tpu_v5e"):
        rt.hw.get("test-torch-custom")
    with pytest.raises(TypeError):
        rt.hw.register(rt.DDR4_1866)


@pytest.mark.parametrize("name", PRESETS)
def test_session_with_hardware_matches_reference(name):
    ref = repro.Session(backend="numpy-batch").with_hardware(
        repro.hw.get(name))
    port = rt.Session(device="cpu").with_hardware(rt.hw.get(name))
    for t in ("BC_ALIGNED", "BC_NON_ALIGNED", "BC_WRITE_ACK",
              "ATOMIC_PIPELINED"):
        a = ref.estimate(repro.Design.microbench(
            getattr(repro.LsuType, t), n_ga=3, simd=4, n_elems=1 << 14,
            delta=7))
        b = port.estimate(rt.Design.microbench(
            getattr(rt.LsuType, t), n_ga=3, simd=4, n_elems=1 << 14, delta=7))
        assert (b.t_exe, b.bound_ratio, b.memory_bound) == \
            (a.t_exe, a.bound_ratio, a.memory_bound)
