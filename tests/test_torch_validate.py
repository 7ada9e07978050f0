"""The port's measured-vs-predicted harness on the CPU: the four cases close
the loop end to end (finite errors, the stream anchor's error ~0, CSV-able
rows — the contract of tests/test_validate.py), a broken case becomes a
failure record, and given the same classed bytes and measured times the
prediction side equals the reference's ``lsus_from_classes`` ->
``estimate_batch`` -> host factor within rtol 1e-12."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import validate as REF
from repro.core.model_batch import GroupBatch as RefGroupBatch
from repro.core.model_batch import estimate_batch as ref_estimate_batch
from repro_torch.core import validate as V


@pytest.fixture(scope="module")
def report():
    return rt.Session(device="cpu").validate(V.default_cases(small=True),
                                             iters=2, warmup=1)


def test_four_cases_close_the_loop(report):
    assert report.failures == []
    assert [r.name for r in report.results] == [
        "membench_aligned", "membench_strided", "membench_gather",
        "decode_attention"]
    for r in report.results:
        assert np.isfinite(r.err_pct) and r.measured_s > 0
        assert np.isfinite(r.predicted_s) and r.predicted_s > 0
        assert r.bytes_moved > 0 and r.backend == "cpu"
    assert report.results[0].err_pct < 1e-6
    assert report.calibration_factor > 0
    rows = report.rows()
    assert all(set(rows[0]) == set(r) for r in rows)
    assert report.to_csv().splitlines()[0].startswith("kernel")
    assert report.summary()["kernels"] == 4
    spec = rt.hw.Hardware.from_calibration(report, name="cpu-calibrated")
    assert rt.hw.Hardware.from_json(spec.to_json()) == spec
    assert rt.Session(device="cpu").with_calibration(report).dram == report.dram


@pytest.mark.parametrize("i", range(4))
def test_each_case_names_its_plain_version(i):
    """``plain`` takes the case's own arguments (block, delta, ids): on the
    CPU, where the wrapper runs its plain version, the two agree exactly."""
    case = V.default_cases(small=True)[i]
    fn, args, _ = case.build(torch.device("cpu"))
    assert torch.equal(fn(*args), case.plain(*args))


def test_failed_case_becomes_record_not_exception():
    def boom(device):
        raise RuntimeError("no kernel here")

    rep = rt.Session(device="cpu").validate([V.ValidationCase("broken", boom)],
                                            iters=1)
    assert rep.results == [] and len(rep.failures) == 1
    assert "no kernel here" in rep.failures[0]["error"]


def test_prediction_side_matches_reference():
    traffic = [
        ("membench_aligned", True, 3.1e-4, {"stream": 1 << 30}),
        ("membench_strided", False, 7.5e-5,
         {"strided": 2 << 24, "stream": 1 << 24}),
        ("membench_gather", False, 7.6e-5,
         {"gather": 2 << 24, "stream": (1 << 24) + (1 << 17)}),
        ("decode_attention", False, 1.1e-3, {"stream": 536985604}),
    ]
    measured = [(V.ValidationCase(name, None, calibration=cal), t,
                 {"bytes_by_class": {k: float(v) for k, v in bbc.items()},
                  "total_bytes": float(sum(bbc.values())), "flops": 0.0})
                for name, cal, t, bbc in traffic]
    base = rt.Session(device="cpu").dram
    got = V._report(measured, [], backend="cpu", dram=None, base=base,
                    fit_host_factor=True, device="cpu")

    anchor_bw = (1 << 30) / 3.1e-4
    ref_dram = REF.calibrate_dram(anchor_bw)
    kernels = [REF.lsus_from_classes(dict(bbc)) for *_, bbc in traffic]
    t_raw = np.asarray(ref_estimate_batch(
        RefGroupBatch.from_kernels(kernels, ref_dram)).t_exe)
    factor = 3.1e-4 / t_raw[0]
    assert got.measured_bw == anchor_bw
    assert dataclasses.asdict(got.dram) == dataclasses.asdict(ref_dram)
    assert got.calibration_factor == pytest.approx(factor, rel=1e-12)
    np.testing.assert_allclose([r.predicted_s for r in got.results],
                               t_raw * factor, rtol=1e-12)
    np.testing.assert_array_equal(
        [r.memory_bound for r in got.results],
        np.asarray(ref_estimate_batch(
            RefGroupBatch.from_kernels(kernels, ref_dram)).memory_bound))

    fixed = V._report(measured, [], backend="cpu", dram=base, base=base,
                      fit_host_factor=False, device="cpu")
    t_fixed = np.asarray(ref_estimate_batch(
        RefGroupBatch.from_kernels(kernels, REF._default_dram())).t_exe)
    assert fixed.calibration_factor == 1.0
    np.testing.assert_allclose([r.predicted_s for r in fixed.results],
                               t_fixed, rtol=1e-12)


def test_mapping_and_calibration_units_match_reference():
    classes = {"stream": 1 << 20, "strided": 1 << 16, "gather": 1 << 12,
               "serialized": 1 << 10, "empty": 0.0}
    key = lambda l: (l.lsu_type.value, l.ls_width, l.ls_acc, l.name)  # noqa: E731
    assert [key(l) for l in V.lsus_from_classes(classes)] == \
        [key(l) for l in REF.lsus_from_classes(classes)]
    assert V.ACCESS_BYTES == REF.ACCESS_BYTES
    assert dataclasses.asdict(V.calibrate_dram(40e9)) == \
        dataclasses.asdict(REF.calibrate_dram(40e9))
    t = V.time_callable(lambda x: x + 1, (torch.ones(8),), device="cpu",
                        iters=2, warmup=1)
    assert np.isfinite(t) and t > 0
