"""The port's Eqs. 1-10 estimator against the reference on the CPU.

The reference is ``repro.Session(backend="numpy-batch")`` and the scalar
loop, never ``jax-jit``.  Tolerances: the torch core on ``device="cpu"``
runs the same float64 operations in the same order as NumPy, so its sweep
is held bit-equal; the scalar loop sums per LSU in another order (rtol
1e-9, the reference's own scalar-vs-batch check); ``estimate_many``'s
segment sum against single estimates rtol 1e-12 (tests/test_api.py).
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch as rt
from repro_torch.core import stream as rt_stream
from repro.core import DDR4_1866, DDR4_2666

REF_TYPES = [repro.LsuType.BC_ALIGNED, repro.LsuType.BC_NON_ALIGNED,
             repro.LsuType.BC_WRITE_ACK, repro.LsuType.ATOMIC_PIPELINED]
PORT_TYPES = [rt.LsuType(t.value) for t in REF_TYPES]

#: tests/test_api.py's 864-point backend-equivalence grid, once per package.
REF_GRID = dict(lsu_type=REF_TYPES, n_ga=[1, 2, 4], simd=[1, 4, 16],
                n_elems=[1 << 14, 1 << 16], delta=[1, 2, 7],
                include_write=[False, True], dram=[DDR4_1866, DDR4_2666])
PORT_GRID = dict(REF_GRID, lsu_type=PORT_TYPES,
                 dram=[rt.DDR4_1866, rt.DDR4_2666])


def _lsu_key(l):
    return (l.lsu_type.value, l.ls_width, l.ls_acc, l.ls_bytes, l.delta,
            l.is_write, l.val_constant, l.name, l.span_bytes)


@pytest.fixture(scope="module")
def grid_pair():
    ref = repro.Session(backend="numpy-batch").sweep(
        repro.Space.grid(**REF_GRID))
    got = rt.Session(device="cpu").sweep(rt.Space.grid(**PORT_GRID))
    return ref, got


class TestGridParity:
    def test_estimates_bit_equal(self, grid_pair):
        ref, got = grid_pair
        assert got.n_points == ref.n_points == 864
        for col in ("t_exe", "bound_ratio", "t_ideal", "t_ovh",
                    "total_bytes"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got.estimate, col)),
                np.asarray(getattr(ref.estimate, col)), err_msg=col)

    def test_classification_resource_and_selection_equal(self, grid_pair):
        ref, got = grid_pair
        np.testing.assert_array_equal(got.memory_bound, ref.memory_bound)
        np.testing.assert_array_equal(got.resource, ref.resource)
        assert got.top_k(10) == ref.top_k(10)
        np.testing.assert_array_equal(got.pareto(), ref.pareto())
        np.testing.assert_array_equal(
            got.pareto(["t_exe", "resource", "bound_ratio"]),
            ref.pareto(["t_exe", "resource", "bound_ratio"]))
        assert got.rows() == ref.rows()
        want = dict(ref.summary(), backend="torch")
        assert got.summary() == want

    def test_scalar_backend_matches_batch(self, grid_pair):
        _, got = grid_pair
        sc = rt.Session(device="cpu", backend="scalar").sweep(
            rt.Space.grid(**PORT_GRID))
        np.testing.assert_allclose(sc.t_exe, got.t_exe, rtol=1e-9, atol=0.0)
        np.testing.assert_allclose(np.asarray(sc.estimate.bound_ratio),
                                   np.asarray(got.estimate.bound_ratio),
                                   rtol=1e-9)
        np.testing.assert_array_equal(sc.memory_bound, got.memory_bound)
        np.testing.assert_array_equal(sc.resource, got.resource)


def test_random_space_draws_like_the_reference():
    axes = dict(n_ga=(1, 8), simd=[1, 2, 4, 8, 16], n_elems=(1 << 12, 1 << 16))
    ref = repro.Session().sweep(repro.Space.random(
        64, seed=7, lsu_type=REF_TYPES, **axes))
    got = rt.Session(device="cpu").sweep(rt.Space.random(
        64, seed=7, lsu_type=PORT_TYPES, **axes))
    np.testing.assert_array_equal(got.t_exe, ref.t_exe)
    assert got.rows() == ref.rows()


def test_hardware_axis_and_calibration_match_reference():
    def sweep(pkg, sess, types):
        return sess.sweep(pkg.Space.grid(
            lsu_type=types, n_ga=[1, 3], n_elems=[1 << 14],
            hardware=[None, pkg.hw.get("tpu_v5e").with_host_factor(1.5)]))

    ref = sweep(repro, dataclasses.replace(repro.Session(),
                                           calibration_factor=2.0), REF_TYPES)
    got = sweep(rt, dataclasses.replace(rt.Session(device="cpu"),
                                        calibration_factor=2.0), PORT_TYPES)
    np.testing.assert_array_equal(got.t_exe, ref.t_exe)
    assert got.rows() == ref.rows()


@pytest.mark.parametrize("t", REF_TYPES, ids=lambda t: t.value)
def test_single_estimate_matches_reference_scalar(t):
    ref = repro.Session(backend="scalar").estimate(repro.Design.microbench(
        t, n_ga=3, simd=16, n_elems=1 << 16, delta=7))
    d = rt.Design.microbench(rt.LsuType(t.value), n_ga=3, simd=16,
                             n_elems=1 << 16, delta=7)
    for backend in rt.BACKENDS:
        got = rt.Session(device="cpu", backend=backend).estimate(d)
        assert got.t_exe == pytest.approx(ref.t_exe, rel=1e-9)
        assert got.memory_bound == ref.memory_bound
        assert got.n_lsu == ref.n_lsu
    scalar = rt.Session(device="cpu", backend="scalar").estimate(d)
    assert [(_lsu_key(p.lsu), p.t_ideal, p.t_ovh) for p in scalar.per_lsu] \
        == [(_lsu_key(p.lsu), p.t_ideal, p.t_ovh) for p in ref.per_lsu]


def test_estimate_many_matches_single():
    designs = [rt.Design.microbench(t, n_ga=2, n_elems=1 << 14)
               for t in PORT_TYPES]
    designs.append(rt.Design.from_app("vectoradd", 1 << 16))
    sess = rt.Session(device="cpu")
    for d, e in zip(designs, sess.estimate_many(designs)):
        assert e.t_exe == pytest.approx(sess.estimate(d).t_exe, rel=1e-12)


def test_design_builders_match_reference():
    for t_ref, t in zip(REF_TYPES, PORT_TYPES):
        a = repro.Design.microbench(t_ref, n_ga=2, simd=4, n_elems=1 << 12,
                                    delta=3)
        b = rt.Design.microbench(t, n_ga=2, simd=4, n_elems=1 << 12, delta=3)
        assert [_lsu_key(l) for l in b.lsus] == [_lsu_key(l) for l in a.lsus]
        assert (b.f, b.name, b.n_lsu, b.total_bytes, b.resource_bytes) == \
            (a.f, a.name, a.n_lsu, a.total_bytes, a.resource_bytes)
    for app in repro.core.apps.APPS:
        a, b = repro.Design.from_app(app, 1 << 16), rt.Design.from_app(app, 1 << 16)
        assert [_lsu_key(l) for l in b.lsus] == [_lsu_key(l) for l in a.lsus]
    classes = {"stream": 1 << 20, "strided": 1 << 16, "gather": 1 << 12}
    a = repro.Design.from_classes(classes, flops=5.0)
    b = rt.Design.from_classes(classes, flops=5.0)
    assert [_lsu_key(l) for l in b.lsus] == [_lsu_key(l) for l in a.lsus]
    d = rt.Design(lsus=()).with_access(rt.LsuType.BC_ALIGNED, n_elems=1 << 10,
                                       f=4).with_dram(rt.DDR4_2666).with_f(2)
    assert (d.n_lsu, d.dram, d.f) == (1, rt.DDR4_2666, 2)


def test_session_derivations():
    sess = rt.Session(device="cpu")
    d = rt.Design.microbench(rt.LsuType.BC_ALIGNED, n_ga=2, n_elems=1 << 16)
    raw = sess.estimate(d)
    cal = dataclasses.replace(sess, calibration_factor=2.0).estimate(d)
    assert cal.t_exe == pytest.approx(2.0 * raw.t_exe, rel=1e-12)
    assert cal.bound_ratio == raw.bound_ratio
    fast = sess.with_dram(rt.DDR4_2666)
    assert fast.hardware is None and fast.estimate(d).t_exe < raw.t_exe
    assert sess.estimate(d.with_dram(rt.DDR4_2666)).t_exe == \
        fast.estimate(d).t_exe
    assert sess.with_backend("scalar").estimate(d).t_exe == \
        pytest.approx(raw.t_exe, rel=1e-12)


def test_report_protocol_and_unported_options():
    sess = rt.Session(device="cpu")
    res = sess.sweep(n_ga=[1, 2, 4], lsu_type=PORT_TYPES, n_elems=[1 << 14])
    assert res.kind == "sweep" and len(res.rows()) == res.n_points == 12
    assert res.to_csv().splitlines()[0].startswith("lsu_type")
    assert res.best().t_exe == pytest.approx(float(np.min(res.t_exe)))
    assert sess.sweep({"n_ga": [1, 2]}).n_points == 2
    with pytest.raises(TypeError):
        sess.sweep(rt.Space.grid(n_ga=[1]), n_ga=[2])
    # the five streaming options, once unported, now give the
    # materialized result on a one-point grid
    one = sess.sweep(rt.Space.grid(n_ga=[1]))
    top1 = [rt_stream.TopKReducer(1)]
    for kwargs in (dict(chunk_size=64), dict(reducers=top1), dict(workers=2),
                   dict(executor="processes"),
                   dict(constraints=[rt.ResourceEnvelope(lsu_ports=64)])):
        got = sess.sweep(rt.Space.grid(n_ga=[1]), **kwargs)
        assert got.n_points == 1, kwargs
        assert got.rows() == one.rows(), kwargs
        assert got.best() == one.best(), kwargs
        assert got.summary()["t_exe_min_ms"] == \
            one.summary()["t_exe_min_ms"], kwargs
