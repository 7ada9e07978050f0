"""The port's device fold (``repro_torch.core.device_stream``) on CPU
tensors, against the port's host fold and the reference's host fold.

The device fold is the same code on the card and on the CPU; here it runs
on CPU tensors.  Folds of the same chunk-aligned partition are compared
through the merge protocol, state for state (the exact sums through
``math.fsum``, fronts sorted by id — the reference's own canonical form,
tests/test_device_stream.py), under seeded and Hypothesis partitions.
Capacity overflow, forced with a small ``FRONT_CAP``/``N_PARTIALS``, must
leave the reducers untouched and refold on the host.

Through an ``enable_x64`` shim (the ``x64_shim`` fixture: jax 0.9 has no
``jax.experimental.enable_x64``, which the reference imports by name) the
reference's own device fold — its ``jax-jit`` ``device-fused`` path — runs
too, and the port's device fold equals it: on the 864-point grid, under
partitions, and on a streamed grid of 115,200 points.
"""
import contextlib
import math

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core import DDR4_1866, DDR4_2666
from repro.core import stream as ref_stream
from repro_torch.core import device_stream as dev
from repro_torch.core import stream as S

REF_TYPES = [repro.LsuType.BC_ALIGNED, repro.LsuType.BC_NON_ALIGNED,
             repro.LsuType.BC_WRITE_ACK, repro.LsuType.ATOMIC_PIPELINED]
PORT_TYPES = [rt.LsuType(t.value) for t in REF_TYPES]
REF_GRID = dict(lsu_type=REF_TYPES, n_ga=[1, 2, 4], simd=[1, 4, 16],
                n_elems=[1 << 14, 1 << 16], delta=[1, 2, 7],
                include_write=[False, True], dram=[DDR4_1866, DDR4_2666])
PORT_GRID = dict(REF_GRID, lsu_type=PORT_TYPES,
                 dram=[rt.DDR4_1866, rt.DDR4_2666])
N = 864


def _plan(chunk):
    return rt.Session(device="cpu").plan(rt.Space.grid(**PORT_GRID),
                                         chunk_size=chunk)


def _ref_plan(chunk):
    return repro.Session(backend="numpy-batch").plan(
        repro.Space.grid(**REF_GRID), chunk_size=chunk)


def _canon(reducers) -> list:
    """state_dicts in the representation-invariant form: exact sums through
    ``math.fsum``, front rows sorted by id, the rest exactly."""
    out = []
    for r in reducers:
        s = r.state_dict()
        if type(r).__name__ == "StatsReducer":
            s = dict(s, t_exe_sum=math.fsum(s["t_exe_sum"]),
                     total_bytes_sum=math.fsum(s["total_bytes_sum"]))
        elif type(r).__name__ == "ParetoReducer" and s["cols"] is not None:
            order = np.argsort(np.asarray(s["cols"]["id"][1]))
            s = dict(s, cols={c: [d, [v[i] for i in order]]
                              for c, (d, v) in sorted(s["cols"].items())})
        elif s.get("cols") is not None:
            s = dict(s, cols=dict(sorted(s["cols"].items())))
        out.append(s)
    return out


def _protocol(fold, base, bounds):
    """Fold each range of ``bounds`` into fresh reducers and merge the
    states in range order — the process executor's protocol."""
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        fresh = tuple(r.fresh() for r in base)
        fold(lo, hi, fresh)
        for b, r in zip(base, fresh):
            b.merge(type(b).from_state(r.state_dict()))
    return _canon(base)


def _device_fold(chunk, bounds):
    drv = dev.DeviceSweep.build(_plan(chunk))
    return _protocol(drv.fold_range, S.default_reducers(10), bounds)


def _host_fold(chunk, bounds):
    plan = _plan(chunk)
    ev = plan.evaluator()
    return _protocol(lambda lo, hi, rs: plan.run_range(lo, hi, rs,
                                                       eval_chunk=ev),
                     S.default_reducers(10), bounds)


def _ref_fold(chunk, bounds):
    plan = _ref_plan(chunk)
    ev = plan.evaluator()
    return _protocol(lambda lo, hi, rs: plan.run_range(lo, hi, rs,
                                                       eval_chunk=ev),
                     ref_stream.default_reducers(10), bounds)


def _random_bounds(rng, chunk):
    n_chunks = -(-N // chunk)
    cuts = sorted(set(rng.integers(1, max(n_chunks, 2),
                                   int(rng.integers(0, 6))).tolist()))
    return [0] + [min(c * chunk, N) for c in cuts if c < n_chunks] + [N]


class TestBitEquality:
    @pytest.mark.parametrize("chunk", [37, 100, 864, 4096])
    def test_whole_grid_matches_both_host_folds(self, chunk):
        """One range [0, n), any chunk size (a non-dividing chunk with a
        masked tail, and one larger than the grid)."""
        got = _device_fold(chunk, [0, N])
        assert got == _host_fold(chunk, [0, N])
        assert got == _ref_fold(chunk, [0, N])

    def test_seeded_partitions(self):
        rng = np.random.default_rng(7)
        for chunk in (16, 37, 100):
            for _ in range(3):
                bounds = _random_bounds(rng, chunk)
                assert _device_fold(chunk, bounds) == \
                    _ref_fold(chunk, bounds), (chunk, bounds)

    def test_hypothesis_partitions(self):
        @hypothesis.settings(max_examples=12, deadline=None)
        @hypothesis.given(chunk=st.sampled_from([8, 29, 64, 200]),
                          seed=st.integers(0, 2 ** 31 - 1))
        def prop(chunk, seed):
            bounds = _random_bounds(np.random.default_rng(seed), chunk)
            assert _device_fold(chunk, bounds) == _ref_fold(chunk, bounds)

        prop()

    @pytest.mark.parametrize("config", [
        (("n_ga", 7), ("resource", "n_lsu")),
        (("memory_bound", 5), ("t_exe", "n_ga")),
        (("id", 300), ("delta", "simd")),
    ])
    def test_custom_reducer_configs(self, config):
        """Top-k by integer and bool columns (k past a chunk, too) and
        fronts over float and integer columns: every key kind, with ties."""
        (key, k), objectives = config
        plan = _plan(50)
        mk = lambda: (S.TopKReducer(k, key=key),  # noqa: E731
                      S.ParetoReducer(objectives), S.StatsReducer())
        drv = dev.DeviceSweep.build(plan)
        assert drv.supports(mk())
        got = _protocol(drv.fold_range, mk(), [0, 400, N])
        host = _protocol(lambda lo, hi, rs: plan.run_range(lo, hi, rs),
                         mk(), [0, 400, N])
        assert got == host

    def test_unsupported_and_ineligible(self):
        drv = dev.DeviceSweep.build(_plan(64))
        assert not drv.supports((S.ParetoReducer(("t_exe", "resource",
                                                  "n_lsu")),))
        assert not drv.supports((S.TopKReducer(3, key="nope"),))
        with pytest.raises(ValueError, match="chunk-aligned"):
            drv.fold_range(5, N, S.default_reducers())
        scalar = rt.Session(device="cpu", backend="scalar").plan(
            rt.Space.grid(n_ga=[1, 2]))
        assert dev.DeviceSweep.build(scalar) is None
        constrained = rt.Session(device="cpu").plan(
            rt.Space.grid(n_ga=[1, 2]),
            constraints=[rt.ResourceEnvelope(lsu_ports=2)])
        assert dev.DeviceSweep.build(constrained) is None
        assert dev.DeviceSweep.build(rt.Session(device="cpu").plan(
            rt.Space.grid(n_ga=[1.5, 2]))) is None

    def test_hardware_axis_and_calibration(self):
        axes = dict(n_ga=[1, 2, 4], simd=[4, 16],
                    lsu_type=PORT_TYPES[:2])
        plan = rt.Session(device="cpu", calibration_factor=1.25).plan(
            rt.Space.grid(hardware=[None, rt.hw.get("stratix10_ddr4_2666")],
                          **axes), chunk_size=7)
        drv = dev.DeviceSweep.build(plan)
        got = _protocol(drv.fold_range, S.default_reducers(5), [0, plan.n])
        host = _protocol(lambda lo, hi, rs: plan.run_range(lo, hi, rs),
                         S.default_reducers(5), [0, plan.n])
        assert got == host


class TestKeysAndSums:
    def test_f64_key_orders_like_floats(self):
        rng = np.random.default_rng(3)
        x = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
            -300, 300, 500), [0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324]])
        k = dev._f64_key(torch.as_tensor(x)).numpy()
        order = np.argsort(x, kind="stable")
        assert np.all(np.diff(k[order]) >= 0)
        assert np.array_equal(k[:, None] == k[None, :],
                              x[:, None] == x[None, :])
        assert k[-6] == k[-5]                       # -0.0 folds into +0.0
        assert k[-4] == dev._INFKEY

    def test_tree_sum_rows_matches_host(self):
        rng = np.random.default_rng(11)
        for m in (1, 2, 3, 100, 1000):
            x = rng.random(m) * 1e3
            got = dev._tree_sum_rows(torch.as_tensor(x)[None, :])[0]
            assert float(got) == S._tree_sum(x)

    @pytest.mark.parametrize("full_walk", [False, True])
    def test_exact_add_matches_shewchuk(self, full_walk):
        """The walk bounded by the adds so far (eager) and the walk over
        every slot (the captured graph) give the host's partials."""
        rng = np.random.default_rng(12)
        xs = rng.random(40) * 10.0 ** rng.integers(-20, 20, 40)
        ref = S._ExactSum()
        parts = torch.zeros((1, 16), dtype=torch.float64)
        cnt = torch.zeros(1, dtype=torch.int64)
        for j, x in enumerate(xs):
            ref.add(x)
            parts, cnt, ovf = dev._exact_add(
                parts, cnt, torch.tensor([x], dtype=torch.float64),
                16 if full_walk else j)
            assert not bool(ovf[0])
            assert parts[0, :int(cnt[0])].tolist() == ref.partials
            assert not parts[0, int(cnt[0]):].any()

    def test_graph_step_form_matches_eager(self):
        """The body a CUDA graph captures — chunk scalars as 0-dim tensors,
        every partial slot walked, the carry updated in place — run op by
        op on the CPU equals the eager loop, state for state."""
        drv = dev.DeviceSweep.build(_plan(100))
        reducers = S.default_reducers(10)
        sig = drv._sig(reducers)
        with torch.no_grad():
            eager = drv._run_eager(drv._init_carry(sig), sig, 0, N, None)
            carry = drv._init_carry(sig)
            for start in range(0, N, 100):
                new = drv._step(
                    carry, sig, torch.tensor(start),
                    torch.tensor(min(100, N - start)),
                    torch.tensor(float(start), dtype=torch.float64),
                    walk=dev.N_PARTIALS)
                for st, nw in zip(carry, new):
                    for k, v in nw.items():
                        st[k].copy_(v)
        for a, b in zip(eager, carry):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k


class TestOverflow:
    def test_front_overflow_refolds_on_host(self, monkeypatch):
        monkeypatch.setattr(dev, "FRONT_CAP", 1)
        plan = _plan(100)
        drv = dev.DeviceSweep.build(plan)
        reducers = S.default_reducers(10)
        with pytest.raises(dev.DeviceFoldOverflow, match="pareto"):
            drv.fold_range(0, N, reducers)
        assert all(r.state_dict() == r.fresh().state_dict()
                   for r in reducers)
        fold = S.make_range_folder(plan)
        assert _protocol(fold, S.default_reducers(10), [0, N]) == \
            _ref_fold(100, [0, N])

    def test_partials_overflow_refolds_on_host(self, monkeypatch):
        """With one partial slot, the first chunk sum that the running
        total cannot absorb exactly has nowhere to go."""
        monkeypatch.setattr(dev, "N_PARTIALS", 1)
        plan = _plan(10)
        drv = dev.DeviceSweep.build(plan)
        reducers = S.default_reducers(10)
        with pytest.raises(dev.DeviceFoldOverflow, match="exact-sum"):
            drv.fold_range(0, N, reducers)
        assert all(r.state_dict() == r.fresh().state_dict()
                   for r in reducers)

    def test_session_sweep_shows_the_refold(self, monkeypatch):
        monkeypatch.setattr(dev, "FRONT_CAP", 1)
        sess = rt.Session(device="cpu")
        rep = sess.sweep(rt.Space.grid(**PORT_GRID), chunk_size=100,
                         profile=True)
        assert rep.profile["path"] == "host-stream"
        assert rep.profile["device_overflow"] is True
        ref = repro.Session(backend="numpy-batch").sweep(
            repro.Space.grid(**REF_GRID), chunk_size=100)
        np.testing.assert_array_equal(rep.point_ids, ref.point_ids)
        assert rep.stats == ref.stats


def test_session_sweep_takes_device_path_and_profiles():
    rep = rt.Session(device="cpu").sweep(rt.Space.grid(**PORT_GRID),
                                         chunk_size=100, profile=True)
    prof = rep.summary()["profile"]
    assert prof["path"] == "device"
    assert {"transfer_s", "compile_s", "score_s", "enumerate_s",
            "reduce_s", "total_s"} <= set(prof)
    assert all(v >= 0 for k, v in prof.items() if k.endswith("_s"))


# ---------------------------------------------------------------------------
# the reference's device fold, through the enable_x64 shim
# ---------------------------------------------------------------------------

@pytest.fixture
def x64_shim(monkeypatch):
    """Install ``jax.experimental.enable_x64`` (gone in jax 0.9) as a
    context manager that flips ``jax_enable_x64`` through
    ``jax.config.update``; the reference's device fold imports it by name."""
    import jax
    import jax.experimental

    @contextlib.contextmanager
    def enable_x64(new_val: bool = True):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", new_val)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)

    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64,
                        raising=False)


def _ref_device_fold(chunk, bounds):
    from repro.core import device_stream as ref_dev

    plan = repro.Session(backend="jax-jit").plan(
        repro.Space.grid(**REF_GRID), chunk_size=chunk)
    drv = ref_dev.DeviceSweep.build(plan)
    assert drv is not None and drv.supports(ref_stream.default_reducers(10))
    return _protocol(drv.fold_range, ref_stream.default_reducers(10), bounds)


class TestAgainstReferenceDeviceFold:
    @pytest.mark.parametrize("chunk", [37, 100, 864, 4096])
    def test_whole_grid(self, x64_shim, chunk):
        assert _device_fold(chunk, [0, N]) == _ref_device_fold(chunk, [0, N])

    def test_seeded_partitions(self, x64_shim):
        rng = np.random.default_rng(11)
        for chunk in (37, 100):
            for _ in range(2):
                bounds = _random_bounds(rng, chunk)
                assert _device_fold(chunk, bounds) == \
                    _ref_device_fold(chunk, bounds), bounds

    def test_streamed_grid_equals_device_fused_sweep(self, x64_shim):
        """115,200 points in 8,192-point chunks: the port's ``device`` path
        and the reference's ``device-fused`` path report the same front,
        top-k rows, survivors and every stats field."""
        axes = dict(n_ga=list(range(1, 101)), simd=[1, 4, 16],
                    n_elems=[1 << 12, 1 << 14, 1 << 16, 1 << 18],
                    delta=[1, 2, 7], include_write=[False, True],
                    val_constant=[False, True])
        ref = repro.Session(backend="jax-jit").sweep(
            repro.Space.grid(**dict(axes, lsu_type=REF_TYPES,
                                    dram=[DDR4_1866, DDR4_2666])),
            chunk_size=8192, profile=True)
        got = rt.Session(device="cpu").sweep(
            rt.Space.grid(**dict(axes, lsu_type=PORT_TYPES,
                                 dram=[rt.DDR4_1866, rt.DDR4_2666])),
            chunk_size=8192, profile=True)
        assert ref.n_points == got.n_points == 115_200
        assert ref.profile["path"] == "device-fused"
        assert got.profile["path"] == "device"
        np.testing.assert_array_equal(got.point_ids, ref.point_ids)
        np.testing.assert_array_equal(got.front_idx, ref.front_idx)
        np.testing.assert_array_equal(got.topk_idx, ref.topk_idx)
        assert got.top_k(10) == ref.top_k(10)
        assert got.stats == ref.stats
        for col in ("t_exe", "t_ideal", "t_ovh", "bound_ratio",
                    "total_bytes"):
            np.testing.assert_array_equal(getattr(got.estimate, col),
                                          getattr(ref.estimate, col), col)
