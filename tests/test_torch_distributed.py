"""The port's process executor (``repro_torch.core.distributed``) and its
picklable ``SweepPlan``, on the CPU.

The plan round-trips through pickle and JSON; spawned workers rebuild it
and fold chunk-aligned units, and the merged result equals the in-process
run bit for bit (front ids, top-k rows, stats; the variance to 1e-12, the
reference's bound for Chan merges across units) and the reference's
streaming sweep.  A killed worker and a straggler are re-issued.  The
executor's refusals match the reference's.  Four worker pools in all.
"""
import pickle

import numpy as np
import pytest

import repro
import repro_torch as rt
from repro.core import DDR4_1866, DDR4_2666
from repro_torch.core import distributed as dist
from repro_torch.core.stream import (ParetoReducer, StatsReducer, SweepPlan,
                                     TopKReducer, default_reducers)

#: The reference's 48-point distributed test grid (tests/test_distributed.py).
REF_GRID = dict(lsu_type=[repro.LsuType.BC_ALIGNED,
                          repro.LsuType.ATOMIC_PIPELINED],
                n_ga=[1, 2, 4], simd=[1, 16], n_elems=[1 << 12, 1 << 14],
                dram=[DDR4_1866, DDR4_2666])
GRID = dict(REF_GRID, lsu_type=[rt.LsuType.BC_ALIGNED,
                                rt.LsuType.ATOMIC_PIPELINED],
            dram=[rt.DDR4_1866, rt.DDR4_2666])
CPU = rt.Session(device="cpu")


@pytest.fixture(scope="module")
def plan():
    return CPU.plan(rt.Space.grid(**GRID), chunk_size=8)


@pytest.fixture(scope="module")
def serial(plan):
    reducers = default_reducers()
    plan.run(reducers)
    return reducers


def _assert_matches_serial(merged, serial):
    for got, ref in zip(merged, serial):
        if isinstance(got, ParetoReducer):
            np.testing.assert_array_equal(got.ids, ref.ids)
        elif isinstance(got, TopKReducer):
            np.testing.assert_array_equal(got.ids, ref.ids)
            for k in ref.cols:
                np.testing.assert_array_equal(got.cols[k], ref.cols[k])
        else:
            g, r = got.summary(), ref.summary()
            assert g["t_exe_var"] == pytest.approx(r["t_exe_var"],
                                                   rel=1e-12, abs=1e-24)
            g.pop("t_exe_var"), r.pop("t_exe_var")
            assert g == r


class TestSweepPlan:
    def test_pickle_and_json_round_trip(self, plan):
        assert pickle.loads(pickle.dumps(plan)) == plan
        assert SweepPlan.from_json(plan.to_json()) == plan
        assert plan.device == "cpu"

    def test_json_round_trip_hardware_axis_and_constraints(self):
        p = CPU.plan(rt.Space.grid(
            n_ga=[1, 2], n_elems=[1 << 12],
            hardware=[None, rt.hw.get("tpu_v4")]), chunk_size=4,
            constraints=[rt.ResourceEnvelope(lsu_ports=8)])
        p2 = SweepPlan.from_json(p.to_json())
        assert p2 == p and pickle.loads(pickle.dumps(p)) == p
        ids = np.arange(p.n, dtype=np.int64)
        a, b = p.evaluator()(ids), p2.evaluator()(ids)
        np.testing.assert_array_equal(a["t_exe"], b["t_exe"])

    def test_rebuilt_plan_scores_identically(self, plan, serial):
        reducers = default_reducers()
        SweepPlan.from_json(plan.to_json()).run(reducers)
        _assert_matches_serial(reducers, serial)

    def test_alignment_backend_and_device_checks(self, plan, monkeypatch):
        with pytest.raises(ValueError, match="chunk"):
            plan.run_range(3, plan.n, default_reducers())
        with pytest.raises(ValueError, match="chunk"):
            plan.run_range(0, 9, default_reducers())
        with pytest.raises(ValueError, match="backend"):
            SweepPlan(lists=dict(plan.lists), backend="numpy-batch")
        import torch

        # a plan without a device means the card, resolved where it runs
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        bare = SweepPlan(lists=dict(plan.lists))
        assert bare.device is None
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bare.evaluator()

    def test_partition_merges_equal_serial(self, plan, serial):
        rng = np.random.default_rng(0)
        for _ in range(5):
            cuts = np.sort(rng.choice(np.arange(1, plan.n_chunks), size=int(
                rng.integers(0, 4)), replace=False))
            bounds = [0] + [int(c) * plan.chunk_size for c in cuts] \
                + [plan.n]
            base = default_reducers()
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                part = plan.run_range(lo, hi, default_reducers())
                for b, p in zip(base, part):
                    b.merge(type(b).from_state(p.state_dict()))
            _assert_matches_serial(base, serial)


class TestDistributedExecutor:
    def test_processes_bit_equal_to_threads_and_reference(self):
        rep_t = CPU.sweep(rt.Space.grid(**GRID), chunk_size=8)
        rep_p = CPU.sweep(rt.Space.grid(**GRID), chunk_size=8,
                          executor="processes", workers=2, profile=True)
        assert rep_p.profile["path"] == "distributed"
        np.testing.assert_array_equal(rep_p.point_ids, rep_t.point_ids)
        np.testing.assert_array_equal(rep_p.front_idx, rep_t.front_idx)
        np.testing.assert_array_equal(rep_p.topk_idx, rep_t.topk_idx)
        assert rep_p.rows() == rep_t.rows()
        assert rep_p.stats["t_exe_sum"] == rep_t.stats["t_exe_sum"]
        assert rep_p.stats["t_exe_var"] == pytest.approx(
            rep_t.stats["t_exe_var"], rel=1e-12)
        ref = repro.Session(backend="numpy-batch").sweep(
            repro.Space.grid(**REF_GRID), chunk_size=8)
        np.testing.assert_array_equal(rep_p.point_ids, ref.point_ids)
        assert rep_p.rows() == ref.rows()

    def test_killed_worker_reissued(self, plan, serial, tmp_path,
                                    monkeypatch):
        marker = tmp_path / "killed"
        monkeypatch.setenv(dist._FAULT_ENV, f"1:kill:{marker}")
        out = dist.run_distributed(plan, default_reducers(), workers=2,
                                   unit_chunks=2)
        assert marker.exists(), "fault never fired"
        _assert_matches_serial(out.reducers, serial)

    def test_straggling_worker_reissued(self, plan, serial, tmp_path,
                                        monkeypatch):
        marker = tmp_path / "hung"
        monkeypatch.setenv(dist._FAULT_ENV, f"1:hang:{marker}")
        out = dist.run_distributed(plan, default_reducers(), workers=2,
                                   unit_chunks=2, straggler_timeout_s=3.0)
        assert marker.exists(), "fault never fired"
        _assert_matches_serial(out.reducers, serial)

    def test_custom_reducer_configuration_survives_transport(self, plan):
        out = dist.run_distributed(plan, (TopKReducer(k=3, key="resource"),
                                          ParetoReducer(("t_exe", "n_lsu"))),
                                   workers=1)
        ref = (TopKReducer(k=3, key="resource"),
               ParetoReducer(("t_exe", "n_lsu")), StatsReducer())
        plan.run(ref)
        np.testing.assert_array_equal(out.reducers[0].ids, ref[0].ids)
        np.testing.assert_array_equal(out.reducers[1].ids, ref[1].ids)


class TestExecutorErrorMatrix:
    def test_unknown_executor_and_workers_below_one(self):
        with pytest.raises(ValueError, match="unknown executor 'mpi'"):
            CPU.sweep(rt.Space.grid(n_ga=[1]), executor="mpi")
        with pytest.raises(ValueError, match="workers must be >= 1"):
            CPU.sweep(rt.Space.grid(n_ga=[1]), workers=0)

    def test_threads_workers_on_scalar_and_cuda(self, monkeypatch):
        with pytest.raises(ValueError, match="GIL-bound"):
            rt.Session(device="cpu", backend="scalar").sweep(
                rt.Space.grid(n_ga=[1]), workers=2)
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        cuda = rt.Session(device="cuda")
        with pytest.raises(ValueError, match="already runs the whole chunk"):
            cuda.sweep(rt.Space.grid(n_ga=[1]), workers=2)

    def test_processes_on_random_space(self):
        with pytest.raises(TypeError, match="grid space"):
            CPU.sweep(rt.Space.random(4, seed=0, n_ga=(1, 8)),
                      executor="processes")

    def test_empty_grids(self):
        for kw in ({}, {"chunk_size": 4},
                   {"executor": "processes", "workers": 2}):
            rep = CPU.sweep(rt.Space.grid(n_ga=[], simd=[1, 2]), **kw)
            assert rep.n_points == 0 and rep.rows() == []
        p = CPU.plan(rt.Space.grid(n_ga=[], simd=[1]), chunk_size=4)
        assert p.n == 0 and p.n_chunks == 0
        assert SweepPlan.from_json(p.to_json()) == p
