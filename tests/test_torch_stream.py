"""The port's streaming sweep engine (``repro_torch.core.stream``) against
the reference's on the CPU.

Same numpy-made grids through ``repro.Session(backend="numpy-batch")`` and
``repro_torch.Session(device="cpu")``: front ids, top-k rows and ``stats``
are held bit-equal (the reference's streaming contract), at chunk sizes
that do not divide the grid.  The reducers are run side by side on the
same synthetic columns, and the tensor core ``estimate_columns`` against
its NumPy wrapper.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core import DDR4_1866, DDR4_2666
from repro.core import stream as ref_stream
from repro_torch.core import model_batch as MB
from repro_torch.core import stream as S
from repro_torch.core.sweep import _grid_points

REF_TYPES = [repro.LsuType.BC_ALIGNED, repro.LsuType.BC_NON_ALIGNED,
             repro.LsuType.BC_WRITE_ACK, repro.LsuType.ATOMIC_PIPELINED]
PORT_TYPES = [rt.LsuType(t.value) for t in REF_TYPES]

#: The reference's 864-point streaming acceptance grid, once per package.
REF_GRID = dict(lsu_type=REF_TYPES, n_ga=[1, 2, 4], simd=[1, 4, 16],
                n_elems=[1 << 14, 1 << 16], delta=[1, 2, 7],
                include_write=[False, True], dram=[DDR4_1866, DDR4_2666])
PORT_GRID = dict(REF_GRID, lsu_type=PORT_TYPES,
                 dram=[rt.DDR4_1866, rt.DDR4_2666])

CPU = rt.Session(device="cpu")


@pytest.fixture(scope="module")
def materialized():
    return CPU.sweep(rt.Space.grid(**PORT_GRID))


@pytest.fixture(scope="module")
def ref_streams():
    sess = repro.Session(backend="numpy-batch")
    return {c: sess.sweep(repro.Space.grid(**REF_GRID), chunk_size=c)
            for c in (37, 100)}


def _assert_reports_equal(got, ref):
    """Front ids, top-k rows, stats (every field) and survivor columns."""
    assert got.is_streaming and ref.is_streaming
    np.testing.assert_array_equal(got.point_ids, ref.point_ids)
    np.testing.assert_array_equal(got.front_idx, ref.front_idx)
    np.testing.assert_array_equal(got.topk_idx, ref.topk_idx)
    assert got.top_k(10) == ref.top_k(10)
    assert got.stats == ref.stats
    for col in ("t_exe", "t_ideal", "t_ovh", "bound_ratio", "total_bytes"):
        np.testing.assert_array_equal(getattr(got.estimate, col),
                                      getattr(ref.estimate, col), col)
    np.testing.assert_array_equal(got.resource, ref.resource)
    np.testing.assert_array_equal(got.memory_bound, ref.memory_bound)
    assert got.rows() == ref.rows()


def _synthetic_cols(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int64),
            "t_exe": rng.random(n), "resource": rng.integers(1, 40, n) * 1.0,
            "memory_bound": rng.random(n) > 0.5,
            "total_bytes": rng.random(n) * 1e6}


class TestAgainstReference:
    @pytest.mark.parametrize("chunk", [37, 100])
    def test_device_fold_stream_bit_equal(self, ref_streams, chunk):
        """The CPU session's default stream (the device fold on CPU
        tensors) against the reference's numpy-batch host stream."""
        got = CPU.sweep(rt.Space.grid(**PORT_GRID), chunk_size=chunk,
                        profile=True)
        assert got.profile["path"] == "device"
        _assert_reports_equal(got, ref_streams[chunk])

    def test_host_stream_threads_bit_equal(self, ref_streams):
        got = CPU.sweep(rt.Space.grid(**PORT_GRID), chunk_size=37,
                        workers=3, profile=False)
        _assert_reports_equal(got, ref_streams[37])
        prof = CPU.sweep(rt.Space.grid(**PORT_GRID), chunk_size=37,
                         workers=3, profile=True).profile
        assert prof["path"] == "host-stream"
        assert {"enumerate_s", "score_s", "reduce_s",
                "total_s"} <= set(prof)

    def test_scalar_backend_stream(self, ref_streams):
        got = rt.Session(device="cpu", backend="scalar").sweep(
            rt.Space.grid(**PORT_GRID).stream(100))
        ref = ref_streams[100]
        np.testing.assert_array_equal(got.point_ids, ref.point_ids)
        assert [r["lsu_type"] for r in got.top_k(10)] == \
            [r["lsu_type"] for r in ref.top_k(10)]
        np.testing.assert_allclose(got.t_exe, ref.t_exe, rtol=1e-9)

    def test_streaming_matches_materialized(self, materialized):
        st = CPU.sweep(rt.Space.grid(**PORT_GRID), chunk_size=100)
        front_st = np.asarray(st.point_ids)[st.pareto()]
        np.testing.assert_array_equal(np.sort(front_st),
                                      materialized.pareto())
        assert st.top_k(10) == materialized.top_k(10)
        sm = {k: v for k, v in materialized.summary().items()}
        assert st.summary() == sm
        assert st.best().t_exe == float(np.min(materialized.t_exe))
        assert st.stats["t_exe_min"] == float(np.min(materialized.t_exe))

    def test_hardware_axis_and_calibration(self):
        """A hardware axis (spec views + host factor) and a session
        calibration factor stream identically in both packages."""
        ref_sess = repro.Session(backend="numpy-batch",
                                 calibration_factor=1.5)
        got_sess = rt.Session(device="cpu", calibration_factor=1.5)
        ref_hw = [None, repro.hw.get("stratix10_ddr4_2666")]
        got_hw = [None, rt.hw.get("stratix10_ddr4_2666")]
        axes = dict(n_ga=[1, 2, 4], simd=[4, 16])
        ref = ref_sess.sweep(repro.Space.grid(hardware=ref_hw, **axes),
                             chunk_size=5)
        got = got_sess.sweep(rt.Space.grid(hardware=got_hw, **axes),
                             chunk_size=5)
        _assert_reports_equal(got, ref)

    def test_plan_lists_and_tables_match(self):
        ref = repro.Session(backend="numpy-batch").plan(
            repro.Space.grid(**REF_GRID), chunk_size=64)
        got = CPU.plan(rt.Space.grid(**PORT_GRID), chunk_size=64)
        assert got.n == ref.n == 864 and got.n_chunks == ref.n_chunks
        assert got.device == "cpu" and got.backend == "torch"
        ids = np.arange(0, 864, 7)
        g, r = got.evaluator()(ids), ref.evaluator()(ids)
        assert list(g) == list(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], k)


class TestGridEnumerator:
    def test_codes_match_reference_and_materialized(self):
        lists = rt.Session(device="cpu").plan(
            rt.Space.grid(**PORT_GRID)).lists
        enum = S.GridEnumerator(lists)
        ref = ref_stream.GridEnumerator(repro.Session().plan(
            repro.Space.grid(**REF_GRID)).lists)
        ids = np.arange(enum.n)
        got_codes, ref_codes = enum.codes(ids), ref.codes(ids)
        for k in ref_codes:
            np.testing.assert_array_equal(got_codes[k], ref_codes[k])
        np.testing.assert_array_equal(enum.encode(got_codes), ids)
        points, n, cats = _grid_points(PORT_GRID)
        assert n == enum.n
        np.testing.assert_array_equal(cats["lsu_type"][1],
                                      got_codes["lsu_type"])

    def test_empty_axis_yields_empty_grid(self):
        rep = CPU.sweep(rt.Space.grid(n_ga=[]), chunk_size=8)
        assert rep.n_points == 0 and rep.stats["n_points"] == 0
        with pytest.raises(ValueError, match="empty"):
            rep.best()

    def test_chunk_ids_pad_with_last_id(self):
        ids, valid = S._chunk_ids(14, 17, 7)
        assert valid == 3 and ids.tolist() == [14, 15, 16, 16, 16, 16, 16]


class TestReducersAgainstReference:
    @pytest.mark.parametrize("cuts", [[123, 307, 499], [1, 2, 3], []])
    def test_fold_states_equal(self, cuts):
        cols = _synthetic_cols(500, seed=1)
        cols["t_exe"] = np.round(cols["t_exe"], 2)      # force value ties
        got = (S.ParetoReducer(), S.TopKReducer(25), S.StatsReducer())
        ref = (ref_stream.ParetoReducer(), ref_stream.TopKReducer(25),
               ref_stream.StatsReducer())
        for idx in np.split(np.arange(500), cuts):
            if len(idx):
                for r in got + ref:
                    r.update({k: v[idx] for k, v in cols.items()})
        for g, r in zip(got, ref):
            assert g.state_dict() == r.state_dict(), type(g).__name__

    def test_state_round_trip_and_merge(self):
        """Fold two chunks serially, or each into its own reducers and
        merge the states: equal (the variance to 1e-12)."""
        cols = _synthetic_cols(300, seed=4)
        chunks = np.split(np.arange(300), [130])
        whole = S.default_reducers(7)
        halves = [S.default_reducers(7), S.default_reducers(7)]
        for part, idx in zip(halves, chunks):
            for r, w in zip(part, whole):
                r.update({k: v[idx] for k, v in cols.items()})
                w.update({k: v[idx] for k, v in cols.items()})
        merged = [type(r).from_state(r.state_dict()) for r in halves[0]]
        for m, r in zip(merged, halves[1]):
            m.merge(type(r).from_state(r.state_dict()))
        for m, w in zip(merged, whole):
            if isinstance(w, S.StatsReducer):
                a, b = m.summary(), w.summary()
                assert a["t_exe_var"] == pytest.approx(b["t_exe_var"],
                                                       rel=1e-12)
                a.pop("t_exe_var"), b.pop("t_exe_var")
                assert a == b
            else:
                np.testing.assert_array_equal(m.ids, w.ids)

    def test_exact_sum_and_tree_sum(self):
        rng = np.random.default_rng(5)
        xs = rng.random(1000) * 10.0 ** rng.integers(-8, 8, 1000)
        got, ref = S._ExactSum(), ref_stream._ExactSum()
        for x in xs:
            got.add(x)
            ref.add(x)
        assert got.partials == ref.partials
        for m in (1, 5, 64, 100):
            assert S._tree_sum(xs[:m]) == ref_stream._tree_sum(xs[:m])

    def test_validation_and_merge_mismatch(self):
        with pytest.raises(ValueError):
            S.TopKReducer(k=0)
        with pytest.raises(ValueError):
            S.ParetoReducer(objectives=())
        with pytest.raises(ValueError):
            S.run_stream(4, 0, lambda ids: {}, [])
        with pytest.raises(ValueError, match="different configs"):
            S.TopKReducer(3).merge(S.TopKReducer(4))
        with pytest.raises(TypeError):
            S.StatsReducer().merge(S.TopKReducer(3))
        with pytest.raises(NotImplementedError, match="merge protocol"):
            S.Reducer().merge(S.StatsReducer())


class TestSessionStreaming:
    def test_reducer_reuse_does_not_contaminate(self):
        reds = [S.ParetoReducer(), S.TopKReducer(3), S.StatsReducer()]
        r1 = CPU.sweep(rt.Space.grid(n_ga=[1, 2], n_elems=[1 << 14]),
                       reducers=reds)
        r2 = CPU.sweep(rt.Space.grid(n_ga=[4, 8], n_elems=[1 << 14]),
                       reducers=reds)
        assert r1.stats["n_points"] == 2 and r2.stats["n_points"] == 2
        assert {row["n_ga"] for row in r2.top_k(2)} == {4, 8}
        assert reds[1].cols is None and reds[2].n_points == 0

    def test_custom_key_and_stats_only_reports(self):
        rep = CPU.sweep(rt.Space.grid(**PORT_GRID),
                        reducers=[S.TopKReducer(4, key="resource")],
                        chunk_size=50)
        full = CPU.sweep(rt.Space.grid(**PORT_GRID))
        assert rep.top_k(4, key="resource") == full.top_k(4, key="resource")
        with pytest.raises(ValueError, match="kept top-k by"):
            rep.top_k(4)
        with pytest.raises(ValueError, match="front"):
            rep.pareto()
        stats_only = CPU.sweep(rt.Space.grid(**PORT_GRID),
                               reducers=[S.StatsReducer()], chunk_size=50)
        assert stats_only.stats["t_exe_min"] == float(full.t_exe.min())
        with pytest.raises(ValueError, match="no survivor rows"):
            stats_only.best()

    def test_space_stream_and_random_space_refuse(self):
        sp = rt.Space.grid(n_ga=[1, 2]).stream(16)
        assert sp.chunk_size == 16 and CPU.sweep(sp).is_streaming
        with pytest.raises(TypeError, match="grid space"):
            rt.Space.random(8, n_ga=(1, 4)).stream()
        with pytest.raises(TypeError, match="grid space"):
            CPU.sweep(rt.Space.random(8, n_ga=(1, 4)), chunk_size=4)
        with pytest.raises(ValueError):
            rt.Space.grid(n_ga=[1]).stream(0)
        lists = rt.Space.grid(n_ga=[3]).lists(dram=rt.DDR4_2666,
                                              bsp=rt.STRATIX10_BSP)
        assert lists["n_ga"] == [3] and lists["dram"] == [rt.DDR4_2666]

    def test_materialized_profile(self):
        rep = CPU.sweep(rt.Space.grid(n_ga=[1, 2, 4]), profile=True)
        assert rep.profile["path"] == "materialized"
        assert {"enumerate_s", "score_s"} <= set(rep.summary()["profile"])


@pytest.mark.parametrize("paired", [False, True])
def test_estimate_columns_is_estimate_batch_core(paired):
    """The tensor core returns tensors that cross to exactly the arrays
    ``estimate_batch`` returns, and it keeps autograd."""
    points, n, cats = _grid_points(dict(PORT_GRID, n_ga=[1, 3]))
    from repro_torch.core import sweep as SW

    captured = {}

    def grab(batch):
        captured["batch"] = batch
        return MB.estimate_batch(batch, device="cpu", paired_kernel=paired)

    est = SW._score({k: points[k] for k in SW._NUMERIC}, cats, n, grab)[0]
    cols = MB._device_columns(captured["batch"], torch.device("cpu"))
    kern, groups = MB.estimate_columns(cols, n, paired_kernel=paired)
    assert list(kern) == list(MB.KERNEL_COLUMNS)
    for name in ("t_exe", "t_ideal", "t_ovh", "bound_ratio", "total_bytes",
                 "memory_bound"):
        np.testing.assert_array_equal(kern[name].numpy(),
                                      getattr(est, name), name)
    sel, _ = MB.estimate_columns(cols, n, paired_kernel=paired,
                                 want=("total_bytes", "t_exe"))
    assert list(sel) == ["total_bytes", "t_exe"]
    width = cols["ls_width"].clone().requires_grad_(True)
    out, _ = MB.estimate_columns(dict(cols, ls_width=width, ls_bytes=width),
                                 n, paired_kernel=paired, want=("t_exe",))
    (g,) = torch.autograd.grad(out["t_exe"].sum(), [width])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def _canon_states(reducers) -> list:
    """state_dicts with exact sums through ``math.fsum`` and front rows
    sorted by id (the form the merge protocol keeps invariant)."""
    import math

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
        out.append(s)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_stream_chunk_order_equals_reference(seed):
    """``run_stream(chunk_order=)`` evaluates and folds the chunks in the
    given order, as the reference's test hook does: the port and the
    reference fold the same permutation to the same state, and the front,
    top-k and stats equal the in-order fold's (the running mean and M2 to
    1e-12)."""
    chunk = 37
    plan = CPU.plan(rt.Space.grid(**PORT_GRID), chunk_size=chunk)
    ref_plan = repro.Session(backend="numpy-batch").plan(
        repro.Space.grid(**REF_GRID), chunk_size=chunk)
    n_chunks = -(-plan.n // chunk)
    order = list(np.random.default_rng(seed).permutation(n_chunks))
    seen = []
    ev = plan.evaluator()

    def logged(ids):
        seen.append(int(ids[0]))
        return ev(ids)

    got = S.run_stream(plan.n, chunk, logged, S.default_reducers(10),
                       chunk_order=order).reducers
    assert seen == [i * chunk for i in order]
    ref = ref_stream.run_stream(ref_plan.n, chunk, ref_plan.evaluator(),
                                ref_stream.default_reducers(10),
                                chunk_order=order).reducers
    assert _canon_states(got) == _canon_states(ref)
    in_order = _canon_states(S.run_stream(
        plan.n, chunk, plan.evaluator(), S.default_reducers(10)).reducers)
    got = _canon_states(got)
    # the Chan moments follow the fold order in their last bits; every
    # other field is order-invariant
    for g, w in zip(got[-1:], in_order[-1:]):
        for k in ("mean", "m2"):
            assert g.pop(k) == pytest.approx(w.pop(k), rel=1e-12)
    assert got == in_order


def test_envelope_admits_and_constraint_equal_reference():
    from repro_torch.search import constraints as C

    env = rt.ResourceEnvelope(lsu_ports=6, interconnect_bytes=64)
    ref_env = repro.search.ResourceEnvelope(lsu_ports=6,
                                            interconnect_bytes=64)
    lists = CPU.plan(rt.Space.grid(**PORT_GRID)).lists
    enum = S.GridEnumerator(lists)
    cols = C.columns_from_lists(lists, enum.codes(np.arange(enum.n)))
    usage = {k: cols[k] for k in env.caps()}
    got = env.admits(usage)
    np.testing.assert_array_equal(got, ref_env.admits(usage))
    assert 0 < got.sum() < enum.n
    con = env.constraint()
    assert isinstance(con, C.EnvelopeConstraint) and con.envelope is env
    np.testing.assert_array_equal(con.mask(cols), got)
    assert C.constraint_to_json(con) == \
        ref_env.constraint().to_json_dict()
    empty = rt.ResourceEnvelope()
    np.testing.assert_array_equal(empty.admits({"n_ga": np.arange(5)}),
                                  np.ones(5, dtype=bool))
    assert empty.admits({}).shape == (0,)


def test_top_level_constants_equal_reference():
    assert rt.__version__ == repro.__version__
    assert sorted(rt.DRAM_CONFIGS) == sorted(repro.DRAM_CONFIGS)
    for name, d in rt.DRAM_CONFIGS.items():
        assert d.__dict__ == repro.DRAM_CONFIGS[name].__dict__
    assert rt.TPU_V5E.__dict__ == repro.TPU_V5E.__dict__
    assert [c.value for c in rt.AccessClass] == \
        [c.value for c in repro.AccessClass]
    for name in ("DRAM_CONFIGS", "TPU_V5E", "TpuParams", "AccessClass",
                 "RooflineReport", "__version__"):
        assert name in rt.__all__ and name in repro.__all__
