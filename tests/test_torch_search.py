"""The port's constrained search (``repro_torch.search``) and optimizer
against the reference on the CPU.

* Feasibility masks are bit-equal to post-filtering the unconstrained
  sweep, and equal the reference's masks; constraint JSON written by the
  reference reads back in the port (and the other way round); a random
  space rejection-samples the reference's exact points.
* ``Session.optimize`` with ``steps=0`` (no descent — the reference's own
  descent does not run on this jax) reports what the reference reports.
  With the descent on, the optimum of a 20,480-point grid is matched bit
  for bit, and the relaxed objective is held to the grid: at integer
  coordinates its per-lane values equal ``numpy-batch``'s ``t_exe``
  exactly (the loss, their log-sum, to 1e-12), and off the knots its
  autograd gradient agrees with central differences to 1e-6 relative.
* Through an ``enable_x64`` shim (the reference imports
  ``jax.experimental.enable_x64``, which jax 0.9 no longer has; the
  ``x64_shim`` fixture installs a context manager under that name), the
  reference's own descent runs, and the port's report equals it with the
  descent on — evaluation count, optimum and front ids — for every entry
  of ``OBJECTIVE_COLUMNS`` (five of which the port's autograd descent
  used to crash on: an objective that ignores a relaxed axis, and
  ``memory_bound``, which is constant), and on a space whose (t_exe,
  resource) front has six distinct points, where the port's front also
  reaches the exhaustive one.
* ``adamw_update`` follows ``repro.optim.adamw`` over 20 steps to 1e-6
  relative, 1e-7 absolute near zero (float32 state on both sides).
"""
import contextlib
import json

import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core import DDR4_1866, DDR4_2666
from repro.search import constraints as ref_cons
from repro_torch.core import stream as S
from repro_torch.core import sweep as SW
from repro_torch.search import constraints as C
from repro_torch.search import envelope as E
from repro_torch.search import optimize as O

REF_TYPES = [repro.LsuType.BC_ALIGNED, repro.LsuType.BC_NON_ALIGNED,
             repro.LsuType.BC_WRITE_ACK, repro.LsuType.ATOMIC_PIPELINED]
PORT_TYPES = [rt.LsuType(t.value) for t in REF_TYPES]
REF_GRID = dict(lsu_type=REF_TYPES, n_ga=[1, 2, 4], simd=[1, 4, 16],
                n_elems=[1 << 14, 1 << 16], delta=[1, 2, 7],
                include_write=[False, True], dram=[DDR4_1866, DDR4_2666])
PORT_GRID = dict(REF_GRID, lsu_type=PORT_TYPES,
                 dram=[rt.DDR4_1866, rt.DDR4_2666])
ENV = rt.ResourceEnvelope(lsu_ports=6, interconnect_bytes=64)
REF_ENV = repro.search.ResourceEnvelope(lsu_ports=6, interconnect_bytes=64)

#: The reference's optimizer grid (tests/test_search.py BIG) at one element
#: size: 4*8*5*4*8*2*2 = 20,480 points.
BIG_AXES = dict(n_ga=[1, 2, 3, 4, 6, 8, 12, 16], simd=[1, 2, 4, 8, 16],
                n_elems=[1 << 10, 1 << 12, 1 << 14, 1 << 16],
                delta=[1, 2, 3, 4, 5, 6, 7, 8],
                include_write=[False, True], val_constant=[False, True])
REF_BIG = dict(BIG_AXES, lsu_type=REF_TYPES)
PORT_BIG = dict(BIG_AXES, lsu_type=PORT_TYPES)

CPU = rt.Session(device="cpu")


def _grid_columns():
    lists = CPU.plan(rt.Space.grid(**PORT_GRID)).lists
    enum = S.GridEnumerator(lists)
    return C.columns_from_lists(lists, enum.codes(np.arange(enum.n)))


def _ref_grid_columns():
    lists = repro.Session().plan(repro.Space.grid(**REF_GRID)).lists
    enum = repro.core.stream.GridEnumerator({k: list(v)
                                             for k, v in lists.items()})
    return ref_cons.columns_from_lists(lists, enum.codes(np.arange(enum.n)))


@pytest.fixture(scope="module")
def unconstrained():
    return CPU.sweep(rt.Space.grid(**PORT_GRID))


# ---------------------------------------------------------------------------
# envelopes and usage
# ---------------------------------------------------------------------------

def test_envelope_caps_and_design_usage():
    assert ENV.caps() == {"lsu_ports": 6.0, "interconnect_bytes": 64.0}
    assert C.as_constraint(ENV) == C.EnvelopeConstraint(ENV)
    for t in PORT_TYPES:
        for n_ga, simd, iw in [(1, 1, False), (4, 16, True), (2, 4, True)]:
            d = rt.Design.microbench(t, n_ga=n_ga, simd=simd,
                                     n_elems=1 << 14, include_write=iw)
            ref_d = repro.Design.microbench(
                repro.LsuType(t.value), n_ga=n_ga, simd=simd,
                n_elems=1 << 14, include_write=iw)
            assert E.usage_of_design(d) == \
                repro.search.usage_of_design(ref_d)
            lists = CPU.plan(rt.Space.grid(
                lsu_type=[t], n_ga=[n_ga], simd=[simd], n_elems=[1 << 14],
                include_write=[iw])).lists
            cols = C.columns_from_lists(lists, {k: np.zeros(1, np.int64)
                                                for k in lists})
            for col in E.USAGE_COLUMNS:
                assert E.usage_of_design(d)[col] == float(cols[col][0])


def test_usage_columns_equal_reference_and_torch():
    got, ref = _grid_columns(), _ref_grid_columns()
    for col in E.USAGE_COLUMNS + ("lsu_type_code", "n_ga", "simd"):
        np.testing.assert_array_equal(got[col], ref[col], col)
    t = E.usage_from_axes(
        type_codes=torch.as_tensor(got["lsu_type_code"]),
        n_ga=torch.as_tensor(got["n_ga"], dtype=torch.float64),
        simd=torch.as_tensor(got["simd"], dtype=torch.float64),
        elem_bytes=torch.as_tensor(got["elem_bytes"], dtype=torch.float64),
        include_write=torch.as_tensor(got["include_write"]),
        max_txn=torch.full((got.n,), 1024.0, dtype=torch.float64))
    np.testing.assert_array_equal(t["lsu_ports"].numpy(), got["lsu_ports"])
    np.testing.assert_array_equal(t["interconnect_bytes"].numpy(),
                                  got["interconnect_bytes"])


# ---------------------------------------------------------------------------
# feasibility masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "scalar"])
def test_masked_sweep_bit_equal_to_post_filter(unconstrained, backend):
    cols = _grid_columns()
    mask = C.feasibility_mask(C.normalize_constraints([ENV]), cols)
    ref_mask = ref_cons.feasibility_mask(
        ref_cons.normalize_constraints([REF_ENV]), _ref_grid_columns())
    np.testing.assert_array_equal(mask, ref_mask)
    got = rt.Session(device="cpu", backend=backend).sweep(
        rt.Space.grid(**PORT_GRID), constraints=[ENV])
    assert got.n_candidates == 864 and got.n_points == int(mask.sum())
    want = unconstrained.t_exe[mask]
    if backend == "torch":
        np.testing.assert_array_equal(got.t_exe, want)
    else:
        np.testing.assert_allclose(got.t_exe, want, rtol=1e-9)
    np.testing.assert_array_equal(got.resource, unconstrained.resource[mask])
    assert got.summary()["n_feasible"] == got.n_points


@pytest.mark.parametrize("chunk", [97, 300])
def test_masked_streaming_equals_reference(chunk):
    got = CPU.sweep(rt.Space.grid(**PORT_GRID), chunk_size=chunk,
                    constraints=[ENV], profile=True)
    ref = repro.Session(backend="numpy-batch").sweep(
        repro.Space.grid(**REF_GRID), chunk_size=chunk, constraints=[REF_ENV])
    assert got.profile["path"] == "host-stream"
    np.testing.assert_array_equal(got.point_ids, ref.point_ids)
    np.testing.assert_array_equal(got.front_idx, ref.front_idx)
    assert got.rows() == ref.rows() and got.stats == ref.stats
    assert got.summary()["n_candidates"] == 864


def test_bound_constraints_property():
    import hypothesis
    import hypothesis.strategies as st

    cols = _grid_columns()
    full = CPU.sweep(rt.Space.grid(**PORT_GRID))

    @hypothesis.settings(max_examples=15, deadline=None)
    @hypothesis.given(column=st.sampled_from(
        ("lsu_ports", "interconnect_bytes", "buffer_bytes", "n_ga", "simd")),
        bound=st.floats(0, 5000, allow_nan=False),
        op=st.sampled_from(("<=", ">=")), chunk=st.integers(1, 300))
    def prop(column, bound, op, chunk):
        c = C.BoundConstraint(column, bound, op=op)
        mask = C.feasibility_mask((c,), cols)
        got = CPU.sweep(rt.Space.grid(**PORT_GRID), chunk_size=chunk,
                        constraints=c)
        assert got.stats["n_points"] == int(mask.sum())
        if mask.any():
            assert got.stats["t_exe_min"] == full.t_exe[mask].min()

    prop()


def test_lambda_constraint_and_conjunction():
    c = C.within(ENV) & C.LambdaConstraint(lambda cols: cols["n_ga"] >= 2)
    got = CPU.sweep(rt.Space.grid(**PORT_GRID), constraints=c)
    assert got.n_points > 0
    assert np.asarray(got.points["n_ga"], dtype=np.int64).min() >= 2
    with pytest.raises(TypeError):
        C.constraint_to_json(c)
    with pytest.raises(ValueError, match="bool mask"):
        CPU.sweep(rt.Space.grid(n_ga=[1, 2]),
                  constraints=lambda cols: np.ones(3))
    with pytest.raises(TypeError, match="cannot interpret"):
        C.as_constraint(3)


def test_reference_constraint_json_reads_back():
    ref_c = ref_cons.within(REF_ENV) & ref_cons.BoundConstraint(
        "n_ga", 2, op=">=")
    text = json.dumps(ref_cons.constraint_to_json(ref_c))
    got = C.constraint_from_json(json.loads(text))
    assert got == C.within(ENV) & C.BoundConstraint("n_ga", 2.0, op=">=")
    np.testing.assert_array_equal(got.mask(_grid_columns()),
                                  ref_c.mask(_ref_grid_columns()))
    back = ref_cons.constraint_from_json(json.loads(json.dumps(
        C.constraint_to_json(got))))
    assert back == ref_c
    plan = CPU.plan(rt.Space.grid(**PORT_GRID), chunk_size=128,
                    constraints=[got])
    again = S.SweepPlan.from_json(plan.to_json())
    assert again.constraints == plan.constraints
    ids = np.arange(plan.n, dtype=np.int64)
    np.testing.assert_array_equal(again.feasible_mask(ids),
                                  plan.feasible_mask(ids))
    assert C.envelope_caps(again.constraints) == ENV.caps()


def test_empty_region_fails_loudly():
    none = rt.ResourceEnvelope(lsu_ports=0)
    got = CPU.sweep(rt.Space.grid(**PORT_GRID), constraints=[none])
    assert got.n_points == 0 and got.summary()["n_candidates"] == 864
    with pytest.raises(ValueError, match="constraints eliminated every"):
        got.best()
    with pytest.raises(ValueError, match="feasible region"):
        CPU.sweep(rt.Space.random(16, seed=0, **PORT_GRID),
                  constraints=[none])
    with pytest.raises(ValueError, match="eliminated every|no feasible"):
        CPU.optimize(PORT_GRID, constraints=[none])


def test_random_space_rejection_sampling_matches_reference():
    got = CPU.sweep(rt.Space.random(64, seed=3, **PORT_GRID),
                    constraints=[ENV])
    ref = repro.Session(backend="numpy-batch").sweep(
        repro.Space.random(64, seed=3, **REF_GRID), constraints=[REF_ENV])
    assert got.n_points == ref.n_points == 64
    np.testing.assert_array_equal(got.t_exe, ref.t_exe)
    for a in ("n_ga", "simd", "n_elems", "delta"):
        np.testing.assert_array_equal(got.points[a], ref.points[a])
    cats = {a: SW._factorize(got.points[a]) for a in SW._CATEGORICAL}
    cols = C.columns_from_parts({a: np.asarray(got.points[a])
                                 for a in SW._NUMERIC}, cats, 64)
    assert C.feasibility_mask(C.normalize_constraints([ENV]), cols).all()


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _report_fields(rep):
    s = dict(rep.summary())
    s.pop("backend")
    return s


@pytest.mark.parametrize("objective", ["t_exe", ("t_exe", "resource")])
def test_optimize_steps0_equals_reference(objective):
    kw = dict(objective=objective, max_evals=1500, seed=0, steps=0)
    got = CPU.optimize(PORT_BIG, **kw)
    ref = repro.Session(backend="numpy-batch").optimize(REF_BIG, **kw)
    assert _report_fields(got) == _report_fields(ref)
    np.testing.assert_array_equal(got.front_ids, ref.front_ids)
    for k in O.OBJECTIVE_COLUMNS:
        np.testing.assert_array_equal(got.front[k], ref.front[k], k)
    assert got.best == type(got.best)(**{
        **{f: getattr(ref.best, f) for f in ("t_exe", "t_ideal", "t_ovh",
                                             "bound_ratio", "memory_bound",
                                             "total_bytes", "n_lsu")},
        "backend": "torch"})
    assert [r["lsu_type"] for r in got.rows()] == \
        [r["lsu_type"] for r in ref.rows()]


def test_optimize_constrained_steps0_equals_reference():
    env = rt.ResourceEnvelope(lsu_ports=4, interconnect_bytes=64)
    ref_env = repro.search.ResourceEnvelope(lsu_ports=4,
                                            interconnect_bytes=64)
    got = CPU.optimize(PORT_BIG, constraints=[env], max_evals=1500, seed=1,
                       steps=0)
    ref = repro.Session(backend="numpy-batch").optimize(
        REF_BIG, constraints=[ref_env], max_evals=1500, seed=1, steps=0)
    assert _report_fields(got) == _report_fields(ref)
    assert float(got.best_config["n_ga"]) <= 4


@pytest.mark.parametrize("constrained", [False, True])
def test_optimize_with_descent_matches_grid_optimum(constrained):
    """With envelope caps, the descent's loss carries their penalties."""
    cons = [rt.ResourceEnvelope(lsu_ports=4, interconnect_bytes=64)] \
        if constrained else []
    ref_cons_ = [repro.search.ResourceEnvelope(
        lsu_ports=4, interconnect_bytes=64)] if constrained else []
    rep = CPU.optimize(PORT_BIG, constraints=cons, max_evals=1500, seed=0)
    st = CPU.sweep(PORT_BIG, chunk_size=4096, constraints=cons,
                   reducers=(S.StatsReducer(),))
    assert rep.n_total == 20480 and rep.n_evals <= 1500
    assert rep.best.t_exe == st.stats["t_exe_min"]
    ref_min = float(repro.Session(backend="numpy-batch").sweep(
        REF_BIG, constraints=ref_cons_).t_exe.min())
    assert rep.best.t_exe == ref_min
    descend = next(t for t in rep.trajectory if t["phase"] == "descend")
    assert descend["lanes"] > 0 and "skipped" not in descend
    assert descend["loss_last"] < descend["loss_first"]


def test_optimize_small_grid_exhaustive_and_bad_objective():
    rep = CPU.optimize(PORT_GRID)
    full = CPU.sweep(rt.Space.grid(**PORT_GRID))
    assert rep.n_grid_evals == 864 and rep.trajectory[0]["phase"] == \
        "exhaustive"
    assert rep.best.t_exe == float(full.t_exe.min())
    assert rep.summary()["best_id"] == rep.best_id
    with pytest.raises(ValueError, match="unknown objective"):
        CPU.optimize(PORT_GRID, objective="latency")
    with pytest.raises(ValueError, match="one column or a pair"):
        CPU.optimize(PORT_GRID, objective=("t_exe", "resource", "t_ovh"))


def _relaxed(seeds, objective="t_exe"):
    plan = CPU.plan(rt.Space.grid(**PORT_BIG))
    log = O._EvalLog(plan, (), 10 ** 6)
    relaxed = [a for a in SW._NUMERIC
               if len(set(map(float, log.lists[a]))) >= 3]
    return O._Relaxed(log, np.asarray(seeds), objective, (), relaxed,
                      torch.device("cpu")), plan


def test_relaxed_objective_is_exact_at_the_knots():
    seeds = np.random.default_rng(2).choice(20480, 64, replace=False)
    relax, plan = _relaxed(seeds)
    obj, _ = relax.values(relax.start())
    want = repro.Session(backend="numpy-batch").sweep(REF_BIG).t_exe[seeds]
    np.testing.assert_array_equal(obj.numpy(), want)
    assert float(relax.loss(relax.start())) == pytest.approx(
        float(np.sum(np.log(want))), rel=1e-12)
    res, _ = _relaxed(seeds, "resource")
    np.testing.assert_array_equal(res.values(res.start())[0].numpy(),
                                  plan.evaluator()(seeds)["resource"])


def test_relaxed_gradient_matches_central_differences():
    seeds = np.random.default_rng(4).choice(20480, 32, replace=False)
    relax, _ = _relaxed(seeds)
    rng = np.random.default_rng(5)
    u = {a: torch.as_tensor(np.clip(
        p.numpy() + rng.uniform(0.2, 0.8, len(seeds)) * np.where(
            p.numpy() >= relax.kmax[a], -1.0, 1.0), 0.0, relax.kmax[a]))
        for a, p in relax.start().items()}
    leaves = {a: v.clone().requires_grad_(True) for a, v in u.items()}
    grads = torch.autograd.grad(relax.loss(leaves), list(leaves.values()))
    h = 1e-6
    for (a, v), g in zip(u.items(), grads):
        up, dn = dict(u), dict(u)
        up[a], dn[a] = v + h, v - h
        fd = (torch.log(relax.values(up)[0])
              - torch.log(relax.values(dn)[0])) / (2 * h)
        np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=a)


def test_adamw_follows_reference():
    import jax.numpy as jnp
    from repro.optim import adamw as ref_adamw

    from repro_torch.optim import adamw as A

    kw = dict(lr=0.05, warmup_steps=3, total_steps=20, weight_decay=0.1,
              clip_norm=0.5, min_lr_ratio=0.2)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(20)]
    rcfg, cfg = ref_adamw.OptimizerConfig(**kw), A.OptimizerConfig(**kw)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.as_tensor(v) for k, v in p0.items()}
    rs, ts = ref_adamw.adamw_init(rp, rcfg), A.adamw_init(tp, cfg)
    for g in grads:
        rp, rs, rm = ref_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, rs, rp, rcfg)
        tp, ts, tm = A.adamw_update(
            {k: torch.as_tensor(v) for k, v in g.items()}, ts, tp, cfg)
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(rs["m"][k]),
                                   rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(rs["step"]) == 20


# ---------------------------------------------------------------------------
# the reference's descent, through the enable_x64 shim
# ---------------------------------------------------------------------------

@pytest.fixture
def x64_shim(monkeypatch):
    """Install ``jax.experimental.enable_x64`` (gone in jax 0.9) as a
    context manager that flips ``jax_enable_x64`` through
    ``jax.config.update``; the reference's descent imports it by name."""
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


def _without_losses(rep):
    """The report summary with the descent's loss values taken out (held
    to tolerances separately)."""
    s = _report_fields(rep)
    s["phases"] = [{k: v for k, v in p.items()
                    if k not in ("loss_first", "loss_last")}
                   for p in s["phases"]]
    return s


def _assert_report_equals_reference(got, ref):
    assert _without_losses(got) == _without_losses(ref)
    assert (got.n_evals, got.n_grid_evals, got.best_id) == \
        (ref.n_evals, ref.n_grid_evals, ref.best_id)
    np.testing.assert_array_equal(got.front_ids, ref.front_ids)
    for k in O.OBJECTIVE_COLUMNS:
        np.testing.assert_array_equal(got.front[k], ref.front[k], k)
    phases = [t["phase"] for t in got.trajectory]
    assert phases == [t["phase"] for t in ref.trajectory]
    d = next(t for t in got.trajectory if t["phase"] == "descend")
    rd = next(t for t in ref.trajectory if t["phase"] == "descend")
    assert "skipped" not in d and "skipped" not in rd
    assert (d["lanes"], d["steps"], d["relaxed_axes"]) == \
        (rd["lanes"], rd["steps"], rd["relaxed_axes"])
    assert d["loss_first"] == pytest.approx(rd["loss_first"], rel=1e-12)
    # the steps run float32 AdamW state on both sides, one ulp apart here
    # and there: the trajectories agree to ~1e-9 after 16 steps
    assert d["loss_last"] == pytest.approx(rd["loss_last"], rel=1e-7)


@pytest.mark.parametrize("objective",
                         list(O.OBJECTIVE_COLUMNS) + [("t_exe", "resource")])
def test_optimize_with_descent_equals_reference(x64_shim, objective):
    kw = dict(objective=objective, max_evals=1500, seed=0)
    got = CPU.optimize(PORT_BIG, **kw)
    ref = repro.Session(backend="numpy-batch").optimize(REF_BIG, **kw)
    _assert_report_equals_reference(got, ref)


def test_optimize_constrained_with_descent_equals_reference(x64_shim):
    kw = dict(max_evals=1500, seed=1, objective=("t_exe", "resource"))
    got = CPU.optimize(PORT_BIG, constraints=[
        rt.ResourceEnvelope(lsu_ports=4, interconnect_bytes=64)], **kw)
    ref = repro.Session(backend="numpy-batch").optimize(
        REF_BIG, constraints=[repro.search.ResourceEnvelope(
            lsu_ports=4, interconnect_bytes=64)], **kw)
    _assert_report_equals_reference(got, ref)


#: A space whose (t_exe, resource) front has six distinct value points:
#: n_elems fixed per point as a workload size, every design with >= 2 LSUs,
#: and the non-aligned LSU's burst growing with its width (simd x
#: elem_bytes) against the atomic and write-ACK classes' narrow ports.
PARETO_AXES = dict(n_ga=[1, 2, 3, 4, 6, 8], simd=[1, 2, 4, 8, 16, 32],
                   n_elems=[1 << 14, 1 << 16], elem_bytes=[1, 2, 4, 8],
                   delta=[1, 2, 3, 4, 5, 6, 7, 8], include_write=[True],
                   val_constant=[False, True])
PARETO_REF_TYPES = [repro.LsuType.BC_NON_ALIGNED,
                    repro.LsuType.ATOMIC_PIPELINED,
                    repro.LsuType.BC_WRITE_ACK]


@pytest.fixture(scope="module")
def pareto_exhaustive():
    full = repro.Session(backend="numpy-batch").sweep(
        dict(PARETO_AXES, lsu_type=PARETO_REF_TYPES))
    return {(float(full.t_exe[i]), float(full.resource[i]))
            for i in full.pareto()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_front_parity(x64_shim, pareto_exhaustive, seed):
    assert len(pareto_exhaustive) >= 4
    kw = dict(objective=("t_exe", "resource"), seed=seed)
    got = CPU.optimize(dict(PARETO_AXES, lsu_type=[
        rt.LsuType(t.value) for t in PARETO_REF_TYPES]), **kw)
    ref = repro.Session(backend="numpy-batch").optimize(
        dict(PARETO_AXES, lsu_type=PARETO_REF_TYPES), **kw)
    _assert_report_equals_reference(got, ref)
    found = {(float(got.front["t_exe"][i]), float(got.front["resource"][i]))
             for i in range(got.n_front)}
    recall = len(found & pareto_exhaustive) / len(pareto_exhaustive)
    assert recall >= 0.95
    assert got.n_evals < got.n_total // 4
