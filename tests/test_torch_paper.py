"""The paper's comparison layer in the port against the reference on the CPU:
the event-driven DRAM simulator, the Wang and HLScope+ baselines, the
scalar model helpers, Table IV, and the Table V / Fig. 3-5 rows rebuilt
through ``repro_torch.paper_tables``.

* ``dramsim.simulate`` gives the reference's ``SimResult`` field for field
  on every LSU type (Hypothesis shapes after
  ``tests/test_dramsim_property.py``; write-ACK addresses come from the
  same ``np.random.default_rng(seed)``);
* both baselines, the model helpers and ``table4_rows`` are exactly the
  reference's; Table IV's max and mean error are those ``BENCH_smoke.json``
  records (9.3 % / 5.7 %);
* the Table V and Fig. 3-5 rows equal ``benchmarks/paper_tables.py``'s, on
  the scalar backend and on the torch backend on the CPU.
"""
import json
import pathlib

import hypothesis
import hypothesis.strategies as st
import pytest

import repro
import repro_torch as rt
from benchmarks import paper_tables as ref_tables
from repro.core import apps as ref_apps
from repro.core import baselines as ref_base
from repro.core import dramsim as ref_sim
from repro.core import model as ref_model
from repro_torch import paper_tables
from repro_torch.core import apps, baselines, dramsim, model

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The global LSU types the simulator and the scalar helpers time.
TYPES = ["bc_aligned", "bc_non_aligned", "bc_cache", "bc_write_ack",
         "atomic_pipelined"]
DRAMS = ["DDR4-1866", "DDR4-2666"]
SETTINGS = hypothesis.settings(max_examples=30, deadline=None)


def _pair(type_value: str, **kw):
    """The same microbenchmark LSU list in both packages."""
    port = apps.microbench(rt.LsuType(type_value), **kw)
    ref = ref_apps.microbench(repro.LsuType(type_value), **kw)
    return port, ref


def _sim_fields(r):
    return (r.t_total, r.n_transactions, r.n_row_misses, r.row_miss_rate)


# ---------------------------------------------------------------------------
# the DRAM simulator
# ---------------------------------------------------------------------------

@SETTINGS
@hypothesis.given(
    lsu_type=st.sampled_from(TYPES), n_ga=st.integers(1, 4),
    simd=st.sampled_from([1, 4, 8, 16]), log_n=st.integers(8, 14),
    delta=st.integers(1, 8), dram=st.sampled_from(DRAMS),
    seed=st.integers(0, 3), interleave=st.sampled_from([256, 1024, 4096]),
    include_write=st.booleans(), const=st.booleans())
def test_simulate_equals_reference(lsu_type, n_ga, simd, log_n, delta, dram,
                                   seed, interleave, include_write, const):
    n = 1 << (log_n - 3 if lsu_type == "atomic_pipelined" else log_n)
    port, ref = _pair(lsu_type, n_ga=n_ga, simd=simd, n_elems=n,
                      delta=delta if lsu_type in (
                          "bc_aligned", "bc_non_aligned", "bc_cache") else 1,
                      include_write=include_write, val_constant=const)
    got = dramsim.simulate(port, rt.DRAM_CONFIGS[dram], seed=seed,
                           interleave_bytes=interleave)
    want = ref_sim.simulate(ref, repro.DRAM_CONFIGS[dram], seed=seed,
                            interleave_bytes=interleave)
    assert _sim_fields(got) == _sim_fields(want)


@SETTINGS
@hypothesis.given(log_n=st.integers(10, 14),
                  span_kb=st.sampled_from([8, 64, 1024]),
                  seed=st.integers(0, 1000))
def test_write_ack_addresses_follow_the_seed(log_n, span_kb, seed):
    port, ref = _pair("bc_write_ack", n_ga=1, n_elems=1 << log_n,
                      span_bytes=span_kb << 10)
    d, rd = rt.DDR4_1866, repro.DDR4_1866
    got = dramsim.DramSimulator(d, seed=seed).run(port)
    assert _sim_fields(got) == _sim_fields(
        ref_sim.DramSimulator(rd, seed=seed).run(ref))
    # a different seed draws different addresses (and both agree again)
    other = dramsim.simulate(port, d, seed=seed + 1)
    assert _sim_fields(other) == _sim_fields(
        ref_sim.simulate(ref, rd, seed=seed + 1))


def test_simulate_edge_cases():
    empty = dramsim.simulate([], rt.DDR4_1866)
    assert _sim_fields(empty) == (0.0, 0, 0, 0.0)
    local = [rt.Lsu(rt.LsuType.PIPELINED, ls_width=4, ls_acc=16, ls_bytes=4)]
    assert dramsim.simulate(local, rt.DDR4_1866).n_transactions == 0
    spec = rt.hw.get("stratix10_ddr4_2666")
    port, ref = _pair("bc_non_aligned", n_ga=3, n_elems=1 << 12, delta=5)
    got = dramsim.DramSimulator(spec.dram_params(), spec.bsp_params(),
                                interleave_bytes=spec.dram.interleave_bytes)
    want = ref_sim.DramSimulator(
        repro.hw.get("stratix10_ddr4_2666").dram_params(),
        repro.hw.get("stratix10_ddr4_2666").bsp_params(),
        interleave_bytes=spec.dram.interleave_bytes)
    assert _sim_fields(got.run(port)) == _sim_fields(want.run(ref))


# ---------------------------------------------------------------------------
# the scalar model helpers and the baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lsu_type", TYPES)
@pytest.mark.parametrize("dram", DRAMS)
def test_model_helpers_equal_reference(lsu_type, dram):
    d, rd = rt.DRAM_CONFIGS[dram], repro.DRAM_CONFIGS[dram]
    bsp, rbsp = model._default_bsp(), ref_model._default_bsp()
    assert bsp == rt.BspParams(**rbsp.__dict__)
    for delta in (1, 2, 7):
        for simd in (1, 4, 16):
            port, ref = _pair(lsu_type, n_ga=3, simd=simd, n_elems=1 << 14,
                              delta=delta)
            for p, r in zip(port, ref):
                assert model.k_lsu(p) == ref_model.k_lsu(r)
                assert model.burst_size_bytes(p, d, bsp) == \
                    ref_model.burst_size_bytes(r, rd, rbsp)
                assert model.t_row_seconds(p, d) == \
                    ref_model.t_row_seconds(r, rd)
                for n_lsu in (1, 4):
                    a = model.lsu_timing(p, d, bsp, n_lsu=n_lsu, f=simd)
                    b = ref_model.lsu_timing(r, rd, rbsp, n_lsu=n_lsu, f=simd)
                    assert (a.burst_size, a.n_bursts, a.t_ideal, a.t_ovh,
                            a.t_total) == (b.burst_size, b.n_bursts,
                                           b.t_ideal, b.t_ovh, b.t_total)
            assert model.memory_bound_ratio(port, d) == \
                ref_model.memory_bound_ratio(ref, rd)
            assert baselines.wang_estimate(port, d) == \
                ref_base.wang_estimate(ref, rd)
            assert baselines.hlscope_estimate(port, d) == \
                ref_base.hlscope_estimate(ref, rd)


def test_model_helper_errors_and_pipeline_time():
    for t in ("pipelined", "prefetching"):
        lsu = rt.Lsu(rt.LsuType(t), ls_width=4, ls_acc=16, ls_bytes=4)
        with pytest.raises(ValueError, match="does not issue DRAM bursts"):
            model.burst_size_bytes(lsu, rt.DDR4_1866, model._default_bsp())
        with pytest.raises(ValueError, match="no DRAM row timing"):
            model.t_row_seconds(lsu, rt.DDR4_1866)
    for n in (1 << 20, 1 << 18, 1000):
        for kw in ({}, {"f": 4}, {"f": 16, "f_kernel": 450e6, "depth": 17,
                                  "ii": 2}):
            assert model.pipeline_time(n, **kw) == \
                ref_model.pipeline_time(n, **kw)


def test_baselines_keep_the_papers_claims():
    """Wang's ACK signature, neither baseline tracks the DRAM, and ours is
    at least 2x more accurate than either against the simulator."""
    port, _ = _pair("bc_write_ack", n_ga=1, n_elems=1 << 18)
    ours = model._estimate(port, rt.DDR4_1866).t_exe
    assert baselines.wang_estimate(port, rt.DDR4_1866) > 10 * ours
    port, _ = _pair("bc_aligned", n_ga=1, include_write=False)
    for f in (baselines.wang_estimate, baselines.hlscope_estimate):
        assert f(port, rt.DDR4_2666) == f(port, rt.DDR4_1866)
    cases = [_pair("bc_aligned", n_ga=1, n_elems=1 << 18,
                   include_write=False)[0],
             _pair("bc_aligned", n_ga=4, n_elems=1 << 18)[0],
             _pair("atomic_pipelined", n_ga=2, n_elems=1 << 12)[0]]
    errs = {"ours": [], "wang": [], "hlscope": []}
    for dram in (rt.DDR4_1866, rt.DDR4_2666):
        for lsus in cases:
            t_meas = dramsim.simulate(lsus, dram).t_total
            for name, t_est in [
                    ("ours", model._estimate(lsus, dram).t_exe),
                    ("wang", baselines.wang_estimate(lsus, dram)),
                    ("hlscope", baselines.hlscope_estimate(lsus, dram))]:
                errs[name].append(abs(t_est - t_meas) / t_meas)
    assert max(errs["ours"]) * 2 <= max(errs["wang"])
    assert max(errs["ours"]) * 2 <= max(errs["hlscope"])


# ---------------------------------------------------------------------------
# Table IV
# ---------------------------------------------------------------------------

def test_table4_rows_equal_reference_and_bench_record():
    got = apps.table4_rows()
    assert got == ref_apps.table4_rows()
    assert got == ref_apps.table4_rows(repro.DDR4_1866)
    rec = json.loads((ROOT / "BENCH_smoke.json").read_text())
    assert got == rec["details"]["table4_applications"]
    errs = [r["err_pct"] for r in got]
    assert f"max_err={max(errs):.1f}% mean_err={sum(errs) / len(errs):.1f}%" \
        == "max_err=9.3% mean_err=5.7%"
    derived = next(s["derived"] for s in rec["summary"]
                   if s["name"] == "table4_applications")
    assert derived.startswith("max_err=9.3% mean_err=5.7%")
    for name, app in apps.APPS.items():
        ref = ref_apps.APPS[name]
        for d, rd in ((None, None), (rt.DDR4_2666, repro.DDR4_2666)):
            assert app.calibrated_elems(d) == ref.calibrated_elems(rd)
    assert apps.table4_rows(rt.DDR4_2666) == \
        ref_apps.table4_rows(repro.DDR4_2666)


# ---------------------------------------------------------------------------
# Table V and Figs. 3-5, rebuilt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["scalar", "torch"])
@pytest.mark.parametrize("table", ["fig3_membound", "fig5_stride",
                                   "table4_applications",
                                   "table5_comparison"])
def test_tables_equal_reference(table, backend):
    sess = rt.Session(dram=rt.DDR4_1866, backend=backend, device="cpu")
    assert paper_tables.ALL[table](sess) == ref_tables.ALL[table]()


def test_fig4_equals_reference():
    sess = rt.Session(dram=rt.DDR4_1866, backend="scalar", device="cpu")
    assert paper_tables.fig4_lsu_microbench(sess) == \
        ref_tables.fig4_lsu_microbench()


def test_table5_claim_holds_in_the_port():
    """The paper's second claim: on average at least 2x less error than
    either previous work, against the simulator."""
    rows = paper_tables.table5_comparison(
        rt.Session(dram=rt.DDR4_1866, device="cpu"))
    mean = {k: sum(r[k] for r in rows) / len(rows)
            for k in ("err_ours_pct", "err_wang_pct", "err_hlscope_pct")}
    assert 2 * mean["err_ours_pct"] <= mean["err_wang_pct"]
    assert 2 * mean["err_ours_pct"] <= mean["err_hlscope_pct"]


def test_tables_follow_a_hardware_spec():
    spec = rt.hw.get("stratix10_ddr4_2666")
    ref_spec = repro.hw.get("stratix10_ddr4_2666")
    sess = rt.Session(backend="scalar", device="cpu").with_hardware(spec)
    ref_tables.set_session(repro.Session().with_hardware(ref_spec))
    try:
        for name in ("fig3_membound", "fig5_stride", "table4_applications"):
            assert paper_tables.ALL[name](sess) == ref_tables.ALL[name]()
    finally:
        ref_tables.set_session(repro.Session(dram=repro.DDR4_1866,
                                             backend="scalar"))
