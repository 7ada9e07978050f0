"""The port's HLO layer (``hbm``, ``hlo``, ``hlo_counter``, ``predictor``,
``roofline``, ``Design.from_hlo``, ``Session.predict``/``roofline``)
against the reference on the CPU, bit for bit.

Two sources of HLO text:

* programs the reference's jax lowers here, at the shapes of
  ``tests/test_hlo_counter.py`` and ``tests/test_predictor_roofline.py``;
  both packages analyze the same text;
* the committed fixtures ``tests/data/torch_hlo/*.txt`` (written by
  ``tools/dump_hlo_fixtures.py``) with the reference's results as JSON:
  both packages must still reproduce the JSON, so neither a jax upgrade nor
  a change in either package leaves the fixtures that ``chip_smoke.py``
  checks on the card silently stale.
"""
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch as rt
from repro.core import hbm as ref_hbm
from repro.core import hlo as ref_hlo
from repro.core import hlo_counter as ref_hc
from repro.core import predictor as ref_pred
from repro.core import roofline as ref_roof
from repro_torch.core import hbm
from repro_torch.core import hlo
from repro_torch.core import hlo_counter as hc
from repro_torch.core import predictor as pred
from repro_torch.core import roofline as roof

DATA = pathlib.Path(__file__).resolve().parent / "data" / "torch_hlo"
FIXTURES = sorted(p.stem for p in DATA.glob("*.txt"))
CPU = rt.Session(device="cpu")


def _compiled_text(f, *specs):
    return jax.jit(f).lower(*specs).compile().as_text()


def _spec(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _scan(x, ws):
    return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]


def _nested(c, xs):
    def step(c, x):
        return jax.lax.scan(lambda c, x: (c * x, None), c, x)[0], None
    return jax.lax.scan(step, c, xs)[0]


#: The reference tests' programs and shapes.
LOWERED = {
    "mlp": (lambda x, w1, w2: jnp.tanh(x @ w1) @ w2,
            [_spec((64, 256)), _spec((256, 512)), _spec((512, 128))]),
    "scan": (_scan, [_spec((8, 128)), _spec((12, 128, 128))]),
    "nested_scan": (_nested, [_spec((64,)), _spec((5, 7, 64))]),
    "gather_small": (lambda e, i: e[i].sum(),
                     [_spec((1024, 64)), _spec((128,), jnp.int32)]),
    "sort": (jnp.sort, [_spec((4096,))]),
    "matmul_bf16": (lambda a: a @ a, [_spec((4096, 4096), jnp.bfloat16)]),
    "elementwise": (lambda a, b: a + b,
                    [_spec((1 << 22,)), _spec((1 << 22,))]),
    "gather": (lambda e, i: e[i].sum(),
               [_spec((1 << 16, 256)), _spec((1 << 14,), jnp.int32)]),
    "tanh_matmul": (lambda a: jnp.tanh(a @ a), [_spec((512, 512))]),
}


@pytest.fixture(scope="module")
def lowered():
    return {k: _compiled_text(f, *specs) for k, (f, specs) in LOWERED.items()}


def _design_rows(design):
    return {"name": design.name, "flops": design.flops,
            "lsus": [[l.lsu_type.value, l.ls_width, l.ls_acc, l.ls_bytes,
                      l.delta, l.is_write, l.name] for l in design.lsus]}


def _same(a, b):
    """Equal as JSON data (inf/nan-aware, exact floats)."""
    return json.loads(json.dumps(a, sort_keys=True)) == \
        json.loads(json.dumps(b, sort_keys=True))


# ---------------------------------------------------------------------------
# freshly lowered HLO: both packages on the same text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LOWERED))
@pytest.mark.parametrize("fused", [True, False])
def test_analyze_equals_reference(lowered, name, fused):
    text = lowered[name]
    got = hc.record(hc.analyze(text, fused=fused))
    want = hc.record(ref_hc.analyze(text, fused=fused))
    assert got == want
    assert got["flops"] > 0


@pytest.mark.parametrize("name", sorted(LOWERED))
def test_predict_step_equals_reference(lowered, name):
    text = lowered[name]
    cost = {"flops": 1.5, "bytes_accessed": 2.0}
    got = pred.record(pred.predict_step(text, cost, rt.TPU_V5E,
                                        gather_row_bytes=128.0))
    want = pred.record(ref_pred.predict_step(text, cost, repro.TPU_V5E,
                                             gather_row_bytes=128.0))
    assert _same(got, want)
    # the session surface: the same call under the session's hw
    assert _same(pred.record(CPU.predict(text, cost)),
                 pred.record(repro.Session().predict(text, cost)))


@pytest.mark.parametrize("name", sorted(LOWERED))
def test_build_cell_from_hlo_and_roofline_equal_reference(lowered, name):
    text = lowered[name]
    kw = dict(arch=name, shape="s", mesh="1x1", chips=1, hlo_text=text,
              cost={"flops": 3.0}, model_flops_global=2 * 512 ** 3)
    got, want = roof.build_cell(**kw), ref_roof.build_cell(**kw)
    assert _same(got.as_row(), want.as_row())
    assert got.dominant == want.dominant and got.t_step == want.t_step
    d = rt.Design.from_hlo(text, name=name)
    rd = repro.Design.from_hlo(text, name=name)
    assert _design_rows(d) == _design_rows(rd)
    r, rr = CPU.roofline(d), repro.Session().roofline(rd)
    assert _same(r.rows(), rr.rows())
    assert (r.t_exe, r.bottleneck, r.memory_bound) == \
        (rr.t_exe, rr.bottleneck, rr.memory_bound)


def test_predictor_verdicts_match_the_reference_tests(lowered):
    """The reference tests' own claims, on the port."""
    p = pred.predict_step(lowered["matmul_bf16"])
    assert p.bottleneck == "compute"
    assert p.flops == pytest.approx(2 * 4096 ** 3, rel=0.05)
    p = pred.predict_step(lowered["elementwise"])
    assert p.bottleneck == "memory" and p.arithmetic_intensity < 1.0
    p = pred.predict_step(lowered["gather"])
    assert "gather" in {t.name for t in p.memory_components}
    assert hc.analyze(lowered["sort"]).bytes_by_class.get("strided", 0) > 0
    assert hc.analyze(lowered["nested_scan"]).flops == \
        pytest.approx(35 * 64, rel=0.3)
    cell = roof.build_cell(arch="t", shape="s", mesh="1x1", chips=1,
                           hlo_text=lowered["tanh_matmul"],
                           model_flops_global=2 * 512 ** 3)
    assert cell.useful_flops_ratio == pytest.approx(1.0, rel=0.05)


# ---------------------------------------------------------------------------
# the committed fixtures and the reference's JSON
# ---------------------------------------------------------------------------

def _fixture(name):
    return ((DATA / f"{name}.txt").read_text(),
            json.loads((DATA / f"{name}.json").read_text()))


def test_fixtures_cover_the_required_programs():
    assert {"matmul", "elementwise", "gather", "scan", "psum"} <= \
        set(FIXTURES)
    text, rec = _fixture("scan")
    assert " while(" in text and rec["analyze_fused"]["flops"] > 0
    text, rec = _fixture("psum")
    assert "all-reduce(" in text
    assert rec["predict_step"]["n_collectives"] >= 1


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_json_reproduced(name, package):
    text, rec = _fixture(name)
    mods = (hc, pred, roof, rt) if package == "port" else \
        (ref_hc, ref_pred, ref_roof, repro)
    H, PR, RL, top = mods
    assert _same(hc.record(H.analyze(text)), rec["analyze_fused"])
    assert _same(hc.record(H.analyze(text, fused=False)),
                 rec["analyze_unfused"])
    p = PR.predict_step(text, rec["cost"], top.TPU_V5E)
    assert _same(pred.record(p), rec["predict_step"])
    cell = RL.build_cell(arch=name, shape="fixture", mesh=f"{rec['chips']}",
                         chips=rec["chips"], hlo_text=text, cost=rec["cost"],
                         model_flops_global=p.flops * rec["chips"])
    assert _same(cell.as_row(), rec["cell"])
    d = top.Design.from_hlo(text, name=name)
    assert _same(_design_rows(d), rec["design"])
    sess = CPU if package == "port" else repro.Session()
    assert _same(sess.roofline(d).rows()[0], rec["roofline"])


# ---------------------------------------------------------------------------
# the HBM traffic model
# ---------------------------------------------------------------------------

def test_access_classes_and_params_match():
    assert [c.value for c in hbm.AccessClass] == \
        [c.value for c in ref_hbm.AccessClass]
    assert rt.TPU_V5E.__dict__ == repro.TPU_V5E.__dict__
    assert CPU.hw == rt.TPU_V5E
    v4 = rt.hw.get("tpu_v4")
    assert CPU.with_hardware(v4).hw == v4.tpu_params()


@pytest.mark.parametrize("row_bytes", [1.0, 64.0, 512.0, 700.0, 4096.0])
def test_traffic_time_equals_reference(row_bytes):
    for cls in hbm.AccessClass:
        for nbytes in (0.0, 1.0, 4096.0, 3.7e8, 1e12):
            t = hbm.Traffic(cls, nbytes, row_bytes=row_bytes, name="x")
            rt_ = ref_hbm.Traffic(ref_hbm.AccessClass(cls.value), nbytes,
                                  row_bytes=row_bytes, name="x")
            assert hbm.traffic_time(t) == ref_hbm.traffic_time(rt_)
            assert hbm.memory_time([t, t]) == ref_hbm.memory_time([rt_, rt_])


@pytest.mark.parametrize("row_bytes", [1.0, 64.0, 512.0, 700.0, 4096.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_memory_time_batch_bit_equal(row_bytes, seed):
    rng = np.random.default_rng(seed)
    by_class = {}
    for i, cls in enumerate(hbm.AccessClass):
        b = rng.integers(0, 1 << 34, size=257).astype(np.float64)
        b[::17] = 0.0
        by_class[cls.value if i % 2 else cls] = b * rng.random(257)
    ref_in = {(ref_hbm.AccessClass(k.value) if isinstance(k, hbm.AccessClass)
               else k): v for k, v in by_class.items()}
    got = hbm.memory_time_batch(by_class, row_bytes=row_bytes, device="cpu")
    want = ref_hbm.memory_time_batch(ref_in, row_bytes=row_bytes)
    assert got.dtype == __import__("torch").float64
    np.testing.assert_array_equal(got.numpy(), want)
    # and equal to the scalar traffic_time sum, point by point
    for j in (0, 1, 17, 100):
        comps = [hbm.Traffic(hbm.AccessClass(getattr(k, "value", k)),
                             float(v[j]), row_bytes=row_bytes)
                 for k, v in by_class.items()]
        assert float(got[j]) == pytest.approx(hbm.memory_time(comps),
                                              rel=1e-15)
    assert hbm.memory_time_batch({}, device="cpu").shape == (0,)


# ---------------------------------------------------------------------------
# HLO text helpers, degenerate modules, HloCost arithmetic
# ---------------------------------------------------------------------------

def test_hlo_helpers_equal_reference(lowered):
    for shape in ("bf16[2,16,4096]{2,1,0}", "(f32[8]{0}, s32[4]{0})",
                  "pred[]", "f8e4m3fn[3,5]", "token[]"):
        assert hlo.shape_bytes(shape) == ref_hlo.shape_bytes(shape)
    lines = [
        "%ar = f32[256]{0} all-reduce(%x), channel_id=1, "
        "replica_groups=[2,4]<=[8], to_apply=%sum",
        "%ag = f32[256]{0} all-gather(%x), channel_id=1, "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        "%rs = bf16[64]{0} reduce-scatter(%x), replica_groups={{0,1}}",
        "%cp = f32[32]{0} collective-permute(%x), source_target_pairs={{0,1}}",
        "%a2a = f32[128]{0} all-to-all(%x), replica_groups={{0,1,2,3}}",
    ]
    text = "\n".join(lines) + "\n" + _fixture("psum")[0]
    got, want = hlo.parse_collectives(text), ref_hlo.parse_collectives(text)
    assert [c.__dict__ for c in got] == [c.__dict__ for c in want]
    assert got[0].group_size == 4 and got[1].group_size == 8
    for t in list(lowered.values()) + [text]:
        a, b = hlo.classify_module(t), ref_hlo.classify_module(t)
        assert (a.class_bytes, a.opcode_bytes, a.n_instructions) == \
            (b.class_bytes, b.opcode_bytes, b.n_instructions)
        assert a.collective_bytes_by_kind() == b.collective_bytes_by_kind()
        assert (a.collective_operand_bytes, a.collective_wire_bytes) == \
            (b.collective_operand_bytes, b.collective_wire_bytes)


def test_degenerate_modules():
    cost = hc.analyze("not hlo at all")
    assert cost.total_bytes == 0 and cost.flops == 0
    assert any("no ENTRY" in w for w in cost.warnings)
    text = "\n".join(["HloModule folded", "", "ENTRY %main () -> (f32[]) {",
                      "  %c = f32[] constant(42)",
                      "  ROOT %t = (f32[]) tuple(%c)", "}"])
    assert hc.record(hc.analyze(text)) == hc.record(ref_hc.analyze(text))
    assert dict(hc.analyze(text).bytes_by_class) == {}
    d = rt.Design.from_hlo(text, name="folded")
    assert d.lsus == () and CPU.roofline(d).t_exe == 0.0


def test_hlocost_scaling_and_cells():
    c = hc.HloCost()
    c.bytes_by_class["gather"] = 512.0
    c.collective_by_kind["all-reduce"] = 64.0
    c.flops = 100.0
    z = c.scaled(0.0)
    assert dict(z.bytes_by_class) == {} and z.total_bytes == 0.0
    z.add(c.scaled(2.0))
    assert dict(z.bytes_by_class) == {"gather": 1024.0}
    base = dict(arch="a", shape="s", mesh="m", chips=256,
                flops_per_chip=1e12, bytes_per_chip=1e9,
                collective_operand_bytes=1e8, collective_wire_bytes=1e8,
                n_collectives=4, model_flops_global=2e14,
                t_compute=1e12 / 197e12, t_memory_naive=1e9 / 819e9,
                t_memory_refined=1.5e9 / 819e9, t_collective=1e8 / 200e9)
    for over in ({}, {"t_compute": 1e-6}, {"t_compute": 1e-9,
                                            "t_memory_refined": 1e-9,
                                            "t_memory_naive": 1e-9},
                 {"model_bytes_global": 5e11, "t_compute": 1e-6}):
        a = roof.RooflineCell(**{**base, **over})
        b = ref_roof.RooflineCell(**{**base, **over})
        assert _same(a.as_row(), b.as_row())
        assert math.isfinite(a.roofline_fraction)
    cells = [roof.RooflineCell(**base)]
    assert roof.markdown_table(cells) == ref_roof.markdown_table(
        [ref_roof.RooflineCell(**base)])


def test_write_report(tmp_path):
    cells = [roof.RooflineCell(arch="a", shape="s", mesh="m", chips=1,
                               flops_per_chip=1.0, bytes_per_chip=2.0,
                               collective_operand_bytes=0.0,
                               collective_wire_bytes=0.0, n_collectives=0,
                               model_flops_global=1.0, t_compute=1.0)]
    roof.write_report(cells, str(tmp_path / "r.json"))
    rows = json.loads((tmp_path / "r.json").read_text())
    assert rows[0]["dominant"] == "compute" and rows[0]["t_step_s"] == 1.0


def test_hlo_analysis_cache_round_trip(tmp_path):
    from repro_torch.core.cache import HloAnalysisCache, config_hash

    cache = HloAnalysisCache(tmp_path)
    key = config_hash({"hlo": "x"})
    assert cache.get(key) is None and len(cache) == 0
    cache.put(key, {"flops": 1.5, "classes": {"stream": 2.0}})
    assert key in cache and len(cache) == 1
    assert cache.get(key) == {"flops": 1.5, "classes": {"stream": 2.0}}
    assert cache.clear() == 1 and len(cache) == 0
