"""The layout: every configuration, cell, traffic kind and metric is found
by its name, ``BENCHMARK.json`` keeps to the benchmark's contract, and a
cell added as files alone runs with no edit of the harness."""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import time

import numpy as np
import pytest

from portbench import archs, trace
from portbench.harness import HERE, Layout, run_cell
from portbench.tests import tiny

ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LAYOUT = Layout(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def names(layout: Layout, sub: str, suffix: str) -> list[str]:
    """The names of the files ``<sub>/*<suffix>`` of a layout."""
    return sorted(p.name[:-len(suffix)]
                  for p in (layout.dir / sub).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_file_is_named_and_every_name_has_a_file():
    assert names(LAYOUT, "configs", ".json") == sorted(
        c["name"] for c in BENCH["configs"])
    assert names(LAYOUT, "workloads", ".json") == sorted(CELLS)
    assert names(LAYOUT, "metrics", ".py") == sorted(
        m["name"] for m in METRICS)
    # every kind a cell names has a file, and every file is named by a cell
    kinds = {LAYOUT.workload(c)["kind"] for c in CELLS}
    assert sorted(kinds) == names(LAYOUT, "traffic", ".py")
    # every family a configuration names has a file, and every file is
    # named by a configuration (``qwen`` where it names none)
    families = {LAYOUT.config(c["name"])["architecture"].get("family",
                                                             archs.DEFAULT)
                for c in BENCH["configs"]}
    assert sorted(families) == names(LAYOUT, "archs", ".py")
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = LAYOUT.config(name)
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    # each key cut for one chip has its published value beside it, and
    # no width is ever cut
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert cfg["published"][key] != cfg[key]
        assert not key.endswith(("_size", "_dim", "_rank", "_tok"))
    assert set(cfg.get("published", {})) == set(cfg["reduced"])
    g = LAYOUT.arch(cfg).geometry(cfg)
    assert g.n_layers == cfg["num_hidden_layers"]
    assert g.padded_vocab % 256 == 0 and g.padded_vocab >= g.vocab


@pytest.mark.parametrize("name", CELLS)
def test_cell(name):
    entry = LAYOUT.cell(name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4)
    assert NAME.match(name) and NAME.match(entry["traffic"])
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    wl = LAYOUT.workload(name)
    assert wl["config"] == entry["config"] and wl["why"] == entry["why"]
    # every cell reports set-up, another end-to-end metric and a
    # per-layer one
    e2e = {m["name"] for m in LAYOUT.metrics_of(name, traced=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert LAYOUT.metrics_of(name, traced=True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    per_layer = m in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(metric) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if per_layer:
        moved = next(x for x in BENCH["end_to_end"]
                     if x["name"] == m["moves"])
        # reported only where the metric it moves is
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if metric.endswith("_roofline") or "mfu" in metric:
            assert m["unit"] == "%"
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_a_cell_added_as_files_runs(tmp_path):
    """A new cell of an existing configuration and traffic kind: a
    workload file and a ``BENCHMARK.json`` entry, nothing else."""
    layout = tiny.layout(tmp_path)
    src = tmp_path / "portbench" / "workloads" \
        / "tiny-dense.prefill-mixed.json"
    new = json.loads(src.read_text())
    new.update(name="tiny-dense.prefill-long",
               traffic=dict(new["traffic"], shapes=[[1, 64]]))
    (src.parent / "tiny-dense.prefill-long.json").write_text(json.dumps(new))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-dense.prefill-long",
                               "config": "tiny-dense",
                               "traffic": "prefill-long", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-dense.prefill-mixed" in m.get("workloads", []):
            m["workloads"].append("tiny-dense.prefill-long")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    layout = Layout(tmp_path, tmp_path / "portbench")
    r = run_cell(layout, "tiny-dense.prefill-long", 31, 0.2, False,
                 t_start=time.perf_counter(), need_card=False, device="cpu")
    assert r["correct"]
    assert set(r["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert r["metrics"]["prefill_tokens_per_s"]["value"] > 0


def test_a_real_cell_added_as_files_is_found(tmp_path):
    """A cell added to a copy of the benchmark as a workload file and
    ``BENCHMARK.json`` entries alone is listed by name, reports the
    metrics of its kind, and the tiny layout built from that copy takes
    them with no edit of the harness or the tests."""
    real = tmp_path / "real"
    shutil.copytree(HERE, real / "portbench", ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    old = "qwen2-7b.prefill-mixed"
    new = dict(LAYOUT.workload(old), name="qwen2-7b.prefill-8k",
               why="one 8,192-token prompt a call")
    new["traffic"] = dict(new["traffic"], shapes=[[1, 8192]])
    (real / "portbench" / "workloads" / "qwen2-7b.prefill-8k.json"
     ).write_text(json.dumps(new))
    bench["workloads"].append({"name": new["name"], "config": "qwen2-7b",
                               "traffic": "prefill-8k", "chips": 1,
                               "why": new["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if old in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (real / "BENCHMARK.json").write_text(json.dumps(bench))
    layout = Layout(real, real / "portbench")
    assert names(layout, "workloads", ".json") == sorted(
        w["name"] for w in bench["workloads"])
    for traced in (False, True):
        assert layout.metrics_of(new["name"], traced) == \
            layout.metrics_of(old, traced)
    small = tiny.layout(tmp_path / "tiny", layout)
    base = tiny.layout(tmp_path / "base")
    for cell in tiny.WORKLOADS:
        for traced in (False, True):
            assert small.metrics_of(cell, traced) == \
                base.metrics_of(cell, traced)


def test_a_metric_added_as_a_file_is_read(tmp_path):
    layout = tiny.layout(tmp_path)
    (tmp_path / "portbench" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n"
        "    w = run['window']\n"
        "    return w['calls'] / w['seconds'] if 'calls' in w else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    layout = Layout(tmp_path, tmp_path / "portbench")
    r = run_cell(layout, "tiny-dense.prefill-mixed", 32, 0.2, False,
                 t_start=time.perf_counter(), need_card=False, device="cpu")
    assert r["metrics"]["calls_per_s"]["value"] > 0
    # a reader that finds nothing to read leaves its metric out
    r = run_cell(layout, "tiny-dense.decode", 33, 0.3, False,
                 t_start=time.perf_counter(), need_card=False, device="cpu")
    assert "calls_per_s" not in r["metrics"]


def digests(root) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_added_as_files_runs(tmp_path, monkeypatch):
    """A model family added as files alone to a copy of the benchmark:
    ``archs/window.py`` (``window_family.py``: sliding-window layers with
    rings of cache rows among full ones, its own reference, cache shapes
    and counts), a configuration that names it, a prefill and a decode
    cell, and their ``BENCHMARK.json`` entries.  Sound seeds read
    correct, the control does not, the family's counts feed the metrics,
    and no file of the copy but the new ones changed."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench_dir)
    layout = tiny.add_window_family(tmp_path, bench_dir)

    for name in tiny.WINDOW_CELLS:
        for seed, control in ((41, True), (2**31 + 43, False)):
            r = run_cell(layout, name, seed, 0.4, False,
                         t_start=time.perf_counter(), need_card=False,
                         device="cpu", control=control)
            assert r["correct"], r["checks"]
            assert r.get("control_correct") is (False if control else None)
    # a traced run: the host-clock metrics read the family's counts
    monkeypatch.setattr(trace, "Tracer", NoDeviceTracer)
    r = run_cell(layout, "tiny-window.decode", 44, 0.6, True,
                 t_start=time.perf_counter(), need_card=False, device="cpu")
    assert r["correct"] and r["metrics"]["mfu.decode"]["value"] > 0
    after = digests(bench_dir)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        pathlib.Path(p) for p in ("archs/window.py",
                                  "configs/tiny-window.json",
                                  "workloads/tiny-window.decode.json",
                                  "workloads/tiny-window.prefill.json")}


class NoDeviceTracer(trace.Tracer):
    """The tracer with no device to profile: it records no event."""

    def __enter__(self):
        self.anchor = (time.perf_counter(), time.time_ns(),
                       time.monotonic_ns())
        return self

    def events(self):
        empty = np.zeros(0, np.int64)
        return [], empty, empty


def test_a_traced_run_reads_the_host_clock_untraced(tmp_path, monkeypatch):
    """A ``--trace 1`` run reads the host-clock metrics from its untraced
    first part and the device's from the traced rest (none on the CPU)."""
    monkeypatch.setattr(trace, "Tracer", NoDeviceTracer)
    layout = tiny.layout(tmp_path)
    cell = f"{tiny.DENSE}.decode"
    r = run_cell(layout, cell, 34, 0.6, True, t_start=time.perf_counter(),
                 need_card=False, device="cpu")
    plain, traced = r["_windows"]["untraced"], r["_windows"]["traced"]
    assert r["correct"]
    assert r["attempted"] == plain["attempted"] + traced["attempted"]
    assert plain["t_last"] <= traced["t_first"]
    assert 0.3 <= plain["seconds"] and 0.6 <= plain["seconds"] \
        + traced["seconds"] < 1.5
    assert r["device"]["window_s"] == traced["t_last"] - traced["t_first"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == {"mfu.decode", "host_cpu_ms_per_step.decode"}
    assert got["host_cpu_ms_per_step.decode"] == \
        plain["host_cpu_s"] / plain["steps"] * 1e3


def test_no_card_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        run_cell(LAYOUT, CELLS[0], 1, 1.0, False, t_start=time.perf_counter())


def test_the_layout_copy_is_whole(tmp_path):
    """``tiny.layout`` copies every family, kind and metric the real
    layout has."""
    layout = tiny.layout(tmp_path)
    assert names(layout, "archs", ".py") == names(LAYOUT, "archs", ".py")
    assert names(layout, "metrics", ".py") == names(LAYOUT, "metrics", ".py")
    assert names(layout, "traffic", ".py") == names(LAYOUT, "traffic", ".py")
    shutil.rmtree(tmp_path / "portbench")
