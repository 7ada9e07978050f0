"""The per-layer metrics that read the program's own spans
(``program_spans.py``; ``repro_torch.runtime.tracing`` records them while
a profiler session is active).

On the CPU: each tiny traced cell, dense and MoE, runs with every reader
giving None or a finite number; the host-clock readers read the decode
steps' spans under a CPU profiler, the device-time ones nothing; a buffer
left from an earlier session is not read; a program without the module
gives None.  On the card (``-m card``): each tiny cell reads every metric
whose spans it opens; the spans' clock is the trace's as ``trace._to_host``
maps it; and the MoE layer's four stages take no more device time than
the device was busy at the real widths.
"""
from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import pytest
import torch

from portbench import port, program_spans, trace
from portbench import weights as W
from portbench.archs import qwen
from portbench.harness import HERE, Layout, run_cell
from portbench.tests import tiny

DECODE = f"{tiny.DENSE}.decode"
PREFILL = f"{tiny.DENSE}.prefill-mixed"
MOE = f"{tiny.MOE}.prefill"
#: Long enough that the traced half issues calls after an untraced half
#: slowed by a loaded host.
SECONDS = {DECODE: 1.0, PREFILL: 1.0, MOE: 2.0}
SEED = 2**31 + 29
STAGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")
#: The metrics that read the program's spans, by the spans that feed them.
DEVICE = {f"{s}_us_per_token.prefill": f"moe.{s[4:]}" for s in STAGES}
DEVICE["attention_us_per_token.prefill"] = "attention"
HOST = {"host_attention_ms_per_step.decode": "attention",
        "host_mlp_ms_per_step.decode": "mlp"}
#: The metrics each tiny cell reads on the card: those whose spans it opens.
OPENS = {DECODE: set(HOST), PREFILL: {"attention_us_per_token.prefill"},
         MOE: set(DEVICE)}


def layout(tmp) -> Layout:
    """The tiny layout with a tiny MoE prefill cell besides, listed by every
    metric the tiny prefill cell reports."""
    lay = tiny.layout(tmp)
    wl = dict(tiny.WORKLOADS[PREFILL], config=tiny.MOE, name=MOE, why="tiny",
              traffic={"tokens_per_call": 64, "shapes": [[2, 32]],
                       "pool_calls": 4, "warmup_calls": 1,
                       "check_calls_per_shape": 1})
    (lay.dir / "workloads" / f"{MOE}.json").write_text(json.dumps(wl))
    bench = dict(lay.bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": MOE, "config": tiny.MOE, "traffic": "prefill", "chips": 1,
         "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if PREFILL in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [MOE]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(tmp, lay.dir)


class CpuTracer(trace.Tracer):
    """The tracer on the CPU: a profiler session of host activity, so that
    the program records its spans; no device events."""

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.__enter__()
        self.anchor = (time.perf_counter(), time.time_ns(),
                       time.monotonic_ns())
        return self

    def events(self):
        empty = np.zeros(0, np.int64)
        return [], empty, empty


class NoProfiler(CpuTracer):
    """A traced run's tracer with no profiler session."""

    def __init__(self, on: bool):
        super().__init__(False)


def _run(lay, cell, device="cpu"):
    return run_cell(lay, cell, SEED, SECONDS[cell], True,
                    t_start=time.perf_counter(), need_card=device != "cpu",
                    device=device)


def _spans_read(lay, cell, r) -> dict:
    """The result's values of the metrics that read spans, of those the
    layout lists for ``cell``."""
    listed = {m["name"] for m in lay.metrics_of(cell, True)}
    assert listed >= OPENS[cell]
    return {k: v["value"] for k, v in r["metrics"].items()
            if k in listed & (set(DEVICE) | set(HOST))}


@pytest.mark.parametrize("cell", [DECODE, PREFILL, MOE])
def test_each_tiny_cell_reads_spans_on_the_cpu(tmp_path, monkeypatch, cell):
    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    lay = layout(tmp_path)
    got = _spans_read(lay, cell, _run(lay, cell))
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    # the host's clock is read wherever the spans open; the device's
    # nowhere on the CPU
    assert set(got) == (set(HOST) if cell == DECODE else set())


def test_a_buffer_from_an_earlier_session_is_not_read(tmp_path, monkeypatch):
    lay = layout(tmp_path)
    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    assert _spans_read(lay, DECODE, _run(lay, DECODE))
    # traced with no profiler: the program records nothing new and the
    # buffer holds the earlier run's spans
    monkeypatch.setattr(trace, "Tracer", NoProfiler)
    r = _run(lay, DECODE)
    assert not _spans_read(lay, DECODE, r)
    assert set(r["metrics"]) == {"mfu.decode", "host_cpu_ms_per_step.decode"}


def test_a_program_without_spans_reads_none(monkeypatch):
    import repro_torch.runtime

    monkeypatch.delattr(repro_torch.runtime, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    run = {"traced": {"window": {"calls": 1, "steps": 1, "tokens": 1,
                                 "t_first": 0.0, "t_last": 1e12}}}
    assert program_spans.totals(run, "prefill_step", "calls") is None
    assert program_spans.device_us_per_token(run, "attention") is None
    assert program_spans.host_ms_per_step(run, "mlp") is None


@pytest.mark.card
def test_the_traced_half_switches_recording_on(card):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch._C._autograd._profiler_enabled()
    assert not torch._C._autograd._profiler_enabled()


@pytest.mark.card
@pytest.mark.parametrize("cell", [DECODE, PREFILL, MOE])
def test_each_tiny_cell_reads_its_spans_on_the_card(card, tmp_path, cell):
    lay = layout(tmp_path)
    got = _spans_read(lay, cell, _run(lay, cell, str(card)))
    assert set(got) == OPENS[cell], got
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got


def _program(name: str, dev):
    g = qwen.geometry(tiny.configs()[name])
    cfg = qwen.model_config(g)
    port.build_kernels(qwen, dev)
    return g, cfg, qwen.load_model(g, cfg, W.draw_weights(qwen, g, SEED, dev),
                                   dev)


@pytest.mark.card
def test_the_spans_clock_is_the_traces(card):
    """Three synchronised decode steps: mapped onto ``perf_counter`` by
    ``trace._to_host``, no kernel starts before the first step's span
    opens, each step's kernels (those that start after its span opens)
    end before the next step's span opens, and every step has some."""
    from repro_torch.runtime import tracing

    g, cfg, model = _program(tiny.DENSE, card)
    step = qwen.make_decode_step(cfg)
    caches = qwen.init_caches(cfg, 4, 64, card)
    tok = torch.ones((4, 1), dtype=torch.int32, device=card)
    index = torch.full((1,), 8, dtype=torch.int64, device=card)
    step(model, tok, caches, index)
    torch.cuda.synchronize()
    with trace.Tracer(True) as tracer:
        t_first = time.perf_counter()
        for _ in range(3):
            step(model, tok, caches, index)
            torch.cuda.synchronize()
        t_last = time.perf_counter()
    opens = [s.t0 * 1e-9 for s in tracing.records() if s.parent is None]
    assert len(opens) == 3 and t_first <= opens[0]
    _, starts, ends = tracer.events()
    zero = trace._to_host(starts, tracer.anchor, t_first, t_last)
    assert zero is not None
    perf0 = tracer.anchor[0]
    begin = perf0 + (starts - zero) * 1e-9
    end = perf0 + (ends - zero) * 1e-9
    of = np.searchsorted(opens, begin, side="right") - 1
    assert (of >= 0).all(), (opens[0] - begin.min())
    for i in range(2):
        assert (end[of == i] < opens[i + 1]).all(), \
            (end[of == i].max() - opens[i + 1])
    assert (np.bincount(of, minlength=3) > 0).all()


#: The MoE cell's configuration cut to one layer, every width kept.
ONE_LAYER = "qwen3-moe-235b-a22b.ep16.one-layer"
REAL_MOE = "qwen3-moe-235b-a22b.ep16.prefill-4k"


@pytest.mark.card
def test_the_moe_stages_take_no_more_than_the_busy_time(card, tmp_path):
    """The MoE cell's traffic on its configuration cut to one layer: the
    event time of the four ``moe.*`` stages is at most the traced window's
    busy time.  At the real widths the device runs the layer's kernels
    back to back; the tiny cells' kernels last about as long as the gaps
    between them, which event time counts and busy time does not."""
    lay = layout(tmp_path)
    real_cfg = json.loads((HERE / "configs" / f"{REAL_MOE.rsplit('.', 1)[0]}"
                                      ".json").read_text())
    cfg = dict(real_cfg, name=ONE_LAYER, num_hidden_layers=1)
    (lay.dir / "configs" / f"{ONE_LAYER}.json").write_text(json.dumps(cfg))
    cell = f"{ONE_LAYER}.prefill-4k"
    real = json.loads((HERE / "workloads" / f"{REAL_MOE}.json").read_text())
    wl = dict(real, name=cell, config=ONE_LAYER,
              traffic=dict(real["traffic"], pool_calls=4, warmup_calls=1,
                           check_calls_per_shape=1))
    (lay.dir / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    bench = dict(lay.bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": cell, "config": ONE_LAYER, "traffic": "prefill-4k",
         "chips": 1, "why": "one layer"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if MOE in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [cell]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lay = Layout(tmp_path, lay.dir)
    r = run_cell(lay, cell, SEED, 2.0, True, t_start=time.perf_counter(),
                 device=str(card))
    got = {k: v["value"] for k, v in r["metrics"].items()}
    stages = [got[f"{x}_us_per_token.prefill"] for x in STAGES]
    tokens = r["_windows"]["traced"]["tokens"]
    assert all(v > 0 for v in stages), got
    assert sum(stages) * tokens * 1e-6 <= r["device"]["busy_s"], \
        (got, tokens, r["device"])
