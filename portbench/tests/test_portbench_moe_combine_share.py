"""``moe_combine_kernel_share.prefill`` on synthetic traces and span
totals: 100 where every ``moe.combine`` span's combine launched the
kernel, 0 where none did (the program before the kernel), None where no
``moe.combine`` span opened or the spans have no device time."""
from __future__ import annotations

import types

import pytest

from portbench.harness import HERE, Layout

NAME = "moe_combine_kernel_share.prefill"
CALLS, LAYERS = 3, 47
KERNEL = "void (anonymous namespace)::moe_combine_rows<__nv_bfloat16>(...)"
OTHER = "void at::native::elementwise_kernel<128, 4>(...)"


def run(by_name: dict) -> dict:
    trace = {"by_name": {k: [1e-3 * n, n] for k, n in by_name.items()},
             "kernels": sum(by_name.values())}
    return {"traced": {"window": {"calls": CALLS, "tokens": CALLS * 8192,
                                  "t_first": 0.0, "t_last": 10.0},
                       "trace": trace}}


@pytest.fixture
def spans(monkeypatch):
    """The program's recording, replaced: one root a call and the named
    spans ``LAYERS`` times a call, with device time or not."""
    from repro_torch.runtime import tracing

    def plant(names, device=True):
        dev = 1e-3 if device else None
        got = {"prefill_step": tracing.Total(CALLS, 1.0, 0.1, dev, dev)}
        got.update({n: tracing.Total(CALLS * LAYERS, 0.5, 0.5, dev, dev)
                    for n in names})
        monkeypatch.setattr(tracing, "records",
                            lambda: [types.SimpleNamespace(t0=int(1e9))])
        monkeypatch.setattr(tracing, "totals", lambda: got)
    return plant


def read(r: dict):
    return Layout(HERE.parent).metric(NAME).read(r)


def test_every_combine_on_the_kernel_reads_100(spans):
    spans(["moe.route", "moe.combine"])
    assert read(run({KERNEL: CALLS * LAYERS, OTHER: 500})) == 100.0


def test_no_kernel_reads_0(spans):
    spans(["moe.route", "moe.combine"])
    assert read(run({OTHER: 500})) == 0.0


def test_no_combine_span_reads_none(spans):
    spans(["attention", "mlp"])
    assert read(run({OTHER: 500})) is None


def test_spans_without_device_time_read_none(spans):
    spans(["moe.combine"], device=False)
    assert read(run({})) is None


def test_an_untraced_run_reads_none():
    assert read({"traced": None}) is None
