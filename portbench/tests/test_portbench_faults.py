"""Whole runs of the tiny cells on the CPU, past the harness's look for a
card: a sound run is correct; a run whose timed path is broken underneath
is not, once for each fault the cell can have; and the control (the
reference in fp8 in the program's place) reads past a limit.

The faults are planted in the program's step functions as the harness
reaches them (``repro_torch.launch.steps``):
* a decode step that returns its state unchanged (every cache row it
  wrote restored);
* half of the batch left out: the second half's outputs are the mean of
  the first half's;
* a token (decode) or an answer (prefill: its first token) altered where
  it is produced.
The control is judged by the harness's own verdict (``control_correct``).
No cell exchanges anything between chips (each runs on one), so the
fault of an exchange left out has no cell to break.
"""
from __future__ import annotations

import time

import pytest
import torch

import repro_torch.launch.steps as STEPS
from portbench.harness import run_cell
from portbench.tests import tiny

DECODE = f"{tiny.DENSE}.decode"
PREFILL = f"{tiny.DENSE}.prefill-mixed"
SECONDS = {DECODE: 0.6, PREFILL: 0.3}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.layout(tmp_path_factory.mktemp("tiny"))


def run(layout, cell, seed=101, control=False):
    r = run_cell(layout, cell, seed, SECONDS[cell], False,
                 t_start=time.perf_counter(), need_card=False, device="cpu",
                 control=control)
    return r, r.pop("_checked")


def failing(result) -> set[str]:
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", [DECODE, PREFILL])
@pytest.mark.parametrize("seed", [101, 2**31 + 7])
def test_sound_runs_are_correct(layout, cell, seed):
    r, _ = run(layout, cell, seed)
    assert r["correct"] and not failing(r) and r["failed"] == 0


@pytest.mark.parametrize("cell", [DECODE, PREFILL])
def test_the_control_fails(layout, cell):
    r, checked = run(layout, cell, control=True)
    assert r["correct"] and r["control_correct"] is False
    limits = tiny.WORKLOADS[cell]["limits"]
    assert any(v > limits[k] for k, v in checked["control"].items())


def _decode_fault(monkeypatch, alter):
    real = STEPS.make_decode_step

    def make(cfg, *args, **kwargs):
        step = real(cfg, *args, **kwargs)

        def faulty(params, tokens, caches, index):
            return alter(step, params, tokens, caches, index)
        return faulty
    monkeypatch.setattr(STEPS, "make_decode_step", make)


def _prefill_fault(monkeypatch, alter):
    real = STEPS.make_prefill_step

    def make(cfg, *args, **kwargs):
        step = real(cfg, *args, **kwargs)
        return lambda params, batch: alter(step(params, batch))
    monkeypatch.setattr(STEPS, "make_prefill_step", make)


def _half_mean(t):
    half = t.shape[0] // 2
    if half:
        t[half:] = t[:half].float().mean(0, keepdim=True).to(t.dtype)
    return t


def test_decode_state_left_unchanged(layout, monkeypatch):
    def alter(step, params, tokens, caches, index):
        saved = [{k: v.clone() for k, v in c.items()} for c in caches]
        out = step(params, tokens, caches, index)
        for c, s in zip(caches, saved):
            for k in c:
                c[k].copy_(s[k])
        return out
    _decode_fault(monkeypatch, alter)
    r, _ = run(layout, DECODE)
    assert not r["correct"] and "kv_rows_rel_l2" in failing(r)


def test_decode_half_the_batch_left_out(layout, monkeypatch):
    def alter(step, params, tokens, caches, index):
        nxt, logits, caches = step(params, tokens, caches, index)
        logits = _half_mean(logits)
        return logits.argmax(-1).to(torch.int32)[:, None], logits, caches
    _decode_fault(monkeypatch, alter)
    r, _ = run(layout, DECODE)
    assert not r["correct"]


def test_decode_token_altered(layout, monkeypatch):
    def alter(step, params, tokens, caches, index):
        nxt, logits, caches = step(params, tokens, caches, index)
        return (nxt + 1) % logits.shape[-1], logits, caches
    _decode_fault(monkeypatch, alter)
    r, _ = run(layout, DECODE)
    assert not r["correct"] and "token_gap" in failing(r)


def test_prefill_half_the_batch_left_out(layout, monkeypatch):
    _prefill_fault(monkeypatch, _half_mean)
    r, _ = run(layout, PREFILL)
    assert not r["correct"] and "logits_rel_l2" in failing(r)


def test_prefill_answer_altered(layout, monkeypatch):
    def alter(logits):
        first = logits.argmax(-1, keepdim=True)
        return logits.scatter(-1, first, logits.min().item())
    _prefill_fault(monkeypatch, alter)
    r, _ = run(layout, PREFILL)
    assert not r["correct"] and "top_gap" in failing(r)
