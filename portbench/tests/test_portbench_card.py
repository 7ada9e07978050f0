"""The tiny cells through the program's CUDA kernels, on the card:
``python -m pytest portbench/tests -m card``.  Each run is correct, and
every attention layer launched its kernel once a call or a step; the
control (the reference in fp8 in the program's place) is not correct."""
from __future__ import annotations

import time

import pytest

from portbench.harness import run_cell
from portbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("cell", list(tiny.WORKLOADS))
def test_tiny_cell_on_the_card(card, tmp_path, cell):
    layout = tiny.layout(tmp_path)
    r = run_cell(layout, cell, 2**31 + 11, 1.0, True,
                 t_start=time.perf_counter(), device=str(card), control=True)
    checked = r.pop("_checked")
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, checked["control"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    for name in ("k4_launches_off", "k5_launches_off"):
        if name in r["checks"]:
            assert r["checks"][name]["value"] == 0
