"""The tiny cells, and those of the tiny ``window`` family, through the
program's CUDA kernels, on the card: ``python -m pytest portbench/tests
-m card``.  Each run is correct, and every attention layer launched its
kernel once a call or a step; the control (the reference in fp8 in the
program's place) is not correct."""
from __future__ import annotations

import shutil
import time

import pytest

from portbench.harness import HERE, run_cell
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


@pytest.mark.card
@pytest.mark.parametrize("cell", list(tiny.WINDOW_CELLS))
def test_window_family_on_the_card(card, tmp_path, cell):
    """The tiny ``window`` family, added as files: K5 with a window and K4
    over rings, one launch a layer a call or step, against its reference
    and its control."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    layout = tiny.add_window_family(tmp_path, bench_dir)
    r = run_cell(layout, cell, 2**31 + 13, 1.0, True,
                 t_start=time.perf_counter(), device=str(card), control=True)
    checked = r.pop("_checked")
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, checked["control"]
    for name in ("k4_launches_off", "k5_launches_off"):
        if name in r["checks"]:
            assert r["checks"][name]["value"] == 0
