"""No run loads JAX or the JAX package: top-level module names compared
whole, so the port's ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench.harness import FORBIDDEN, HERE

ROOT = HERE.parent

RUN = """
import json, pathlib, shutil, sys, tempfile, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench.harness import HERE, loaded_forbidden, run_cell
from portbench.tests import tiny
layout = tiny.layout(pathlib.Path(tempfile.mkdtemp()))
for cell in tiny.WORKLOADS:
    r = run_cell(layout, cell, 5, 0.2, False, t_start=time.perf_counter(),
                 need_card=False, device="cpu")
    assert r["correct"], r["checks"]
# a family added as files (``archs/window.py``) loads none either
tmp = pathlib.Path(tempfile.mkdtemp())
shutil.copytree(HERE, tmp / "portbench",
                ignore=shutil.ignore_patterns("__pycache__"))
layout = tiny.add_window_family(tmp, tmp / "portbench")
for cell in tiny.WINDOW_CELLS:
    r = run_cell(layout, cell, 5, 0.2, False, t_start=time.perf_counter(),
                 need_card=False, device="cpu")
    assert r["correct"], r["checks"]
import torch.profiler  # what a traced run imports besides (no card here)
print(json.dumps({{"forbidden": loaded_forbidden(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT),
                                          src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    assert "repro_torch" in seen["top"]
    assert not set(seen["top"]) & set(FORBIDDEN)


def test_the_check_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.loaded_forbidden() or "repro" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.loaded_forbidden()


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
