"""The port's examples (``examples/torch_*.py``) on the CPU, each held to
its reference script (``examples/*.py``).

Each example runs once, in a subprocess, with ``--device cpu`` and small
arguments, under a timeout of its own; it must exit 0 with neither ``jax``
nor ``repro`` among the modules it loaded.  The numbers it prints are held
against the reference's, computed here: quickstart's section 1 (T_est,
T_sim and bandwidth at each #ga), ``--sweep-only``'s summary and top rows
(every line but the two that carry timings), and the served tokens of
the first three requests (the reference's server on its seed-0 weights,
carried to the port with ``models.convert.from_reference``, f32).
"""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
#: the runner: the example as ``__main__``, then the reference modules it
#: loaded (none expected)
_RUN = r"""
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_path(path, run_name="__main__")
finally:
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    print("LEAKED " + repr(leaked))
"""
TIMEOUT_S = 240


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, str(EXAMPLES / script), "--device",
         "cpu", *args], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "LEAKED []" in proc.stdout.splitlines(), proc.stdout[-500:]
    return proc.stdout


def _reference_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, monkeypatch) -> list[str]:
    monkeypatch.setattr(sys, "argv", [fn.__module__])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_section_1_is_the_reference(monkeypatch):
    """Section 1's three lines (T_est and T_sim in ms, bandwidth) equal the
    reference's as printed; section 2 predicts the captured step."""
    got = _run("torch_quickstart.py").splitlines()
    ref = _printed(_reference_module("quickstart").faithful_demo,
                   monkeypatch)
    want = [ln for ln in ref if "sum-reduction" in ln]
    assert len(want) == 3
    assert [ln for ln in got if "sum-reduction" in ln] == want
    assert "2. Model layer: predict a training step before running it" in got
    flops = next(ln for ln in got if "FLOPs/step" in ln)
    assert float(flops.split()[-1]) > 0
    terms = next(ln for ln in got if ln.strip().startswith("t_compute="))
    assert all(np.isfinite(float(v)) for v in
               re.findall(r"=\s*([0-9.e+-]+) us", terms))
    assert any(ln.strip().startswith("bottleneck: memory") for ln in got)


# ---------------------------------------------------------------------------
# membound_explorer
# ---------------------------------------------------------------------------

def test_sweep_only_is_the_reference(monkeypatch):
    """``--sweep-only``: the memory-bound counts, the fastest five, the
    Pareto rows, the streaming summary and its top 3 equal the reference's
    lines (the two lines that carry wall times are left out)."""
    got = _run("torch_membound_explorer.py", "--sweep-only").splitlines()
    mod = _reference_module("membound_explorer")

    def ref_run():
        mod.sweep_demo()
        mod.stream_demo()
    ref = _printed(ref_run, monkeypatch)

    def timeless(lines):
        return [ln for ln in lines if "points/s" not in ln
                and not ln.startswith("LEAKED")]
    assert sum("points/s" in ln for ln in got) == 2
    assert len(timeless(ref)) >= 15
    assert timeless(got) == timeless(ref)
    assert any(ln.startswith("memory-bound:") and "Pareto front" in ln
               for ln in got)


def test_validate_prints_every_kernels_launches():
    """``--validate``: the seven rows in the reference's order, then every
    kernel wrapper's launches (none on the CPU: the plain versions run)."""
    got = _run("torch_membound_explorer.py", "--validate").splitlines()
    names = ["membench_aligned", "membench_strided", "membench_gather",
             "flash_attention", "decode_attention", "rglru_scan",
             "mlstm_chunk"]
    rows = [ln.split()[0] for ln in got if ln.strip().split()[:1]
            and ln.split()[0] in names]
    assert rows == names
    launches = json.loads(next(ln for ln in got if ln.startswith(
        "kernel launches: ")).split(": ", 1)[1])
    assert launches == dict.fromkeys(names, 0)


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------

def test_served_tokens_are_the_reference_servers(tmp_path):
    """The first three requests' tokens equal the reference server's on
    the same weights and traffic (reduced qwen2-7b, f32)."""
    import jax
    import torch

    from repro.configs import get_config as ref_config
    from repro.configs import reduced_config as ref_reduced
    from repro.launch import serve as REF_SERVE
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as REF_TF
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.convert import from_reference

    requests, max_new = 3, 4
    rcfg = dataclasses.replace(ref_reduced(ref_config("qwen2-7b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-7b")),
                              dtype="float32")
    params = REF_TF.init_params(jax.random.PRNGKey(0), rcfg)
    torch.save(from_reference(params, cfg), tmp_path / "params.pt")
    server = REF_SERVE.BatchedServer(rcfg, make_host_mesh(), batch_slots=4,
                                     max_len=256, params=params)
    rng = np.random.default_rng(0)
    reqs = [REF_SERVE.Request(
        rid=i, prompt=rng.integers(0, rcfg.vocab_size, 8).tolist(),
        max_new=max_new) for i in range(requests)]
    server.run(reqs)
    got = _run("torch_serve_lm.py", "--requests", str(requests),
               "--max-new", str(max_new), "--params",
               str(tmp_path / "params.pt"), "--dtype", "float32")
    lines = got.splitlines()
    assert any("12 tokens in" in ln and ln.endswith("(CPU)") for ln in lines)
    for r in reqs:
        assert len(r.generated) == max_new
        assert (f"  req {r.rid}: prompt={r.prompt[:4]}... -> "
                f"{r.generated[:8]}...") in lines


# ---------------------------------------------------------------------------
# train_lm and autotune_sharding
# ---------------------------------------------------------------------------

def test_train_lm_trains_and_checkpoints(tmp_path):
    """The SMALL config for three steps: finite metrics, the final step,
    and the final checkpoint written."""
    got = _run("torch_train_lm.py", "--steps", "3", "--seq-len", "32",
               "--batch", "2", "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "[train_lm] lm-25m:" in got
    final = next(ln for ln in got.splitlines()
                 if ln.startswith("[train_lm] final: "))
    metrics = ast.literal_eval(final.split(": ", 1)[1])
    assert metrics["final_step"] == 3
    assert np.isfinite(metrics["loss"]) and metrics["loss"] > 0
    assert any((tmp_path / "ckpt").iterdir())


def test_autotune_ranks_the_reference_candidates():
    """Every decode candidate of ``default_candidates`` is ranked or, where
    the config cannot take it, named; the winner is the first row."""
    from repro_torch.core.autotune import default_candidates

    got = _run("torch_autotune_sharding.py").splitlines()
    names = {c.name for c in default_candidates("decode")}
    rows = [ln.split()[0] for ln in got if ln.split()[:1]
            and ln.split()[0] in names]
    assert rows and set(rows) <= names
    winner = next(ln for ln in got if ln.startswith("[autotune] winner: "))
    assert winner.split()[2] == rows[0]
    assert any("on (1, 1) mesh" in ln for ln in got)
