"""Import surface of the PyTorch port: no JAX and nothing of the reference
package ``repro`` at import or in its sources; its entry points run on the
CUDA card unless the caller asks for the CPU, and nothing is built for CPU
tensors."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch as rt
from repro_torch import compat
from repro_torch.core.model_batch import GroupBatch, estimate_batch
from repro_torch.kernels.membench import ops as MB

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code_or_args, cwd=ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_loads_neither_jax_nor_repro():
    out = _run("import sys, repro_torch, repro_torch.core.validate, "
               "repro_torch.kernels.decode_attention.ops\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] "
               "in ('jax', 'jaxlib', 'repro')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[\s.,]|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_session_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.Session()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.Session(device="cuda")
    assert rt.Session(device="cpu").device == torch.device("cpu")
    assert rt.Session(device="cpu", backend="scalar").backend == "scalar"
    batch = GroupBatch.from_kernels(
        [[rt.Lsu(rt.LsuType.BC_ALIGNED, ls_width=64, ls_acc=16,
                 ls_bytes=4)]],
        rt.DDR4_1866)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimate_batch(batch)
    assert estimate_batch(batch, device="cpu").t_exe.shape == (1,)


def test_unknown_backend_and_device_rejected():
    with pytest.raises(ValueError, match="backend"):
        rt.Session(device="cpu", backend="numpy-batch")
    with pytest.raises(ValueError, match="unsupported device"):
        rt.Session(device="meta")


def test_cpu_tensors_run_plain_versions_and_build_nothing():
    before = (MB.aligned_sum.launches, dict(compat._LIBS))
    xs = [torch.ones(1024), torch.ones(1024)]
    assert torch.equal(MB.aligned_sum(xs, block=512), torch.full((1024,), 2.0))
    assert (MB.aligned_sum.launches, compat._LIBS) == before


def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    here = _run([str(ROOT / "chip_smoke.py")])
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    lonely = _run([str(alone)], cwd=tmp_path)
    assert lonely.returncode != 0 and '"ok"' not in lonely.stdout
