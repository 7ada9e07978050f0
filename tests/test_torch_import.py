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
               "repro_torch.kernels.decode_attention.ops, "
               "repro_torch.kernels.flash_attention.ops, "
               "repro_torch.kernels.rglru.ops, "
               "repro_torch.kernels.mlstm_chunk.ops, "
               "repro_torch.core.stream, repro_torch.core.device_stream, "
               "repro_torch.core.distributed, repro_torch.optim.adamw, "
               "repro_torch.search.envelope, repro_torch.search.constraints, "
               "repro_torch.search.optimize, repro_torch.core.serving, "
               "repro_torch.core.hlo_counter, repro_torch.core.predictor, "
               "repro_torch.core.roofline, repro_torch.core.dramsim, "
               "repro_torch.core.baselines, repro_torch.core.cache, "
               "repro_torch.paper_tables, repro_torch.models, "
               "repro_torch.models.transformer, repro_torch.models.convert, "
               "repro_torch.models.recurrent, repro_torch.models.xlstm, "
               "repro_torch.configs, repro_torch.configs.shapes, "
               "repro_torch.launch.steps, repro_torch.launch.serve\n"
               "rep = repro_torch.Session(device='cpu').sweep("
               "n_ga=[1, 2, 4], chunk_size=2)\n"
               "assert rep.is_streaming and rep.n_points == 3\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] "
               "in ('jax', 'jaxlib', 'repro')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_whole_model_estimation_loads_neither_jax_nor_repro():
    """``repro_torch.workload``, a captured config through
    ``Session.estimate_model`` and ``plan_model`` stay clear of both."""
    out = _run("import sys, repro_torch.workload\n"
               "from repro_torch import Session\n"
               "from repro_torch.configs import ARCHS, reduced_config\n"
               "cfg = reduced_config(ARCHS['qwen2-7b'])\n"
               "s = Session(device='cpu')\n"
               "rep = s.estimate_model(cfg, phases=('train', 'decode'), "
               "batch=1, seq_len=8)\n"
               "assert rep.total_latency() > 0\n"
               "plan = s.plan_model(cfg, phases=('prefill',), seq_len=(8,))\n"
               "assert plan.materialize()['t_exe'].shape == (1,)\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] "
               "in ('jax', 'jaxlib', 'repro')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_mesh_layer_loads_neither_jax_nor_repro():
    """The mesh modules, a dry-run cell on a fake 4x2 mesh and
    ``Session.autotune`` over it stay clear of both."""
    out = _run("import sys, repro_torch.launch.mesh, "
               "repro_torch.launch.sharding, repro_torch.launch.dryrun as DR, "
               "repro_torch.models.pspec, repro_torch.runtime.elastic, "
               "repro_torch.core.autotune\n"
               "from repro_torch import Session\n"
               "from repro_torch.configs import ARCHS, reduced_config\n"
               "from repro_torch.configs.shapes import ShapeSpec\n"
               "cfg = reduced_config(ARCHS['qwen2-7b'])\n"
               "shape = ShapeSpec('d', 16, 8, 'decode')\n"
               "layout = ((4, 2), ('data', 'model'))\n"
               "rec = DR.run_cell('qwen2-7b', shape, layout=layout, cfg=cfg, "
               "save=False)\n"
               "assert rec['status'] == 'ok', rec\n"
               "rep = Session(device='cpu').autotune(cfg, shape, layout, "
               "cache=False)\n"
               "assert len(rep) == 3, rep.rows()\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] "
               "in ('jax', 'jaxlib', 'repro')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_training_loads_neither_jax_nor_repro(tmp_path):
    """The trainer's modules, and two CPU steps of its loop, stay clear of
    both."""
    out = _run("import sys, dataclasses, repro_torch.launch.train as T, "
               "repro_torch.checkpoint, repro_torch.data, "
               "repro_torch.runtime\n"
               "from repro_torch.configs import ARCHS, reduced_config\n"
               "from repro_torch.configs.shapes import ShapeSpec\n"
               "from repro_torch.data import DataConfig\n"
               "cfg = dataclasses.replace(reduced_config(ARCHS['stablelm-3b']),"
               " use_kernels=False)\n"
               "built = T.build_step(cfg, ShapeSpec('t', 16, 2, 'train'), "
               "T.TrainConfig(), device='cpu')\n"
               f"m = T.train_loop(cfg, built, T.TrainConfig(), steps=2, "
               f"ckpt_dir={str(tmp_path)!r}, data_cfg=DataConfig(16, 2), "
               "preemption=T.PreemptionHandler())\n"
               "assert m['final_step'] == 2\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] "
               "in ('jax', 'jaxlib', 'repro')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


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
