"""The port's dry-run (``repro_torch.launch.dryrun``) and its autotune
(``repro_torch.core.autotune``, ``Session.autotune``), held to the
reference's on the same inputs.

A dry-run cell is one rank's sharded step captured under a fake process
group of the mesh's size and ``FakeTensorMode``: reduced configs on a 4x2
mesh here.  The reference's own per-chip products come from its compiled
SPMD program for 8 forced host devices, built in a subprocess.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import hw as ref_hw
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.configs.shapes import ShapeSpec as RefShapeSpec
from repro.configs.shapes import cell_status as ref_cell_status
from repro.core import autotune as RAT
from repro_torch import Session
from repro_torch import hw as port_hw
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import autotune as AT
from repro_torch.core.cache import HloAnalysisCache
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_world, init_mesh

from test_torch_workload import _hlo_dots

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUT = ((4, 2), ("data", "model"))
KINDS = ("train", "prefill", "decode", "long_decode")
S, B = 16, 8

#: The record keys of an "ok" cell: the reference's, less what reads a
#: compiled program (``lower_s``, ``compile_s``, ``xla_cost``), plus the
#: capture's seconds and op count and the mesh's device type.
OK_KEYS = {"arch", "shape", "mesh", "status", "reason", "params",
           "active_params", "n_layers", "chips", "mesh_device", "capture_s",
           "n_ops", "memory_analysis", "hlo_flops_per_chip",
           "hlo_bytes_per_chip", "bytes_by_class", "collective_operand_bytes",
           "collective_wire_bytes", "collective_by_kind", "n_collectives",
           "tokens_per_step", "model_flops_global", "kind", "warnings"}


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dryrun_cells_capture_where_the_reference_runs(arch):
    """Every kind on a fake 4x2 mesh: "ok" where ``cell_status`` allows,
    "skipped" with the reference's reason where it does not, and an ok
    record carries the per-rank counts."""
    cfg = reduced_config(ARCHS[arch])
    for kind in KINDS:
        shape = ShapeSpec(kind, S, B, kind)
        ok, reason = ref_cell_status(ref_reduced(REF_ARCHS[arch]),
                                     RefShapeSpec(kind, S, B, kind))
        rec = DR.run_cell(arch, shape, layout=LAYOUT, cfg=cfg, save=False)
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == reason
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert set(rec) == OK_KEYS
        assert rec["chips"] == 8 and rec["mesh"] == "4x2"
        assert rec["hlo_flops_per_chip"] > 0 and rec["n_collectives"] > 0
        mem = rec["memory_analysis"]
        assert mem["param_bytes"] > 0
        # the capture follows every storage: the eager peak is the
        # arguments and the peak of what the step created
        assert mem["peak_live_bytes"] == mem["total_bytes"] == (
            mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
        assert mem["temp_size_in_bytes"] > 0
        assert mem["total_bytes"] > mem["argument_size_in_bytes"]


def _reference_hlo(tmp_path, arch, kind, layout=LAYOUT,
                   overrides=None) -> str:
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from repro.configs import ARCHS, reduced_config\n"
        "from repro.configs.shapes import ShapeSpec\n"
        "from repro.launch.steps import TrainConfig, build_step\n"
        "from repro.compat import make_mesh\n"
        "import dataclasses\n"
        f"mesh = make_mesh({layout[0]!r}, {layout[1]!r})\n"
        f"cfg = dataclasses.replace(reduced_config(ARCHS[{arch!r}]), "
        f"**{overrides or {}!r})\n"
        f"built = build_step(cfg, ShapeSpec('c', {S}, {B}, {kind!r}), mesh, "
        "TrainConfig())\n"
        "open(sys.argv[1], 'w').write("
        "built.fn.lower(*built.args).compile().as_text())\n")
    out = tmp_path / "ref.hlo"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, "-c", code, str(out)], check=True,
                   env=env, timeout=600, capture_output=True)
    return out.read_text()


def test_dryrun_products_equal_the_reference_per_chip(tmp_path):
    """stablelm-3b's train step on 4x2: rank 0's captured products (its
    local matmuls, backward and remat recompute included) against the dot
    FLOPs of the reference's SPMD-partitioned program for one of its 8
    devices, product for product.  No op differs: the bound (2 %) is
    met exactly."""
    arch = "stablelm-3b"
    ref = _hlo_dots(_reference_hlo(tmp_path, arch, "train"))
    with fake_world(8):
        mesh = init_mesh(*LAYOUT, device_type="cpu")
        records, _ = DR.capture_step(reduced_config(ARCHS[arch]),
                                     ShapeSpec("c", S, B, "train"),
                                     DR.TrainConfig(), mesh)
    products = [r.flops for r in records if r.op_class == "matmul"]
    want = sum(f * n for f, n in ref.items())
    assert sum(products) == pytest.approx(want, rel=0.02)
    assert sorted(products) == sorted(
        f for f, n in ref.items() for _ in range(int(n)))


def test_dryrun_products_where_heads_do_not_divide_the_model_axis(tmp_path):
    """qwen2-7b's decode step with 6 query heads over a model axis of 4
    (2x4), the small counterpart of the pod cell's 28 heads over 16, where
    the plan leaves the q, k and v weights whole over ``model``.  Rank 0's
    products equal the reference's per-chip dots op for op, the q, k and v
    projections included: each rank computes its own quarter of their
    columns (``attention._project``), as the reference's SPMD partitioner
    splits them, where it computed them whole (4 times the reference's,
    1.51 times its product FLOPs in all)."""
    arch, layout, over = "qwen2-7b", ((2, 4), ("data", "model")), {
        "n_heads": 6}
    ref = _reference_hlo(tmp_path, arch, "decode", layout, over)
    ref = sorted(f for f, n in _hlo_dots(ref).items() for _ in range(int(n)))
    with fake_world(8):
        mesh = init_mesh(*layout, device_type="cpu")
        records, _ = DR.capture_step(
            dataclasses.replace(reduced_config(ARCHS[arch]), **over),
            ShapeSpec("c", S, B, "decode"), DR.TrainConfig(), mesh)
    products = [r for r in records if r.op_class == "matmul"]
    qkv = [r.flops for r in products
           if r.scope.rsplit(".", 1)[-1] in ("wq", "wk", "wv")]
    rest = [r.flops for r in products
            if r.scope.rsplit(".", 1)[-1] not in ("wq", "wk", "wv")]
    assert len(qkv) == 3
    assert sorted(rest + qkv) == ref
    assert sum(r.flops for r in products) / sum(ref) == 1.0


def test_collectives_are_charged_and_waits_are_free():
    """A redistribution's collectives by ``core/hlo.py``'s rules: an
    all-gather of a (4, 8) f32 shard over 2 ranks moves 128 operand bytes,
    128 on the wire; a partial sum's all-reduce 2 R (g-1)/g; a shard moved
    to another dim an all-to-all of the (4, 8) shard the rank keeps, R
    operand bytes and R (g-1)/g on the wire, where a CPU mesh runs an
    all-gather and a chunk (recorded as the all-to-all, the chunk's copy
    not recorded)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.workload.capture import fake_mode, walk_callable
    with fake_world(2):
        mesh = init_mesh((2,), ("model",), device_type="cpu")
        with fake_mode():
            x = DTensor.from_local(torch.zeros(4, 8), mesh, (Shard(0),))
            y = DTensor.from_local(torch.zeros(8, 8), mesh, (Partial(),))
            z = DTensor.from_local(torch.zeros(4, 8), mesh, (Shard(0),))

        def step(x, y, z):
            return (x.redistribute(mesh, (Replicate(),)),
                    y.redistribute(mesh, (Replicate(),)),
                    z.redistribute(mesh, (Shard(1),)))
        records = walk_callable(step, x, y, z)
    kinds = {r.opcode: r for r in records if r.n_collectives}
    assert set(kinds) == {"all-gather", "all-reduce", "all-to-all"}
    assert len(records) == 3
    ag, ar, a2a = (kinds[k] for k in ("all-gather", "all-reduce",
                                      "all-to-all"))
    assert (ag.collective_operand_bytes, ag.collective_wire_bytes) == (128, 128)
    assert (ar.collective_operand_bytes, ar.collective_wire_bytes) == (256, 256)
    assert (a2a.collective_operand_bytes,
            a2a.collective_wire_bytes) == (128, 64)
    assert not any("wait" in r.opcode for r in records)


def test_run_cell_saves_under_results(tmp_path, monkeypatch):
    monkeypatch.setattr(DR, "RESULTS_DIR", str(tmp_path))
    cfg = reduced_config(ARCHS["qwen2-7b"])
    rec = DR.run_cell("qwen2-7b", ShapeSpec("decode_s", S, B, "decode"),
                      layout=LAYOUT, cfg=cfg, tag="t")
    path = pathlib.Path(DR.cell_path("qwen2-7b", "decode_s", "4x2", "t"))
    assert path.parent == tmp_path and path.is_file()
    import json
    assert json.loads(path.read_text())["status"] == rec["status"] == "ok"
    assert not list(tmp_path.glob("*.gz"))          # no HLO archive


def test_default_train_config_keeps_the_reference_rule():
    """bf16 moments from 1e11 parameters on (``repro.launch.dryrun``'s
    rule; that module is not imported here: it sets ``XLA_FLAGS`` for 512
    host devices at import, which would leak into this worker)."""
    for arch in sorted(ARCHS):
        got = DR.default_train_config(ARCHS[arch]).optimizer.state_dtype
        big = REF_ARCHS[arch].param_count() >= 1e11
        assert got == ("bfloat16" if big else "float32"), arch
    assert DR.default_train_config(ARCHS["grok-1-314b"]).optimizer \
        .state_dtype == "bfloat16"


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_default_candidates_equal_reference(kind):
    got = [dataclasses.asdict(c) for c in AT.default_candidates(kind)]
    want = [dataclasses.asdict(c) for c in RAT.default_candidates(kind)]
    assert got == want


def _records(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        classes = [c for c in ("stream", "strided", "gather", "serialized")
                   if rng.random() < 0.8] or ["stream"]
        out.append({
            "flops": float(rng.uniform(1e9, 1e14)),
            "bytes_by_class": {c: float(rng.uniform(1e6, 1e11))
                               for c in classes},
            "collective_wire_bytes": float(rng.uniform(0, 1e10)),
            "collective_operand_bytes": float(rng.uniform(0, 1e10)),
            "collective_by_kind": {},
            "n_collectives": float(rng.integers(0, 2000))})
    return out


@pytest.mark.parametrize("preset", sorted(port_hw.names()) + [None])
def test_rank_records_bit_equal_to_reference(preset):
    records = _records(17, seed=len(str(preset)))
    want = RAT.rank_records(records, ref_hw.get(preset) if preset else None,
                            gather_row_bytes=256.0)
    got = AT.rank_records(records, port_hw.get(preset) if preset else None,
                          gather_row_bytes=256.0, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), (preset, k)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; with a card the default scores there")
def test_scoring_defaults_to_the_card():
    """With no device named the scoring goes to the card, as every entry
    point of the port does; with none present it raises, never falling
    back to the host."""
    records = _records(3, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AT.rank_records(records)
    cfg, shape = SMALL
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AT.run_trial(cfg, shape, LAYOUT, AT.default_candidates("decode")[0],
                     cache=None)


SMALL = (reduced_config(ARCHS["qwen2-7b"]), ShapeSpec("decode_s", S, B,
                                                      "decode"))


def test_autotune_ranks_candidates_and_serves_the_cache(tmp_path,
                                                        monkeypatch):
    """Two candidates ranked by predicted step time, a kv-heads candidate
    that fails where the kv heads do not split (2 over a model axis of 4,
    the reference's error), and a second call served from the cache with
    no capture."""
    cfg, shape = SMALL
    cands = AT.default_candidates("decode")
    cache = HloAnalysisCache(tmp_path)
    sess = Session(device="cpu")
    rep = sess.autotune(cfg, shape, ((2, 4), ("data", "model")), cands,
                        cache=cache)
    assert [f.candidate.name for f in rep.failures] == ["kv-heads"]
    assert rep.failures[0].error_msg == "kv heads not divisible by model axis"
    assert len(rep) == 2 and rep.best is rep[0]
    assert rep[0].t_step <= rep[1].t_step
    assert {r["name"] for r in rep.rows()} == {c.name for c in cands}
    assert rep.summary() == {"kind": "autotune", "candidates": 2,
                             "failures": 1, "best": rep[0].candidate.name}

    def no_capture(*a, **k):
        raise AssertionError("captured again")
    monkeypatch.setattr(AT, "_capture", no_capture)
    again = sess.autotune(cfg, shape, ((2, 4), ("data", "model")), cands,
                          cache=cache)
    assert all(t.cached for t in again)
    assert [t.candidate.name for t in again] == [t.candidate.name for t in rep]
    assert [t.t_step for t in again] == [t.t_step for t in rep]


def test_autotune_key_follows_the_hardware_and_the_mesh():
    cfg, shape = SMALL
    c = AT.default_candidates("decode")[0]
    keys = {AT.candidate_key(cfg, shape, layout, c, hw)
            for layout in (((4, 2), ("data", "model")),
                           ((2, 4), ("data", "model")))
            for hw in (None, port_hw.get("tpu_v5e"),
                       port_hw.get("stratix10_ddr4_1866"))}
    assert len(keys) == 4        # None is the registry's tpu_v5e


def test_autotune_all_failed_alike_raises():
    """Two candidates failing with one error: environmental, raised; one
    failing candidate alone: an empty ranking with its failure."""
    cfg, shape = SMALL
    bad = [AT.Candidate(name, {"no_such_field": 1}, {}) for name in "ab"]
    with pytest.raises(RuntimeError, match="all 2 candidates failed"):
        AT._autotune(cfg, shape, LAYOUT, bad, cache=False, device="cpu")
    one = AT._autotune(cfg, shape, LAYOUT, bad[:1], cache=False,
                       device="cpu")
    assert len(one) == 0 and len(one.failures) == 1
