"""Whole-model estimation in the port (``repro_torch.workload``,
``Design.from_kernel``, ``Session.estimate_model``/``plan_model``/
``sweep_model``) against the reference on the CPU.

Two sources of records:

* the reference's HLO text (its toy config's phases, lowered once per
  module as ``tests/test_workload.py`` does, and the committed fixtures
  ``tests/data/torch_hlo/*.txt``): both packages walk the same text, and
  the walk, the composed estimate and the model sweep must agree — the
  ``torch`` backend on the CPU bit for bit with ``numpy-batch``, ``scalar``
  with ``scalar`` to 1e-9;
* the port's own phases, captured op by op under ``FakeTensorMode``
  (``workload.capture``): their matmul FLOPs must equal the dot FLOPs of
  the reference's HLO for the same config, and their bytes are charged by
  ``hlo_counter``'s rules per ATen op.
"""
import collections
import dataclasses
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro import workload as ref_wl
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.workload import steps as ref_steps
from repro_torch import workload as wl
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.core import hlo_counter as HC
from repro_torch.core import stream as ST
from repro_torch.kernels.mlstm_chunk import ops as ML
from repro_torch.models import moe as MOE
from repro_torch.workload import steps

DATA = pathlib.Path(__file__).resolve().parent / "data" / "torch_hlo"
FIXTURES = sorted(p.stem for p in DATA.glob("*.txt"))
PHASES = ("train", "prefill", "decode")
B, S = 2, 32
TOY = sorted(ARCHS)[0]

CPU = rt.Session(device="cpu")


@pytest.fixture(scope="module")
def ref_cfg():
    return ref_reduced(REF_ARCHS[TOY], layers_scale=2)


@pytest.fixture(scope="module")
def cfg():
    return reduced_config(ARCHS[TOY], layers_scale=2)


@pytest.fixture(scope="module")
def texts(ref_cfg):
    """The reference's compiled HLO of the toy config's three phases."""
    return {p: ref_steps.phase_hlo(ref_cfg, p, batch=B, seq_len=S)
            for p in PHASES}


@pytest.fixture(scope="module")
def captured(cfg):
    """The port's own three phases of the same config, captured."""
    return {p: steps.phase_records(cfg, p, batch=B, seq_len=S, device="cpu")
            for p in PHASES}


def _record(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _matmul_flops(records) -> float:
    return sum(r.flops for r in records if r.op_class == "matmul")


def _hlo_dots(text: str) -> collections.Counter:
    """Every ``dot`` of a module (inside fusions and called computations
    too) by its FLOPs, counted as many times as its loops run it."""
    an = HC.Analyzer(text)
    dots = collections.Counter()

    def comp(c, mult):
        for ins in c.instrs:
            if ins.opcode == "dot":
                dots[HC._dot_flops(ins, c)] += mult
            elif ins.opcode == "while":
                body = an.comps.get(HC._called(ins.rest, "body") or "")
                cond = an.comps.get(HC._called(ins.rest, "condition") or "")
                if body is not None:
                    comp(body, mult * (HC._while_trips(cond)
                                       if cond else 1))
            else:
                for key in ("calls", "to_apply", "true_computation",
                            "false_computation", "branch_computations"):
                    callee = HC._called(ins.rest, key)
                    if callee in an.comps:
                        comp(an.comps[callee], mult)

    comp(an.entry_comp(), 1)
    return dots


def _hlo_dot_flops(text: str) -> float:
    """Every ``dot`` of a module times its loop trips."""
    return sum(f * n for f, n in _hlo_dots(text).items())


# ---------------------------------------------------------------------------
# the walker: the reference's records, field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("phase", PHASES)
def test_walk_module_equals_reference_on_phases(texts, phase, fused):
    got = [_record(r) for r in wl.walk_module(texts[phase], fused=fused)]
    want = [_record(r) for r in ref_wl.walk_module(texts[phase], fused=fused)]
    assert got and got == want


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", FIXTURES)
def test_walk_module_equals_reference_on_fixtures(name, fused):
    text = (DATA / f"{name}.txt").read_text()
    got = [_record(r) for r in wl.walk_module(text, fused=fused)]
    want = [_record(r) for r in ref_wl.walk_module(text, fused=fused)]
    assert got == want


# ---------------------------------------------------------------------------
# the composed estimate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,ref_backend", [("torch", "numpy-batch"),
                                                 ("scalar", "scalar")])
def test_estimate_model_equals_reference(texts, backend, ref_backend):
    got = rt.Session(device="cpu", backend=backend).estimate_model(texts)
    want = repro.Session(backend=ref_backend).estimate_model(texts)
    assert got.phase_names == want.phase_names == PHASES
    rel = 0.0 if backend == "torch" else 1e-9
    for pg, pw in zip(got.phases, want.phases):
        assert [op.record.path for op in pg.ops] == \
            [op.record.path for op in pw.ops]
        a = np.array([op.t_exe for op in pg.ops])
        b = np.array([op.t_exe for op in pw.ops])
        np.testing.assert_allclose(a, b, rtol=rel, atol=0.0)
        assert pg.t_total == pytest.approx(pw.t_total, rel=rel, abs=0.0)
        for f in ("flops", "transcendentals", "t_compute", "t_collective",
                  "n_flops_only", "peak_bandwidth"):
            assert getattr(pg, f) == getattr(pw, f), f
        assert dict(pg.bytes_by_class) == dict(pw.bytes_by_class)
        assert pg.bottleneck == pw.bottleneck
    if backend == "torch":
        assert got.total_latency() == want.total_latency()
    assert got.memory_bound == want.memory_bound
    assert got.ridge_intensity == want.ridge_intensity
    assert got.split() == pytest.approx(want.split(), rel=rel)


@pytest.mark.parametrize("backend", rt.BACKENDS)
def test_phase_total_is_the_sum_of_per_op_estimates(texts, captured,
                                                    backend):
    """The reference's ``model_e2e`` contract, on walked HLO and on the
    port's captured phases."""
    sess = rt.Session(device="cpu", backend=backend)
    for rep in (sess.estimate_model(texts),
                wl.compose_model(sess, "captured", captured)):
        for phase in rep.phases:
            assert phase.ops, f"{phase.name} composed zero scored ops"
            parts = sum(sess.estimate(op.design).t_exe for op in phase.ops)
            assert phase.t_total == pytest.approx(parts, rel=1e-6)
        assert rep.total_latency() == pytest.approx(
            sum(p.t_total for p in rep.phases), rel=1e-12)


def test_report_breakdowns(texts):
    rep = CPU.estimate_model(texts)
    ph = rep.phase("train")
    assert sum(d["t_exe"] for d in ph.by_class()) == pytest.approx(
        ph.t_total, rel=1e-9)
    assert sum(d["t_exe"] for d in ph.by_layer()) == pytest.approx(
        ph.t_total, rel=1e-9)
    rows = rep.rows()
    assert rows and rep.to_csv().count("\n") == len(rows) + 1
    assert rep.summary()["split"].keys() == set(PHASES)
    ref = repro.Session().estimate_model(texts).phase("train")
    assert [d["op_class"] for d in ph.by_class()] == \
        [d["op_class"] for d in ref.by_class()]
    assert "matmul" in wl.report.op_table(ph)


def test_estimate_model_rejects_other_inputs():
    with pytest.raises(TypeError):
        CPU.estimate_model(12345)


def test_estimate_model_on_a_callable():
    rep = CPU.estimate_model(lambda x, w: torch.tanh(x @ w),
                             torch.zeros(64, 128), torch.zeros(128, 128))
    assert rep.phase_names == ("step",)
    assert [op.record.opcode for op in rep.phase("step").ops] == ["mm", "tanh"]
    assert rep.total_latency() > 0


def test_config_phases_capture_on_the_session_device(cfg):
    rep = CPU.estimate_model(cfg, phases=("prefill", "decode"), batch=1,
                             seq_len=16)
    assert rep.name == cfg.name and rep.phase_names == ("prefill", "decode")
    assert all(p.t_total > 0 for p in rep.phases)


def test_no_card_and_no_cpu_raises(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.phase_callable(cfg, "prefill", batch=1, seq_len=8)


def test_frontend_models_raise():
    with pytest.raises(ValueError, match="frontend"):
        steps.phase_callable(reduced_config(ARCHS["hubert-xlarge"]),
                             "prefill", batch=1, seq_len=8, device="cpu")


# ---------------------------------------------------------------------------
# the model sweep
# ---------------------------------------------------------------------------

_GRID = dict(phases=("train", "decode"), batch=(B,), seq_len=(S,),
             shards=(1, 2, 4), hardware=(None, "tpu_v5e"), chunk_size=4)


@pytest.fixture(scope="module")
def plans(texts):
    return {"torch": CPU.plan_model(texts, **_GRID),
            "scalar": CPU.with_backend("scalar").plan_model(texts, **_GRID),
            "numpy-batch": repro.Session().plan_model(texts, **_GRID),
            "ref-scalar": repro.Session(backend="scalar").plan_model(
                texts, **_GRID)}


def _same_columns(a, b, rtol=0.0):
    assert a.keys() == b.keys()
    for k in a:
        if rtol:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=0.0,
                                       err_msg=k)
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_plan_materializes_the_reference_columns(plans):
    assert plans["torch"].device == "cpu" and plans["torch"].n == 12
    assert plans["torch"].tables == plans["numpy-batch"].tables
    assert plans["torch"].param_bytes == 0.0
    _same_columns(plans["torch"].materialize(),
                  plans["numpy-batch"].materialize())
    _same_columns(plans["scalar"].materialize(),
                  plans["ref-scalar"].materialize(), rtol=1e-9)


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_streaming_equals_materialized(plans, chunk):
    plan = plans["torch"]
    full = plan.materialize()
    rep = CPU.sweep_model(plan=plan, chunk_size=chunk)
    assert rep.streaming and rep.n_points == plan.n
    ids = rep.cols["id"].astype(np.int64)
    for k in full:
        assert np.array_equal(np.asarray(full[k])[ids], rep.cols[k]), k
    stats = ST.run_stream(plan.n, chunk, plan.evaluator(),
                          [ST.StatsReducer()]).reducers[0]
    assert stats.t_exe_sum == pytest.approx(float(np.sum(full["t_exe"])),
                                            rel=1e-12)
    want = repro.Session().sweep_model(plan=plans["numpy-batch"],
                                       chunk_size=chunk)
    _same_columns(rep.cols, want.cols)


def test_materialized_report(plans):
    rep = CPU.sweep_model(plan=plans["torch"])
    assert not rep.streaming and len(rep) == plans["torch"].n
    assert rep.best() == repro.Session().sweep_model(
        plan=plans["numpy-batch"]).best()
    assert rep.to_csv().count("\n") == len(rep) + 1


def test_json_round_trip_and_pickle(plans):
    plan = plans["torch"]
    for again in (wl.ModelSweepPlan.from_json(plan.to_json()),
                  pickle.loads(pickle.dumps(plan))):
        assert again.device == "cpu"
        _same_columns(plan.materialize(), again.materialize())
    assert wl.ModelSweepPlan.from_json(plan.to_json()).to_json() == \
        plan.to_json()


def test_reference_plan_json_loads(plans):
    plan = wl.ModelSweepPlan.from_json(plans["numpy-batch"].to_json())
    assert plan.backend == "torch" and plan.device is None
    _same_columns(dataclasses.replace(plan, device="cpu").materialize(),
                  plans["numpy-batch"].materialize())


def test_sweep_model_from_a_config(cfg):
    """A config's plan carries its parameter bytes: a sharded train point
    gains the gradient all-reduce op."""
    rep = CPU.sweep_model(cfg, phases=("train",), batch=(1,), seq_len=(8,),
                          shards=(1, 2))
    plan = rep.plan
    assert plan.param_bytes == steps.param_bytes(cfg) > 0
    assert len(rep) == 2 and np.all(rep.cols["t_exe"] > 0)
    one, two = (plan._point_kernels("train", 1, 8, s)[0] for s in (1, 2))
    assert len(two) == len(one) + 1


# ---------------------------------------------------------------------------
# the capture of the port's own phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_bytes_equal_reference_at_full_width(arch):
    assert steps.param_bytes(ARCHS[arch]) == \
        ref_steps.param_bytes(REF_ARCHS[arch])


@pytest.mark.parametrize("phase", PHASES)
def test_matmul_flops_equal_reference_dots(texts, captured, phase):
    """Every product of the port's eager phase is one of the reference's
    dots: the same FLOPs, at 1e-6."""
    assert _matmul_flops(captured[phase]) == pytest.approx(
        _hlo_dot_flops(texts[phase]), rel=1e-6)


def _expected_product_differences(cfg, phase: str) -> tuple[dict, dict]:
    """(products of the reference's dots the port's capture lacks, products
    the capture has beyond them), by FLOPs: {flops: count}.

    * MoE (einsum semantics): the reference dispatches and combines with
      one-hot einsums, dots of 2 T E C d FLOPs each (T = B S tokens), two a
      layer forward and three more backward (the dispatch into x, the
      combine into the experts' outputs and into its weights); the port
      gathers instead.  The expert products are the same.
    * mLSTM (train only): the reference's backward of its chunk scan runs
      one body for every chunk; autograd skips what reaches no parameter:
      the gradient into chunk 0's zero state through q C (2 B H c dh^2)
      and into its n through q n (2 B H c dh), and the last chunk's state
      update, whose result is never read (two products of 2 B H c dh^2).
      The backward of the two per-row dots q n and q n_intra (n_inter and
      the denominator) forms outer products: XLA multiplies, the port runs
      them as batched matrix products with an inner size of 1, one a chunk
      for q n, two for q n_intra (2 B H c dh FLOPs each).
    """
    missing, extra = collections.Counter(), collections.Counter()
    kinds = cfg.block_kinds
    if cfg.is_moe:
        g, n, C = MOE.groups(cfg, B, S, "einsum")
        per_layer = 2 if phase == "prefill" else 5
        missing[2.0 * g * n * cfg.n_experts * C * cfg.d_model] += \
            per_layer * sum(k in ("attn", "local") for k in kinds)
    if phase == "train" and "mlstm" in kinds:
        layers = kinds.count("mlstm")
        H = cfg.n_heads
        dh = int(cfg.d_model * cfg.mlstm_proj_factor) // H
        c = ML.chunk_size(S, cfg.chunk_size)
        missing[2.0 * B * H * c * dh * dh] += 3 * layers
        extra[2.0 * B * H * c * dh] += (3 * (S // c) - 1) * layers
    return dict(missing), dict(extra)


@pytest.mark.parametrize("phase", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b",
                                  "qwen3-moe-235b-a22b"])
def test_non_dense_products_against_reference_dots(arch, phase):
    """The recurrent and MoE families at ``reduced_config``: every product
    of the port's captured phase against the reference's dots, FLOPs by
    FLOPs.  The RG-LRU, the sLSTM and every prefill but MoE's match
    exactly; the differences are listed and explained in
    ``_expected_product_differences``."""
    cfg = reduced_config(ARCHS[arch])
    port = collections.Counter(
        r.flops for r in steps.phase_records(cfg, phase, batch=B, seq_len=S,
                                             device="cpu")
        if r.op_class == "matmul")
    ref = _hlo_dots(ref_steps.phase_hlo(ref_reduced(REF_ARCHS[arch]), phase,
                                        batch=B, seq_len=S))
    missing, extra = _expected_product_differences(cfg, phase)
    assert dict(ref - port) == missing
    assert dict(port - ref) == extra


def test_remat_adds_the_recomputed_forward(cfg, ref_cfg):
    """``cfg.remat`` is read by ``forward_hidden``: the train phase gains
    exactly the products of the forward that the backward recomputes —
    each one a product of the forward, of the same module — and as many
    FLOPs as the reference's remat adds to its dots."""
    def train(remat):
        return steps.phase_records(dataclasses.replace(cfg, remat=remat),
                                   "train", batch=B, seq_len=S,
                                   device="cpu")

    def products(records):
        return collections.Counter((r.scope, r.opcode, r.flops)
                                   for r in records
                                   if r.op_class == "matmul")

    plain, remat = train(False), train(True)
    extra = products(remat) - products(plain)
    assert sum(extra.values()) == \
        sum(products(remat).values()) - sum(products(plain).values()) > 0
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    _, args = steps.phase_callable(cfg, "train", batch=B, seq_len=S,
                                   device="cpu")
    forward = products(wl.walk_callable(
        lambda params, tokens, labels: _loss(params, plain_cfg, tokens,
                                             labels), *args))
    assert not extra - forward
    ref_extra = _hlo_dot_flops(ref_steps.phase_hlo(
        dataclasses.replace(ref_cfg, remat=True), "train", batch=B,
        seq_len=S)) - _hlo_dot_flops(ref_steps.phase_hlo(
            ref_cfg, "train", batch=B, seq_len=S))
    assert sum(k[2] * n for k, n in extra.items()) == \
        pytest.approx(ref_extra, rel=1e-6)
    assert _matmul_flops(remat) - _matmul_flops(plain) == \
        pytest.approx(ref_extra, rel=1e-6)


def _loss(params, cfg, tokens, labels):
    from repro_torch.models import transformer as TF

    with torch.no_grad():
        return TF.loss_fn(params, cfg, {"tokens": tokens, "labels": labels})


def test_scopes_cover_every_record(captured):
    for phase, records in captured.items():
        assert records and all(r.scope for r in records)
        scopes = {r.scope for r in records}
        assert phase in scopes                   # ops outside every module
        assert {"layers.0.attn", "layers.1.mlp.wo", "head"} <= scopes
        assert all(r.trips == 1.0 for r in records)
        assert len({r.path for r in records}) == len(records)
        rep = wl.compose_model(CPU, "captured", {phase: records}).phases[0]
        rows = rep.by_layer()
        assert len(rows) == len({op.record.scope for op in rep.ops})
        assert sum(d["bytes"] for d in rows) == pytest.approx(
            rep.total_bytes, rel=1e-12)
        assert sum(d["t_exe"] for d in rows) == pytest.approx(
            rep.t_total, rel=1e-12)


def test_backward_ops_take_their_forward_scope(captured):
    """The backward's products land in the modules whose forward made
    them: three products a weight (forward, both gradients), and six
    batched products (scores and P·V, two gradients each) for each of the
    attention core's three (q-block, kv-block) pairs at S 32."""
    mm = collections.Counter(r.scope for r in captured["train"]
                             if r.op_class == "matmul")
    for layer in ("layers.0", "layers.1"):
        for w in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi",
                  "mlp.wg", "mlp.wo"):
            assert mm[f"{layer}.{w}"] == 3, (layer, w)
        assert mm[f"{layer}.attn"] == 6 * 3
    assert mm["head"] == 3


def test_decode_writes_the_caches_as_slice_updates(cfg, captured):
    writes = [r for r in captured["decode"] if r.opcode == "index_copy_"]
    row = B * cfg.n_kv_heads * cfg.head_dim * 2       # one bf16 K or V row
    assert len(writes) == 2 * cfg.n_layers
    assert all(r.op_class == "dynamic"
               and r.bytes_by_class == {"stream": 2.0 * row} for r in writes)


def _ref_from_kernel(f, *shapes_dtypes):
    specs = [jax.ShapeDtypeStruct(s, d) for s, d in shapes_dtypes]
    return repro.Design.from_kernel(f, *specs, name="k")


def _lsus(design):
    return [(l.lsu_type.value, l.ls_width, l.ls_acc, l.ls_bytes, l.delta,
             l.is_write, l.val_constant, l.name) for l in design.lsus]


def test_from_kernel_matmul_equals_reference():
    got = rt.Design.from_kernel(lambda x, w: x @ w, torch.zeros(64, 128),
                                torch.zeros(128, 128), name="k")
    want = _ref_from_kernel(lambda x, w: x @ w, ((64, 128), jnp.float32),
                            ((128, 128), jnp.float32))
    assert got.flops == want.flops == 2_097_152
    assert _lsus(got) == _lsus(want)
    assert got.total_bytes == want.total_bytes == 131_072
    assert got.name == want.name == "k"


def test_from_kernel_gather_lands_in_gather():
    """``x[idx]`` is one gather in both packages.  XLA fuses the index's
    clamp into the gather, so the reference also reads the 1,024 bytes of
    int32 indices and counts the clamp's 768 FLOPs; the eager ``index``
    charges 2 x its result, as ``hlo_counter`` charges a plain gather."""
    x, idx = torch.zeros(1024, 64), torch.zeros(256, dtype=torch.int32)
    gathers = [r for r in wl.walk_callable(lambda x, i: x[i], x, idx)
               if r.op_class == "gather"]
    text = jax.jit(lambda x, i: x[i]).lower(
        jax.ShapeDtypeStruct((1024, 64), jnp.float32),
        jax.ShapeDtypeStruct((256,), jnp.int32)).compile().as_text()
    want = HC.analyze(text)
    assert dict(want.bytes_by_class) == {"gather": 132_096}
    assert want.flops == 768
    assert [(r.opcode, r.bytes_by_class, r.flops) for r in gathers] == \
        [("index", {"gather": 131_072.0}, 0.0)]
    assert want.bytes_by_class["gather"] - 131_072 == idx.numel() * 4
    got = rt.Design.from_kernel(lambda x, i: x[i], x, idx)
    ref = repro.Design.from_classes(dict(want.bytes_by_class))
    assert {l.lsu_type.value for l in got.lsus} >= \
        {l.lsu_type.value for l in ref.lsus}


def _wrapper_calls():
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.membench import ops as MB
    from repro_torch.kernels.mlstm_chunk import ops as ML
    from repro_torch.kernels.rglru import ops as RG

    def t(*shape, dtype=torch.float32, device="cpu"):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "aligned_sum": lambda d: MB.aligned_sum([t(4096, device=d)] * 2),
        "strided_sum": lambda d: MB.strided_sum([t(4096, device=d)],
                                                delta=2),
        "gather_sum": lambda d: MB.gather_sum(
            [t(4096, device=d)], t(2, dtype=torch.int32, device=d)),
        "flash_attention": lambda d: FA.mha(t(1, 64, 2, 16, device=d),
                                            t(1, 64, 2, 16, device=d),
                                            t(1, 64, 2, 16, device=d)),
        "decode_attention": lambda d: DA.gqa_decode(
            t(1, 1, 2, 16, device=d), t(1, 64, 2, 16, device=d),
            t(1, 64, 2, 16, device=d), 64),
        "rglru_scan": lambda d: RG.scan(t(1, 16, 32, device=d),
                                        t(1, 16, 32, device=d)),
        "mlstm_chunk": lambda d: ML.chunked_mlstm(
            t(1, 32, 2, 16, device=d), t(1, 32, 2, 16, device=d),
            t(1, 32, 2, 16, device=d), t(1, 32, 2, device=d),
            t(1, 32, 2, device=d), chunk=16),
    }


@pytest.mark.parametrize("kernel", sorted(_wrapper_calls()))
def test_kernel_wrappers_raise_on_meta_and_fake_tensors(kernel):
    call = _wrapper_calls()[kernel]
    call("cpu")                                  # the plain version runs
    with pytest.raises(RuntimeError, match="meta or fake"):
        call("meta")
    with pytest.raises(RuntimeError, match="meta or fake"):
        rt.Design.from_kernel(lambda: call("cpu"))


def test_capture_allocates_nothing_at_full_width():
    """qwen2-7b's train phase at B 2 x 4,096 is built as fakes: every
    parameter and input is a fake tensor (no storage), and the model holds
    the reference's parameter bytes."""
    from torch._subclasses.fake_tensor import is_fake

    cfg = ARCHS["qwen2-7b"]
    fn, (params, tokens, labels) = steps.phase_callable(
        cfg, "train", batch=2, seq_len=4096, device="cpu")
    assert all(is_fake(p) for p in params.parameters())
    assert is_fake(tokens) and tokens.shape == (2, 4096)
    assert sum(p.numel() for p in params.parameters()) * 4 == \
        ref_steps.param_bytes(REF_ARCHS["qwen2-7b"])
    assert fn.__name__ == "train"
