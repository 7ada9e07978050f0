"""The ``deepseek_v3`` family: found by name from a copy of the benchmark
and run as a tiny cell on the CPU, its counts at the published widths,
and the tiny cell through the kernels on the card.

The tiny cell runs the program in f32 (its configuration states f32
products): at 64 widths a near tie in the sigmoid gate flips under bf16
rounding in some seeds and moves the logits as far as the fp8 control
does, as ``tiny.py`` notes of the ``qwen`` MoE.  In f32 the program and
the reference are one function, so the limits hold rounding alone
(twelve sound seeds read under 3e-6 / 0), and the control, the reference
with its products' inputs in fp8, reads 0.40-0.64 / 0.97-1.4 (six).  The bf16
program against the reference at the tiny size is
``tests/test_torch_deepseek_mla.py``'s.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time

import pytest

from portbench import trace
from portbench.archs import deepseek_v3 as A
from portbench.harness import HERE, Layout, run_cell
from portbench.tests.test_portbench_layout import NoDeviceTracer, digests

CELL = "tiny-deepseek.prefill"
#: The tiny configuration: the real file with every size cut but the head
#: sizes (K5's 192/128 pair), 3 layers (1 dense), 16 gate outputs in 4
#: groups (2 kept), top-4, products in f32.
SIZES = dict(name="tiny-deepseek", hidden_size=64, intermediate_size=96,
             moe_intermediate_size=32, num_attention_heads=2,
             num_key_value_heads=2, q_lora_rank=32, kv_lora_rank=32,
             num_hidden_layers=3, first_k_dense_replace=1,
             n_routed_experts=4, num_experts_per_tok=4, n_group=4,
             topk_group=2, vocab_size=500)
LIMITS = {"logits_rel_l2": 1e-4, "top_gap": 1e-3, "k5_launches_off": 0,
          "k8_launches_off": 0, "routed_rel_l2": 1e-4,
          "routed_choices_off": 0}
REAL = "deepseek-v3.ep32"


def add_tiny_deepseek(tmp: pathlib.Path, bench_dir: pathlib.Path) -> Layout:
    """The tiny configuration and its prefill cell added, as files and
    ``BENCHMARK.json`` entries alone, to a copy of the benchmark at
    ``bench_dir``; the cell reports what the real cell reports."""
    c = json.loads((bench_dir / "configs" / f"{REAL}.json").read_text())
    c.update(SIZES)
    c["expert_share"] = dict(c["expert_share"], held=[0, 4],
                             router_outputs=16)
    c["assumed"] = dict(c["assumed"], padded_vocab=512)
    c["dtype"] = dict(c["dtype"], products="float32",
                      activations="float32")
    (bench_dir / "configs" / "tiny-deepseek.json").write_text(json.dumps(c))
    w = dict(name=CELL, config="tiny-deepseek", kind="prefill_batches_routed",
             why="tiny", limits=LIMITS,
             traffic={"tokens_per_call": 64, "shapes": [[2, 32], [1, 64]],
                      "pool_calls": 4, "warmup_calls": 1,
                      "check_calls_per_shape": 2})
    (bench_dir / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-deepseek",
                               "traffic": "prefill", "chips": 1,
                               "why": "tiny"})
    real = f"{REAL}.prefill-16k"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if real in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(tmp, bench_dir)


def test_the_family_is_found_by_name(tmp_path, monkeypatch):
    """A copy of the benchmark with the tiny configuration and cell added
    as files: the harness loads ``archs/deepseek_v3.py`` by the name the
    configuration gives, sound seeds read correct, the control does not,
    the family's counts feed the metrics, and no file of the copy but the
    new ones changed."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench_dir)
    layout = add_tiny_deepseek(tmp_path, bench_dir)
    assert layout.arch(layout.config("tiny-deepseek")).__file__ == \
        str(bench_dir / "archs" / "deepseek_v3.py")
    for seed, control in ((51, True), (2**31 + 53, False), (54, True)):
        r = run_cell(layout, CELL, seed, 0.3, False,
                     t_start=time.perf_counter(), need_card=False,
                     device="cpu", control=control)
        assert r["correct"], r["checks"]
        assert r.get("control_correct") is (False if control else None)
        assert r["_checked"]["kept_pairs_per_call"] > 0
    monkeypatch.setattr(trace, "Tracer", NoDeviceTracer)
    # the untraced first half must leave the traced rest a call or more,
    # on a loaded host too
    r = run_cell(layout, CELL, 55, 3.0, True, t_start=time.perf_counter(),
                 need_card=False, device="cpu")
    assert r["correct"] and r["metrics"]["mfu.prefill"]["value"] > 0
    after = digests(bench_dir)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        pathlib.Path("configs/tiny-deepseek.json"),
        pathlib.Path(f"workloads/{CELL}.json")}


def _fault(monkeypatch, fault: str) -> None:
    """Break the program's routed experts as ``fault`` names: their output
    projections zeroed, the gate's correction bias dropped, or the
    weights left unscaled (``routed_scaling_factor`` 1)."""
    from repro_torch.models import convert
    from repro_torch.models import moe as MOE

    if fault == "scaling_factor_1":
        sigmoid_router = MOE._sigmoid_router

        def unscaled(p, cfg, logits):
            probs, w, e = sigmoid_router(p, cfg, logits)
            return probs, w / cfg.routed_scaling_factor, e
        monkeypatch.setattr(MOE, "_sigmoid_router", unscaled)
        return
    to_serving = convert.to_serving

    def broken(model):
        model = to_serving(model)
        for block in model.layers:
            if hasattr(block, "moe"):
                t = block.moe.wo if fault == "experts_zeroed" \
                    else block.moe.router.bias
                t.data.zero_()
        return model
    monkeypatch.setattr(convert, "to_serving", broken)


@pytest.mark.parametrize("fault, number, least", [
    ("experts_zeroed", "routed_rel_l2", 0.99),
    ("scaling_factor_1", "routed_rel_l2", 0.59),
    ("gate_bias_dropped", "routed_choices_off", 5)])
def test_a_routing_fault_reads_incorrect(tmp_path, monkeypatch, fault,
                                         number, least):
    """The routed layers' check sees each of these faults of the program's
    routed experts (``traffic/prefill_batches_routed.py``), whatever the
    logits' check reads of it: nothing added reads 1, weights 1 / 2.5 of
    what they should be 0.6, and the bias dropped changes the choice of
    tokens away from ties."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    layout = add_tiny_deepseek(tmp_path, bench_dir)
    _fault(monkeypatch, fault)
    r = run_cell(layout, CELL, 2**31 + 57, 0.3, False,
                 t_start=time.perf_counter(), need_card=False, device="cpu")
    assert not r["correct"]
    assert r["checks"][number]["value"] >= least, r["checks"]


def test_a_choice_at_a_near_tie_is_not_counted(tmp_path):
    """The routed check compares choices away from near ties only: a token
    whose gate scores all tie (a zero input, no correction bias) may take
    any experts; one away from ties that takes another expert counts."""
    import torch

    from portbench import weights as W
    from portbench.traffic import prefill_batches_routed as K

    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    layout = add_tiny_deepseek(tmp_path, bench_dir)
    cfg = layout.config("tiny-deepseek")
    g = A.geometry(cfg)
    i = g.n_dense_layers
    weights = {f"layers.{i}.{k}": v for k, v in
               W.draw_layer(A, g, 5, i, torch.device("cpu")).items()}
    weights[f"layers.{i}.mlp.gate.e_score_correction_bias"].zero_()
    ref = A.Reference(g, weights)
    h = torch.randn(32, g.d_model,
                    generator=torch.Generator().manual_seed(3))
    h[0] = 0.0
    _, own, near = ref.routed(i, h, torch.zeros(32, g.top_k,
                                                 dtype=torch.long))
    assert near[0] and not near[1:].all()
    other = own.clone()
    far = int((~near).nonzero()[0])
    other[0] = (own[0] + 1) % g.router_outputs
    assert K._off(other, own, near) == 0
    other[far, -1] = next(e for e in range(g.router_outputs)
                          if e not in own[far].tolist())
    assert K._off(other, own, near) == 1


G = A.geometry(json.loads((HERE / "configs" / f"{REAL}.json").read_text()))


def test_counts_at_the_published_widths():
    """One 16,384-token call through the 31 layers: K5 at 192/128 is
    2 H S (S + 1) / 2 (192 + 128) = 11.0 TFLOP a layer, 11.1 ms at 989
    TFLOP/s; the call ~620 TFLOP (37.9 GFLOP a token with the held
    experts' expected 0.25 pairs a token and layer), of which latent
    attention (projections and K5) is 85 % and K5 55 %; the weights 38.2 GB
    read (40.1 GB held with the embedding table)."""
    S, H = 16384, 128
    k5 = A.flash_attention(G, 1, S)
    assert k5["flops"] == 2 * H * S * (S + 1) / 2 * (192 + 128)
    assert k5["bytes"] == 2 * S * H * (192 * 2 + 128 * 2)
    assert k5["bound_s"] == pytest.approx(11.118e-3, rel=1e-3)
    assert A.kernel_bounds(G, "prefill", 1, S)["flash_attention"] == \
        pytest.approx(31 * k5["bound_s"])
    assert A.kernel_bounds(G, "decode", 1, S) == {}
    assert A.mla_params(G) == 187_105_280
    kept = 0.25 * S * 28
    call = A.prefill_call(G, 1, S, kept)
    assert call["flops"] / S == pytest.approx(37.87e9, rel=1e-3)
    mla = 2.0 * S * 31 * A.mla_params(G) + 31 * k5["flops"]
    assert mla / call["flops"] == pytest.approx(0.855, abs=0.005)
    assert 31 * k5["flops"] / call["flops"] == pytest.approx(0.55, abs=0.01)
    assert A.weight_bytes(G) / 1e9 == pytest.approx(38.24, abs=0.01)
    held = A.weight_bytes(G) + 2 * G.padded_vocab * G.d_model
    assert held / 1e9 == pytest.approx(40.09, abs=0.01)
    assert A.expected_launches(G, "prefill", 3) == {"flash_attention": 93,
                                                    "moe_combine": 84}
    assert A.expected_launches(G, "decode", 3) == {"decode_attention": 0}


def test_the_leaves_and_the_program_names():
    """Every leaf of the plan has a program name; the dense layers draw the
    MLP, the others the gate, its bias, the held experts and the shared
    expert."""
    dense = {n for n, *_ in A.layer_leaves(G, 0)}
    moe = {n for n, *_ in A.layer_leaves(G, 3)}
    assert "mlp.gate_proj" in dense and "mlp.gate.weight" not in dense
    assert {"mlp.gate.weight", "mlp.gate.e_score_correction_bias",
            "mlp.experts.gate_proj",
            "mlp.shared_experts.down_proj"} <= moe
    assert dense | moe <= set(A.LAYER_NAMES)
    shapes = {n: s for n, s, *_ in A.layer_leaves(G, 3)}
    assert shapes["mlp.experts.up_proj"] == (8, 7168, 2048)
    assert shapes["self_attn.kv_b_proj.w"] == (512, 128 * 256)


@pytest.mark.card
def test_tiny_deepseek_on_the_card(card, tmp_path):
    """The tiny cell through the kernels, in the real configuration's bf16
    (K5's 192/128 pair runs in bf16 alone): the instance launches once a
    layer a call.  Its numbers are not judged: the tiny limits are f32's,
    and at 64 widths bf16 flips gate ties (the module note)."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    layout = add_tiny_deepseek(tmp_path, bench_dir)
    cfg_path = bench_dir / "configs" / "tiny-deepseek.json"
    c = json.loads(cfg_path.read_text())
    c["dtype"] = json.loads((HERE / "configs" / f"{REAL}.json").read_text()
                            )["dtype"]
    cfg_path.write_text(json.dumps(c))
    r = run_cell(layout, CELL, 61, 0.5, False, t_start=time.perf_counter(),
                 device="cuda")
    assert r["checks"]["k5_launches_off"]["value"] == 0
    assert r["_checked"]["kept_pairs_per_call"] > 0
