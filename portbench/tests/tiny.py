"""A copy of the benchmark's layout at a tiny size, for the CPU tests.

The configurations keep the real files' keys and architecture with every
size cut (widths too: these run only here, never as a cell); the cells
keep the real traffic kinds and metrics.  ``LIMITS`` were set from CPU
readings of sound runs and of the fp8 control, as the real cells' limits
were from chip readings.
"""
from __future__ import annotations

import json
import pathlib
import shutil

from portbench.harness import HERE, Layout

DENSE = "tiny-dense"
MOE = "tiny-moe"


def _config(real: str, **sizes) -> dict:
    c = json.loads((HERE / "configs" / f"{real}.json").read_text())
    c.update(sizes)
    return c


def configs() -> dict[str, dict]:
    dense = _config("qwen2-7b", name=DENSE, hidden_size=64,
                    intermediate_size=128, num_attention_heads=4,
                    num_key_value_heads=2, num_hidden_layers=2,
                    vocab_size=512)
    dense["architecture"] = dict(dense["architecture"], head_dim=16)
    dense["assumed"] = dict(dense["assumed"], padded_vocab=512)
    moe = _config("qwen3-moe-235b-a22b.ep16", name=MOE, hidden_size=64,
                  moe_intermediate_size=32, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
                  num_experts=4, vocab_size=500)
    moe["expert_share"] = dict(moe["expert_share"], held=[0, 4],
                               router_outputs=16)
    moe["num_experts_per_tok"] = 4
    moe["assumed"] = dict(moe["assumed"], padded_vocab=512)
    return {DENSE: dense, MOE: moe}


#: Limits of the tiny cells, set from CPU readings of ten seeds with
#: windows of 0.4 s (four of them with the control): sound runs read at most
#: 0.001 / 0.024 / 0.0095 (decode: served-token gap, last logits, written
#: K/V rows) and 0.018 / 0.033 (prefill: logits, top-16 rank gap); the fp8
#: control at least 0.091 / 0.13 (decode logits, K/V) and 0.16 / 0.37.
#: At these sizes the control often serves the same tokens (gap 0).
LIMITS = {
    "decode": {"token_gap": 0.05, "logits_rel_l2": 0.05,
               "kv_rows_rel_l2": 0.04, "k4_launches_off": 0},
    "prefill": {"logits_rel_l2": 0.05, "top_gap": 0.12,
                "k5_launches_off": 0},
}

#: The tiny cells.  No MoE cell: at 64 widths a near tie in the router
#: flips under bf16 rounding in most runs, and with 32 tokens of
#: attention the flipped token moves the last position's logits as far as
#: the fp8 control does (up to 0.30 against the control's 0.15 on the
#: CPU).  The MoE path is held to the reference in f32 instead
#: (``test_portbench_reference.py``), where nothing rounds to a flip.
WORKLOADS = {
    f"{DENSE}.decode": dict(
        config=DENSE, kind="decode_closed_loop", limits=LIMITS["decode"],
        traffic={"batch": 4, "prompt": 40, "max_len": 64, "new_tokens": 8,
                 "pool_batches": 4, "warmup_steps": 2, "check_rows": 2}),
    f"{DENSE}.prefill-mixed": dict(
        config=DENSE, kind="prefill_batches", limits=LIMITS["prefill"],
        traffic={"tokens_per_call": 64, "shapes": [[4, 16], [2, 32], [1, 64]],
                 "pool_calls": 8, "warmup_calls": 1,
                 "check_calls_per_shape": 1}),
}


def layout(tmp: pathlib.Path, source: Layout | None = None) -> Layout:
    """The tiny layout under ``tmp``: ``BENCHMARK.json`` and a copy of the
    families, kinds and metrics of ``source`` (the benchmark's own layout
    by default), with the tiny files.  Each tiny cell reports the metrics
    that ``source``'s cells of its traffic kind report."""
    source = source or Layout(HERE.parent)
    bench = tmp / "portbench"
    for sub in ("archs", "traffic", "metrics"):
        shutil.copytree(source.dir / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs").mkdir()
    (bench / "workloads").mkdir()
    for name, c in configs().items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(c))
    real = source.bench
    kind_of = {w["name"]: source.workload(w["name"])["kind"]
               for w in real["workloads"]}
    cells = []
    for name, w in WORKLOADS.items():
        w = dict(w, name=name, why="tiny")
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(w))
        cells.append({"name": name, "config": w["config"],
                      "traffic": name[len(w["config"]) + 1:], "chips": 1,
                      "why": "tiny"})

    def retarget(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                want = {kind_of[w] for w in m["workloads"]}
                m["workloads"] = [c["name"] for c in cells
                                  if WORKLOADS[c["name"]]["kind"] in want]
            out.append(m)
        return out
    bench_json = dict(real, configs=[], workloads=cells,
                      end_to_end=retarget(real["end_to_end"]),
                      per_layer=retarget(real["per_layer"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return Layout(tmp, bench)


WINDOW = "tiny-window"
#: The tiny ``window`` family's cells (``window_family.py``): sliding-
#: window layers (window 16) among full ones, sequences longer than the
#: window.  Limits from CPU readings of 12 seeds with windows of 0.4 /
#: 0.3 s (four with the control): sound runs read at most 0.031 / 0.021 /
#: 0.012 (decode: served-token gap, last logits, written K/V rows) and
#: 0.023 / 0.050 (prefill: logits, top-16 rank gap); the fp8 control at
#: least 0.16 / 0.106 / 0.14 and 0.155 / 0.27.
WINDOW_CELLS = {
    f"{WINDOW}.decode": dict(
        kind="decode_closed_loop",
        limits={"token_gap": 0.08, "logits_rel_l2": 0.05,
                "kv_rows_rel_l2": 0.04, "k4_launches_off": 0},
        traffic={"batch": 4, "prompt": 40, "max_len": 64, "new_tokens": 8,
                 "pool_batches": 4, "warmup_steps": 2, "check_rows": 2}),
    f"{WINDOW}.prefill": dict(
        kind="prefill_batches",
        limits={"logits_rel_l2": 0.06, "top_gap": 0.12,
                "k5_launches_off": 0},
        traffic={"tokens_per_call": 64, "shapes": [[2, 32], [1, 64]],
                 "pool_calls": 8, "warmup_calls": 1,
                 "check_calls_per_shape": 1}),
}


def add_window_family(tmp: pathlib.Path, bench_dir: pathlib.Path) -> Layout:
    """A copy of the benchmark at ``bench_dir`` (under ``tmp``) with the
    tiny ``window`` family added as a family is: ``archs/window.py``, a
    configuration naming it (the tiny dense one, three layers, pattern
    local, local, attn), a workload file a cell, and ``tmp``'s
    ``BENCHMARK.json``: the benchmark's, with the cells added to it and
    to the metrics their kind's cells report."""
    source = Layout(HERE.parent)
    shutil.copy(HERE / "tests" / "window_family.py",
                bench_dir / "archs" / "window.py")
    cfg = dict(configs()[DENSE], name=WINDOW, num_hidden_layers=3)
    cfg["architecture"] = dict(cfg["architecture"], family="window",
                               pattern=["local", "local", "attn"], window=16)
    (bench_dir / "configs" / f"{WINDOW}.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(source.bench))
    for name, w in WINDOW_CELLS.items():
        w = dict(w, name=name, config=WINDOW, why="tiny")
        (bench_dir / "workloads" / f"{name}.json").write_text(json.dumps(w))
        bench["workloads"].append({"name": name, "config": WINDOW,
                                   "traffic": name.split(".", 1)[1],
                                   "chips": 1, "why": "tiny"})
        same = {c["name"] for c in source.bench["workloads"]
                if source.workload(c["name"])["kind"] == w["kind"]}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if same & set(m.get("workloads", [])):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(tmp, bench_dir)
