"""Traffic kind ``prefill_batches``: prefill calls back to back.

Parameters (the cell's ``traffic``): ``tokens_per_call``; ``shapes``, the
(batch, length) pairs a call takes, each of ``tokens_per_call`` tokens;
the calls take them in a seeded permutation, repeated, so every window
holds the same mix; ``pool_calls`` distinct prompt batches drawn from the
seed (call i takes batch i modulo the pool); ``warmup_calls`` a shape in
set-up; ``check_calls_per_shape`` calls of each shape, drawn from the seed
among those the window issued, that the reference judges.

The window issues the family's ``make_prefill_step`` calls until
``seconds`` have passed on the host's clock, then waits for the card:
every issued call counts, and so does the time the queued ones take.  A
call's output is its last-position logits, kept on the card until the
window closes.  The model, its weights, reference and counts are the
family's (``cell.arch``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import weights as W
from portbench.reference import exact_matmuls


def _shapes(cell) -> list[tuple[int, int]]:
    p = cell.traffic
    shapes = [tuple(s) for s in p["shapes"]]
    for b, s in shapes:
        if b * s != p["tokens_per_call"]:
            raise ValueError(f"{cell.name}: shape {b} x {s} is not "
                             f"{p['tokens_per_call']} tokens")
    return shapes


def setup(cell) -> dict:
    arch, g, p, dev = cell.arch, cell.geometry, cell.traffic, cell.device
    cfg = arch.model_config(g)
    model = arch.load_model(g, cfg, W.draw_weights(arch, g, cell.seed, dev),
                            dev)
    cell.mark("weights")
    shapes = _shapes(cell)
    rng = np.random.default_rng(W.seed_of(cell.seed, "order"))
    order = [int(i) for i in rng.permutation(len(shapes))]
    pool = W.token_pool(cell.seed, "prompts", p["pool_calls"],
                        p["tokens_per_call"], g.vocab, dev)
    step = arch.make_prefill_step(cfg)
    for b, s in shapes:
        for _ in range(p["warmup_calls"]):
            step(model, {"tokens": pool[0].view(b, s)})
    cell.mark("warm-up")
    return {"cfg": cfg, "model": model, "step": step, "pool": pool,
            "order": [shapes[i] for i in order]}


def window(cell, st: dict, seconds: float, spans) -> dict:
    pool, order, step, model = st["pool"], st["order"], st["step"], st["model"]
    n_pool = pool.shape[0]
    outs, shapes = [], []
    t_first = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if t0 - t_first >= seconds:
            break
        i = len(outs)
        b, s = order[i % len(order)]
        outs.append(step(model, {"tokens": pool[i % n_pool].view(b, s)}))
        shapes.append((b, s))
        spans.add("issue a prefill call", t0, time.perf_counter())
    t0 = time.perf_counter()
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    t_last = time.perf_counter()
    spans.add("wait for the queued calls", t0, t_last)
    return {"calls": len(outs), "shapes": shapes, "outs": outs,
            "tokens": sum(b * s for b, s in shapes), "t_first": t_first,
            "t_last": t_last, "seconds": t_last - t_first,
            "attempted": len(outs)}


def judged(cell, st: dict, rec: dict) -> dict:
    """The calls the reference judges, drawn from the seed (every shape's
    share), with their outputs and prompts."""
    rng = np.random.default_rng(W.seed_of(cell.seed, "check"))
    picks = []
    for shape in sorted(set(rec["shapes"])):
        mine = [i for i, s in enumerate(rec["shapes"]) if s == shape]
        n = min(cell.traffic["check_calls_per_shape"], len(mine))
        picks += sorted(int(i) for i in rng.choice(mine, n, replace=False))
    n_pool = st["pool"].shape[0]
    return {"calls": [{"index": i, "shape": rec["shapes"][i],
                       "logits": rec["outs"][i][:, 0].clone(),
                       "tokens": st["pool"][i % n_pool].view(
                           *rec["shapes"][i]).clone()} for i in picks]}


#: Ranks of the output distribution whose order ``top_gap`` compares.
TOP_RANKS = 16


def _rows(want: torch.Tensor, got: torch.Tensor) -> tuple[list, list]:
    """Each row's relative L2 distance of ``got`` from ``want``, and its
    widest rank gap: over the first ``TOP_RANKS`` ranks of ``got``'s
    order, by how much the reference's logit of ``got``'s i-th token lies
    below the reference's own i-th largest (rank 0: the served first
    token's gap below the reference's best)."""
    rel = (torch.linalg.vector_norm(got - want, dim=-1)
           / torch.linalg.vector_norm(want, dim=-1))
    order = got.topk(TOP_RANKS, dim=-1).indices
    gap = want.topk(TOP_RANKS, dim=-1).values - want.gather(-1, order)
    return rel.tolist(), gap.max(-1).values.tolist()


def check(cell, out: dict, rec: dict, launched: dict) -> dict:
    """The numbers ``correct`` compares (each the worst over the judged
    rows), the control's where ``cell.control``, and what the counts of
    the metrics need (the reference's kept expert pairs a call)."""
    arch, g, dev = cell.arch, cell.geometry, cell.device
    exact_matmuls()
    weights = W.draw_weights(arch, g, cell.seed, dev)
    ref = arch.Reference(g, weights)
    ctl = arch.Reference(g, weights, fp8=True) if cell.control else None
    rels, gaps, c_rels, c_gaps, kept, margins = [], [], [], [], [], []
    for call in out["calls"]:
        ref.margins = [] if g.is_moe else None
        want, n_kept = ref.prefill_last(call["tokens"])
        kept.append(n_kept)
        if ref.margins:
            margins += torch.stack(ref.margins).min(0).values.tolist()
        r, gp = _rows(want, call["logits"][:, :g.vocab].float())
        rels += r
        gaps += gp
        if ctl is not None:
            c, _ = ctl.prefill_last(call["tokens"])
            r, gp = _rows(want, c)
            c_rels += r
            c_gaps += gp
    numbers = {"logits_rel_l2": max(rels), "top_gap": max(gaps)}
    numbers.update(cell.launches_off("prefill", rec["calls"], launched))
    result = {"numbers": numbers,
              "rows": {"logits_rel_l2": rels, "top_gap": gaps,
                       "held_router_margin": margins},
              "kept_pairs_per_call": sum(kept) / len(kept)}
    if ctl is not None:
        result["control"] = {"logits_rel_l2": max(c_rels),
                             "top_gap": max(c_gaps)}
        result["control_rows"] = {"logits_rel_l2": c_rels,
                                  "top_gap": c_gaps}
    return result


def counts(cell, rec: dict, checked: dict) -> dict:
    """The window's work by the family's counts: every call's bound, and
    each kernel's over its launches."""
    arch, g = cell.arch, cell.geometry
    kept = checked.get("kept_pairs_per_call", 0.0)
    step = sum(arch.prefill_call(g, b, s, kept)["bound_s"]
               for b, s in rec["shapes"])
    return {"step_bound_s": step,
            "kernel_bound_s": cell.kernel_bounds("prefill", rec["shapes"]),
            "tokens": rec["tokens"], "calls": rec["calls"]}
