"""Traffic kind ``decode_closed_loop``: one batch of sequences decoding
greedily, each step's tokens read back to the host and fed in again.

Parameters (the cell's ``traffic``): ``batch`` sequences; ``prompt``
cached positions a sequence starts from, drawn from the seed N(0, 1) for
every layer's K and V (not built by a prefill); ``max_len`` the cache's
rows; ``new_tokens`` a batch generates before a new batch starts at
``prompt`` again, with new first tokens (``pool_batches`` of them drawn);
``warmup_steps`` in set-up; ``check_rows`` sequences of the first batch
that the reference judges, one drawn from the seed in each of as many
runs of consecutive rows.

A step is timed from its issue until its tokens are on the host.  The
host thread feeds them back through a pinned buffer and moves the
position on the card: the client's whole loop.  The reference judges
the first batch: every token the window served to the judged rows, the
cache rows the steps wrote for them, and the logits of its last step.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts as C
from portbench import port
from portbench import weights as W
from portbench.reference.model import Reference, exact_matmuls


def setup(cell) -> dict:
    g, p, dev = cell.geometry, cell.traffic, cell.device
    B, P = p["batch"], p["prompt"]
    if P + p["new_tokens"] > p["max_len"]:
        raise ValueError(f"{cell.name}: {P} + {p['new_tokens']} positions "
                         f"do not fit {p['max_len']}")
    cfg = port.model_config(g)
    model = port.load_model(g, cfg, W.draw_weights(g, cell.seed, dev), dev)
    cell.mark("weights")
    caches = port.init_caches(cfg, B, p["max_len"], dev)
    for i, cache in enumerate(caches):
        W.fill_cache(cache["k"], cell.seed, i, "k")
        W.fill_cache(cache["v"], cell.seed, i, "v")
    cell.mark("caches")
    firsts = W.token_pool(cell.seed, "first", p["pool_batches"], B, g.vocab,
                          dev)
    # one judged row from each of ``check_rows`` runs of consecutive
    # rows, so that every part of the batch is judged
    rng = np.random.default_rng(W.seed_of(cell.seed, "check"))
    rows = [int(rng.choice(part))
            for part in np.array_split(np.arange(B), p["check_rows"])]
    pinned = dev.type == "cuda"
    st = {"cfg": cfg, "model": model, "caches": caches, "firsts": firsts,
          "rows": rows, "step": port.decode_step(cfg),
          "host": torch.empty((B, 1), dtype=torch.int32, pin_memory=pinned),
          "tok": torch.empty((B, 1), dtype=torch.int32, device=dev),
          "index": torch.empty(1, dtype=torch.int64, device=dev)}
    # the warm-up writes rows that the first step of the window rewrites
    # before any step reads them
    st["index"].fill_(P)
    st["tok"].copy_(firsts[-1].view(B, 1))
    for _ in range(p["warmup_steps"]):
        nxt, logits, _ = st["step"](model, st["tok"], caches, st["index"])
        st["host"].copy_(nxt)
        st["tok"].copy_(st["host"], non_blocking=True)
        st["index"].add_(1)
    # what the window does once, when the first batch ends
    logits[rows].clone()
    _written(st, P, 1)
    cell.mark("warm-up")
    return st


def _written(st: dict, start: int, n: int) -> list:
    """The judged rows' cache rows ``start``..``start+n-1``, every layer."""
    rows = torch.tensor(st["rows"], device=st["index"].device)
    return [(c["k"][rows, start:start + n].clone(),
             c["v"][rows, start:start + n].clone()) for c in st["caches"]]


def window(cell, st: dict, seconds: float, spans) -> dict:
    p = cell.traffic
    B, P, N = p["batch"], p["prompt"], p["new_tokens"]
    step, model, caches = st["step"], st["model"], st["caches"]
    host, tok, index, firsts = st["host"], st["tok"], st["index"], st["firsts"]
    host_np = host.numpy()
    served, step_s, first_batch = [], [], None
    batch, j = 0, 0
    index.fill_(P)
    tok.copy_(firsts[0].view(B, 1))
    t_first = time.perf_counter()
    cpu0 = time.thread_time()
    while True:
        t0 = time.perf_counter()
        nxt, logits, _ = step(model, tok, caches, index)
        t1 = time.perf_counter()
        host.copy_(nxt)
        t2 = time.perf_counter()
        if batch == 0:
            served.append(host_np[:, 0].copy())
            last = logits
        step_s.append(t2 - t0)
        j += 1
        done = t2 - t_first >= seconds
        if batch == 0 and (j == N or done):
            first_batch = {"logits": last[st["rows"]].clone(),
                           "kv": _written(st, P, j), "steps": j}
        if done:
            spans.add("issue a decode step", t0, t1)
            spans.add("wait for the step's tokens", t1, t2)
            break
        if j == N:
            batch, j = batch + 1, 0
            index.fill_(P)
            tok.copy_(firsts[batch % firsts.shape[0]].view(B, 1))
        else:
            tok.copy_(host, non_blocking=True)
            index.add_(1)
        t3 = time.perf_counter()
        spans.add("issue a decode step", t0, t1)
        spans.add("wait for the step's tokens", t1, t2)
        spans.add("feed the tokens back", t2, t3)
    cpu = time.thread_time() - cpu0
    steps = len(step_s)
    return {"steps": steps, "step_s": step_s, "tokens": steps * B,
            "t_first": t_first, "t_last": t2, "seconds": t2 - t_first,
            "host_cpu_s": cpu, "batches": batch + 1,
            "served": np.stack(served), "first_batch": first_batch,
            "attempted": (batch + 1) * B}


def judged(cell, st: dict, rec: dict) -> dict:
    fb = rec["first_batch"]
    served = rec["served"][:, st["rows"]].T          # (rows, n)
    firsts = st["firsts"][0][st["rows"]].cpu().numpy()
    return {"rows": st["rows"], "served": served, "firsts": firsts,
            "logits": fb["logits"], "kv": fb["kv"], "steps": fb["steps"],
            "cache_shape": tuple(st["caches"][0]["k"].shape),
            "cache_dtype": st["caches"][0]["k"].dtype}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def _numbers(g, want_logits, want_kv, served, got_logits, got_kv) -> dict:
    """The compared numbers of one side against the f32 reference: the
    widest gap of a served token below the reference's best, the last
    step's logits and the written cache rows, relative L2."""
    best = want_logits.max(-1).values
    pick = want_logits.gather(-1, served[..., None])[..., 0]
    kv = max(max(_rel(gk, wk), _rel(gv, wv))
             for (gk, gv), (wk, wv) in zip(got_kv, want_kv))
    return {"token_gap": float((best - pick).max()),
            "logits_rel_l2": max(_rel(a, b) for a, b in
                                 zip(got_logits, want_logits[:, -1])),
            "kv_rows_rel_l2": kv}


def check(cell, out: dict, rec: dict, launched: dict) -> dict:
    g, p, dev = cell.geometry, cell.traffic, cell.device
    P, n = p["prompt"], out["steps"]
    exact_matmuls()
    weights = W.draw_weights(g, cell.seed, dev)
    served = torch.as_tensor(out["served"][:, :n], device=dev).long()
    inputs = torch.cat([torch.as_tensor(out["firsts"], device=dev)
                        .long()[:, None], served[:, :-1]], 1)
    rows = torch.tensor(out["rows"], device=dev)

    def prefix_of(i):
        return tuple(W.cache_tensor(out["cache_shape"], out["cache_dtype"],
                                    dev, cell.seed, i, w)[rows, :P]
                     for w in ("k", "v"))

    logits, kv = Reference(g, weights).decode_chunk(inputs, P, prefix_of)
    numbers = _numbers(g, logits, kv, served,
                       out["logits"][:, :g.vocab], out["kv"])
    want_launches = rec["steps"] * g.n_layers if dev.type == "cuda" else 0
    numbers["k4_launches_off"] = abs(launched["decode_attention"]
                                     - want_launches)
    result = {"numbers": numbers}
    if cell.control:
        c_logits, c_kv = Reference(g, weights, fp8=True).decode_chunk(
            inputs, P, prefix_of)
        result["control"] = _numbers(g, logits, kv,
                                     c_logits.argmax(-1), c_logits[:, -1],
                                     c_kv)
    return result


def counts(cell, rec: dict, checked: dict) -> dict:
    """Every step's bound and K4's over its launches, at the positions the
    window decoded (each batch from ``prompt`` on)."""
    g, p = cell.geometry, cell.traffic
    B, P, N = p["batch"], p["prompt"], p["new_tokens"]
    index = [P + j % N for j in range(rec["steps"])]
    return {"step_bound_s": sum(C.decode_step(g, B, i)["bound_s"]
                                for i in index),
            "kernel_bound_s": {"decode_attention": g.n_layers * sum(
                C.decode_attention(g, B, i + 1)["bound_s"] for i in index)},
            "tokens": rec["tokens"], "steps": rec["steps"]}
