"""Traffic kind ``decode_closed_loop``: one batch of sequences decoding
greedily, each step's tokens read back to the host and fed in again.

Parameters (the cell's ``traffic``): ``batch`` sequences; ``prompt``
cached positions a sequence starts from, drawn from the seed N(0, 1) for
every cache tensor of every layer (the family's ``cache_leaves``: K and V
of a GQA layer; not built by a prefill); ``max_len`` the positions a
sequence may reach (a full cache's rows; a ring holds fewer);
``new_tokens`` a batch generates before a new batch starts at
``prompt`` again, with new first tokens (``pool_batches`` of them drawn);
``warmup_steps`` in set-up; ``check_rows`` sequences of the first batch
that the reference judges, one drawn from the seed in each of as many
runs of consecutive rows.

A step is timed from its issue until its tokens are on the host.  The
host thread feeds them back through a pinned buffer and moves the
position on the card: the client's whole loop.  The reference judges
the first batch: every token the window served to the judged rows, the
cache rows the steps wrote for them (those a ring still holds), and the
logits of its last step.  The model, its weights, caches, reference and
counts are the family's (``cell.arch``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import weights as W
from portbench.reference import exact_matmuls


def setup(cell) -> dict:
    arch, g, p, dev = cell.arch, cell.geometry, cell.traffic, cell.device
    B, P = p["batch"], p["prompt"]
    if P + p["new_tokens"] > p["max_len"]:
        raise ValueError(f"{cell.name}: {P} + {p['new_tokens']} positions "
                         f"do not fit {p['max_len']}")
    cfg = arch.model_config(g)
    model = arch.load_model(g, cfg, W.draw_weights(arch, g, cell.seed, dev),
                            dev)
    cell.mark("weights")
    caches = arch.init_caches(cfg, B, p["max_len"], dev)
    # each layer's cache tensors, (name, shape, tag); position p in row
    # p % rows of a tensor (a ring where it holds fewer than max_len)
    leaves_of = [arch.cache_leaves(g, i, B, p["max_len"])
                 for i in range(g.n_layers)]
    for i, (cache, leaves) in enumerate(zip(caches, leaves_of,
                                            strict=True)):
        for name, shape, tag in leaves:
            if tuple(cache[name].shape) != shape:
                raise ValueError(f"{cell.name}: layer {i}'s {name} is "
                                 f"{tuple(cache[name].shape)}, the family "
                                 f"says {shape}")
            W.fill_cache(cache[name], cell.seed, i, tag)
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
          "rows": rows, "leaves": leaves_of,
          "step": arch.make_decode_step(cfg),
          "host": torch.empty((B, 1), dtype=torch.int32, pin_memory=pinned),
          "tok": torch.empty((B, 1), dtype=torch.int32, device=dev),
          "index": torch.empty(1, dtype=torch.int64, device=dev)}
    # the warm-up writes rows that the first step of the window rewrites
    # before any step reads them (in a ring, rows the window draws again)
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


def _draw_rings(cell, st: dict) -> None:
    """Every ring (a cache tensor of fewer than ``max_len`` rows) drawn
    again as set-up drew it: earlier steps wrote into rows that hold
    prompt positions, which a full cache never does.  None in a family
    without rings."""
    rings = [(i, cache[name], tag)
             for i, (cache, leaves) in enumerate(zip(st["caches"],
                                                     st["leaves"]))
             for name, shape, tag in leaves
             if shape[1] < cell.traffic["max_len"]]
    for i, t, tag in rings:
        W.fill_cache(t, cell.seed, i, tag)
    if rings and cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)


def _written(st: dict, start: int, n: int) -> list:
    """The judged rows' cache rows of positions ``start``..``start+n-1``
    that each cache tensor still holds (a ring of ``rows`` rows, the last
    ``rows``), every layer: a tuple a layer in ``cache_leaves`` order."""
    dev = st["index"].device
    rows = torch.tensor(st["rows"], device=dev)[:, None]
    slots = {}
    for leaves in st["leaves"]:
        for _, shape, _ in leaves:
            if shape[1] not in slots:
                held = range(max(start, start + n - shape[1]), start + n)
                slots[shape[1]] = torch.tensor([q % shape[1] for q in held],
                                               device=dev)[None, :]
    return [tuple(c[name][rows, slots[shape[1]]].clone()
                  for name, shape, _ in leaves)
            for c, leaves in zip(st["caches"], st["leaves"])]


def window(cell, st: dict, seconds: float, spans) -> dict:
    p = cell.traffic
    B, P, N = p["batch"], p["prompt"], p["new_tokens"]
    step, model, caches = st["step"], st["model"], st["caches"]
    host, tok, index, firsts = st["host"], st["tok"], st["index"], st["firsts"]
    host_np = host.numpy()
    served, step_s, first_batch = [], [], None
    batch, j = 0, 0
    _draw_rings(cell, st)
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
    dtypes = [[c[name].dtype for name, _, _ in leaves]
              for c, leaves in zip(st["caches"], st["leaves"])]
    return {"rows": st["rows"], "served": served, "firsts": firsts,
            "logits": fb["logits"], "kv": fb["kv"], "steps": fb["steps"],
            "leaves": st["leaves"], "dtypes": dtypes}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def _numbers(g, want_logits, want_kv, served, got_logits, got_kv) -> dict:
    """The compared numbers of one side against the f32 reference: the
    widest gap of a served token below the reference's best, the last
    step's logits and the written cache rows (the last ones, where a ring
    holds fewer than the steps wrote), relative L2."""
    best = want_logits.max(-1).values
    pick = want_logits.gather(-1, served[..., None])[..., 0]
    kv = max(_rel(got, want[:, want.shape[1] - got.shape[1]:])
             for gots, wants in zip(got_kv, want_kv)
             for got, want in zip(gots, wants, strict=True))
    return {"token_gap": float((best - pick).max()),
            "logits_rel_l2": max(_rel(a, b) for a, b in
                                 zip(got_logits, want_logits[:, -1])),
            "kv_rows_rel_l2": kv}


def check(cell, out: dict, rec: dict, launched: dict) -> dict:
    arch, g, p, dev = cell.arch, cell.geometry, cell.traffic, cell.device
    P, n = p["prompt"], out["steps"]
    exact_matmuls()
    weights = W.draw_weights(arch, g, cell.seed, dev)
    served = torch.as_tensor(out["served"][:, :n], device=dev).long()
    inputs = torch.cat([torch.as_tensor(out["firsts"], device=dev)
                        .long()[:, None], served[:, :-1]], 1)
    rows = torch.tensor(out["rows"], device=dev)[:, None]

    def prefix_of(i):
        """Layer ``i``'s prompt rows as drawn in set-up: the positions all
        its cache tensors hold before the first step (a ring, the last)."""
        leaves = out["leaves"][i]
        first = max(0, P - min(shape[1] for _, shape, _ in leaves))
        return first, tuple(
            W.cache_tensor(shape, dtype, dev, cell.seed, i, tag)[
                rows, torch.tensor([q % shape[1] for q in range(first, P)],
                                   device=dev)[None, :]]
            for (_, shape, tag), dtype in zip(leaves, out["dtypes"][i]))

    logits, kv = arch.Reference(g, weights).decode_chunk(inputs, P,
                                                         prefix_of)
    numbers = _numbers(g, logits, kv, served,
                       out["logits"][:, :g.vocab], out["kv"])
    numbers.update(cell.launches_off("decode", rec["steps"], launched))
    result = {"numbers": numbers}
    if cell.control:
        c_logits, c_kv = arch.Reference(g, weights, fp8=True).decode_chunk(
            inputs, P, prefix_of)
        result["control"] = _numbers(g, logits, kv,
                                     c_logits.argmax(-1), c_logits[:, -1],
                                     c_kv)
    return result


def counts(cell, rec: dict, checked: dict) -> dict:
    """Every step's bound and each kernel's over its launches, by the
    family's counts, at the positions the window decoded (each batch from
    ``prompt`` on)."""
    g, p = cell.geometry, cell.traffic
    B, P, N = p["batch"], p["prompt"], p["new_tokens"]
    index = [P + j % N for j in range(rec["steps"])]
    return {"step_bound_s": sum(cell.arch.decode_step(g, B, i)["bound_s"]
                                for i in index),
            "kernel_bound_s": cell.kernel_bounds("decode",
                                                 [(B, i) for i in index]),
            "tokens": rec["tokens"], "steps": rec["steps"]}
