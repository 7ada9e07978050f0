#!/usr/bin/env python3
"""The served decode step of two or more checkouts, on one H100:
``python3 tools/decode_step_timing.py [--steps N] [--profile N] ROOT
[ROOT ...]``.

Each ROOT is a checkout (``git archive`` of a commit unpacked into a
gitignored directory, or ``.`` for this tree).  In the order given, one
process per ROOT builds that checkout's decode attention kernel (K4) and
times qwen2-7b's decode step as it serves it (``make_decode_step``, seed-0
weights cast once, full depth and width, B 8 over 4,096 rows), step by
step with a sync around each, ``--steps`` steps (default 200) after a
warm-up, each process pinned to one host core.  The step is host-bound
(~1,000 launches), so this is where a change to the model code's Python
shows.  The steps are read on the wall clock (each around the step and
its sync) and on the thread's CPU clock (the timed loop in all, over
the steps: the host's work, without the time the core was taken away;
that clock ticks in 10 ms on the H100 machine, so it is read over the
whole loop, not a step).  Give a ROOT twice, as in ``parent change change parent``, so that a
drift of the card's clock shows.

``--profile N`` also runs N steps under ``cProfile`` and reports, a step,
the Python function calls in all and in ``repro_torch``'s own functions
(deterministic counts) and each ``repro_torch`` function's calls and
profiled own time; with two or more ROOTs it then prints the functions
whose calls a step differ between the first ROOT and each other ROOT.
Prints one JSON line a run, then the card's name and power limit.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 8, 4096


def profile(step, args, n: int, root: pathlib.Path) -> dict:
    """Calls a step of every function, ``repro_torch``'s own by name with
    their profiled own time (ms a step), over ``n`` steps."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        step(*args)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    src = str(root / "src" / "repro_torch")
    own = {}
    for (file, line, name), (_, calls, tt, _, _) in stats.items():
        if file.startswith(src):
            key = f"{file[len(src) + 1:]}:{name}"
            c, t = own.get(key, (0.0, 0.0))
            own[key] = (c + calls / n, t + tt * 1e3 / n)
    return {"profile_steps": n,
            "calls_a_step": sum(v[1] for v in stats.values()) / n,
            "own_calls_a_step": sum(c for c, _ in own.values()),
            "own_ms_a_step": sum(t for _, t in own.values()),
            "own": {k: {"calls": c, "ms": t}
                    for k, (c, t) in sorted(own.items())}}


def child(root: pathlib.Path, steps: int, prof_steps: int) -> int:
    sys.path.insert(0, str(root / "src"))
    import os
    import time

    # one host core for every run: the step is host-bound, and a move
    # between cores shows as run-to-run spread
    os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})

    import torch

    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as TF
    from repro_torch.models.convert import to_serving

    if pathlib.Path(compat.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported repro_torch from {compat.__file__}")
    compat.build(["decode_attention"])
    dev = torch.device("cuda")
    cfg = get_config("qwen2-7b")
    params = to_serving(TF.init_params(cfg, seed=0, device=dev))
    caches = TF.init_caches(cfg, B, S, device=dev)
    step = make_decode_step(cfg)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    idx = torch.tensor([S - 1], device=dev)
    for _ in range(5):
        step(params, tok, caches, idx)
    ms = []
    c0 = time.thread_time()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, tok, caches, idx)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cpu = (time.thread_time() - c0) * 1e3 / steps
    ms.sort()
    row = {"root": str(root), "arch": "qwen2-7b", "batch": B, "rows": S,
           "steps": steps, "median_ms": ms[steps // 2],
           "p10_ms": ms[steps // 10], "min_ms": ms[0],
           "mean_ms": sum(ms) / steps, "host_cpu_ms_a_step": cpu}
    if prof_steps:
        row |= profile(step, (params, tok, caches, idx), prof_steps, root)
    print(json.dumps(row), flush=True)
    return 0


def calls_diff(first: dict, other: dict) -> dict:
    """The ``repro_torch`` functions whose calls a step differ, with the
    other run's profiled own time."""
    a, b = first["own"], other["own"]
    out = {}
    for k in sorted(set(a) | set(b)):
        ca, cb = a.get(k, {}).get("calls", 0.0), b.get(k, {}).get("calls", 0.0)
        if ca != cb:
            out[k] = {"calls": cb - ca, "ms": b.get(k, {}).get("ms", 0.0)}
    return {"from": first["root"], "to": other["root"],
            "calls_a_step": other["calls_a_step"] - first["calls_a_step"],
            "own_calls_a_step": (other["own_calls_a_step"]
                                 - first["own_calls_a_step"]),
            "functions": out,
            "functions_ms": sum(v["ms"] for v in out.values()
                                if v["calls"] > 0)}


def main(argv: list[str]) -> int:
    steps, prof_steps = 200, 0
    while argv[:1] in (["--steps"], ["--profile"]):
        if argv[0] == "--steps":
            steps = int(argv[1])
        else:
            prof_steps = int(argv[1])
        argv = argv[2:]
    if argv[:1] == ["--child"]:
        return child(pathlib.Path(argv[1]).resolve(), steps, prof_steps)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--steps", str(steps),
                              "--profile", str(prof_steps),
                              "--child", str(pathlib.Path(root).resolve())],
                             check=False, capture_output=True, text=True)
        sys.stderr.write(out.stderr)
        print(out.stdout, end="", flush=True)
        if out.returncode:
            return out.returncode
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
    if prof_steps:
        seen = {rows[0]["root"]}
        for row in rows[1:]:
            if row["root"] not in seen:
                seen.add(row["root"])
                print(json.dumps({"calls_diff": calls_diff(rows[0], row)}),
                      flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
