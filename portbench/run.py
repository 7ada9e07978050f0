#!/usr/bin/env python3
"""The benchmark's command: one run of one cell on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  It builds the program's kernels where
they are missing (into ``build/`` inside the checkout), draws the weights,
inputs and caches from the seed on the card, warms up the cell's shapes
(``setup_s``), drives the cell's traffic for ``--seconds`` (traced by
``torch.profiler`` with ``--trace 1``, after an untraced first half whose
host-clock readings the per-layer metrics take), then judges what the timed path
produced against the plain f32 reference.  It prints the compared numbers
beside their limits as the last lines of standard error, and the result
as one JSON object, the last line of standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``.  Without a CUDA card, with fewer cards than the cell asks
for, or where the program or ``BENCHMARK.json`` is missing, it exits
non-zero and prints no result; so it does where a run has loaded JAX or
the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path.cwd()
BENCH = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of compiled code stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    # the script's own directory off the path: its modules are
    # imported as ``portbench.*``, and ``trace`` would shadow the
    # standard library's
    sys.path[:] = [str(BENCH.parent), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != BENCH]
    from portbench.harness import Layout, loaded_forbidden, run_cell

    result = run_cell(Layout(ROOT, BENCH), args.workload, args.seed,
                      args.seconds, bool(args.trace), t_start=T_START)
    result.pop("_checked")
    found = loaded_forbidden()
    if found:
        print(f"a run loaded {', '.join(found)}: the program and the "
              "harness must not import JAX or the JAX package",
              file=sys.stderr)
        return 1
    print("set-up, s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    result["setup_stages_s"].items()),
          file=sys.stderr)
    for label, w in result.pop("_windows").items():
        if "step_s" in w:
            print(steps_line(label, w), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def steps_line(label: str, w: dict) -> str:
    """A decode window's step times by tenth, and its host CPU a step."""
    tenth = max(1, len(w["step_s"]) // 10)
    means = [1e3 * sum(w["step_s"][i:i + tenth]) / tenth
             for i in range(0, tenth * 10, tenth)]
    return (f"{label} window, step ms by tenth: "
            + ", ".join(f"{m:.2f}" for m in means)
            + f"; host CPU ms a step {1e3 * w['host_cpu_s'] / w['steps']:.2f}")


if __name__ == "__main__":
    sys.exit(main())
