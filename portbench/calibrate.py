#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds S] [--out FILE]

Run from the root of a checkout, on the card.  For each seed it makes one
whole run of the cell (set-up, a window of ``--seconds``, the check) and
prints the compared numbers of the program; on each control seed it also
computes the control's: the reference in fp8 put in the program's place,
on the same prompts and served tokens.  The last line is the summary: the
largest reading of each number over the seeds (the lower reading) and the
smallest of the control's (the upper reading).  The control is judged by
the harness's own verdict against the cell's limits; the command exits 1
where the control reads correct on any seed.  The benchmark's own runs
never compute the control.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path.cwd()
BENCH = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    # the script's own directory off the path: its modules are
    # imported as ``portbench.*``, and ``trace`` would shadow the
    # standard library's
    sys.path[:] = [str(BENCH.parent), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != BENCH]
    from portbench.harness import Layout, run_cell

    layout = Layout(ROOT, BENCH)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows, lower, upper = [], {}, {}
    t0 = T_START
    for seed in seeds:
        r = run_cell(layout, args.workload, seed, args.seconds, False,
                     t_start=t0, control=seed in controls)
        checked = r.pop("_checked")
        r.pop("_windows")
        row = {"seed": seed, "correct": r["correct"],
               "numbers": checked["numbers"],
               "control": checked.get("control"),
               "control_correct": r.get("control_correct"),
               "rows": checked.get("rows"),
               "control_rows": checked.get("control_rows"),
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "peak": r["device"]["memory_peak_bytes"],
               "check_s": time.perf_counter() - t0}
        for k, v in row["numbers"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in (row["control"] or {}).items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps(row), flush=True)
        rows.append(row)
        t0 = time.perf_counter()
    passed = [r["seed"] for r in rows if r["control_correct"]]
    summary = {"workload": args.workload, "seeds": seeds,
               "control_seeds": sorted(controls), "lower": lower,
               "upper": upper, "control_correct_on": passed}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"summary": summary, "runs": rows}) + "\n")
    print(json.dumps(summary), flush=True)
    if passed:
        print(f"the control reads correct on seeds {passed}: the limits "
              "do not separate it from the program", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
