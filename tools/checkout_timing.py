#!/usr/bin/env python3
"""Two or more checkouts of the repo, compared on one H100:
``python3 tools/checkout_timing.py [--cases A,B] [--sass F,G] ROOT [ROOT ...]``.

Each ROOT is a checkout (``git archive`` of a commit unpacked into a
gitignored directory, or ``.`` for this tree).  In the order given, one
process per ROOT builds that checkout's attention kernels and times
the attention cases of ``default_cases(small=False)`` (qwen2-7b) and of
``chip_smoke.head_size_cases`` (defined by this tree, run through ROOT's
``repro_torch``) whose label holds one of ``--cases`` (default all): each
held once against its plain version at the card tolerance, then timed,
kernel alone, 50 iterations.  Give a ROOT twice, as in
``parent change change parent``, so that a drift of the card's clock shows.

Then, for each checkout against the first, it compares the SASS of the
kernel functions whose name holds one of ``--sass`` (default the
``flash_wgmma`` instances at D 64/128/256 and ``decode_bulk`` at 64/128):
instruction counts and the lines that differ once the constant-bank
offsets of kernel parameters (``c[0x0][...]``) are masked, so that a
parameter added to the launch does not count as a change.
Prints one JSON line per case and run, one per compared kernel, then the
card's name and power limit.
"""
from __future__ import annotations

import difflib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention", "decode_attention")


def child(root: pathlib.Path, cases: list[str]) -> int:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch import compat

    if pathlib.Path(compat.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported repro_torch from {compat.__file__}")
    from repro_torch.core.validate import default_cases

    compat.build(list(SOURCES))
    dev = torch.device("cuda")
    card = []
    for vc in default_cases(small=False):
        if vc.name in SOURCES:
            fn, args, traffic = vc.build(dev)
            card.append(cs._case(
                vc.name, f"{vc.name}_{cs._shapes(args)}",
                lambda fn=fn, a=args: fn(*a), lambda p=vc.plain, a=args: p(*a),
                cs.CARD_TOL[vc.name], traffic, args=args, ref=vc.plain))
    card += cs.head_size_cases(dev)
    for c in card:
        if any(s in c["label"] for s in cases):
            err, _, ok = cs.compare(c["run"](), c["plain"](), c["tol"],
                                    cs.spread(c))
            print(json.dumps({"root": str(root), "case": c["label"],
                              "ms": cs.time_ms(c["run"], dev, iters=50,
                                               warmup=5),
                              "max_abs_err": err, "within_card_tol": ok}),
                  flush=True)
    print(json.dumps({"root": str(root), "libs": {
        s: str(compat.library_path(s)) for s in SOURCES}}), flush=True)
    return 0


def sass(lib: str, fragments: list[str]) -> dict:
    """Kernel (short name) -> its instructions, constant offsets masked."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    out = subprocess.run([cs.cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    fns, fn = {}, None
    for line in out.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            name = cs.short_name(text.split(":", 1)[1].strip())
            fn = fns.setdefault(name, []) if any(
                f in name for f in fragments) else None
        elif fn is not None and text.startswith("/*") and ";" in text:
            ins = text.split("*/", 1)[1].split(";", 1)[0].strip()
            fn.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][*]", ins))
    return fns


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return child(pathlib.Path(argv[1]).resolve(), argv[2].split(","))
    cases = ["_"]
    fragments = [f"flash_wgmmaILi{d}E" for d in (64, 128, 256)] + [
        f"decode_bulkILi{d}E" for d in (64, 128)]
    while argv and argv[0].startswith("--"):
        opt, val, argv = argv[0], argv[1].split(","), argv[2:]
        if opt == "--cases":
            cases = val
        elif opt == "--sass":
            fragments = val
        else:
            raise SystemExit(f"unknown option {opt}")
    roots = [str(pathlib.Path(r).resolve()) for r in argv]
    if not roots:
        raise SystemExit(__doc__)
    libs = {}
    for r in roots:
        run = subprocess.run([sys.executable, __file__, "--one", r,
                              ",".join(cases)], capture_output=True, text=True,
                             timeout=1200)
        if run.returncode:
            print(run.stdout, run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        for line in run.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else None
            if row and "libs" in row:
                libs[r] = row["libs"]
            elif row:
                print(line, flush=True)
    first = roots[0]
    for r in dict.fromkeys(roots[1:]):
        if r == first:
            continue
        for src in SOURCES:
            a, b = sass(libs[first][src], fragments), sass(libs[r][src], fragments)
            for name in sorted(set(a) | set(b)):
                x, y = a.get(name, []), b.get(name, [])
                diff = [d for d in difflib.unified_diff(x, y, lineterm="", n=0)
                        if d[:1] in "+-" and d[:3] not in ("+++", "---")]
                print(json.dumps({"kernel": name, "against": first, "root": r,
                                  "instructions": [len(x), len(y)],
                                  "lines_differing": len(diff),
                                  "first_differences": diff[:12]}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
