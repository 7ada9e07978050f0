#!/usr/bin/env python3
"""The examples phase alone, on one H100: ``python3 tools/examples_phase.py``.

Builds the kernels (``compat.build``), then runs ``chip_smoke
.phase_examples``: the port's five examples (``examples/torch_*.py``),
each a process of its own on the card with small arguments, all started
together; each must exit 0 and the explorer's ``--validate`` must launch
all seven kernels.  Prints the same JSON line as the smoke run.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import compat

    if not torch.cuda.is_available():
        print("examples_phase: needs the CUDA card", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    compat.build()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    cs.phase_examples()
    return 0


if __name__ == "__main__":
    sys.exit(main())
