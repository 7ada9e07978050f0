#!/usr/bin/env python3
"""The mesh phase alone, on one H100: ``python3 tools/mesh_phase.py``.

Runs ``chip_smoke.phase_mesh``: the dry-run of the 16x16 pod cells (rank
0 captured under a fake 256-rank group), qwen2-7b cut to 4 layers and
reduced stablelm-3b's train step sharded on a 2x2 mesh of threaded ranks
on the card against the unsharded model, ``Session(device="cuda")
.autotune`` on qwen2-7b's decode_32k cell and the 2x2 checkpoint resumed
on 4x1, and check (e): the dry-run's memory accounting against the
card's peak rise on the train phase's full-width stablelm-3b step (built
here alone: ~66 GB) and on the unsharded 4-layer qwen2-7b prefill.
Builds no kernel (the mesh path is the plain path).  Prints the same JSON
line as the smoke run.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("mesh_phase: needs the CUDA card", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    wrappers = {name: spec[0] for name, spec in cs.kernel_table().items()}
    device = torch.device("cuda")
    live_train = cs.live_bytes_train(device)
    torch.cuda.empty_cache()
    cs.phase_mesh(device, wrappers, live_train)
    return 0


if __name__ == "__main__":
    sys.exit(main())
