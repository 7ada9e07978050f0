#!/usr/bin/env python3
"""The train phase alone, on one H100: ``python3 tools/train_phase.py``.

Builds the two attention kernels (the trained model is served through K5
on prefill and K4 on decode), then runs ``chip_smoke.phase_train``: the
card against the CPU at ``reduced_config(stablelm-3b)``, five full-width
stablelm-3b steps, ``train_loop``'s resume and a bf16 checkpoint, and the
trained model served by ``chip_smoke.phase_model``.  A quicker loop than
the whole ``chip_smoke.py`` when only the training path changed; prints
the same JSON lines.
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
    from repro_torch import compat

    if not torch.cuda.is_available():
        print("train_phase: needs the CUDA card", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    compat.build(["decode_attention", "flash_attention"])
    wrappers = {name: spec[0] for name, spec in cs.kernel_table().items()}
    by_part, _, _ = cs.phase_train(torch.device("cuda"), wrappers)
    cs.emit({"phase": "launches", f"trained/{cs.TRAIN_ARCH}": by_part})
    return 0


if __name__ == "__main__":
    sys.exit(main())
