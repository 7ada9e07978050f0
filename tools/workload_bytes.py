#!/usr/bin/env python3
"""Bytes of a captured phase against the reference's fused HLO walk, by
access class: ``python3 tools/workload_bytes.py [arch]`` (needs jax and the
reference package ``repro``; runs on the CPU).

The port captures its eager steps op by op (``repro_torch.workload``), so
every elementwise op reads its inputs and writes its result where XLA fuses
a chain into one pass.  This script lowers the reference's phases of
``reduced_config(ARCHS[arch], layers_scale=2)`` at B 2 x S 32 (the toy
config of the workload tests; default: the first arch by name), walks them
with ``walk_module(fused=True)``, captures the port's same phases, and
prints one JSON line per phase: bytes by class on each side, their ratio
and the op counts.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _by_class(records) -> dict:
    out: dict = {}
    for r in records:
        for k, v in r.bytes_by_class.items():
            out[k] = out.get(k, 0.0) + v
    return out


def main(argv: list[str]) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    from repro import workload as ref_wl
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import reduced_config as ref_reduced
    from repro.workload import steps as ref_steps
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.workload import steps

    arch = argv[0] if argv else sorted(ARCHS)[0]
    ref_cfg = ref_reduced(REF_ARCHS[arch], layers_scale=2)
    cfg = reduced_config(ARCHS[arch], layers_scale=2)
    for phase in ("train", "prefill", "decode"):
        fused = ref_wl.walk_module(
            ref_steps.phase_hlo(ref_cfg, phase, batch=2, seq_len=32))
        captured = steps.phase_records(cfg, phase, batch=2, seq_len=32,
                                       device="cpu")
        ref, got = _by_class(fused), _by_class(captured)
        print(json.dumps({
            "arch": cfg.name, "phase": phase, "device": "cpu",
            "fused_hlo_bytes": ref, "captured_bytes": got,
            "captured_over_fused": {k: got.get(k, 0.0) / v
                                    for k, v in ref.items() if v},
            "total_ratio": sum(got.values()) / sum(ref.values()),
            "fused_ops": len(fused), "captured_ops": len(captured)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
