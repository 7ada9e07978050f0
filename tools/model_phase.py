#!/usr/bin/env python3
"""The model path alone, on one H100: ``python3 tools/model_phase.py
[arch ...] [--experts LO HI] [--layers N]`` (default: every arch of
``chip_smoke.MODEL_RUNS``, each with its own run; ``--experts`` and
``--layers`` replace an MoE arch's expert share and depth, e.g.
``python3 tools/model_phase.py qwen3-moe-235b-a22b --experts 8 16``).

Builds the four model-path kernels (decode and flash attention, the
RG-LRU scan, the mLSTM), holds the two attention kernels against their
plain versions at the reference's test shapes and at the zoo's other head
sizes (each with its fault check), times the head-size cases
(``chip_smoke.phase_head_sizes``), then runs ``chip_smoke.phase_model``
for each arch: prefill, one decode step at depth (and at the long shape
where the arch runs it) and the batched server.  A quicker loop than the
whole ``chip_smoke.py`` when only the model path changed; prints the same
JSON lines.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import compat

    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", help="archs of chip_smoke.MODEL_RUNS")
    ap.add_argument("--experts", type=int, nargs=2, metavar=("LO", "HI"),
                    help="the experts an MoE arch's layers hold, lo..hi-1")
    ap.add_argument("--layers", type=int, help="an MoE arch's depth")
    args = ap.parse_args(argv)
    unknown = set(args.archs) - set(cs.MODEL_RUNS)
    if unknown:
        ap.error(f"not in chip_smoke.MODEL_RUNS: {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("model_phase: needs the CUDA card", file=sys.stderr)
        return 2
    archs = args.archs or list(cs.MODEL_RUNS)
    print(cs.nvidia_smi(), flush=True)
    compat.build(["decode_attention", "flash_attention", "rglru",
                  "mlstm_chunk"])
    dev = torch.device("cuda")
    attention = ("decode_attention", "flash_attention")
    card = cs.head_size_cases(dev)
    for c in cs.test_cases(dev) + card:
        if c["name"] not in attention:
            continue
        got = c["run"]()
        torch.cuda.synchronize()
        want = c["plain"]()
        sp = cs.spread(c)
        err, _, ok = cs.compare(got, want, c["tol"], sp)
        cs.check(ok, f"parity {c['label']}: max_abs_err {err}")
        if c.get("fault"):
            what, bad = cs.perturbed(c["name"], c["args"], want, c["ref"])
            cs.check(not cs.compare(bad, want, c["tol"], sp)[2],
                     f"{c['label']}: the tolerance does not catch: {what}")
    cs.device_profile(lambda: torch.ones(8, device=dev).sum())  # CUPTI up
    cs.phase_head_sizes(dev, card)
    del card
    wrappers = {name: spec[0] for name, spec in cs.kernel_table().items()}
    for arch in archs:
        runs = dict(cs.MODEL_RUNS[arch])
        if "experts" in runs:
            runs.update({k: v for k, v in (("experts", args.experts),
                                           ("layers", args.layers)) if v})
        cs.phase_model(dev, wrappers, arch, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
