#!/usr/bin/env python3
"""Where the wgmma flash attention kernel spends its time, per CTA, on one
H100: ``python3 tools/flash_cta_timing.py [label]``.

Builds ``csrc/flash_attention.cu`` with ``-DFLASH_TIMING`` (each CTA records
its start, end, kv tiles and SM), runs the qwen2-7b prefill case that
``Session.validate`` times (or the first flash attention card case of
``chip_smoke.card_cases`` whose label holds ``label``, e.g. ``stablelm``),
and fits CTA time = fixed + per-tile * tiles by least squares; prints the
fit, the mean CTA time at a few tile counts and the idle gap between
consecutive CTAs on an SM.
"""
from __future__ import annotations

import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import compat

    if not torch.cuda.is_available():
        print("flash_cta_timing: needs the CUDA card", file=sys.stderr)
        return 2
    compat.NVCC_FLAGS = compat.NVCC_FLAGS + ("-DFLASH_TIMING",)
    dev = torch.device("cuda")
    case = next(c for c in cs.card_cases(dev) if c["name"] == "flash_attention"
                and (argv[0] in c["label"] if argv else c["timed"]))
    print(case["label"])
    print(cs.nvidia_smi())
    print("kernel ms", cs.time_ms(case["run"], dev))
    case["run"]()
    torch.cuda.synchronize()
    lib = compat._LIBS["flash_attention"]
    lib.flash_timing.argtypes = [ctypes.c_void_p]
    buf = np.zeros(4 * 8192, dtype=np.uint64)
    compat.check_launch(lib.flash_timing(buf.ctypes.data), "flash_timing")
    q = case["args"][0]
    B, S, Hq, _ = q.shape
    Hkv = case["args"][1].shape[2]
    n_cta = -(-S * (Hq // Hkv) // 128) * B * Hkv
    rec = buf.reshape(-1, 4)[:min(n_cta, 8192)].astype(np.float64)
    rec = rec[rec[:, 0] > 0]  # a persistent grid holds fewer CTAs than items
    t0 = rec[:, 0].min()
    start, end = (rec[:, 0] - t0) / 1e3, (rec[:, 1] - t0) / 1e3
    tiles, sm = rec[:, 2], rec[:, 3]
    dur = end - start
    fixed, per_tile = np.linalg.lstsq(np.stack([np.ones_like(tiles), tiles], 1),
                                      dur, rcond=None)[0]
    print(f"CTAs {len(rec)}, span {end.max():.1f} us; "
          f"CTA us = {fixed:.2f} + {per_tile:.3f} * tiles")
    for k in (1, 8, 16, 24, 32):
        sel = tiles == k
        if sel.any():
            print(f"tiles {k}: mean CTA {dur[sel].mean():.2f} us over {sel.sum()}")
    gaps = []
    for s in np.unique(sm):
        order = np.argsort(start[sm == s])
        st, en = start[sm == s][order], end[sm == s][order]
        gaps.extend(st[1:] - en[:-1])
    print(f"gap between CTAs on an SM: mean {np.mean(gaps):.2f} us, "
          f"max {np.max(gaps):.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
