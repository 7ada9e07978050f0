#!/usr/bin/env python3
"""Decode attention's split floor, timed on one H100:
``python3 tools/decode_split_floor.py [floor ...]``.

Times ``gqa_decode`` (K4) under each ``MIN_SPLIT_STAGES`` (default 1, 2,
4, ..., 128; 1 is the plan of whole waves alone) at recurrentgemma-9b's
local decode over its 2,048-row ring (16 query heads over one kv head of
256, bf16) at B 8 and B 128, and at qwen2-7b's decode (28 query heads
over 4 kv heads of 128, B 8 over 32,768 rows), beside
``scaled_dot_product_attention`` on the same inputs.  The floors are taken
in turn within each of two rounds, so a drift of the card's clock shows as
a difference between rounds.  Prints one JSON line per shape and round,
then the card's name and power limit.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"recurrentgemma-9b_ring_B8": (8, 2048, 16, 1, 256),
          "recurrentgemma-9b_ring_B128": (128, 2048, 16, 1, 256),
          "qwen2-7b_B8": (8, 32768, 28, 4, 128)}


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import compat
    from repro_torch.kernels.decode_attention import ops as DA

    if not torch.cuda.is_available():
        print("decode_split_floor: needs the CUDA card", file=sys.stderr)
        return 2
    floors = [int(a) for a in argv] or [1, 2, 4, 8, 16, 32, 64, 128]
    compat.build(["decode_attention"])
    dev = torch.device("cuda")
    print(json.dumps({"ctas_per_sm_D256": DA.bulk_ctas_per_sm(1, 256),
                      "card_ctas_per_sm_D256": DA.card_bulk_residency(1, 256)}),
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    default = DA.MIN_SPLIT_STAGES
    for rnd in range(2):
        for name, (B, S, Hq, Hkv, D) in SHAPES.items():
            q = cs.randn((B, 1, Hq, D), 1, dev, torch.bfloat16)
            k = cs.randn((B, S, Hkv, D), 2, dev, torch.bfloat16)
            v = cs.randn((B, S, Hkv, D), 3, dev, torch.bfloat16)
            # kv_len on the device, as the model passes it: an int costs a
            # copy to the card on every call
            n = torch.tensor(S, dtype=torch.int32, device=dev)
            want = DA.gqa_decode_ref(q, k, v, n)
            row = {"shape": name, "round": rnd, "default": default,
                   "bound_ms": DA.gqa_decode_traffic(q, k, v, S)["total_bytes"]
                   / cs.PEAK_BYTES_PER_S * 1e3}
            path = DA.kernel_path(q.dtype, D)
            if path == "bulk":
                ctas = B * (Hkv // DA.heads_per_cta(Hkv, D)) * -(-(Hq // Hkv) // 16)
                per_sm = DA.bulk_ctas_per_sm(Hkv, D)
            else:
                ctas, per_sm = B * Hkv * -(-(Hq // Hkv) // 8), DA.SIMT_CTAS_PER_SM
            row["path"], row["ctas_per_sm"] = path, per_sm
            for f in floors:
                DA.MIN_SPLIT_STAGES = f
                n_split, _ = DA._plan(S, ctas, sms, per_sm, fullest=path == "bulk")
                err, _, ok = cs.compare(DA.gqa_decode(q, k, v, n), want,
                                        "bfloat16_card")
                cs.check(ok, f"{name} floor {f}: off by {err}")
                row[f"floor{f}"] = {"splits": n_split,
                                    "ms": cs.time_ms(lambda: DA.gqa_decode(
                                        q, k, v, n), dev, iters=50, warmup=5)}
            DA.MIN_SPLIT_STAGES = default
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["sdpa_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True), dev, iters=50, warmup=5)
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
