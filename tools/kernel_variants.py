#!/usr/bin/env python3
"""Build one CUDA source of the port with extra ``nvcc`` flags per variant and
time its card-scale cases on one H100: ``python3 tools/kernel_variants.py
mlstm_chunk "" "-DSOME_MACRO=1"`` (the first argument names a source of
``csrc/``).

For each variant (a comma-separated list of ``nvcc`` flags, "" for none) it
prints the compiler's registers and spills for the kernel functions of the
card shape (``chip_smoke.SASS_REQUIRED``), their Hopper instructions in the
SASS, each card case's error against its plain version as a share of
``chip_smoke``'s bound, the timed case's time and the attention kernels'
head-size cases' (beside their bound and the one PyTorch call that
computes the same function), and each CUDA kernel's device time from
``torch.profiler``.  Compare variants only within
one run.  Writes each variant's ``-Xptxas -v`` log to ``chiprun_out/``.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import compat

    if not torch.cuda.is_available():
        print("kernel_variants: needs the CUDA card", file=sys.stderr)
        return 2
    which, variants = argv[0], [tuple(v.split(",")) if v else () for v in argv[1:] or [""]]
    fragments = [f for f, _ in cs.SASS_REQUIRED[which]]
    kernel = {"rglru": "rglru_scan", "membench": "membench_aligned"}.get(which, which)
    attention = which in ("flash_attention", "decode_attention")
    dev = torch.device("cuda")
    card = [c for c in cs.card_cases(dev) if c["name"] == kernel]
    base = compat.NVCC_FLAGS
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    print(cs.nvidia_smi(), flush=True)
    for i, flags in enumerate(variants):
        compat.NVCC_FLAGS = base + flags
        compat._LIBS.clear()
        t0 = time.perf_counter()
        compat.build([which])
        log = (compat.BUILD_DIR / f"{which}.log").read_text()
        (out_dir / f"variants_{which}_{i}.log").write_text(" ".join(flags) + "\n" + log)
        print(f"variant {flags}: build {time.perf_counter() - t0:.1f} s", flush=True)
        for block in log.split("Compiling entry function")[1:]:
            if any(f in block.split("\n")[0] for f in fragments):
                print("  ", " | ".join(ln.strip() for ln in block.split("\n")[1:4]
                                      if "bytes" in ln or "registers" in ln))
        sass = cs.sass_counts(compat.library_path(which))
        print("  ", {n: c for n, c in sass.items() if any(f in n for f in fragments)})
        for c in card:
            got = c["run"]()
            torch.cuda.synchronize()
            want = c["plain"]()
            err, of_bound, ok = cs.compare(got, want, c["tol"], cs.spread(c))
            print(f"   {c['label'][:48]} err {err:.3g} of_bound {of_bound:.3g} ok {ok}")
        for c in (c for c in card if c["timed"] or c.get("head_size")):
            if attention:
                t = cs._timing(c, dev)
                print(f"   {c['label'][:48]} ms {t['ms']} sdpa_ms {t['library_ms']} "
                      f"bound_ms {t['bound_ms']}")
            else:
                print("   ms", cs.time_ms(c["run"], dev))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    c["run"]()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                if t:
                    print(f"   device {e.key[:60]} {t / max(e.count, 1):.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
