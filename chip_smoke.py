#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one H100: ``python3 chip_smoke.py``.

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/csrc``, holds each kernel against its plain PyTorch
version on the card, drives the port's main path — estimate and sweep with
``Session(backend="torch")`` on the card and on the CPU, then
``Session.validate`` over the card-scale kernels — and times each kernel
beside its bound, its plain version and, where one exists, the one PyTorch
call that computes the same function.

Prints one JSON object per phase (env, build, parity, estimator, validate,
kernels); then the ``{"kernels": [...]}`` line, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed; so does a machine without
a CUDA device, or a directory that holds this script without the repo.
Imports nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet) the bounds are taken against.
PEAK_BYTES_PER_S = 3.35e12        # HBM3
PEAK_FP32_FLOPS = 67e12           # fp32 outside the tensor cores

#: Tolerances of the kernel-vs-plain checks, |got - want| <= atol + rtol *
#: |want| + of_max * max|want|.  The membench sums add in the plain
#: version's order (bit-equality expected).  Decode attention's split-S
#: merge reorders the softmax sums: at the test shapes it gets the
#: reference's own kernel tolerances (tests/test_kernels.py), whose outputs
#: are ~0.2.  At the card shape the outputs are ~sqrt(e / S) ~ 0.01, so the
#: bound scales with the data: 1e-2 of the largest output, about 1.3 bf16
#: ulps of it -- both sides sum in fp32 and round once to bf16.
TOL = {"membench": dict(rtol=1e-6, atol=0.0, of_max=0.0),
       "float32": dict(rtol=2e-5, atol=2e-5, of_max=0.0),
       "bfloat16": dict(rtol=2e-2, atol=2e-2, of_max=0.0),
       "bfloat16_card": dict(rtol=0.0, atol=0.0, of_max=1e-2)}

#: Cache rows dropped from the plain version to show that the card-scale
#: decode tolerance catches a kernel that skips a fraction of one tile.
DROPPED_ROWS = 64


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels under test
# ---------------------------------------------------------------------------

def kernel_table():
    """name -> (wrapper, source, TPU kernel it replaces)."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.membench import ops as MB

    src = "src/repro_torch/csrc/"
    tpu = "src/repro/kernels/"
    return {
        "membench_aligned": (MB.aligned_sum, src + "membench.cu",
                             tpu + "membench/kernel.py:50 aligned_sum"),
        "membench_strided": (MB.strided_sum, src + "membench.cu",
                             tpu + "membench/kernel.py:69 strided_sum"),
        "membench_gather": (MB.gather_sum, src + "membench.cu",
                            tpu + "membench/kernel.py:91 gather_sum"),
        "decode_attention": (DA.decode_attention, src + "decode_attention.cu",
                             tpu + "decode_attention/kernel.py:107 "
                                   "decode_attention"),
    }


def randn(shape, seed, device, dtype=None):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    return x if dtype is None else x.to(dtype)


def _case(name, label, run, plain, tol, traffic, **extra) -> dict:
    return dict(name=name, label=label, run=run, plain=plain, tol=tol,
                traffic=traffic, **extra)


def test_cases(device) -> list[dict]:
    """Kernel calls with their plain versions, tolerance key and traffic,
    at the reference test shapes (tests/test_kernels.py)."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.membench import ops as MB

    n = 1 << 14
    aligned = [(g, b, torch.float32) for g in (1, 2, 4) for b in (512, 2048)]
    aligned += [(2, 512, torch.bfloat16)]
    strided = [(d, 512) for d in (1, 2, 4)]
    gathers = [(3, 16)]
    decodes = [(B, S, Hq, Hkv, D, L, dt, 32, 0.0)
               for (B, S, Hq, Hkv, D, L) in [(2, 96, 8, 2, 32, 96),
                                             (2, 96, 8, 2, 32, 17),
                                             (1, 64, 4, 4, 64, 1),
                                             (3, 80, 16, 2, 16, 40)]
               for dt in (torch.float32, torch.bfloat16)]
    # both split kernels at D = 128, 16 heads per KV head, a softcap
    decodes += [(2, 200, 32, 2, 128, 150, torch.bfloat16, 64, 0.0),
                (1, 96, 12, 2, 64, 77, torch.bfloat16, 32, 20.0),
                (1, 64, 8, 1, 128, 50, torch.float32, 32, 20.0)]
    out = []
    for g, block, dt in aligned:
        xs = tuple(randn((n,), i, device, dt) for i in range(g))
        out.append(_case(
            "membench_aligned", f"n{n}_g{g}_block{block}_{str(dt)[6:]}",
            lambda xs=xs, b=block: MB.aligned_sum(xs, block=b),
            lambda xs=xs: MB.aligned_sum_ref(xs), "membench",
            MB.aligned_sum_traffic(xs, block=block)))
    for delta, block in strided:
        xs = tuple(randn((n,), i, device) for i in range(2))
        out.append(_case(
            "membench_strided", f"n{n}_g2_delta{delta}_block{block}",
            lambda xs=xs, d=delta, b=block: MB.strided_sum(xs, delta=d, block=b),
            lambda xs=xs, d=delta, b=block: MB.strided_sum_ref(xs, delta=d, block=b),
            "membench", MB.strided_sum_traffic(xs, delta=delta, block=block)))
    for g, m in gathers:
        xs = tuple(randn((n,), i, device) for i in range(g))
        ids = np.random.default_rng(9).integers(0, n // 512, m)
        idx = torch.as_tensor(ids, dtype=torch.int32, device=device)
        out.append(_case(
            "membench_gather", f"n{n}_g{g}_ids{m}_block512",
            lambda xs=xs, idx=idx: MB.gather_sum(xs, idx, block=512),
            lambda xs=xs, idx=idx: MB.gather_sum_ref(xs, idx, block=512),
            "membench", MB.gather_sum_traffic(xs, idx, block=512)))
    for B, S, Hq, Hkv, D, L, dt, bs, cap in decodes:
        G = Hq // Hkv
        args = (randn((B, Hkv, G, D), 1, device, dt),
                randn((B, S, Hkv, D), 2, device, dt),
                randn((B, S, Hkv, D), 3, device, dt),
                torch.tensor(L, dtype=torch.int32, device=device))
        out.append(_case(
            "decode_attention",
            f"B{B}_S{S}_Hq{Hq}_Hkv{Hkv}_D{D}_len{L}_cap{cap:g}_{str(dt)[6:]}",
            lambda a=args, bs=bs, cap=cap: DA.decode_attention(
                *a, block_s=bs, softcap=cap),
            lambda a=args, cap=cap: DA.decode_attention_ref(*a, softcap=cap),
            str(dt)[6:],
            DA.gqa_decode_traffic(args[0].reshape(B, 1, Hq, D), args[1],
                                  args[2], L)))
    return out


def card_cases(device) -> list[dict]:
    """The main path's own kernel calls: each case of
    ``default_cases(small=False)``, which ``Session.validate`` times, built
    on the card and paired with its plain version on the same arguments."""
    from repro_torch.core.validate import default_cases

    out = []
    for vc in default_cases(small=False):
        fn, args, traffic = vc.build(device)
        shapes = "_".join("x".join(map(str, a.shape))
                          for a in _tensors(args) if a.dim())
        decode = vc.name == "decode_attention"
        out.append(_case(
            vc.name, shapes, lambda fn=fn, a=args: fn(*a),
            lambda p=vc.plain, a=args: p(*a),
            "bfloat16_card" if decode else "membench", traffic, args=args))
    return out


def _tensors(args):
    for a in args:
        if isinstance(a, (tuple, list)):
            yield from _tensors(a)
        else:
            yield a


def tolerance(want, tol_key: str) -> dict:
    tol = TOL[tol_key]
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    return dict(rtol=tol["rtol"], atol=tol["atol"] + tol["of_max"] * scale)


def compare(got, want, tol_key: str) -> tuple[float, bool]:
    import torch

    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = (g.shape == w.shape and bool(torch.isfinite(g).all())
          and torch.allclose(g, w, **tolerance(w, tol_key)))
    return err, ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_parity(device, card: list[dict]) -> dict:
    """Every kernel against its plain version, at the test shapes and at the
    main path's ``card`` cases; returns the card-scale max error per
    kernel."""
    import torch

    from repro_torch.kernels.decode_attention import ops as DA

    card_err = {}
    for scale, cs in (("test", test_cases(device)), ("card", card)):
        rows = []
        for c in cs:
            got = c["run"]()
            torch.cuda.synchronize()
            want = c["plain"]()
            err, ok = compare(got, want, c["tol"])
            row = {"kernel": c["name"], "case": c["label"],
                   "max_abs_err": err, **tolerance(want.float(), c["tol"]),
                   "bit_equal": bool(torch.equal(got, want)), "ok": ok}
            check(ok, f"parity {c['name']} {c['label']}: max_abs_err {err}")
            if c["tol"] == "bfloat16_card":
                # The plain version without the last DROPPED_ROWS cache rows
                # is what a kernel skipping them would return: it must fail.
                q, kc, vc, kv_len = c["args"]
                short = DA.gqa_decode_ref(q, kc, vc, kv_len - DROPPED_ROWS)
                short_err, short_ok = compare(short, want, c["tol"])
                row[f"err_without_last_{DROPPED_ROWS}_rows"] = short_err
                check(not short_ok, "card-scale decode tolerance does not "
                      f"catch {DROPPED_ROWS} dropped cache rows")
            rows.append(row)
            if scale == "card":
                card_err[c["name"]] = max(card_err.get(c["name"], 0.0), err)
        emit({"phase": "parity", "scale": scale, "tolerances": TOL,
              "rows": rows})
    return card_err


STREAM_AXES_NUMERIC = dict(
    n_ga=list(range(1, 11)),
    simd=[1, 2, 4, 8, 16],
    n_elems=[1 << e for e in range(14, 22)],
    delta=list(range(1, 21)),
    include_write=[False, True],
    val_constant=[False, True],
    elem_bytes=[4, 8],
)


def grids():
    """The reference's 864-point test grid (tests/test_api.py) and its
    1,024,000-point streaming bench grid (benchmarks/sweep_bench.py),
    rebuilt from the port's own types."""
    import repro_torch as rt

    types = [rt.LsuType.BC_ALIGNED, rt.LsuType.BC_NON_ALIGNED,
             rt.LsuType.BC_WRITE_ACK, rt.LsuType.ATOMIC_PIPELINED]
    drams = [rt.DDR4_1866, rt.DDR4_2666]
    grid864 = dict(lsu_type=types, n_ga=[1, 2, 4], simd=[1, 4, 16],
                   n_elems=[1 << 14, 1 << 16], delta=[1, 2, 7],
                   include_write=[False, True], dram=drams)
    grid1m = dict(lsu_type=types, dram=drams,
                  bsp=[rt.STRATIX10_BSP, rt.BspParams(burst_cnt=5, max_th=64)],
                  **STREAM_AXES_NUMERIC)
    return {"grid864": grid864, "grid1m": grid1m}


def phase_estimator(device) -> None:
    import numpy as np

    import repro_torch as rt

    rows = []
    for name, axes in grids().items():
        reps = {}
        for dev in (device, "cpu"):
            sess = rt.Session(backend="torch", device=dev)
            t0 = time.perf_counter()
            rep = sess.sweep(rt.Space.grid(**axes))
            wall = time.perf_counter() - t0
            reps[str(dev)] = (rep, wall)
        (gpu, gpu_s), (cpu, cpu_s) = reps[str(device)], reps["cpu"]
        ids = lambda r: np.argsort(r.t_exe, kind="stable")[:10].tolist()  # noqa: E731
        row = {
            "grid": name, "n_points": gpu.n_points,
            "t_exe_bit_equal": bool(np.array_equal(gpu.t_exe, cpu.t_exe)),
            "bound_ratio_bit_equal": bool(np.array_equal(
                gpu.estimate.bound_ratio, cpu.estimate.bound_ratio)),
            "top10_ids": ids(gpu), "pareto_points": int(len(gpu.pareto())),
            "points_per_s": {"cuda": gpu.n_points / gpu_s,
                             "cpu": cpu.n_points / cpu_s},
        }
        rows.append(row)
        check(gpu.n_points == cpu.n_points > 0, f"{name}: point counts")
        check(np.allclose(gpu.t_exe, cpu.t_exe, rtol=1e-12, atol=0.0),
              f"{name}: t_exe differs across devices")
        check(np.allclose(gpu.estimate.bound_ratio, cpu.estimate.bound_ratio,
                          rtol=1e-12, atol=0.0), f"{name}: bound_ratio differs")
        check(np.array_equal(gpu.memory_bound, cpu.memory_bound),
              f"{name}: memory_bound differs")
        check(np.array_equal(gpu.resource, cpu.resource),
              f"{name}: resource differs")
        check(ids(gpu) == ids(cpu), f"{name}: top_k(10) ids differ")
        check(np.array_equal(gpu.pareto(), cpu.pareto()),
              f"{name}: pareto ids differ")
        check(np.all(np.isfinite(gpu.t_exe)) and np.all(gpu.t_exe > 0),
              f"{name}: non-finite estimates")
    # single and heterogeneous estimates on the card against the CPU
    designs = [rt.Design.microbench(t, n_ga=2, n_elems=1 << 14)
               for t in grids()["grid864"]["lsu_type"]]
    on_card = rt.Session(device=device).estimate_many(designs)
    on_cpu = rt.Session(device="cpu").estimate_many(designs)
    one = rt.Session(device=device).estimate(designs[0])
    check(all(math.isclose(a.t_exe, b.t_exe, rel_tol=1e-12)
              for a, b in zip(on_card, on_cpu)), "estimate_many differs")
    check(math.isclose(one.t_exe, on_cpu[0].t_exe, rel_tol=1e-12),
          "estimate differs")
    emit({"phase": "estimator", "rows": rows})


def phase_validate(device) -> None:
    import numpy as np

    import repro_torch as rt
    from repro_torch.core.validate import default_cases

    rep = rt.Session(device=device).validate(default_cases(small=False),
                                            iters=10, warmup=3)
    check(rep.failures == [], f"validate failures: {rep.failures}")
    check(len(rep.results) == 4, "validate: four kernels expected")
    rows = []
    for r in rep.results:
        check(np.isfinite(r.err_pct) and r.measured_s > 0
              and np.isfinite(r.predicted_s), f"validate {r.name}: {r}")
        gbs = r.bytes_moved / r.measured_s
        rows.append({"kernel": r.name, "measured_ms": r.measured_s * 1e3,
                     "predicted_ms": r.predicted_s * 1e3,
                     "err_pct": r.err_pct, "bytes": r.bytes_moved,
                     "gb_per_s": gbs / 1e9,
                     "share_of_3.35TBps": gbs / PEAK_BYTES_PER_S})
    anchor = next(r for r in rep.results if r.name == "membench_aligned")
    check(anchor.err_pct < 1e-6, f"anchor error {anchor.err_pct}")
    emit({"phase": "validate", "measured_bw_gbs": rep.measured_bw / 1e9,
          "calibration_factor": rep.calibration_factor, "rows": rows})


def time_ms(fn, device, iters=20, warmup=3) -> float:
    from repro_torch.core.validate import time_callable

    return time_callable(fn, (), device=device, iters=iters,
                         warmup=warmup) * 1e3


def phase_kernels(device, card: list[dict], launches: dict,
                  card_err: dict) -> list[dict]:
    """Each kernel at the main path's shape: time beside its bound, its
    plain version and (decode attention) ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    table = kernel_table()
    out = []
    for c in card:
        _, source, replaces = table[c["name"]]
        t_bytes = c["traffic"]["total_bytes"] / PEAK_BYTES_PER_S
        t_ops = c["traffic"]["flops"] / PEAK_FP32_FLOPS
        library_ms = None
        if c["name"] == "decode_attention":
            q, kc, vc, _ = c["args"]
            qt = q.transpose(1, 2)
            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True), device)
        out.append({
            "name": c["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[c["name"]],
            "max_abs_err": card_err[c["name"]],
            "ms": time_ms(c["run"], device),
            "plain_ms": time_ms(c["plain"], device),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        })
    return out


def main() -> int:
    import torch

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import compat

    device = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    built = compat.build()
    ptxas = {name: [ln.strip() for ln in (compat.BUILD_DIR / f"{name}.log")
                    .read_text().splitlines() if "registers" in ln or "spill" in ln]
             for name in built}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": built, "ptxas": ptxas})

    card = card_cases(device)
    card_err = phase_parity(device, card)

    # The main path: estimate -> sweep -> validate, with every launch
    # counter at zero just before it and read just after.
    wrappers = {name: spec[0] for name, spec in kernel_table().items()}
    for fn in wrappers.values():
        fn.launches = 0
    phase_estimator(device)
    phase_validate(device)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    emit({"phase": "launches", "main_path": launches})
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the main path")

    kernels = phase_kernels(device, card, launches, card_err)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
