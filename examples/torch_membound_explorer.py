"""Classify any torch function as memory- vs compute- vs collective-bound
without running it — the Eq. 3 criterion applied to a captured step — and
sweep the paper's FPGA design space at exploration scale.

The port of ``examples/membound_explorer.py``, section for section.  A
function is captured op by op on fake tensors
(``repro_torch.workload.capture.walk_callable``: nothing is allocated or
launched) where the reference lowers a ``jax.jit``, and the same records
make a ``Design`` (``Design.from_kernel``).  Then the membench kernels
(the paper's Listing-4 microbenchmarks, hand-written CUDA on the card):
contiguous streaming, strided, and data-dependent gather.  Then the
vectorized sweep engine over thousands of LSU/SIMD/stride/DRAM design
points, printing the fastest configurations and the Pareto front of
predicted time vs interconnect resource use.

Finally closes the loop: ``--validate`` (also run by default) measures the
seven kernels and scores the analytical model against the measurement
(``repro_torch.core.validate``), printing the paper-style error table and
each kernel wrapper's launches.

Run:  PYTHONPATH=src python examples/torch_membound_explorer.py
(--sweep-only to skip the capture part, --validate for just the
measured-vs-predicted table, --model for the whole-model transformer
walkthrough (``Session.estimate_model``), --hw <name> to evaluate against
a ``repro_torch.hw`` registry spec, e.g. --hw tpu_v4, --device cpu to run
on the CPU instead of the CUDA card)

Everything routes through the unified ``repro_torch.Design``/``Session``
API — this file doubles as its end-to-end example.
"""
import sys
import time

from repro_torch import Design, Session, Space


def _flag(name: str) -> str | None:
    """The value of ``--name <value>`` or ``--name=<value>``, if given."""
    argv = sys.argv[1:]
    for i, arg in enumerate(argv):
        if arg == f"--{name}":
            if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                sys.exit(f"usage: --{name} <value>")
            return argv[i + 1]
        if arg.startswith(f"--{name}="):
            return arg.split("=", 1)[1]
    return None


def _session() -> Session:
    """The evaluation context, honoring ``--device`` and a ``--hw <name>``
    registry flag."""
    sess = Session(device=_flag("device"))
    name = _flag("hw")
    if name is None:
        return sess
    import repro_torch.hw as hwreg

    try:
        return sess.with_hardware(hwreg.get(name))
    except KeyError as e:
        sys.exit(f"--hw: {e.args[0]}")


def sweep_demo() -> None:
    """Score a full design space in one pass and show the interesting slices."""
    from repro_torch import DDR4_1866, DDR4_2666, LsuType

    sess = _session()
    axes = dict(
        lsu_type=[LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED,
                  LsuType.BC_WRITE_ACK, LsuType.ATOMIC_PIPELINED],
        n_ga=[1, 2, 3, 4],
        simd=[1, 2, 4, 8, 16],
        n_elems=[1 << 16],
        delta=[1, 2, 4, 7],
    )
    if sess.hardware is None:     # --hw pins the memory system instead
        axes["dram"] = [DDR4_1866, DDR4_2666]
    t0 = time.perf_counter()
    res = sess.sweep(Space.grid(**axes))
    dt = time.perf_counter() - t0
    print(f"\nDesign-space sweep: {res.n_points} points scored in "
          f"{dt * 1e3:.1f} ms ({res.n_points / dt:,.0f} points/s)")
    print(f"memory-bound: {int(res.memory_bound.sum())}/{res.n_points}")

    print("\nfastest 5 designs (by predicted T_exe):")
    for row in res.top_k(5):
        print(f"  {row['lsu_type']:>14s} n_ga={row['n_ga']} simd={row['simd']:2d} "
              f"delta={row['delta']} {row['dram']}: {row['t_exe_ms']:.3f} ms "
              f"({row['eff_bw_gbs']:.1f} GB/s)")

    front = res.pareto()          # minimize (time, LSU interconnect width)
    print(f"\nPareto front (time vs resource): {len(front)} points")
    seen = set()    # collapse performance ties (inert axes, equal designs)
    for row in res.rows(front):
        key = (row["lsu_type"], row["resource_bytes"], row["t_exe_ms"])
        if key in seen:
            continue
        seen.add(key)
        print(f"  {row['lsu_type']:>14s} simd={row['simd']:2d} "
              f"res={row['resource_bytes']:.0f}B: {row['t_exe_ms']:.3f} ms")
        if len(seen) >= 5:
            break


def stream_demo() -> None:
    """Sweep a 200k+-point space in bounded memory: the streaming engine
    (the device fold on the card)."""
    from repro_torch import LsuType

    sess = _session()
    axes = dict(
        lsu_type=[LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED,
                  LsuType.BC_WRITE_ACK, LsuType.ATOMIC_PIPELINED],
        n_ga=list(range(1, 11)),
        simd=[1, 2, 4, 8, 16],
        n_elems=[1 << e for e in range(14, 22)],
        delta=list(range(1, 17)),
        include_write=[False, True],
        val_constant=[False, True],
        elem_bytes=[4, 8],
    )
    space = Space.grid(**axes).stream(chunk_size=1 << 17)
    t0 = time.perf_counter()
    res = sess.sweep(space)       # folds into Pareto/top-k/stats reducers
    dt = time.perf_counter() - t0
    s = res.summary()
    print(f"\nStreaming sweep: {s['n_points']:,} points in {dt:.2f} s "
          f"({s['n_points'] / dt:,.0f} points/s), "
          f"{len(res.resource)} survivors held in memory")
    print(f"memory-bound: {s['memory_bound_points']:,}/{s['n_points']:,}; "
          f"Pareto front: {s['pareto_points']} points; "
          f"fastest {s['t_exe_min_ms']:.4f} ms")
    for row in res.top_k(3):
        print(f"  {row['lsu_type']:>14s} n_ga={row['n_ga']} "
              f"simd={row['simd']:2d} delta={row['delta']}: "
              f"{row['t_exe_ms']:.3f} ms ({row['eff_bw_gbs']:.1f} GB/s)")


def _wrappers() -> dict:
    """name -> the launch-counting wrapper of each of the seven kernels."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.membench import ops as MB
    from repro_torch.kernels.mlstm_chunk import ops as ML
    from repro_torch.kernels.rglru import ops as RG

    return {"membench_aligned": MB.aligned_sum,
            "membench_strided": MB.strided_sum,
            "membench_gather": MB.gather_sum,
            "flash_attention": FA.flash_attention,
            "decode_attention": DA.decode_attention,
            "rglru_scan": RG.scan, "mlstm_chunk": ML.mlstm_chunk}


def validate_demo() -> None:
    """Close the loop: measure the seven kernels and score the analytical
    model against the measurements (paper-style error table); then each
    kernel's launches in this run (the wrappers count launches on the
    card; on the CPU the plain versions run and nothing is counted)."""
    import json

    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    rep = _session().validate()
    print(f"\nMeasured-vs-predicted validation "
          f"(backend={rep.results[0].backend if rep.results else '?'}, "
          f"stream anchor {rep.measured_bw / 1e9:.1f} GB/s, "
          f"host factor {rep.calibration_factor:.3g}):")
    print(f"  {'kernel':>18s} {'measured':>10s} {'predicted':>10s} "
          f"{'bytes':>9s} {'err':>7s}")
    for r in rep.results:
        print(f"  {r.name:>18s} {r.measured_s * 1e3:9.3f}ms "
              f"{r.predicted_s * 1e3:9.3f}ms {r.bytes_moved / 1e6:7.2f}MB "
              f"{r.err_pct:6.1f}%")
    for f in rep.failures:
        print(f"  {f['kernel']:>18s}  FAILED: {f['error']}")
    print("kernel launches: " + json.dumps(
        {name: fn.launches for name, fn in wrappers.items()}))


def model_demo() -> None:
    """Whole-model estimation: capture the shipped transformer's train and
    decode steps, compose per-op Eqs. 1-10 estimates into an end-to-end
    latency/roofline report (``Session.estimate_model``)."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.workload.report import op_table

    cfg = reduced_config(ARCHS[sorted(ARCHS)[0]], layers_scale=2)
    sess = _session()
    t0 = time.perf_counter()
    rep = sess.estimate_model(cfg, phases=("train", "decode"),
                              batch=2, seq_len=64)
    dt = time.perf_counter() - t0
    s = rep.summary()
    print(f"\nWhole-model estimation: {rep.name} on "
          f"{s['hardware']} ({dt:.1f} s to capture + compose)")
    print(f"  total {rep.total_latency() * 1e3:.3f} ms, "
          f"AI={rep.arithmetic_intensity:.2f} FLOP/B "
          f"(ridge {rep.ridge_intensity:.0f}), "
          f"{'memory' if rep.memory_bound else 'compute'}-bound overall")
    for phase in rep.phases:
        print(f"\n  {phase.name}: {phase.t_total * 1e3:.3f} ms over "
              f"{phase.n_ops} ops ({len(phase.ops)} with DRAM traffic), "
              f"bottleneck={phase.bottleneck}")
        for d in phase.by_class():
            print(f"    {d['op_class']:>12s}: {d['t_exe'] * 1e3:8.3f} ms "
                  f"({d['share'] * 100:5.1f}%) {d['n_ops']:3d} ops "
                  f"{d['bytes'] / 1e6:8.2f} MB")
    print(f"\n  heaviest decode ops:\n{op_table(rep.phase('decode'), top=5)}")


def explain(name: str, fn, *args) -> None:
    """One line: ``fn`` captured on ``args`` (fake tensors), its bytes by
    access class, and its predicted bottleneck under the session's model
    hardware; the Design the same capture gives, estimated by Eqs. 1-10."""
    from repro_torch.core.autotune import predict_record
    from repro_torch.launch.dryrun import summarize
    from repro_torch.workload.capture import walk_callable

    sess = _session()
    pred = predict_record(summarize(walk_callable(fn, *args)), sess.hw,
                          device=sess.device)
    classes = {c.name: c.nbytes for c in pred.memory_components}
    est = sess.estimate(Design.from_kernel(fn, *args, name=name))
    print(f"{name:28s} AI={pred.arithmetic_intensity:8.2f} FLOP/B  "
          f"bound={pred.bottleneck:9s} T_eq={est.t_exe * 1e3:8.3f} ms "
          f"classes=" + ", ".join(f"{k}:{v:.2g}B" for k, v in classes.items()))


def main() -> None:
    import torch

    from repro_torch.workload.capture import fake_mode

    sess = _session()
    n = 1 << 20
    with fake_mode():
        x = torch.empty(n, dtype=torch.float32, device=sess.device)
        m = torch.empty(1024, 1024, dtype=torch.float32, device=sess.device)
        idx = torch.empty(n, dtype=torch.int32, device=sess.device)

    def chain(a):
        y = a
        for _ in range(8):
            y = y @ a
        return y.sum()

    hw = sess.hw
    print(f"Eq.-3 analogue: arithmetic intensity vs the {hw.name} ridge "
          f"({hw.peak_flops / 1e12:.0f} TF/s / {hw.hbm_bw / 1e9:.0f} GB/s "
          f"~ {hw.ridge_flops_per_byte:.0f} FLOP/B)\n")
    explain("sum reduction (stream)", lambda a, b: (a + b).sum(), x, x)
    explain("strided sum", lambda a: a.reshape(-1, 4)[:, 0].sum(), x)
    explain("gather sum (write-ACK)", lambda a, i: a[i.long() % n].sum(),
            x, idx)
    explain("matmul 1k (compute)", lambda a: (a @ a).sum(), m)
    explain("matmul chain x8", chain, m)

    where = "CUDA, sm_90a" if sess.device.type == "cuda" else "plain, CPU"
    print(f"\nmembench kernels ({where}) — same taxonomy, kernel-level:")
    from repro_torch.kernels.membench import ops as MB
    g = torch.Generator(device=sess.device)
    xs = tuple(torch.randn(1 << 16, generator=g.manual_seed(i),
                           device=sess.device) for i in range(3))
    out = MB.aligned_sum(xs, block=2048)
    print(f"  aligned_sum   -> {tuple(out.shape)}, {out.dtype}")
    out = MB.strided_sum(xs, delta=4, block=512)
    print(f"  strided_sum   -> {tuple(out.shape)} (delta=4: 4x the fetched "
          f"bytes)")
    i = torch.randint(0, (1 << 16) // 512, (16,), generator=g.manual_seed(9),
                      device=sess.device, dtype=torch.int32)
    out = MB.gather_sum(xs, i, block=512)
    print(f"  gather_sum    -> {tuple(out.shape)} (block indirection: the "
          f"indices read on the device)")

    sweep_demo()
    stream_demo()
    validate_demo()


if __name__ == "__main__":
    if "--sweep-only" in sys.argv[1:]:
        sweep_demo()
        stream_demo()
    elif "--validate" in sys.argv[1:]:
        validate_demo()
    elif "--model" in sys.argv[1:]:
        model_demo()
    else:
        main()
