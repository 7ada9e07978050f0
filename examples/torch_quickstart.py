"""Quickstart on the PyTorch port: the paper's workflow end to end.

1. Faithful layer — estimate an FPGA kernel's execution time from its LSU
   structure (Eqs. 1-10) and compare against the DRAM-simulator oracle.
2. Model layer — capture a small training step, *without running it*,
   classify its memory traffic, and predict the step time / bottleneck.

The port of ``examples/quickstart.py``: it imports ``repro_torch`` only.
The estimates run on the CUDA card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch import DDR4_1866, Design, LsuType, Session
from repro_torch.core.dramsim import simulate


def faithful_demo(sess: Session) -> None:
    print("=" * 64)
    print("1. Faithful FPGA model (paper Eqs. 1-10)")
    print("=" * 64)
    for n_ga in (1, 2, 4):
        design = Design.microbench(LsuType.BC_ALIGNED, n_ga=n_ga, simd=16,
                                   n_elems=1 << 20)
        est = sess.estimate(design)
        sim = simulate(list(design.lsus), DDR4_1866)
        print(f"  sum-reduction #ga={n_ga}: "
              f"T_est={est.t_exe*1e3:6.3f} ms  T_sim={sim.t_total*1e3:6.3f} ms  "
              f"bw={est.effective_bandwidth/1e9:5.2f} GB/s  "
              f"memory_bound={est.memory_bound}")
    print("  -> the 14.9 -> 10.7 GB/s bandwidth drop with #lsu is the "
          "paper's Fig. 4a result.\n")


def model_demo(sess: Session) -> None:
    print("=" * 64)
    print("2. Model layer: predict a training step before running it")
    print("=" * 64)
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.autotune import predict_record
    from repro_torch.launch.dryrun import capture_step, summarize
    from repro_torch.launch.steps import TrainConfig

    cfg = reduced_config(ARCHS["qwen2-7b"])
    # one device's step, captured op by op on fake tensors: nothing is
    # allocated or launched (seconds on a CPU)
    records, _ = capture_step(cfg, ShapeSpec("demo", 128, 4, "train"),
                              TrainConfig(), None, device=sess.device)
    pred = predict_record(summarize(records), sess.hw, device=sess.device)
    print(f"  arch: {cfg.name} (reduced), mesh: one device, "
          f"model hardware: {sess.hw.name}")
    print(f"  FLOPs/step:      {pred.flops:.3g}")
    print(f"  HBM bytes/step:  {pred.hbm_bytes:.3g}")
    for c in pred.memory_components:
        print(f"    {c.name:10s} {c.nbytes:12.3g} B")
    print(f"  t_compute={pred.t_compute*1e6:8.1f} us  "
          f"t_memory={pred.t_memory*1e6:8.1f} us  "
          f"t_collective={pred.t_collective*1e6:8.1f} us")
    print(f"  bottleneck: {pred.bottleneck}  "
          f"(arithmetic intensity {pred.arithmetic_intensity:.1f} FLOP/B, "
          f"{sess.hw.name} ridge ~{sess.hw.ridge_flops_per_byte:.0f})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args()
    sess = Session(dram=DDR4_1866, device=args.device)
    faithful_demo(sess)
    model_demo(sess)


if __name__ == "__main__":
    main()
