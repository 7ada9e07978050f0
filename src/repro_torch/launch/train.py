"""The trainer: data -> step -> checkpoint, with fault tolerance wired.

Port of ``repro.launch.train`` on one card:

* auto-resume from the latest atomic checkpoint (data is a function of
  the step, so a restart is exact);
* SIGTERM preemption -> checkpoint -> clean exit;
* a straggler watchdog on per-step wall times;
* asynchronous checkpoints off the training thread;
* the optimizer-state dtype and gradient compression (``TrainConfig``).

The step runs the plain path (``use_kernels=False``): the kernels have no
backward (``launch/steps.py``).  ``python -m repro_torch.launch.train
--arch stablelm-3b --local --device cpu`` trains a ``reduced_config`` on
the CPU; without ``--device`` it runs on the CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import make_dataset
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.steps import BuiltStep, TrainConfig, build_step
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.runtime import PreemptionHandler, StepWatchdog


def train_state(params: TF.Transformer, opt_state: dict) -> dict:
    """The checkpointed tree: the model's state dict beside the optimizer
    state, sharing their tensors."""
    return {"params": dict(params.named_parameters()), "opt": opt_state}


def train_loop(cfg, built: BuiltStep, tcfg: TrainConfig, *,
               steps: int, ckpt_dir: str, data_cfg: DataConfig,
               ckpt_every: int = 50, log_every: int = 10,
               data_path: str | None = None,
               preemption: PreemptionHandler | None = None) -> dict:
    """Train ``steps`` steps on ``built.device`` from seed-0 parameters, or
    from the latest checkpoint in ``ckpt_dir``.  Returns the final metrics
    as floats with ``final_step``, ``median_step_s`` and ``stragglers``."""
    ckpt = CheckpointManager(ckpt_dir)
    watchdog = StepWatchdog()
    preemption = preemption or PreemptionHandler().install()
    dataset = make_dataset(cfg, data_cfg, data_path)

    params = TF.init_params(cfg, seed=0, device=built.device)
    opt_state = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(train_state(params, opt_state))
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(state["params"][name])
        opt_state = state["opt"]
        print(f"[train] resumed from step {start_step}")

    metrics = {}
    step = start_step
    for step in range(start_step, steps):
        watchdog.start_step(step)
        # the step moves the batch to the device
        params, opt_state, metrics = built.fn(params, opt_state,
                                              dataset.get_batch(step))
        if built.device.type == "cuda":
            torch.cuda.synchronize(built.device)
        dt = watchdog.end_step()
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, train_state(params, opt_state),
                      blocking=False)
        if preemption.should_stop:
            print(f"[train] preempted at step {step}; checkpointing")
            break
    ckpt.save(step + 1, train_state(params, opt_state), blocking=True)
    ckpt.wait()
    return {k: float(v) for k, v in metrics.items()} | {
        "final_step": step + 1,
        "median_step_s": watchdog.median_step_time,
        "stragglers": len(watchdog.straggler_steps),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_ckpt"))
    ap.add_argument("--local", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--opt-state-dtype", default="float32")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.multi_pod:
        ap.error("--multi-pod needs the mesh and sharding modules, which are "
                 "not yet ported; the port trains on one card")

    cfg = get_config(args.arch)
    if args.local:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, use_kernels=False)
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 20),
                                  state_dtype=args.opt_state_dtype),
        grad_compression=args.grad_compression)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    built = build_step(cfg, shape, tcfg, device=args.device)
    data_cfg = DataConfig(seq_len=args.seq_len, batch_size=args.batch)
    out = train_loop(cfg, built, tcfg, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, data_cfg=data_cfg,
                     data_path=args.data)
    print("[train] done:", out)


if __name__ == "__main__":
    main()
