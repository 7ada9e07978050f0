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

The mesh, as the reference chooses it: a run of one process trains on
one card; under ``torchrun`` (``WORLD_SIZE`` > 1; the group is NCCL on
cards, gloo on the CPU) ``--local`` trains on the host mesh of the ranks
that exist and otherwise on the production mesh, 16x16, or 2x16x16 with
``--multi-pod``, which raises when the world holds fewer ranks than the
mesh.  Multi-card NCCL runs are written and not verified here.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import make_dataset
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
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
    place = {}
    if built.mesh is not None:
        ST.place_params(params, cfg, built.plan, built.mesh)
        opt_state = ST.place_opt_state(opt_state, params, cfg, built.plan,
                                       built.mesh)
        opt = dict(built.shardings["opt"], step=None)
        place = dict(shardings={"params": built.shardings["params"],
                                "opt": opt}, mesh=built.mesh)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(train_state(params, opt_state),
                                         **place)
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


def choose_mesh(*, local: bool, multi_pod: bool, device=None):
    """The reference's mesh choice over the ranks this run has: None (one
    card) for a run of one process, but for the production mesh it asks
    for (``multi_pod`` without ``local``); else the host
    mesh (``local``) or the production mesh, which raises when the world
    is smaller than it.  Under ``torchrun`` the group is made here and
    left to the process: the run ends with it."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and (local or not multi_pod):
        return None                     # the 1x1 host mesh: one card
    device_type = compat.resolve_device(device).type
    if world > 1 and not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if local:
        return make_host_mesh(device_type=device_type)
    need = 512 if multi_pod else 256
    if world < need:
        raise RuntimeError(
            f"the {'2x16x16' if multi_pod else '16x16'} mesh needs {need} "
            f"ranks; this run has {world} (launch it with torchrun on "
            f"{need} cards, or use launch.dryrun to capture one rank)")
    return make_production_mesh(multi_pod=multi_pod, device_type=device_type)


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

    cfg = get_config(args.arch)
    if args.local:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, use_kernels=False)
    try:
        mesh = choose_mesh(local=args.local, multi_pod=args.multi_pod,
                           device=args.device)
    except RuntimeError as e:
        ap.error(str(e))
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 20),
                                  state_dtype=args.opt_state_dtype),
        grad_compression=args.grad_compression)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    built = build_step(cfg, shape, tcfg, mesh=mesh, device=args.device)
    data_cfg = DataConfig(seq_len=args.seq_len, batch_size=args.batch)
    out = train_loop(cfg, built, tcfg, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, data_cfg=data_cfg,
                     data_path=args.data)
    print("[train] done:", out)


if __name__ == "__main__":
    main()
