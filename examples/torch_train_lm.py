"""End-to-end training driver on the PyTorch port: train a small dense LM
for a few hundred steps with the production stack (the step, deterministic
data, async atomic checkpoints, preemption handling, straggler watchdog).

The port of ``examples/train_lm.py``, with its ``SMALL`` (~25M) and
``FULL`` (~110M) configurations and flags; ``--arch`` trains any assigned
architecture's reduced config.  Training takes the plain path (the
kernels have no backward).  It trains on the CUDA card unless
``--device cpu`` is given; a run resumes from the latest checkpoint in
``--ckpt-dir``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--full] [--steps N]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.steps import TrainConfig, build_step
from repro_torch.launch.train import train_loop
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig

SMALL = ModelConfig(
    name="lm-25m", family="dense", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=2, d_ff=1536, vocab_size=32768, block_pattern=("attn",),
    remat=False,
)

FULL = ModelConfig(
    name="lm-110m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=3072, vocab_size=32768, block_pattern=("attn",),
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--arch", default=None, help="assigned arch id (reduced)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args()

    if args.arch:
        cfg = reduced_config(get_config(args.arch))
    else:
        cfg = FULL if args.full else SMALL
    cfg = dataclasses.replace(cfg, use_kernels=False)
    steps = args.steps or (300 if args.full else 200)
    print(f"[train_lm] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{steps} steps, seq={args.seq_len}, batch={args.batch}")

    # one card (or the CPU): the 1x1 host mesh
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        lr=6e-4, warmup_steps=max(10, steps // 20), total_steps=steps))
    shape = ShapeSpec("train", args.seq_len, args.batch, "train")
    built = build_step(cfg, shape, tcfg, device=args.device)
    out = train_loop(
        cfg, built, tcfg, steps=steps, ckpt_dir=args.ckpt_dir,
        data_cfg=DataConfig(seq_len=args.seq_len, batch_size=args.batch),
        data_path=args.data, ckpt_every=50, log_every=10)
    print(f"[train_lm] final: {out}")


if __name__ == "__main__":
    main()
