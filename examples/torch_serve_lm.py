"""Batched serving example on the PyTorch port: continuous batching over
fixed decode slots.

The port of ``examples/serve_lm.py``, with its flags and traffic: a
reduced config, seed-0 weights, ``--requests`` prompts of 8 tokens drawn
from numpy's ``default_rng(0)``.  It serves on the CUDA card unless
``--device cpu`` is given.  ``--params FILE`` serves the weights of a
``torch.save``d state dict instead (``models.convert.from_reference``'s
layout), and ``--dtype`` overrides the config's activation dtype.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen2-7b]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models.convert import load, to_serving


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--params", default=None,
                    help="a torch.save'd state dict to serve")
    ap.add_argument("--dtype", default=None,
                    help="activation dtype (default: the config's)")
    args = ap.parse_args()

    cfg = reduced_config(get_config(args.arch))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = compat.resolve_device(args.device)
    params = None
    if args.params:
        params = to_serving(load(cfg, torch.load(args.params,
                                                 weights_only=True),
                                 device=device))
    # one card (or the CPU): the 1x1 host mesh
    server = BatchedServer(cfg, batch_slots=args.slots, max_len=256,
                           params=params, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 8).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    server.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total = sum(len(r.generated) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"[serve_lm] {args.arch}(reduced): {len(reqs)} requests x "
          f"{args.max_new} tokens on {args.slots} slots")
    print(f"[serve_lm] {total} tokens in {dt:.2f}s = {total/dt:.1f} tok/s "
          f"({where})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt[:4]}... -> "
              f"{r.generated[:8]}...")


if __name__ == "__main__":
    main()
