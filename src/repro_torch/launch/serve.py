"""Serving driver: batched prefill + decode with a static-shape KV cache.

Port of ``repro.launch.serve``: a request pool fills fixed batch slots;
finished sequences free their slot, which is refilled at once while the
rest of the batch keeps decoding.  A newcomer's prompt is fed one token a
step through the shared decode step (prefill by decode), with one shared
position index for the batch, as in the reference; steps that emit no
token are timed apart from the decode clock (``metrics``).  A refilled
slot keeps the recurrent state its last request left (the reference's
semantics: nothing resets it), which the attention caches hide behind
the position index and the RG-LRU, mLSTM and sLSTM states do not.

    python -m repro_torch.launch.serve --arch qwen2-7b          # the card
    python -m repro_torch.launch.serve --arch recurrentgemma-9b
    python -m repro_torch.launch.serve --arch internvl2-2b
    python -m repro_torch.launch.serve --arch xlstm-1.3b --local --device cpu
    python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --local --device cpu

The MoE decoders route every served step with the sort semantics (the
server prefills by decode); at their published sizes they exceed one card
(qwen3-moe-235b-a22b runs on the card as one chip's share of its
expert-parallel deployment in ``chip_smoke.py``'s model phase).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import (make_decode_step, place_caches,
                                      place_params)
from repro_torch.models import transformer as TF
from repro_torch.models.convert import to_serving


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Fixed-slot continuous batching on top of the decode step.

    ``params`` defaults to the reference's seed-0 random weights made on
    ``device`` and cast once for serving (``convert.to_serving``);
    ``device`` defaults to the CUDA card and raises without one.  With a
    ``mesh`` (a ``DeviceMesh``; every rank runs the server) the plan is
    the reference's (``make_plan(cfg, mesh, global_batch=batch_slots)``),
    the weights and caches are DTensors placed by it and the decode step
    is the sharded one; the config must take the plain path.
    """

    def __init__(self, cfg, mesh=None, *, batch_slots: int = 4,
                 max_len: int = 256, params=None, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = compat.resolve_device(device)
        self.max_len = max_len
        self.slots = batch_slots
        self.params = params if params is not None else to_serving(
            TF.init_params(cfg, seed=0, device=self.device))
        self.caches = TF.init_caches(cfg, batch_slots, max_len,
                                     device=self.device)
        self.plan = None
        if mesh is not None:
            self.plan = SH.make_plan(cfg, mesh, global_batch=batch_slots)
            place_params(self.params, cfg, self.plan, mesh)
            self.caches = place_caches(self.caches, self.plan, mesh)
        self._decode = make_decode_step(cfg, mesh, self.plan)
        # per-slot position counters; -1 = free slot
        self.pos = np.full((batch_slots,), -1, np.int64)
        self.active: dict[int, Request] = {}
        self.pending: list[Request] = []
        self._prefill_queue: dict[int, list[int]] = {}
        # prompt-feeding steps emit no tokens but take a decode step's time;
        # run() buckets every step by whether it produced a token, so decode
        # throughput is read from decode_s alone
        self.metrics = {"prefill_s": 0.0, "decode_s": 0.0,
                        "prefill_steps": 0, "decode_steps": 0,
                        "new_tokens": 0}

    # ------------------------------------------------------------ pool
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _fill_slots(self) -> None:
        for slot in range(self.slots):
            if self.pos[slot] >= 0 or not self.pending:
                continue
            req = self.pending.pop(0)
            self.active[slot] = req
            self.pos[slot] = 0
            self._prefill_queue[slot] = list(req.prompt)

    def step(self) -> int:
        """One global decode step across all slots; returns the number of
        tokens appended (0 for a pure prefill step).  Idle slots feed token
        0 and their logits are ignored."""
        self._fill_slots()
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, req in self.active.items():
            q = self._prefill_queue.get(slot) or []
            if q:
                tokens[slot, 0] = q.pop(0)
            elif req.generated:
                tokens[slot, 0] = req.generated[-1]
            elif req.prompt:
                tokens[slot, 0] = req.prompt[-1]
        # one shared index for the static-shape cache: slots stay aligned
        # because every slot advances every step
        index = int(self.pos[max(self.active) if self.active else 0])
        next_tok, _, self.caches = self._decode(
            self.params, torch.from_numpy(tokens).to(self.device), self.caches,
            torch.tensor([index], device=self.device))
        if hasattr(next_tok, "full_tensor"):
            next_tok = next_tok.full_tensor()
        next_np = next_tok.cpu().numpy()
        n_new = 0
        for slot, req in list(self.active.items()):
            self.pos[slot] += 1
            if self._prefill_queue.get(slot):
                continue
            req.generated.append(int(next_np[slot, 0]))
            n_new += 1
            if (len(req.generated) >= req.max_new
                    or self.pos[slot] >= self.max_len - 1):
                req.done = True
                del self.active[slot]
                self.pos[slot] = -1
        return n_new

    def run(self, requests: list[Request], *, max_steps: int = 10_000
            ) -> list[Request]:
        for r in requests:
            self.submit(r)
        steps = 0
        m = self.metrics
        while (self.pending or self.active) and steps < max_steps:
            t0 = time.perf_counter()
            n_new = self.step()
            dt = time.perf_counter() - t0
            if n_new:
                m["decode_s"] += dt
                m["decode_steps"] += 1
                m["new_tokens"] += n_new
            else:
                m["prefill_s"] += dt
                m["prefill_steps"] += 1
            steps += 1
        return list(requests)


def cli_requests(cfg, n: int, max_new: int) -> list[Request]:
    """The reference CLI's traffic: ``n`` requests of 8-token prompts drawn
    from numpy's ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).tolist(),
                    max_new=max_new)
            for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--local", action="store_true",
                    help="the reduced config (reduced_config)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.local:
        cfg = reduced_config(cfg)
    server = BatchedServer(cfg, batch_slots=args.batch_slots,
                           max_len=args.max_len, device=args.device)
    reqs = cli_requests(cfg, args.requests, args.max_new)
    server.run(reqs)
    m = server.metrics
    total_new = sum(len(r.generated) for r in reqs)
    tok_s = total_new / m["decode_s"] if m["decode_s"] > 0 else 0.0
    print(f"[serve] {server.device}: {len(reqs)} requests, {total_new} tokens: "
          f"prefill {m['prefill_s']:.2f}s ({m['prefill_steps']} steps), "
          f"decode {m['decode_s']:.2f}s ({m['decode_steps']} steps, "
          f"{tok_s:.1f} tok/s)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")


if __name__ == "__main__":
    main()
