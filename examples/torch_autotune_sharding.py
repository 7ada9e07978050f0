"""The paper's end use-case on the PyTorch port: choose a deployment
configuration from captured steps only — no accelerator time for the
steps themselves.

Compares candidate knob settings (KV-cache sharding axis, remat policy,
attention tiles, gradient compression) by capturing each candidate's step
as one rank of the host mesh runs it (FakeTensorMode: nothing is
allocated or launched) and ranking them with the analytical model
(``core.autotune``), scored on the session's device.

The port of ``examples/autotune_sharding.py``.  The host mesh is the ranks
this process has: one, a 1x1 ``("data", "model")`` mesh of an in-process
group.  The ranking is scored on the CUDA card unless ``--device cpu`` is
given.  Captures are not cached on disk.

Run:  PYTHONPATH=src python examples/torch_autotune_sharding.py [--kind decode]
"""
import argparse

from repro_torch import Session
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.mesh import make_host_mesh, threaded_ranks


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="command-r-35b")
    ap.add_argument("--kind", default="decode", choices=["train", "decode"])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args()

    cfg = reduced_config(get_config(args.arch))
    shape = (ShapeSpec("d", 256, 8, "decode") if args.kind == "decode"
             else ShapeSpec("t", 128, 8, "train"))
    sess = Session(device=args.device)

    def rank(_):
        # the capture runs on fake CPU tensors whatever device scores it
        mesh = make_host_mesh(device_type="cpu")
        print(f"[autotune] {args.arch} (reduced) {args.kind} on "
              f"{tuple(mesh.shape)} mesh — capturing candidates...")
        return sess.autotune(cfg, shape, mesh, cache=False)
    results = threaded_ranks(1, rank)[0]
    print(f"{'candidate':18s} {'t_step':>10s} {'bottleneck':>12s} "
          f"{'mem':>8s} {'compile':>8s}")
    for r in results:
        s = r.summary()
        print(f"{s['name']:18s} {s['t_step_ms']:8.3f}ms {s['bottleneck']:>12s} "
              f"{s['mem_gb']:6.2f}GB {s['compile_s']:6.1f}s")
    best = results[0].candidate.name
    print(f"[autotune] winner: {best} — chosen without ever running a step.")


if __name__ == "__main__":
    main()
