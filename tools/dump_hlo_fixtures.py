#!/usr/bin/env python3
"""Write the compiled-HLO fixtures of the port's HLO tests:
``python3 tools/dump_hlo_fixtures.py`` (needs jax and the reference package
``repro``; runs on the CPU, with four host devices for the ``psum`` module).

The PyTorch port reads compiled HLO text as plain data and lowers nothing
itself, so a machine without jax cannot make such text.  This script lowers
a few programs with the reference's jax once and writes, for each, into
``tests/data/torch_hlo/``:

* ``<name>.txt`` — ``compiled.as_text()``, source paths made relative;
* ``<name>.json`` — what the reference computes from that text: its
  ``analyze`` counts (fused and unfused), ``predict_step`` under
  ``tpu_v5e``, a ``build_cell`` row, ``Design.from_hlo``'s LSUs and the
  ``Session.roofline`` row (``numpy-batch``), plus XLA's own
  ``cost_analysis`` numbers, which ``predict_step`` only records.

``tests/test_torch_hlo.py`` holds both packages to these files, so a jax
upgrade that changes the text cannot leave them stale unnoticed, and
``chip_smoke.py``'s ``predict`` phase holds the port to them on the card.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_hlo"


def _programs():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    f32, bf16, i32 = jnp.float32, jnp.bfloat16, jnp.int32

    def spec(shape, dtype=f32):
        return jax.ShapeDtypeStruct(shape, dtype)

    def scan(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]

    def nested_scan(c, xs):
        def step(c, x):
            return jax.lax.scan(lambda c, x: (c * x, None), c, x)[0], None
        return jax.lax.scan(step, c, xs)[0]

    mesh = jax.make_mesh((4,), ("d",))

    def psum(x):
        return jax.lax.psum(jnp.sin(x), "d")

    psum_fn = jax.jit(jax.shard_map(psum, mesh=mesh, in_specs=P("d"),
                                    out_specs=P()))
    # name -> (jitted function, argument specs, chips)
    return {
        "matmul": (jax.jit(lambda a: a @ a), [spec((4096, 4096), bf16)], 1),
        "mlp": (jax.jit(lambda x, w1, w2: jnp.tanh(x @ w1) @ w2),
                [spec((64, 256)), spec((256, 512)), spec((512, 128))], 1),
        "elementwise": (jax.jit(lambda a, b: a + b),
                        [spec((1 << 22,)), spec((1 << 22,))], 1),
        "gather": (jax.jit(lambda e, i: e[i].sum()),
                   [spec((1 << 16, 256)), spec((1 << 14,), i32)], 1),
        "scan": (jax.jit(scan), [spec((8, 128)), spec((12, 128, 128))], 1),
        "nested_scan": (jax.jit(nested_scan),
                        [spec((64,)), spec((5, 7, 64))], 1),
        "sort": (jax.jit(jnp.sort), [spec((4096,))], 1),
        "psum": (psum_fn, [spec((4 * 1024, 256))], 4),
    }


def main() -> int:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    import repro
    from repro.core import hlo as HLO
    from repro.core import hlo_counter as HC
    from repro.core import predictor as PR
    from repro.core import roofline as RL

    # the plain-data forms both packages' tests compare (attribute access
    # only: they read the reference's objects as well as the port's)
    from repro_torch.core.hlo_counter import record as cost_record
    from repro_torch.core.predictor import record as prediction_record

    OUT.mkdir(parents=True, exist_ok=True)
    sess = repro.Session()
    for name, (fn, specs, chips) in _programs().items():
        compiled = fn.lower(*specs).compile()
        # source locations in the metadata, relative to the checkout
        text = compiled.as_text().replace(f"{ROOT}/", "")
        cost = HLO.cost_analysis_stats(compiled)
        pred = PR.predict_step(text, cost, repro.TPU_V5E)
        cell = RL.build_cell(arch=name, shape="fixture", mesh=f"{chips}",
                             chips=chips, hlo_text=text, cost=cost,
                             model_flops_global=pred.flops * chips)
        design = repro.Design.from_hlo(text, name=name)
        roof = sess.roofline(design)
        rec = {
            "name": name,
            "chips": chips,
            "cost": cost,
            "analyze_fused": cost_record(HC.analyze(text)),
            "analyze_unfused": cost_record(HC.analyze(text, fused=False)),
            "predict_step": prediction_record(pred),
            "cell": cell.as_row(),
            "design": {
                "name": design.name, "flops": design.flops,
                "lsus": [[l.lsu_type.value, l.ls_width, l.ls_acc,
                          l.ls_bytes, l.delta, l.is_write, l.name]
                         for l in design.lsus]},
            "roofline": roof.rows()[0],
        }
        (OUT / f"{name}.txt").write_text(text)
        (OUT / f"{name}.json").write_text(
            json.dumps(rec, indent=1, sort_keys=True) + "\n")
        print(f"{name}: {len(text)} chars, flops {pred.flops:.4g}, "
              f"bytes {pred.hbm_bytes:.4g}, {pred.bottleneck}-bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
