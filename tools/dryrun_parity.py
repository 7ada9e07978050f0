#!/usr/bin/env python3
"""The port's dry-run record against the reference's compiled program, on
the host (jax and ``repro`` for the reference, the port beside it; CPU).

    PYTHONPATH=src python3 tools/dryrun_parity.py [--out FILE]

For each cell, rank 0 of ``repro_torch.launch.dryrun.capture_step`` under
a fake process group, and the reference's ``build_step`` lowered and
compiled for the mesh's count of forced host devices in a subprocess, read
with the port's ``core/hlo_counter`` and ``core/hlo``.  Prints one JSON
object: per cell the products (sums, and the ones only one side has),
the ``memory_analysis`` of both and the ratio of their totals, the
collectives of both by kind (count, operand and wire bytes), every kind
whose wire bytes differ by more than 5 % of the reference's, and for two
cells the ranking of the reference's candidates (``default_candidates``):
the reference's ``_autotune`` order, the port's, and the port's with the
reference's bytes by class swapped in.

The cells are the five of ``tests/test_torch_dryrun_parity.py``, at
``reduced_config`` widths (S 16), among them ``pod-heads``, qwen2-7b's
decode with the pod cell's 28 query and 4 kv heads on the 16x16 mesh
(B 16), the uneven head split of the pod at a width the host compiles in
seconds, and qwen3-moe's decode on 4x2 (the sort semantics on a mesh).
All numbers are CPU counts.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
#: cell -> (arch, kind, mesh shape, config overrides, S, B)
CELLS = {
    "qwen2-7b/decode/2x4": ("qwen2-7b", "decode", (2, 4), {"n_heads": 6},
                            16, 8),
    "stablelm-3b/train/4x2": ("stablelm-3b", "train", (4, 2), {}, 16, 8),
    "qwen3-moe/prefill/4x2": ("qwen3-moe-235b-a22b", "prefill", (4, 2), {},
                              16, 8),
    "pod-heads": ("qwen2-7b", "decode", (16, 16),
                  {"n_heads": 28, "n_kv_heads": 4}, 16, 16),
    "qwen3-moe/decode/4x2": ("qwen3-moe-235b-a22b", "decode", (4, 2), {},
                             16, 8),
}

_REFERENCE = r"""
import dataclasses, json, math, os, sys
arch, kind, shape, over, S, B = json.loads(sys.argv[1])
os.environ['XLA_FLAGS'] = ('--xla_force_host_platform_device_count=%d'
                           % math.prod(shape))
os.environ['JAX_PLATFORMS'] = 'cpu'
from repro.compat import make_mesh
from repro.configs import ARCHS, reduced_config
from repro.configs.shapes import ShapeSpec
from repro.core import hlo as HLO
from repro.launch.steps import TrainConfig, build_step
mesh = make_mesh(tuple(shape), ('data', 'model'))
cfg = dataclasses.replace(reduced_config(ARCHS[arch]), **over)
built = build_step(cfg, ShapeSpec('c', S, B, kind), mesh, TrainConfig())
compiled = built.fn.lower(*built.args).compile()
out = {'hlo': compiled.as_text(),
       'memory': HLO.memory_analysis_stats(compiled)}
if sys.argv[3] == 'rank':
    from repro.core import autotune as AT
    res = AT._autotune(cfg, ShapeSpec('c', S, B, kind), mesh, cache=False)
    out['ranking'] = [t.candidate.name for t in res]
    out['records'] = {}
    for c in AT.default_candidates(kind):
        try:
            out['records'][c.name] = AT.analyze_candidate(
                cfg, ShapeSpec('c', S, B, kind), mesh, c, None)
        except Exception:
            out['records'][c.name] = None
json.dump(out, open(sys.argv[2], 'w'))
"""
#: cells whose ``default_candidates`` are ranked on both sides
RANKED = ("qwen2-7b/decode/2x4", "stablelm-3b/train/4x2")


def reference(cell) -> dict:
    arch, kind, shape, over, S, B = CELLS[cell]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "ref.json"
        subprocess.run([sys.executable, "-c", _REFERENCE,
                        json.dumps([arch, kind, shape, over, S, B]),
                        str(out), "rank" if cell in RANKED else "-"],
                       check=True, env=env, timeout=900,
                       capture_output=True)
        return json.loads(out.read_text())


def port(cell):
    import math

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_world, init_mesh
    arch, kind, shape, over, S, B = CELLS[cell]
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), **over)
    with fake_world(math.prod(shape)):
        mesh = init_mesh(shape, AXES, device_type="cpu")
        return DR.capture_step(cfg, ShapeSpec("c", S, B, kind),
                               DR.TrainConfig(), mesh)


def _dots(text: str) -> list[float]:
    """Every dot of a module by its FLOPs, as many times as loops run it."""
    from repro_torch.core import hlo_counter as HC
    an = HC.Analyzer(text)
    dots = []

    def comp(c, mult):
        for ins in c.instrs:
            if ins.opcode == "dot":
                dots.extend([HC._dot_flops(ins, c)] * mult)
            elif ins.opcode == "while":
                body = an.comps.get(HC._called(ins.rest, "body") or "")
                cond = an.comps.get(HC._called(ins.rest, "condition") or "")
                if body is not None:
                    comp(body, mult * (HC._while_trips(cond) if cond else 1))
            else:
                for key in ("calls", "to_apply", "true_computation",
                            "false_computation", "branch_computations"):
                    callee = HC._called(ins.rest, key)
                    if callee in an.comps:
                        comp(an.comps[callee], mult)
    comp(an.entry_comp(), 1)
    return sorted(dots)


def _by_kind(rows) -> dict:
    out = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for kind, operand, wire in rows:
        out[kind][0] += 1
        out[kind][1] += operand
        out[kind][2] += wire
    return dict(out)


def ranking(cell, ref: dict) -> dict:
    """The port's records of the reference's candidates ranked as captured
    and with the reference's bytes by class swapped in, beside the
    reference's ``_autotune`` order."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import autotune as AT
    arch, kind, shape, over, S, B = CELLS[cell]
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), **over)
    got = {}
    for c in AT.default_candidates(kind):
        try:
            got[c.name] = AT.analyze_candidate(
                cfg, ShapeSpec("c", S, B, kind), (shape, AXES), c)
        except ValueError:
            got[c.name] = None

    def order(records):
        names = [k for k, r in records.items() if r is not None]
        scores = AT.rank_records([records[k] for k in names], device="cpu")
        return [names[i] for i in scores["order"]]
    swapped = {k: r and {**r, "bytes_by_class":
                         ref["records"][k]["bytes_by_class"]}
               for k, r in got.items()}
    return {"reference": ref["ranking"], "port": order(got),
            "port_with_reference_bytes": order(swapped)}


def compare(cell) -> dict:
    from repro_torch.core import hlo as H
    ref = reference(cell)
    records, mem = port(cell)
    ref_dots = _dots(ref["hlo"])
    got = sorted(r.flops for r in records if r.op_class == "matmul")
    only_ref = list((collections.Counter(ref_dots)
                     - collections.Counter(got)).elements())
    only_port = list((collections.Counter(got)
                      - collections.Counter(ref_dots)).elements())
    rc = _by_kind((op.kind, op.operand_bytes, op.wire_bytes)
                  for op in H.parse_collectives(ref["hlo"]))
    pc = _by_kind((r.opcode, r.collective_operand_bytes,
                   r.collective_wire_bytes) for r in records
                  if r.n_collectives)
    wire = sum(v[2] for v in rc.values())
    big = {k: [pc.get(k, [0, 0, 0])[2], rc.get(k, [0, 0, 0])[2]]
           for k in set(rc) | set(pc)
           if abs(pc.get(k, [0, 0, 0])[2] - rc.get(k, [0, 0, 0])[2])
           > 0.05 * wire}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes", "total_bytes")
    out = {
        "products": {"reference": sum(ref_dots), "port": sum(got),
                     "n_reference": len(ref_dots), "n_port": len(got),
                     "only_reference": only_ref, "only_port": only_port},
        "memory": {"reference": {k: ref["memory"].get(k) for k in keys},
                   "port": {k: mem[k] for k in keys},
                   "total_ratio": mem["total_bytes"]
                   / ref["memory"]["total_bytes"]},
        "collectives": {"reference": rc, "port": pc,
                        "wire_reference": wire,
                        "wire_port": sum(v[2] for v in pc.values()),
                        "n_reference": sum(v[0] for v in rc.values()),
                        "n_port": sum(v[0] for v in pc.values()),
                        "over_5pct_of_wire": big},
    }
    if "ranking" in ref:
        out["ranking"] = ranking(cell, ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("cells", nargs="*", default=list(CELLS))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    result = {cell: compare(cell) for cell in args.cells}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
