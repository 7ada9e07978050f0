"""Multi-pod dry-run: prove every (arch x shape x mesh) cell runs sharded,
and extract the roofline inputs of one rank.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for 256 or 512 forced host devices and walks the compiled HLO.  The
port has no compiler: it captures one rank's program.

For each cell, inside a fake process group of the mesh's size
(``mesh.fake_world``: this process is rank 0, collectives return at once)
and a ``FakeTensorMode`` (no tensor is allocated, nothing is launched):

    mesh    = make_production_mesh(multi_pod=...)      16x16 or 2x16x16
    built   = build_step(cfg, shape, tcfg, mesh=mesh)  the sharded step
    params, state, batch, caches placed by the plan    DTensors
    records = capture_call(built.fn, ...)              rank 0's local ops,
                                                       collectives, memory

and the records give the reference's record keys: ``hlo_flops_per_chip``,
``hlo_bytes_per_chip``, ``bytes_by_class``, ``collective_*`` and
``n_collectives`` (charged by ``core/hlo_counter``'s rules,
``workload/capture.py``).  ``memory_analysis`` has the reference's keys
(``hlo.memory_analysis_stats``), from the storages the capture follows
(``workload.capture.capture_call``), at the rank's local shapes:

    argument_size_in_bytes  everything the step takes (parameters,
                            optimizer state, batch; on decode the tokens,
                            the caches and the int32 position)
    output_size_in_bytes    everything it returns
    alias_size_in_bytes     what it returns that it took and updated in
                            place (parameters and optimizer state on
                            train, caches on decode: the reference's
                            donated buffers)
    temp_size_in_bytes      the peak of the live storages the step
                            created, less the outputs it created
    total_bytes             argument + output + temp - alias: the eager
                            peak; ``peak_live_bytes`` is the same number
    generated_code_size_in_bytes, host_*   0 (no compiled code, nothing
                            held on the host)

beside the rank's bytes of each input tree (``param_bytes``,
``opt_bytes``, ``batch_bytes``, ``cache_bytes``).  The temporaries are
eager execution's, each op's result materialized, where the reference's
are XLA's buffer assignment of its fused program.  There is no HLO, so
no archive is written.

The mesh is a CPU mesh by default (``--device-type``): on it DTensor
runs an all-to-all as an all-gather and a chunk, which the capture
records as the all-to-all it stands for; the record names the mesh's
device type.  The mesh's consecutive dims are flattened
(``launch.mesh.init_mesh``), so a reduction over several of them is one
collective, as the reference's.

Results are cached as JSON under ``results/dryrun_torch/``.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from collections import defaultdict

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_status
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (MULTI_POD, MULTI_POD_AXES, POD, POD_AXES,
                                     fake_world, init_mesh)
from repro_torch.launch.steps import TrainConfig, build_step
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.workload.capture import capture_call, fake_mode

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def default_train_config(cfg) -> TrainConfig:
    """Per-arch defaults: >=100B-parameter models keep AdamW moments in
    bf16 (the optimizer-state memory trick: 314B grok would not fit f32
    moments on 256 chips)."""
    if cfg.param_count() >= 1e11:
        return TrainConfig(optimizer=OptimizerConfig(state_dtype="bfloat16"))
    return TrainConfig()


def cell_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> str:
    suffix = f"-{tag}" if tag else ""
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_name}{suffix}.json")


def production_layout(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    return (MULTI_POD, MULTI_POD_AXES) if multi_pod else (POD, POD_AXES)


def summarize(records) -> dict:
    """The reference's per-chip counts from captured records."""
    by_class: dict = defaultdict(float)
    by_kind: dict = defaultdict(float)
    out = dict(flops=0.0, collective_operand_bytes=0.0,
               collective_wire_bytes=0.0, n_collectives=0.0)
    for r in records:
        out["flops"] += r.flops
        for k, v in r.bytes_by_class.items():
            by_class[k] += v
        if r.n_collectives:
            out["collective_operand_bytes"] += r.collective_operand_bytes
            out["collective_wire_bytes"] += r.collective_wire_bytes
            out["n_collectives"] += r.n_collectives
            by_kind[r.opcode] += r.collective_operand_bytes
    out["bytes_by_class"] = dict(sorted(by_class.items()))
    out["total_bytes"] = float(sum(by_class.values()))
    out["collective_by_kind"] = dict(sorted(by_kind.items()))
    return out


#: ``memory_analysis``'s keys of the reference (``hlo.memory_analysis_stats``
#: of a compiled program)
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes", "host_argument_size_in_bytes",
               "host_output_size_in_bytes", "host_temp_size_in_bytes",
               "total_bytes")


def memory_analysis(call, trees: dict) -> dict:
    """The reference's ``memory_analysis`` keys from a captured call
    (``workload.capture.CallMemory``; an eager step runs no generated code
    and holds nothing on the host: those keys are 0), beside the rank's
    bytes of each input tree (``param_bytes``, ``opt_bytes``,
    ``batch_bytes``, ``cache_bytes``).  ``peak_live_bytes`` is the eager
    peak, the arguments and the peak of what the call created:
    ``total_bytes``."""
    got = {"argument_size_in_bytes": call.argument_bytes,
           "output_size_in_bytes": call.output_bytes,
           "temp_size_in_bytes": call.temp_bytes,
           "alias_size_in_bytes": call.alias_bytes,
           "total_bytes": call.total_bytes}
    mem = {k: float(SH.local_bytes(v)) for k, v in trees.items()}
    mem.update({k: got.get(k, 0.0) for k in MEMORY_KEYS})
    mem["peak_live_bytes"] = call.total_bytes
    return mem


def capture_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, mesh,
                 device="cpu") -> tuple[list, dict]:
    """(records, memory) of one rank of the sharded step of (cfg, shape)
    on ``mesh`` (None: the step on one device), captured under a fake
    mode: the step's parameters, optimizer state, batch and caches are
    placed by the plan, then the step runs once.  ``memory`` is
    :func:`memory_analysis` of the call."""
    cfg = dataclasses.replace(cfg, use_kernels=False)
    built = build_step(cfg, shape, tcfg, mesh=mesh, device=device)
    plan = built.plan

    def placed(tree, place):
        return tree if mesh is None else place(tree, plan, mesh)
    with fake_mode():
        params = TF.Transformer(cfg, device=device)
        if mesh is not None:
            ST.place_params(params, cfg, plan, mesh)
        trees = {"param_bytes": dict(params.named_parameters())}
        if shape.kind == "train":
            opt = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
            if mesh is not None:
                opt = ST.place_opt_state(opt, params, cfg, plan, mesh)
            batch = placed(_fake_tree(built.args[2], device), ST.place_batch)
            trees.update(opt_bytes=opt, batch_bytes=batch)
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            batch = placed(_fake_tree(built.args[1], device), ST.place_batch)
            trees["batch_bytes"] = batch
            args = (params, batch)
        else:
            caches = placed(_fake_tree(built.args[2], device),
                            ST.place_caches)
            tokens = placed({"t": _fake_tree(built.args[1], device)},
                            ST.place_batch)["t"]
            # the position, as the reference takes it: an int32 scalar
            index = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                               device=device)
            trees.update(cache_bytes=caches, batch_bytes={"tokens": tokens,
                                                          "index": index})
            args = (params, tokens, caches, index)
    records, call = capture_call(built.fn, *args)
    return records, memory_analysis(call, trees)


def _fake_tree(tree, device):
    """Zero tensors (made under the caller's fake mode) of a meta tree's
    shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tuple(tree.shape), dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _fake_tree(v, device) for k, v in tree.items()}
    return [_fake_tree(v, device) for v in tree]


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             tcfg: TrainConfig | None = None, tag: str = "",
             save: bool = True, cfg_overrides: dict | None = None,
             layout: tuple | None = None, device_type: str = "cpu",
             cfg=None) -> dict:
    """The dry-run record of one cell (saved under ``results/dryrun_torch``
    with ``save``).  ``layout`` (shape, axis names) replaces the
    production mesh (tests use small ones); ``cfg`` replaces the arch's
    config (a reduced one)."""
    if cfg is None:
        cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if tcfg is None:
        tcfg = default_train_config(cfg)
    mesh_shape, axes = layout or production_layout(multi_pod)
    mesh_name = "x".join(map(str, mesh_shape))
    ok, reason = cell_status(cfg, shape)
    record: dict = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "skipped", "reason": reason,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "n_layers": cfg.n_layers,
    }
    if not ok:
        if save:
            _save(record, arch, shape.name, mesh_name, tag)
        return record

    n = 1
    for s in mesh_shape:
        n *= s
    t0 = time.time()
    try:
        with fake_world(n):
            mesh = init_mesh(mesh_shape, axes, device_type=device_type)
            records, mem = capture_step(cfg, shape, tcfg, mesh)
        dt = time.time() - t0
        hc = summarize(records)
        tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                       ("train", "prefill") else 1)
        record.update({
            "status": "ok",
            "reason": "",
            "chips": n,
            "mesh_device": device_type,
            "capture_s": round(dt, 1),
            "n_ops": len(records),
            "memory_analysis": mem,
            "hlo_flops_per_chip": hc["flops"],
            "hlo_bytes_per_chip": hc["total_bytes"],
            "bytes_by_class": hc["bytes_by_class"],
            "collective_operand_bytes": hc["collective_operand_bytes"],
            "collective_wire_bytes": hc["collective_wire_bytes"],
            "collective_by_kind": hc["collective_by_kind"],
            "n_collectives": hc["n_collectives"],
            "tokens_per_step": tokens,
            "model_flops_global": cfg.model_flops(
                tokens, training=shape.kind == "train"),
            "kind": shape.kind,
            "warnings": [],
        })
    except Exception as e:  # noqa: BLE001 — record the failure, it's a bug
        record.update({"status": "failed",
                       "reason": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
    if save:
        _save(record, arch, shape.name, mesh_name, tag)
    return record


def _save(record: dict, arch: str, shape: str, mesh_name: str, tag: str) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(cell_path(arch, shape, mesh_name, tag), "w") as f:
        json.dump(record, f, indent=1, default=float)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--kv-shard", default="auto")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value (repeatable)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device-type", default="cpu",
                    help="the fake mesh's device type (cpu or cuda)")
    args = ap.parse_args()

    def _parse(v: str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        if v in ("true", "false"):
            return v == "true"
        return v

    overrides = {k: _parse(v) for k, v in
                 (item.split("=", 1) for item in args.set)}

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                path = cell_path(arch, shape, mesh_name, args.tag)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {arch} {shape} {mesh_name}")
                    continue
                cfg = get_config(arch)
                tcfg = default_train_config(cfg)
                if args.kv_shard != "auto" or args.grad_compression != "none":
                    tcfg = dataclasses.replace(
                        tcfg, kv_shard=args.kv_shard,
                        grad_compression=args.grad_compression)
                rec = run_cell(arch, shape, multi_pod=mp, tcfg=tcfg,
                               tag=args.tag, cfg_overrides=overrides,
                               device_type=args.device_type)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    gb = rec["memory_analysis"]["total_bytes"] / 1e9
                    extra = (f" mem/chip={gb:.2f}GB capture={rec['capture_s']}s "
                             f"flops/chip={rec['hlo_flops_per_chip']:.3g}")
                elif status == "failed":
                    extra = " " + rec["reason"][:160]
                print(f"[{status}] {arch} {shape} {mesh_name}{extra}", flush=True)


if __name__ == "__main__":
    main()
