#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one H100: ``python3 chip_smoke.py``.

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/csrc``, holds each of the eight kernels (the seven TPU
kernels' ports and the MoE combine, which replaces none) against its plain
PyTorch version on the card (at the reference's test shapes, at the
main path's card shapes, at the MoE combine's expert-parallel prefill
shape, at the model zoo's other head sizes and at the
edges of the D = 256 decode and D = 80 flash instances' tiling, where
one deliberately broken plain version per case must fall outside the
bound), drives the port's main path — estimate and sweep with
``Session(backend="torch")`` on the card and on the CPU; streaming sweeps
of the reference's 1,024,000- and 10,240,000-point grids through the
device fold, the host fold, two worker processes and constraints, each
held bit-equal to the others; the reference's 1m optimizer contract; then
``Session.validate`` over the seven card-scale kernels — and then the
model paths, each arch at full width served through ``make_prefill_step``,
``make_decode_step`` at depth and ``BatchedServer``, each kernel checked
on the inputs of its first call and the logits against the plain path's:
qwen2-7b (flash attention on prefill, decode attention over 32,768
cached rows), recurrentgemma-9b (the RG-LRU scan and windowed flash
attention on prefill, decode attention over the 2,048-row rings at
``decode_32k``'s batch of 128 and at ``long_500k``), xlstm-1.3b (the
mLSTM kernel on prefill; its decode runs no kernel), qwen3-moe-235b-a22b
as one chip's share of its expert-parallel deployment (8 of 128 experts,
47 of 94 layers; flash attention and the MoE combine on prefill, decode
attention over 32,768 rows, the MoE routing recorded), hubert-xlarge (non-causal flash
attention on its feature rows; an encoder, prefill only) and
internvl2-2b (flash attention over patch rows and text, decode attention
at B 16).  Then ``train``: stablelm-3b trained on the card through
``make_train_step`` and ``train_loop`` on the plain path (the card held to
the CPU at ``reduced_config``, five steps at full width and depth, resume
and a bf16 checkpoint; no kernel launches), and the trained model served
through K5 and K4 by the model phase's checks.  It times each kernel
beside its bound, its plain version
and, where one exists, the one PyTorch call that computes the same
function.  Four phases without kernels follow: ``workload`` (whole-model
estimation: qwen2-7b's train, prefill and decode captured at full width
under FakeTensorMode, composed on the card under two hardware specs,
swept, and predicted by a session calibrated with the validate report
beside the model phase's measured steps), ``serve`` (the
reference's ``serve_smoke`` traffic against
``Session(device="cuda").serve()``, every served estimate bit-equal to a
serial one), ``paper`` (Table IV through the scalar model and the card's
torch backend, Table V and Fig. 5 with the port's DRAM simulator and
baselines) and ``predict`` (``Session.predict``, ``Design.from_hlo`` and
``Session.roofline`` on the committed HLO fixtures, held to the
reference's results in ``tests/data/torch_hlo/``).  Last, ``mesh`` (the
plain path; no kernel launches): the dry-run of qwen2-7b and grok-1-314b
at ``decode_32k`` and stablelm-3b at ``train_4k`` (cut to 4 layers) on
the 16x16 pod mesh, one rank captured under a fake 256-rank group;
qwen2-7b (4 layers) and reduced stablelm-3b's train step sharded on a
2x2 mesh of four threaded ranks on the card, held to the unsharded
model; ``Session(device="cuda").autotune`` on the qwen2-7b cell; and
the 2x2 checkpoint resumed on 4x1.  Then ``examples``: the port's five
examples (``examples/torch_*.py``), each a process of its own on the card
with small arguments, each exiting 0, the explorer's ``--validate``
launching all seven kernels.

Prints one JSON object per phase (env, build with each kernel function's
counts of Hopper instructions in its SASS, parity, head_sizes, estimator,
stream, optimize, validate, model once per arch, train and the trained
model, launches, workload, serve, paper, predict, mesh, examples);
then the ``{"kernels": [...]}`` line, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed; so does a machine without
a CUDA device, or a directory that holds this script without the repo.
Imports nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import functools
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet) the bounds are taken against.
PEAK_BYTES_PER_S = 3.35e12        # HBM3
PEAK_FP32_FLOPS = 67e12           # fp32 outside the tensor cores
PEAK_BF16_TENSOR_FLOPS = 989e12   # bf16 on the tensor cores, dense

#: Tolerances of the kernel-vs-plain checks, |got - want| <= atol + rtol *
#: |want| + of_max * max|want| + of_spread * spread, where spread is a
#: per-element scale that the case computes (``spread``).  The membench sums add in the plain
#: version's order (bit-equality expected).  At the test shapes every other
#: kernel gets the reference's own kernel tolerances (tests/test_kernels.py;
#: the RG-LRU scan has its own).  At the card shapes:
#: * decode attention's outputs are ~sqrt(e / S) ~ 0.01, so the bound
#:   scales with the data: 1e-2 of the largest output, about 1.3 bf16 ulps
#:   of it -- both sides sum in fp32 and round once to bf16;
#: * flash attention rounds P to bf16 for the tensor cores (its denominator
#:   sums the unrounded P), which moves an output by at most
#:   2^-9 * sum_j p_j |v_j|, and both sides round once to bf16 (at most
#:   2^-7 of |want| apart): rtol 2e-2 plus 2^-8 of sum_j p_j |v_j| -- the
#:   plain version run on |v| -- per element, twice that rounding's reach.
#:   On the long rows, where nearly all the work is, that is ~3e-3 against
#:   outputs of ~3e-2; a row of one key may move by ~1e-2;
#: * the RG-LRU scan is float32 on both sides, one fmaf a step against the
#:   plain version's multiply-add: 1e-5 relative plus 1e-5 of the largest;
#: * the mLSTM's tensor-core kernels hand three operands to the tensor cores
#:   in bf16 that the plain version keeps in fp32: the entering state C_j
#:   (q C_j), the scores s (s v), and k e^(total - cum + li) (the state
#:   update).  Each rounding moves a term of the numerator by at most 2^-9
#:   of its magnitude, and a term meets at most two of them (C_j is built
#:   from rounded k e^..., then rounded itself; s v meets one), so the
#:   numerator moves by at most 2^-8 of the same arithmetic run on |q|,
#:   |k|, |v| with the same gates.  Divided by the true max(|den|, 1)
#:   (the denominator is fp32 on both sides) that is the per-element
#:   spread (``mlstm_chunk_spread``); the bound is twice that reach,
#:   2^-7 * spread, plus rtol 1e-2 for the two roundings of the output to
#:   bf16 (each within 2^-8 of |want|).  The skipped-chunk fault must fall
#:   outside it, and the parity row prints by what factor.
#: * the MoE combine sums a token's k weighted rows in f32 in slot order
#:   and rounds once; the plain version sums the same f32 terms in another
#:   order, which can move a rounded output by one unit in the last place
#:   of bf16 at the scale of the terms' absolute sum (also where they
#:   cancel and the output itself is near zero).  Its spread
#:   (``combine_spread``) is that unit where a token has two live slots or
#:   more and 0 elsewhere: a token of at most one live slot is held bit
#:   for bit;
#: * the model phase's logits (``logits_check``): the kernel path and the
#:   plain path (``use_kernels=False``) differ only inside the kernels, but
#:   both round every activation of every layer to bf16, and once they part
#:   each rounding goes its own way, so no fixed bound follows from the
#:   kernels' own.  The run measures the noise instead: the plain path run
#:   again with f32 activations on the same weights (E).  By the triangle
#:   inequality |kernel - plain| <= |kernel - E| + |plain - E|, and the
#:   kernel path is no less accurate than the plain one but for the
#:   kernels' own roundings (flash rounds P to bf16, the mLSTM three
#:   operands; the RG-LRU scan is f32 on both paths), at most half
#:   again of the plain path's error; so |kernel - plain| <= 2.5 |plain -
#:   E| in relative L2 over the real vocabulary.  Two bf16 paths with
#:   independent rounding errors sit about sqrt(2) |plain - E| apart.
#:   On prefill the same bound holds at the last position after every
#:   layer: where a random-weight model amplifies rounding until the
#:   final logits of its bf16 and f32 runs are unrelated (xlstm-1.3b),
#:   the early layers still bound the kernels.
TOL = {"membench": dict(rtol=1e-6, atol=0.0, of_max=0.0),
       "float32": dict(rtol=2e-5, atol=2e-5, of_max=0.0),
       "bfloat16": dict(rtol=2e-2, atol=2e-2, of_max=0.0),
       "rglru_float32": dict(rtol=1e-4, atol=1e-4, of_max=0.0),
       "rglru_bfloat16": dict(rtol=3e-2, atol=3e-2, of_max=0.0),
       "bfloat16_card": dict(rtol=0.0, atol=0.0, of_max=1e-2),
       "flash_card": dict(rtol=2e-2, atol=0.0, of_max=0.0, of_spread=2 ** -8),
       "rglru_card": dict(rtol=1e-5, atol=0.0, of_max=1e-5),
       "mlstm_card": dict(rtol=1e-2, atol=0.0, of_max=0.0, of_spread=2 ** -7),
       "moe_combine_card": dict(rtol=0.0, atol=0.0, of_max=0.0, of_spread=1.0),
       "model_logits": dict(of_floor=2.5)}
CARD_TOL = {"decode_attention": "bfloat16_card", "flash_attention": "flash_card",
            "rglru_scan": "rglru_card", "mlstm_chunk": "mlstm_card"}

#: Cache rows dropped from the plain version to show that the card-scale
#: decode tolerance catches a kernel that skips a fraction of one tile; and
#: the keys masked from the end of every row's causal range for flash
#: attention, where only the rows of the second half of the sequence (each
#: with at least S/2 live keys, so 64 keys are at most 1/32 of them) are
#: compared: shorter rows change wholesale.
DROPPED_ROWS = 64


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: SASS instructions the build phase counts in every kernel function:
#: Hopper's warpgroup products, TMA tile loads, 1-D bulk copies, the
#: warp-level products of the earlier tensor-core kernels, and cp.async
#: copies (LDGSTS).
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA", "LDGSTS")
#: Kernel functions of the card shapes (mangled-name fragments), by library,
#: and the SASS instructions each must contain: flash attention at qwen2-7b
#: prefill (D = 128, causal, no window, no cap), at D = 80 (stablelm-3b
#: causal, hubert-xlarge not) and at recurrentgemma-9b's local attention
#: (D = 256, causal, window), decode attention at D = 128 (bulk copies) and
#: at recurrentgemma-9b's D = 256 (cp.async and mma.sync) without a cap,
#: the three tensor-core mLSTM kernels of the xlstm-1.3b shape (bf16, dh
#: 1024, chunk 256), and the RG-LRU's copy-ring scan (float32), so that
#: none of them silently runs on the CUDA cores or without its copies.
SASS_REQUIRED = {
    "flash_attention": tuple((f"flash_wgmmaILi{d}ELb{c}ELb{w}ELb0E", (("HGMMA",), ("UTMALDG",)))
                             for d, c, w in ((128, 1, 0), (80, 1, 0), (80, 0, 0), (256, 1, 1))),
    "decode_attention": (("decode_bulkILi128ELb0E", (("UBLKCP", "UTMALDG"),)),
                         ("decode_bulkILi256ELb0E", (("LDGSTS",), ("HMMA",)))),
    "mlstm_chunk": tuple((f"mlstm_wg_{k}", (("HGMMA",), ("UTMALDG",)))
                         for k in ("state", "scores", "out")),
    "rglru": (("rglru_ringIfE", (("UTMALDG", "UBLKCP"),)),),
}


def cuobjdump() -> str:
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(pathlib.Path("/usr/local/cuda/bin/cuobjdump"))


def short_name(mangled: str) -> str:
    """A kernel's mangled name from its identifier on, through its template
    arguments: ``flash_wgmmaILi128ELb1ELb0ELb0E`` for ``flash_wgmma<128,
    true, false, false>``."""
    m = re.search(r"(?:_cu_[0-9a-f]{8}|_GLOBAL__N_1)(\d+)(\w*)", mangled)
    if not m:
        return mangled
    n, rest = int(m.group(1)), m.group(2)
    name, rest = rest[:n], rest[n:]
    if not rest.startswith("I"):
        return name
    depth, i = 0, 0
    while i < len(rest):
        ch = rest[i]
        if ch.isdigit():                 # a length-prefixed identifier
            j = i
            while rest[j].isdigit():
                j += 1
            i = j + int(rest[i:j])
            continue
        if ch == "L":                    # a literal, L<type><value>E
            i = rest.index("E", i) + 1
            continue
        if ch in "IN":
            depth += 1
        elif ch == "E":
            depth -= 1
            if depth == 0:
                return name + rest[:i + 1]
        i += 1
    return name + rest


def sass_counts(lib) -> dict:
    """Kernel (``short_name``) -> {instruction: count} for ``SASS_OPS``,
    from ``cuobjdump -sass`` of a built library."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            fn = short_name(text.split(":", 1)[1].strip())
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None and text.startswith("/*") and "*/" in text:
            words = text.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):   # predicate
                words = words[1:]
            op = words[0].split(".")[0] if words else ""
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


#: Kernel instances whose registers and spills the build phase reports by
#: name (``ptxas_report``): this port's newest designs.
PTXAS_REPORTED = ("decode_bulkILi256E", "flash_wgmmaILi80E", "flash_wgmmaILi192E",
                  "flash_wgmmaILi256E")
#: Instances that must build with no spill and no ptxas performance note
#: (``check_ptxas``): flash attention at D = 256, whose wgmmas ptxas
#: serialized (C7512) while its registers did not suffice.
PTXAS_CLEAN = "flash_wgmmaILi256E"


def ptxas_report(log: str, fragments=PTXAS_REPORTED) -> dict:
    """Kernel (``short_name``) -> registers, spill bytes and the codes of
    ptxas's performance notes on it (``C7512``: wgmmas serialized for want
    of registers), from an ``nvcc -Xptxas -v`` log, for the kernels whose
    name holds one of ``fragments``."""
    notes = {}
    for m in re.finditer(r"\((C7\d+)\) Potential Performance Loss[^']*'(\w+)'", log):
        notes.setdefault(short_name(m.group(2)), set()).add(m.group(1))
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = short_name(m.group(1))
            if any(f in entry for f in fragments):
                out[entry] = {"notes": sorted(notes.get(entry, ()))}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = short_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
    return out


def check_ptxas(report: dict) -> None:
    """Fail unless all eight ``PTXAS_CLEAN`` instances of ``report`` spill
    nothing and draw no performance note."""
    names = [n for n in report if PTXAS_CLEAN in n]
    check(len(names) == 8, f"ptxas report of {PTXAS_CLEAN}: {sorted(names)}")
    for name in names:
        r = report[name]
        check(r["spill_stores"] == r["spill_loads"] == 0,
              f"{name} spills {r['spill_stores']} B (stores), "
              f"{r['spill_loads']} B (loads)")
        check(not r["notes"], f"ptxas notes {r['notes']} on {name}")


def bulk_residency() -> dict:
    """decode_bulk's CTAs an SM at qwen2-7b's decode (4 kv heads of 128)
    and recurrentgemma-9b's ring (one of 256), as the wrapper plans them
    (``bulk_ctas_per_sm``, from shared memory) and as the card's occupancy
    calculator counts them."""
    from repro_torch.kernels.decode_attention import ops as DA

    return {f"Hkv{hkv}_D{d}": {"predicted": DA.bulk_ctas_per_sm(hkv, d),
                               "card": DA.card_bulk_residency(hkv, d)}
            for hkv, d in ((4, 128), (1, 256))}


def check_sass(sass: dict) -> None:
    """Fail unless each card-shape kernel holds its required instructions
    (any one of each alternative group)."""
    for lib, kernels in SASS_REQUIRED.items():
        for fragment, groups in kernels:
            fns = [c for name, c in sass[lib].items() if fragment in name]
            check(len(fns) == 1, f"{lib}: kernel {fragment} not found in the SASS")
            for group in groups:
                check(any(fns[0][op] > 0 for op in group),
                      f"{lib}: {fragment} contains none of {group}")


# ---------------------------------------------------------------------------
# kernels under test
# ---------------------------------------------------------------------------

def kernel_table():
    """name -> (wrapper, source, TPU kernel it replaces)."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.membench import ops as MB
    from repro_torch.kernels.mlstm_chunk import ops as ML
    from repro_torch.kernels.moe_combine import ops as MC
    from repro_torch.kernels.rglru import ops as RG

    src = "src/repro_torch/csrc/"
    tpu = "src/repro/kernels/"
    return {
        "membench_aligned": (MB.aligned_sum, src + "membench.cu",
                             tpu + "membench/kernel.py:50 aligned_sum"),
        "membench_strided": (MB.strided_sum, src + "membench.cu",
                             tpu + "membench/kernel.py:69 strided_sum"),
        "membench_gather": (MB.gather_sum, src + "membench.cu",
                            tpu + "membench/kernel.py:91 gather_sum"),
        "flash_attention": (FA.flash_attention, src + "flash_attention.cu",
                            tpu + "flash_attention/kernel.py:111 "
                                  "flash_attention"),
        "decode_attention": (DA.decode_attention, src + "decode_attention.cu",
                             tpu + "decode_attention/kernel.py:107 "
                                   "decode_attention"),
        "rglru_scan": (RG.scan, src + "rglru.cu",
                       tpu + "rglru/kernel.py:63 rglru_scan"),
        "mlstm_chunk": (ML.mlstm_chunk, src + "mlstm_chunk.cu",
                        tpu + "mlstm_chunk/kernel.py:92 mlstm_chunk"),
        "moe_combine": (MC.combine, src + "moe_combine.cu",
                        "none (port only): the reference combines with an "
                        "einsum, src/repro/models/moe.py:87 forward_einsum"),
    }


#: Kernels that only the model paths launch: the estimator's main path,
#: ``Session.validate`` and the explorer's ``--validate`` run the seven
#: TPU kernels' ports alone.
MODEL_PATH_ONLY = frozenset({"moe_combine"})


def randn(shape, seed, device, dtype=None):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    return x if dtype is None else x.to(dtype)


def _case(name, label, run, plain, tol, traffic, **extra) -> dict:
    return dict(name=name, label=label, run=run, plain=plain, tol=tol,
                traffic=traffic, **extra)


def test_cases(device) -> list[dict]:
    """Kernel calls with their plain versions, tolerance key and traffic,
    at the reference test shapes (tests/test_kernels.py)."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.membench import ops as MB
    from repro_torch.kernels.mlstm_chunk import ops as ML
    from repro_torch.kernels.rglru import ops as RG

    n = 1 << 14
    aligned = [(g, b, torch.float32) for g in (1, 2, 4) for b in (512, 2048)]
    aligned += [(2, 512, torch.bfloat16)]
    strided = [(d, 512) for d in (1, 2, 4)]
    gathers = [(3, 16)]
    decodes = [(B, S, Hq, Hkv, D, L, dt, 32, 0.0)
               for (B, S, Hq, Hkv, D, L) in [(2, 96, 8, 2, 32, 96),
                                             (2, 96, 8, 2, 32, 17),
                                             (1, 64, 4, 4, 64, 1),
                                             (3, 80, 16, 2, 16, 40)]
               for dt in (torch.float32, torch.bfloat16)]
    # both split kernels at D = 128, 16 heads per KV head, a softcap
    decodes += [(2, 200, 32, 2, 128, 150, torch.bfloat16, 64, 0.0),
                (1, 96, 12, 2, 64, 77, torch.bfloat16, 32, 20.0),
                (1, 64, 8, 1, 128, 50, torch.float32, 32, 20.0)]
    # the bulk kernel over half the kv heads per CTA (8 of 128: one copy
    # per row) and over two chunks of 16 query heads (G = 24)
    decodes += [(1, 100, 16, 8, 128, 77, torch.bfloat16, 32, 0.0),
                (1, 64, 24, 1, 64, 50, torch.bfloat16, 32, 0.0)]
    # the zoo's other head sizes: D = 80 on the CUDA cores (10 or 20
    # slices a row on 16 or 32 lanes; with a softcap) and D = 256 (16 heads
    # over one kv head: two slices a lane in fp32 on the CUDA cores, the
    # bulk kernel's four-warp instance in bf16)
    decodes += [(B, S, Hq, Hkv, D, L, dt, 32, cap)
                for (B, S, Hq, Hkv, D, L, cap) in [(2, 96, 8, 2, 80, 70, 0.0),
                                                   (1, 100, 4, 4, 80, 77, 20.0),
                                                   (1, 64, 16, 1, 256, 50, 0.0)]
                for dt in (torch.float32, torch.bfloat16)]
    out = []
    for g, block, dt in aligned:
        xs = tuple(randn((n,), i, device, dt) for i in range(g))
        out.append(_case(
            "membench_aligned", f"n{n}_g{g}_block{block}_{str(dt)[6:]}",
            lambda xs=xs, b=block: MB.aligned_sum(xs, block=b),
            lambda xs=xs: MB.aligned_sum_ref(xs), "membench",
            MB.aligned_sum_traffic(xs, block=block)))
    for delta, block in strided:
        xs = tuple(randn((n,), i, device) for i in range(2))
        out.append(_case(
            "membench_strided", f"n{n}_g2_delta{delta}_block{block}",
            lambda xs=xs, d=delta, b=block: MB.strided_sum(xs, delta=d, block=b),
            lambda xs=xs, d=delta, b=block: MB.strided_sum_ref(xs, delta=d, block=b),
            "membench", MB.strided_sum_traffic(xs, delta=delta, block=block)))
    for g, m in gathers:
        xs = tuple(randn((n,), i, device) for i in range(g))
        ids = np.random.default_rng(9).integers(0, n // 512, m)
        idx = torch.as_tensor(ids, dtype=torch.int32, device=device)
        out.append(_case(
            "membench_gather", f"n{n}_g{g}_ids{m}_block512",
            lambda xs=xs, idx=idx: MB.gather_sum(xs, idx, block=512),
            lambda xs=xs, idx=idx: MB.gather_sum_ref(xs, idx, block=512),
            "membench", MB.gather_sum_traffic(xs, idx, block=512)))
    for B, S, Hq, Hkv, D, L, dt, bs, cap in decodes:
        G = Hq // Hkv
        args = (randn((B, Hkv, G, D), 1, device, dt),
                randn((B, S, Hkv, D), 2, device, dt),
                randn((B, S, Hkv, D), 3, device, dt),
                torch.tensor(L, dtype=torch.int32, device=device))
        out.append(_case(
            "decode_attention",
            f"B{B}_S{S}_Hq{Hq}_Hkv{Hkv}_D{D}_len{L}_cap{cap:g}_{str(dt)[6:]}",
            lambda a=args, bs=bs, cap=cap: DA.decode_attention(
                *a, block_s=bs, softcap=cap),
            lambda a=args, cap=cap: DA.decode_attention_ref(*a, softcap=cap),
            str(dt)[6:],
            DA.gqa_decode_traffic(args[0].reshape(B, 1, Hq, D), args[1],
                                  args[2], L)))
    flashes = [(*shape, dt) for shape in [
        (2, 64, 64, 4, 2, 32, True, None, 0.0),
        (1, 128, 128, 8, 8, 64, True, None, 0.0),
        (2, 96, 96, 4, 1, 32, True, 32, 0.0),
        (2, 48, 48, 4, 4, 32, False, None, 0.0),
        (1, 64, 64, 2, 2, 32, True, None, 20.0),
        (1, 100, 100, 6, 2, 16, True, None, 0.0)]
        for dt in (torch.float32, torch.bfloat16)]
    # the tensor-core kernel at D = 128 (ragged S, 8 heads a group) and at
    # D = 256 (MQA, window and softcap); the CUDA-core kernel at D = 128/256
    flashes += [(2, 200, 200, 16, 2, 128, True, None, 0.0, torch.bfloat16),
                (1, 300, 300, 8, 1, 256, True, 64, 30.0, torch.bfloat16),
                (1, 70, 90, 4, 2, 128, False, None, 0.0, torch.float32),
                (1, 40, 40, 2, 1, 256, True, 16, 0.0, torch.float32)]
    # the wgmma kernel without the causal mask: Skv > Sq, and a window
    # with a softcap
    flashes += [(1, 70, 90, 4, 2, 128, False, None, 0.0, torch.bfloat16),
                (1, 96, 96, 4, 2, 64, False, 32, 5.0, torch.bfloat16)]
    # D = 80 (the tensor cores' 80-column instance; the CUDA cores'
    # own): both kernels, and a window with a softcap on the tensor cores
    flashes += [(1, 90, 90, 4, 2, 80, True, None, 0.0, dt)
                for dt in (torch.float32, torch.bfloat16)]
    flashes += [(2, 64, 64, 4, 4, 80, True, 32, 5.0, torch.bfloat16)]
    for B, Sq, Skv, Hq, Hkv, D, causal, window, cap, dt in flashes:
        q = randn((B, Sq, Hq, D), 4, device, dt)
        k = randn((B, Skv, Hkv, D), 5, device, dt)
        v = randn((B, Skv, Hkv, D), 6, device, dt)
        kw = dict(causal=causal, window=window, softcap=cap)
        out.append(_case(
            "flash_attention",
            f"B{B}_Sq{Sq}_Skv{Skv}_Hq{Hq}_Hkv{Hkv}_D{D}_causal{int(causal)}"
            f"_win{window}_cap{cap:g}_{str(dt)[6:]}",
            lambda a=(q, k, v), kw=kw: FA.mha(*a, block_q=32, block_kv=16, **kw),
            lambda a=(q, k, v), kw=kw: FA.attention_ref(*a, **kw),
            str(dt)[6:], FA.flash_attention_traffic(q, k, v, causal=causal,
                                                    window=window)))
    # the kernel's own (B, H, S, D) layout, contiguous
    q, k, v = (randn((2, h, 96, 64), 7 + i, device, torch.bfloat16)
               for i, h in enumerate((4, 2, 2)))
    out.append(_case(
        "flash_attention", "BHSD_B2_S96_Hq4_Hkv2_D64_bfloat16",
        lambda: FA.flash_attention(q, k, v),
        lambda: FA.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)))
        .transpose(1, 2), "bfloat16",
        FA.flash_attention_traffic(*(t.transpose(1, 2) for t in (q, k, v)))))
    rglrus = [(B, S, W, bs, bw, dt)
              for B, S, W, bs, bw in [(2, 64, 96, 16, 32), (1, 128, 64, 64, 64),
                                      (3, 96, 128, 32, 128)]
              for dt in (torch.float32, torch.bfloat16)]
    # rows of 200 bytes (no TMA box: plain loads), fewer channels than one
    # tile, and S and W ragged against the stage and the tile
    rglrus += [(1, 100, 100, 32, 128, torch.bfloat16),
               (1, 50, 16, 256, 512, torch.float32),
               (2, 77, 200, 64, 64, torch.float32)]
    for B, S, W, bs, bw, dt in rglrus:
        gen = torch.Generator(device=device).manual_seed(8)
        a = (0.6 + 0.399 * torch.rand((B, S, W), generator=gen,
                                      device=device)).to(dt)
        b = randn((B, S, W), 9, device, dt)
        out.append(_case(
            "rglru_scan", f"B{B}_S{S}_W{W}_bs{bs}_bw{bw}_{str(dt)[6:]}",
            lambda a=a, b=b, bs=bs, bw=bw: RG.scan(a, b, block_s=bs,
                                                   block_w=bw),
            lambda a=a, b=b: RG.rglru_scan_ref(a, b),
            f"rglru_{str(dt)[6:]}", RG.rglru_scan_traffic(a, b)))
    mlstms = [(B, S, H, dh, chunk, dt)
              for B, S, H, dh, chunk in [(2, 64, 3, 16, 16), (1, 96, 2, 32, 32),
                                         (2, 32, 4, 8, 32)]
              for dt in (torch.float32, torch.bfloat16)]
    # the tensor-core kernels: dh 64 and 128, chunks of 64, 128 and 256 over
    # 2-4 chunks, a chunk the reference halves (256 -> 128 at S = 384), and
    # dh 192, which leaves part of a 256-column state tile and of a
    # 128-column output tile empty
    mlstms += [(2, 128, 2, 64, 64, torch.bfloat16),
               (1, 384, 2, 128, 128, torch.bfloat16),
               (1, 1024, 1, 64, 256, torch.bfloat16),
               (2, 512, 2, 128, 256, torch.bfloat16),
               (1, 384, 2, 64, 256, torch.bfloat16),
               (1, 256, 2, 192, 64, torch.bfloat16)]
    for B, S, H, dh, chunk, dt in mlstms:
        args = (randn((B, S, H, dh), 10, device, dt),
                (randn((B, S, H, dh), 11, device) / dh ** 0.5).to(dt),
                randn((B, S, H, dh), 12, device, dt),
                torch.nn.functional.logsigmoid(randn((B, S, H), 13, device)),
                torch.nn.functional.logsigmoid(
                    randn((B, S, H), 14, device) + 2.0))
        out.append(_case(
            "mlstm_chunk", f"B{B}_S{S}_H{H}_dh{dh}_chunk{chunk}_{str(dt)[6:]}",
            lambda a=args, c=chunk: ML.chunked_mlstm(*a, chunk=c),
            lambda a=args, c=chunk: ML.chunked_mlstm_ref(*a, chunk=c),
            str(dt)[6:], ML.mlstm_chunk_traffic(*args, chunk=chunk)))
    # the kernel's own (B, H, S, dh) layout, contiguous: rows dh apart (k
    # scaled by dh^-1/2, as in every case here and in the reference's tests)
    heads_first = (randn((1, 2, 256, 128), 15, device, torch.bfloat16),
                   (randn((1, 2, 256, 128), 16, device) / 128 ** 0.5).to(torch.bfloat16),
                   randn((1, 2, 256, 128), 17, device, torch.bfloat16),
                   torch.nn.functional.logsigmoid(randn((1, 2, 256), 18, device)),
                   torch.nn.functional.logsigmoid(randn((1, 2, 256), 19, device) + 2.0))
    out.append(_case(
        "mlstm_chunk", "BHSD_B1_H2_S256_dh128_chunk128_bfloat16",
        lambda a=heads_first: ML.mlstm_chunk(*a, chunk=128),
        lambda a=heads_first: ML.mlstm_chunk_ref(*a, chunk=128), "bfloat16",
        ML.mlstm_chunk_traffic(*(t.transpose(1, 2) for t in heads_first),
                               chunk=128)))
    return out


def card_cases(device) -> list[dict]:
    """The main path's own kernel calls: each case of
    ``default_cases(small=False)``, which ``Session.validate`` times, built
    on the card and paired with its plain version on the same arguments;
    then the edges of the Hopper kernels' tiling at the qwen2-7b width,
    each with its fault check: flash attention over S = 4000 (ragged
    against the 128-key tile), plain and with Gemma 2's softcap of 50 and a
    window of 1024, and decode attention at kv_len = 32,000 (not a whole
    number of 16-row stages), plain and with the softcap; last the zoo's
    other head sizes (``head_size_cases``)."""
    import torch

    from repro_torch.core.validate import default_cases
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA

    out = []
    for vc in default_cases(small=False):
        fn, args, traffic = vc.build(device)
        out.append(_case(
            vc.name, _shapes(args), lambda fn=fn, a=args: fn(*a),
            lambda p=vc.plain, a=args: p(*a),
            CARD_TOL.get(vc.name, "membench"), traffic, args=args,
            ref=vc.plain, timed=True))
    for window, cap in ((None, 0.0), (1024, 50.0)):
        qkv = tuple(randn((1, 4000, h, 128), 61 + i, device, torch.bfloat16)
                    for i, h in enumerate((28, 4, 4)))
        ref = functools.partial(FA.attention_ref, window=window, softcap=cap)
        out.append(_case(
            "flash_attention", f"qwen2-7b_ragged_win{window}_cap{cap:g}_"
            + _shapes(qkv),
            lambda a=qkv, w=window, c=cap: FA.mha(*a, window=w, softcap=c),
            lambda a=qkv, r=ref: r(*a), "flash_card",
            FA.flash_attention_traffic(*qkv, window=window), args=qkv,
            ref=ref, timed=False, fault=True))
    for cap in (0.0, 50.0):
        args = (randn((8, 1, 28, 128), 71, device, torch.bfloat16),
                randn((8, 32768, 4, 128), 72, device, torch.bfloat16),
                randn((8, 32768, 4, 128), 73, device, torch.bfloat16),
                torch.tensor(32000, dtype=torch.int32, device=device))
        ref = functools.partial(DA.gqa_decode_ref, softcap=cap)
        out.append(_case(
            "decode_attention", f"qwen2-7b_len32000_cap{cap:g}_" + _shapes(args),
            lambda a=args, c=cap: DA.gqa_decode(*a, softcap=c),
            lambda a=args, r=ref: r(*a), "bfloat16_card",
            DA.gqa_decode_traffic(*args[:3], 32000), args=args, ref=ref,
            timed=False, fault=True))
    out += head_size_cases(device)
    out += tiling_edge_cases(device)
    return out + moe_combine_cases(device)


def moe_combine_cases(device) -> list[dict]:
    """The MoE combine (K8) at the expert-parallel prefill's shape
    (qwen3-moe-235b-a22b, B 2 x 4,096, k 8, d 4,096, bf16), on the slots
    and weights of a seeded router's ``assign`` and ``_slots`` and expert
    outputs drawn with their zero row: as one chip's share of 8 experts of
    128 (the benchmark cell's 5,120 buffer rows, most slots spare) and as
    a layer that holds all 128 (every kept slot live).  Both timed, both
    with the fault check."""
    import types

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_combine import ops as MC
    from repro_torch.models import moe as MOE

    arch = "qwen3-moe-235b-a22b"
    cfg = get_config(arch)
    d, E = cfg.d_model, cfg.n_experts
    B, S = MODEL_RUNS[arch]["prefill"]
    out = []
    for held in ((0, 8), (0, E)):
        p = types.SimpleNamespace(
            router=MOE.Router(randn((d, E), 71, device) / d ** 0.5),
            experts=held)
        x = randn((B, S, d), 72, device, torch.bfloat16)
        xg, weights, experts, pos, C, _ = MOE.assign(p, cfg, x, "einsum")
        keep = pos < C
        w = (weights * keep).to(x.dtype)
        slot = MOE._slots(p, experts, pos, keep & (w != 0), C)
        rows = (held[1] - held[0]) * xg.shape[0] * C
        y = randn((rows + 1, d), 73, device, x.dtype)
        y[rows] = 0
        args = (y, slot, w)
        out.append(_case(
            "moe_combine", f"held{held[1] - held[0]}of{E}_" + _shapes(args),
            lambda a=args: MC.combine(*a), lambda a=args: MC.combine_ref(*a),
            "moe_combine_card", MC.combine_traffic(y, slot), args=args,
            ref=MC.combine_ref, timed=True))
    return out


def tiling_edge_cases(device) -> list[dict]:
    """The edges of the two redesigned instances' tiling, at small shapes,
    each with its fault check.  decode_bulk at D = 256 (four warps over
    one kv head of 256, B 2 over 2,048 rows): 16 query heads at kv_len 1,
    17 and 2,000 (a ragged last stage), 8 query heads (half a tensor-core
    tile), a softcap of 30, and 2 kv heads (one CTA each).  flash_wgmma at
    D = 80 (a 64-column block and a 16-column tail): ragged Sq = Skv =
    4,000, a window of 1,024 with a cap of 50, not causal, and GQA with
    groups of 2.  flash_wgmma at D = 256 (16 query heads over one kv head,
    persistent CTAs, Q by TMA where a group's rows are one box): ragged Sq
    = Skv = 4,000 with a window of 2,048, a window of 1,024 with a cap of
    30, not causal, GQA with groups of 4, the model's B 2 x 4,096 (more
    items than two rounds of SMs), and groups of 3 (Q by 16-byte loads) and
    of 128 (half a position's heads a box)."""
    import torch

    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA

    out = []
    for Hq, Hkv, L, cap, seed in ((16, 1, 1, 0.0, 201), (16, 1, 17, 0.0, 204),
                                  (16, 1, 2000, 0.0, 207), (8, 1, 2000, 0.0, 210),
                                  (16, 1, 2000, 30.0, 213), (32, 2, 2000, 0.0, 216)):
        args = (randn((2, 1, Hq, 256), seed, device, torch.bfloat16),
                randn((2, 2048, Hkv, 256), seed + 1, device, torch.bfloat16),
                randn((2, 2048, Hkv, 256), seed + 2, device, torch.bfloat16),
                torch.tensor(L, dtype=torch.int32, device=device))
        ref = functools.partial(DA.gqa_decode_ref, softcap=cap)
        out.append(_case(
            "decode_attention", f"bulk_D256_len{L}_cap{cap:g}_" + _shapes(args),
            lambda a=args, c=cap: DA.gqa_decode(*a, softcap=c),
            lambda a=args, r=ref: r(*a), "bfloat16_card",
            DA.gqa_decode_traffic(*args[:3], L), args=args, ref=ref,
            timed=False, fault=True))
    for S, Hq, Hkv, causal, window, cap, seed in (
            (4000, 8, 8, True, None, 0.0, 221), (4000, 8, 8, True, 1024, 50.0, 224),
            (4000, 8, 8, False, None, 0.0, 227), (2048, 8, 4, True, None, 0.0, 230)):
        qkv = tuple(randn((1, S, h, 80), seed + i, device, torch.bfloat16)
                    for i, h in enumerate((Hq, Hkv, Hkv)))
        ref = functools.partial(FA.attention_ref, causal=causal, window=window,
                                softcap=cap)
        out.append(_case(
            "flash_attention", f"wgmma_D80_causal{int(causal)}_win{window}_cap{cap:g}_"
            + _shapes(qkv),
            lambda a=qkv, c=causal, w=window, cp=cap: FA.mha(*a, causal=c, window=w,
                                                            softcap=cp),
            lambda a=qkv, r=ref: r(*a), "flash_card",
            FA.flash_attention_traffic(*qkv, causal=causal, window=window), args=qkv,
            ref=ref, timed=False, fault=True))
    for B, S, Hq, Hkv, causal, window, cap, seed in (
            (1, 4000, 16, 1, True, 2048, 0.0, 241), (1, 4096, 16, 1, True, 1024, 30.0, 244),
            (1, 2000, 16, 1, False, None, 0.0, 247), (1, 2048, 8, 2, True, None, 0.0, 250),
            (2, 4096, 16, 1, True, 2048, 0.0, 253), (1, 1000, 12, 4, True, 512, 0.0, 256),
            (1, 512, 128, 1, True, 256, 0.0, 259)):
        qkv = tuple(randn((B, S, h, 256), seed + i, device, torch.bfloat16)
                    for i, h in enumerate((Hq, Hkv, Hkv)))
        ref = functools.partial(FA.attention_ref, causal=causal, window=window,
                                softcap=cap)
        out.append(_case(
            "flash_attention", f"wgmma_D256_causal{int(causal)}_win{window}_cap{cap:g}_"
            + _shapes(qkv),
            lambda a=qkv, c=causal, w=window, cp=cap: FA.mha(*a, causal=c, window=w,
                                                            softcap=cp),
            lambda a=qkv, r=ref: r(*a), "flash_card",
            FA.flash_attention_traffic(*qkv, causal=causal, window=window), args=qkv,
            ref=ref, timed=False, fault=True))
    return out


def head_size_cases(device) -> list[dict]:
    """The zoo's other head sizes and head groups, at full width, each
    timed beside its bound (``phase_head_sizes``): recurrentgemma-9b's
    local attention on prefill (16 query heads over one kv head of 256,
    window 2048, B 1 x S 4096: the tensor-core kernel's D = 256
    instances); stablelm-3b (32 query and 32 kv heads of 80) prefill, B 2
    x S 2048 (the 80-column instance), and decode at B 8 over 8,192 rows;
    qwen3-moe-235b-a22b's prefill (64 query heads over 4 kv heads of 128,
    B 2 x S 4096, causal) and hubert-xlarge's (16 heads of 80, B 2 x S
    4096, not causal); DeepSeek-V3's latent attention (128 heads of 192
    and 128, B 1 x S 16,384, causal: the 192/128 instance);
    recurrentgemma-9b's local-attention decode (16
    query heads over one kv head of 256) at B 8 and at B 128 over its
    2,048-row ring; qwen3-moe-235b-a22b's decode at B 8 over 32,768 rows.
    Each carries a fault check."""
    import torch

    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA

    q, k, v = (randn((1, 4096, h, 256), 51 + i, device, torch.bfloat16)
               for i, h in enumerate((16, 1, 1)))
    local = functools.partial(FA.attention_ref, window=2048)
    out = [_case(
        "flash_attention", "recurrentgemma-9b_local_window2048_"
        + _shapes((q, k, v)), lambda: FA.mha(q, k, v, window=2048),
        lambda: local(q, k, v), "flash_card",
        FA.flash_attention_traffic(q, k, v, window=2048), args=(q, k, v),
        ref=local, timed=False, fault=True, head_size=True, window=2048)]
    qkv = tuple(randn((2, 2048, 32, 80), 81 + i, device, torch.bfloat16)
                for i in range(3))
    out += [_case("flash_attention", "stablelm-3b_prefill_" + _shapes(qkv),
                 lambda a=qkv: FA.mha(*a), lambda a=qkv: FA.attention_ref(*a),
                 "flash_card", FA.flash_attention_traffic(*qkv), args=qkv,
                 ref=FA.attention_ref, timed=False, fault=True,
                 head_size=True)]
    # qwen3-moe-235b-a22b's prefill (64 query heads over 4 kv heads of 128,
    # causal) and hubert-xlarge's (16 heads of 80, not causal: the fault
    # drops the last keys of every row)
    for arch, Hq, Hkv, D, causal, seed in (("qwen3-moe-235b-a22b", 64, 4, 128,
                                            True, 101),
                                           ("hubert-xlarge", 16, 16, 80, False,
                                            104)):
        qkv = tuple(randn((2, 4096, h, D), seed + i, device, torch.bfloat16)
                    for i, h in enumerate((Hq, Hkv, Hkv)))
        ref = functools.partial(FA.attention_ref, causal=causal)
        out.append(_case(
            "flash_attention", f"{arch}_prefill_" + _shapes(qkv),
            lambda a=qkv, c=causal: FA.mha(*a, causal=c),
            lambda a=qkv, r=ref: r(*a), "flash_card",
            FA.flash_attention_traffic(*qkv, causal=causal), args=qkv, ref=ref,
            timed=False, fault=True, head_size=True, causal=causal))
    # DeepSeek-V3's latent attention on prefill: 128 heads of 192 (q, k)
    # and 128 (v, the output), B 1 x S 16,384, causal, at its softmax
    # scale; v a view of kv_b's output, as the model takes it (names of
    # their own: the first case's lambdas read q, k and v late)
    from repro_torch.configs.deepseek import DEEPSEEK_V3
    mla_q, mla_k = (randn((1, 16384, 128, 192), 111 + i, device,
                          torch.bfloat16) for i in range(2))
    mla_v = randn((1, 16384, 128, 256), 113, device,
                  torch.bfloat16)[..., 128:]
    mla_qkv = (mla_q, mla_k, mla_v)
    mla = functools.partial(FA.attention_ref, scale=DEEPSEEK_V3.softmax_scale)
    out.append(_case(
        "flash_attention", "deepseek-v3_mla_prefill_" + _shapes(mla_qkv),
        lambda a=mla_qkv: FA.mha(*a, scale=DEEPSEEK_V3.softmax_scale),
        lambda a=mla_qkv, r=mla: r(*a), "flash_card",
        FA.flash_attention_traffic(*mla_qkv), args=mla_qkv, ref=mla,
        timed=False, fault=True, head_size=True))
    # decode: stablelm-3b, recurrentgemma-9b's ring at B 8 and 128, and
    # qwen3-moe-235b-a22b (a group of 16 query heads a kv head: one whole
    # tensor-core tile, kMmaG = 16)
    for arch, B, S, Hq, Hkv, D, seed in (("stablelm-3b", 8, 8192, 32, 32, 80, 84),
                                         ("recurrentgemma-9b_local", 8, 2048,
                                          16, 1, 256, 87),
                                         ("recurrentgemma-9b_local", 128, 2048,
                                          16, 1, 256, 90),
                                         ("qwen3-moe-235b-a22b", 8, 32768,
                                          64, 4, 128, 107)):
        args = (randn((B, 1, Hq, D), seed, device, torch.bfloat16),
                randn((B, S, Hkv, D), seed + 1, device, torch.bfloat16),
                randn((B, S, Hkv, D), seed + 2, device, torch.bfloat16),
                torch.tensor(S, dtype=torch.int32, device=device))
        out.append(_case(
            "decode_attention", f"{arch}_decode_" + _shapes(args),
            lambda a=args: DA.gqa_decode(*a), lambda a=args: DA.gqa_decode_ref(*a),
            "bfloat16_card", DA.gqa_decode_traffic(*args[:3], S), args=args,
            ref=DA.gqa_decode_ref, timed=False, fault=True, head_size=True))
    return out


def _shapes(args) -> str:
    return "_".join("x".join(map(str, a.shape)) for a in _tensors(args)
                    if a.dim())


def perturbed(name: str, args, want, plain):
    """The case's plain version with one fault a kernel could have, on the
    case's arguments: (what was broken, its output), or None."""
    import torch

    if name == "decode_attention":
        # the last 64 rows, or half of a shorter cache (its one row: kv_len
        # 0, where every row is masked and the plain version averages all)
        q, kc, vc, kv_len = args
        drop = min(DROPPED_ROWS, max(1, int(kv_len) // 2))
        return (f"last {drop} cache rows dropped", plain(q, kc, vc, kv_len - drop))
    if name == "flash_attention" and not getattr(
            plain, "keywords", {}).get("causal", True):
        q, k, v = args
        return (f"last {DROPPED_ROWS} keys of every row dropped",
                plain(q, k[:, :-DROPPED_ROWS], v[:, :-DROPPED_ROWS]))
    if name == "flash_attention":
        h = args[0].shape[1] // 2
        bad = plain(*args, q_offset=-DROPPED_ROWS)
        return (f"last {DROPPED_ROWS} keys of every causal range masked, "
                f"rows >= {h} compared",
                torch.cat([want[:, :h], bad[:, h:]], dim=1))
    if name == "moe_combine":
        y, slot, w = args
        first_spare = slot.clone()
        first_spare[..., 0] = y.shape[0] - 1
        return ("every token's first slot read as spare",
                plain(y, first_spare, w))
    if name == "rglru_scan":
        a, b = args
        t0 = a.shape[1] // 2
        return (f"carry into step {t0} zeroed",
                torch.cat([want[:, :t0], plain(a[:, t0:], b[:, t0:])], dim=1))
    if name == "mlstm_chunk":
        # Chunk j adds nothing to the state (log input gate -1e30) and does
        # not decay it (log forget gate 0): its update is skipped.  Rows up
        # to the end of chunk j keep the true output.
        q, k, v, li, lf = args
        c = plain.keywords["chunk"]
        j = max(0, q.shape[1] // c // 2 - 1)
        rows = slice(j * c, (j + 1) * c)
        li2, lf2 = li.clone(), lf.clone()
        li2[:, rows] = -1e30
        lf2[:, rows] = 0.0
        skipped = plain(q, k, v, li2, lf2)
        return (f"state update of chunk {j} skipped",
                torch.cat([want[:, :(j + 1) * c], skipped[:, (j + 1) * c:]],
                          dim=1))
    return None


def _tensors(args):
    for a in args:
        if isinstance(a, (tuple, list)):
            yield from _tensors(a)
        else:
            yield a


def spread(c: dict):
    """Per-element scale of a card case's ``of_spread`` tolerance: for flash
    attention sum_j p_j |v_j|, its plain version run on |v|; for the mLSTM
    ``chunked_mlstm_spread``; for the MoE combine ``combine_spread``; else
    None."""
    if not TOL[c["tol"]].get("of_spread"):
        return None
    if c["name"] == "moe_combine":
        return combine_spread(*c["args"])
    if c["name"] == "mlstm_chunk":
        from repro_torch.kernels.mlstm_chunk import ops as ML

        return ML.chunked_mlstm_spread(*c["args"], chunk=c["ref"].keywords["chunk"])
    check(c["name"] == "flash_attention", f"no spread for {c['name']}")
    q, k, v = c["args"]
    return c["ref"](q, k, v.abs()).float()


def combine_spread(y, slot, w):
    """The MoE combine's per-element scale: one unit in the last place of
    bf16 at the scale of the token's terms' absolute sum where the token
    has two live slots or more, else 0."""
    import torch

    from repro_torch.kernels.moe_combine import ops as MC

    check(y.dtype == torch.bfloat16, f"the combine's spread is bf16's, not {y.dtype}'s")
    terms = MC.combine_rows(y, slot).float() * w.float()[..., None]
    _, e = torch.frexp(terms.abs().sum(-2))
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    live = (slot < y.shape[0] - 1).sum(-1, keepdim=True)
    return torch.where(live >= 2, ulp, torch.zeros_like(ulp))


def tolerance(want, tol_key: str, spread=None) -> dict:
    """rtol and atol of |got - want| <= atol + rtol * |want|; atol is a
    tensor where the tolerance takes a per-element ``spread``."""
    tol = TOL[tol_key]
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    atol = tol["atol"] + tol["of_max"] * scale
    if tol.get("of_spread"):
        atol = atol + tol["of_spread"] * spread
    return dict(rtol=tol["rtol"], atol=atol)


def compare(got, want, tol_key: str, spread=None) -> tuple[float, float, bool]:
    """(max |got - want|, the largest |got - want| / (atol + rtol |want|),
    whether every element is within its bound)."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        return math.inf, math.inf, False
    if not g.numel():
        return 0.0, 0.0, True
    diff = (g - w).abs()
    tol = tolerance(w, tol_key, spread)
    bound = tol["atol"] + tol["rtol"] * w.abs()
    of_bound = torch.where(diff > 0, diff / bound, torch.zeros_like(diff))
    worst = float(of_bound.max())
    return float(diff.max()), worst, worst <= 1.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_parity(device, card: list[dict]) -> dict:
    """Every kernel against its plain version, at the test shapes and at the
    main path's ``card`` cases; at the card shapes each kernel's plain
    version with one fault must fall outside the bound.  Returns the
    card-scale max error per kernel."""
    import torch

    card_err = {}
    for scale, cs in (("test", test_cases(device)), ("card", card)):
        rows = []
        for c in cs:
            got = c["run"]()
            torch.cuda.synchronize()
            want = c["plain"]()
            sp = spread(c)
            err, of_bound, ok = compare(got, want, c["tol"], sp)
            tol = tolerance(want, c["tol"], sp)
            row = {"kernel": c["name"], "case": c["label"],
                   "max_abs_err": err, "err_of_bound": of_bound,
                   "rtol": tol["rtol"], "atol_max": float(tol["atol"].max())
                   if sp is not None else tol["atol"],
                   "bit_equal": bool(torch.equal(got, want)), "ok": ok}
            check(ok, f"parity {c['name']} {c['label']}: max_abs_err {err}")
            fault = (perturbed(c["name"], c["args"], want, c["ref"])
                     if scale == "card" and c.get("fault", c["timed"])
                     else None)
            if fault is not None:
                what, bad = fault
                bad_err, bad_of_bound, bad_ok = compare(bad, want, c["tol"], sp)
                row.update(perturbation=what, perturbed_err=bad_err,
                           perturbed_err_of_bound=bad_of_bound)
                check(not bad_ok, f"card-scale {c['name']} tolerance does not "
                      f"catch: {what}")
            rows.append(row)
            if scale == "card":
                card_err[c["name"]] = max(card_err.get(c["name"], 0.0), err)
        emit({"phase": "parity", "scale": scale, "tolerances": TOL,
              "rows": rows})
    return card_err


STREAM_AXES_NUMERIC = dict(
    n_ga=list(range(1, 11)),
    simd=[1, 2, 4, 8, 16],
    n_elems=[1 << e for e in range(14, 22)],
    delta=list(range(1, 21)),
    include_write=[False, True],
    val_constant=[False, True],
    elem_bytes=[4, 8],
)


def grids():
    """The reference's 864-point test grid (tests/test_api.py) and its
    1,024,000-point streaming bench grid (benchmarks/sweep_bench.py),
    rebuilt from the port's own types."""
    import repro_torch as rt

    types = [rt.LsuType.BC_ALIGNED, rt.LsuType.BC_NON_ALIGNED,
             rt.LsuType.BC_WRITE_ACK, rt.LsuType.ATOMIC_PIPELINED]
    drams = [rt.DDR4_1866, rt.DDR4_2666]
    grid864 = dict(lsu_type=types, n_ga=[1, 2, 4], simd=[1, 4, 16],
                   n_elems=[1 << 14, 1 << 16], delta=[1, 2, 7],
                   include_write=[False, True], dram=drams)
    grid1m = dict(lsu_type=types, dram=drams,
                  bsp=[rt.STRATIX10_BSP, rt.BspParams(burst_cnt=5, max_th=64)],
                  **STREAM_AXES_NUMERIC)
    return {"grid864": grid864, "grid1m": grid1m}


def phase_estimator(device) -> None:
    import numpy as np

    import repro_torch as rt

    rows = []
    for name, axes in grids().items():
        reps = {}
        for dev in (device, "cpu"):
            sess = rt.Session(backend="torch", device=dev)
            t0 = time.perf_counter()
            rep = sess.sweep(rt.Space.grid(**axes))
            wall = time.perf_counter() - t0
            reps[str(dev)] = (rep, wall)
        (gpu, gpu_s), (cpu, cpu_s) = reps[str(device)], reps["cpu"]
        ids = lambda r: np.argsort(r.t_exe, kind="stable")[:10].tolist()  # noqa: E731
        row = {
            "grid": name, "n_points": gpu.n_points,
            "t_exe_bit_equal": bool(np.array_equal(gpu.t_exe, cpu.t_exe)),
            "bound_ratio_bit_equal": bool(np.array_equal(
                gpu.estimate.bound_ratio, cpu.estimate.bound_ratio)),
            "top10_ids": ids(gpu), "pareto_points": int(len(gpu.pareto())),
            "points_per_s": {"cuda": gpu.n_points / gpu_s,
                             "cpu": cpu.n_points / cpu_s},
        }
        rows.append(row)
        check(gpu.n_points == cpu.n_points > 0, f"{name}: point counts")
        check(np.allclose(gpu.t_exe, cpu.t_exe, rtol=1e-12, atol=0.0),
              f"{name}: t_exe differs across devices")
        check(np.allclose(gpu.estimate.bound_ratio, cpu.estimate.bound_ratio,
                          rtol=1e-12, atol=0.0), f"{name}: bound_ratio differs")
        check(np.array_equal(gpu.memory_bound, cpu.memory_bound),
              f"{name}: memory_bound differs")
        check(np.array_equal(gpu.resource, cpu.resource),
              f"{name}: resource differs")
        check(ids(gpu) == ids(cpu), f"{name}: top_k(10) ids differ")
        check(np.array_equal(gpu.pareto(), cpu.pareto()),
              f"{name}: pareto ids differ")
        check(np.all(np.isfinite(gpu.t_exe)) and np.all(gpu.t_exe > 0),
              f"{name}: non-finite estimates")
    # single and heterogeneous estimates on the card against the CPU
    designs = [rt.Design.microbench(t, n_ga=2, n_elems=1 << 14)
               for t in grids()["grid864"]["lsu_type"]]
    on_card = rt.Session(device=device).estimate_many(designs)
    on_cpu = rt.Session(device="cpu").estimate_many(designs)
    one = rt.Session(device=device).estimate(designs[0])
    check(all(math.isclose(a.t_exe, b.t_exe, rel_tol=1e-12)
              for a, b in zip(on_card, on_cpu)), "estimate_many differs")
    check(math.isclose(one.t_exe, on_cpu[0].t_exe, rel_tol=1e-12),
          "estimate differs")
    emit({"phase": "estimator", "rows": rows})


def _stream_ids(rep):
    """(sorted front ids, top-k ids best first) of a streaming report."""
    import numpy as np

    ids = np.asarray(rep.point_ids)
    return np.sort(ids[rep.pareto()]), ids[rep.topk_idx]


def _host_fold_report(sess, space, chunk, workers=None):
    """The host fold of ``space`` through the plan's evaluator on the
    session's device (the path a constrained or custom sweep takes),
    with the reference's stage names."""
    from repro_torch import api
    from repro_torch.core import stream as S

    plan = sess.plan(space, chunk_size=chunk)
    prof = {"path": "host-stream"} if workers is None else None
    t0 = time.perf_counter()
    if prof is not None:
        out = S.run_stream(plan.n, plan.chunk_size,
                           plan.evaluator(stage_times=prof),
                           S.default_reducers(10), stage_times=prof)
    else:
        out = plan.run(S.default_reducers(10), workers=workers)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof["total_s"] = wall
    return api._stream_report(out, plan.tables(), backend=sess.backend,
                              profile=prof), wall


def _same_fold(a, b, what: str) -> None:
    """Front ids, top-k rows (every carried column) and every stats field
    bit-equal between two streaming reports."""
    import numpy as np

    fa, ka = _stream_ids(a)
    fb, kb = _stream_ids(b)
    check(np.array_equal(fa, fb), f"{what}: front ids differ")
    check(np.array_equal(ka, kb), f"{what}: top-k ids differ")
    check(a.rows(a.topk_idx) == b.rows(b.topk_idx), f"{what}: top-k rows")
    ta = next(r for r in a.reducers if type(r).__name__ == "TopKReducer")
    tb = next(r for r in b.reducers if type(r).__name__ == "TopKReducer")
    check(all(np.array_equal(ta.cols[c], tb.cols[c]) for c in tb.cols),
          f"{what}: top-k columns differ")
    check(a.stats == b.stats, f"{what}: stats differ: {a.stats} {b.stats}")


def timed_runs(run, repeats: int = 3):
    """``run()`` ``repeats`` times, each ended by a synchronize: (the last
    result, the wall seconds of each run)."""
    import torch

    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


#: Name fragments of the port's own kernels, which a profile lists whatever
#: their rank (``device_profile``'s ``port_kernels``).
PORT_KERNELS = ("flash_wgmma", "flash_simt", "decode_", "rglru_", "mlstm_")


def device_profile(run, top: int = 0) -> dict:
    """One ``run()`` under ``torch.profiler``: device kernel time over wall
    time (``busy_share``, None when the trace holds no device time), the
    ``top`` kernels by device time (name, ms, calls), and every kernel of
    the port's (``port_kernels``, the same fields).  The trace
    records the device's own events only (host operators would slow the
    host the share is taken against, and their self device time repeats
    their kernels'), and its raw events are summed as they come: building
    the profiler's event tables takes ~0.1 ms an event, minutes for the
    ~10^5 launches of an eager sLSTM loop."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            row = by_name[e.name()]
            row[0] += e.duration_ns() * 1e-3
            row[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return {"busy_share": busy_us * 1e-6 / wall if busy_us > 0 else None,
            "wall_ms": wall * 1e3, "device_ms": busy_us * 1e-3,
            "top": [(name[:80], us * 1e-3, n) for name, (us, n) in ranked[:top]],
            "port_kernels": [(name[:100], us * 1e-3, n) for name, (us, n) in ranked
                             if any(f in name for f in PORT_KERNELS)]}


def phase_stream(device):
    """Streaming sweeps on the card: the reference's stream_1m and
    stream_10m grids (benchmarks/sweep_bench.py) at chunk 2^17 and k = 10,
    each through the device fold (as chosen, forced op by op, forced into a
    CUDA graph) and the host fold; the 1m grid also
    materialized, folded on the CPU, through two worker processes and
    under constraints.  Returns the 1m device-fold report."""
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch.core import device_stream as DS
    from repro_torch.core import sweep as SW
    from repro_torch.search import constraints as C

    chunk = 1 << 17
    grid1m = grids()["grid1m"]
    spaces = {"stream_1m": grid1m,
              "stream_10m": dict(grid1m, n_ga=list(range(1, 101)))}
    sess = rt.Session(device=device)
    rows, peaks, device_1m = [], {}, None
    for name, axes in spaces.items():
        space = rt.Space.grid(**axes)
        prof_rep = sess.sweep(space, chunk_size=chunk, profile=True)
        check(prof_rep.profile.get("path") == "device"
              and "device_overflow" not in prof_rep.profile,
              f"{name}: the device fold did not run: {prof_rep.profile}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dev_rep, dev_s = timed_runs(
            lambda: sess.sweep(space, chunk_size=chunk))
        peaks[name] = torch.cuda.max_memory_allocated() - base
        busy = device_profile(
            lambda: sess.sweep(space, chunk_size=chunk))["busy_share"]
        host_rep, host_s = _host_fold_report(sess, space, chunk)
        # the device fold forced op by op and forced into a CUDA graph
        forced_s = {}
        for mode, attrs in (("eager", {"use_graph": False}),
                            ("graph", {"graph_min_chunks": 1})):
            saved = {k: getattr(DS.DeviceSweep, k) for k in attrs}
            for k, v in attrs.items():
                setattr(DS.DeviceSweep, k, v)
            try:
                forced, forced_s[mode] = timed_runs(
                    lambda: sess.sweep(space, chunk_size=chunk))
            finally:
                for k, v in saved.items():
                    setattr(DS.DeviceSweep, k, v)
            _same_fold(dev_rep, forced, f"{name}: device fold, {mode}")
        _same_fold(dev_rep, prof_rep, f"{name}: profiled device fold")
        _same_fold(dev_rep, host_rep, f"{name}: device fold vs card host fold")
        n = dev_rep.n_points
        check(n == int(np.prod([len(v) for v in axes.values()])),
              f"{name}: point count {n}")
        check(np.isfinite(dev_rep.stats["t_exe_sum"])
              and dev_rep.stats["t_exe_min"] > 0, f"{name}: stats not finite")
        row = {"grid": name, "n_points": n, "chunk": chunk,
               "points_per_s": {"device": [n / t for t in dev_s],
                                "device_eager": [n / t for t in
                                                 forced_s["eager"]],
                                "device_graph": [n / t for t in
                                                 forced_s["graph"]],
                                "host_stream": n / host_s},
               "profile": {"device": prof_rep.profile,
                           "host_stream": host_rep.profile},
               "peak_device_bytes": peaks[name],
               "device_busy_share": busy,
               "front_points": len(dev_rep.pareto()),
               "t_exe_min": dev_rep.stats["t_exe_min"],
               "t_exe_min_id": dev_rep.stats["t_exe_min_id"]}
        if name == "stream_1m":
            device_1m = dev_rep
            front, topk = _stream_ids(dev_rep)
            t0 = time.perf_counter()
            mat = sess.sweep(space)
            mat_s = time.perf_counter() - t0
            check(np.array_equal(front, mat.pareto()),
                  "stream_1m: front ids differ from the materialized sweep")
            check(np.array_equal(topk, np.argsort(mat.t_exe,
                                                  kind="stable")[:10]),
                  "stream_1m: top-k ids differ from the materialized sweep")
            cpu_rep, cpu_s = _host_fold_report(rt.Session(device="cpu"),
                                               space, chunk, workers=4)
            cf, ck = _stream_ids(cpu_rep)
            check(np.array_equal(front, cf) and np.array_equal(topk, ck),
                  "stream_1m: ids differ from the CPU host fold")
            t0 = time.perf_counter()
            proc = sess.sweep(space, chunk_size=chunk, executor="processes",
                              workers=2)
            proc_s = time.perf_counter() - t0
            check(np.array_equal(proc.point_ids, dev_rep.point_ids)
                  and np.array_equal(proc.front_idx, dev_rep.front_idx)
                  and np.array_equal(proc.topk_idx, dev_rep.topk_idx)
                  and proc.rows() == dev_rep.rows(),
                  "stream_1m: processes differ from threads")
            check({k: v for k, v in proc.stats.items() if k != "t_exe_var"}
                  == {k: v for k, v in dev_rep.stats.items()
                      if k != "t_exe_var"}
                  and math.isclose(proc.stats["t_exe_var"],
                                   dev_rep.stats["t_exe_var"],
                                   rel_tol=1e-12),
                  "stream_1m: processes stats differ from threads")
            # constrained: an envelope and a bound, against the
            # unconstrained materialized sweep filtered after the fact
            cons = [C.EnvelopeConstraint(rt.ResourceEnvelope(
                        lsu_ports=8, interconnect_bytes=256)),
                    C.BoundConstraint("n_elems", float(1 << 20))]
            t0 = time.perf_counter()
            con = sess.sweep(space, chunk_size=chunk, constraints=cons,
                             profile=True)
            con_s = time.perf_counter() - t0
            cats = {a: SW._factorize(mat.points[a]) for a in SW._CATEGORICAL}
            mask = C.feasibility_mask(tuple(cons), C.columns_from_parts(
                {a: np.asarray(mat.points[a]) for a in SW._NUMERIC}, cats, n))
            keep = np.flatnonzero(mask)
            t_k = mat.t_exe[keep]
            want_front = keep[SW.pareto_front(np.stack(
                [t_k, mat.resource[keep]], 1))]
            want_topk = keep[np.argsort(t_k, kind="stable")[:10]]
            cfront, ctopk = _stream_ids(con)
            check(con.profile["path"] == "host-stream"
                  and con.n_candidates == n
                  and con.stats["n_points"] == len(keep) > 0,
                  f"constrained sweep: counts {con.summary()}")
            check(np.array_equal(cfront, want_front)
                  and np.array_equal(ctopk, want_topk),
                  "constrained sweep: ids differ from the post-filtered one")
            check(con.stats["t_exe_min"] == t_k.min()
                  and con.stats["t_exe_min_id"] == keep[np.argmin(t_k)]
                  and math.isclose(con.stats["t_exe_sum"], math.fsum(t_k),
                                   rel_tol=1e-12),
                  "constrained sweep: stats differ from the post-filtered one")
            row["points_per_s"].update(
                materialized=n / mat_s, cpu_host_stream=n / cpu_s,
                processes_2=n / proc_s, constrained_host_stream=n / con_s)
            row["constrained"] = {"feasible": len(keep),
                                  "profile": con.profile}
        rows.append(row)
    check(peaks["stream_10m"] <= 1.25 * peaks["stream_1m"] + (16 << 20),
          f"the 10m device fold's memory grew with the grid: {peaks}")
    emit({"phase": "stream", "rows": rows})
    return device_1m


def phase_optimize(device, full) -> None:
    """The reference's optimize_1m contract (benchmarks/sweep_bench.py) on
    the card: 2-objective search of the 1m grid against its exhaustive
    device-fold sweep ``full``."""
    import repro_torch as rt

    sess = rt.Session(device=device)
    t0 = time.perf_counter()
    rep = sess.optimize(rt.Space.grid(**grids()["grid1m"]),
                        objective=("t_exe", "resource"), seed=0)
    wall = time.perf_counter() - t0
    ref_front = {(float(full.t_exe[i]), float(full.resource[i]))
                 for i in full.pareto()}
    got = {(float(rep.front["t_exe"][i]), float(rep.front["resource"][i]))
           for i in range(rep.n_front)}
    recall = len(ref_front & got) / max(1, len(ref_front))
    descend = next(t for t in rep.trajectory if t["phase"] == "descend")
    emit({"phase": "optimize", "seconds": wall, "n_total": rep.n_total,
          "n_evals": rep.n_evals, "evals_fraction": rep.evals_fraction,
          "matched_optimum": rep.best.t_exe == full.stats["t_exe_min"],
          "front_recall": recall, "ref_front_size": len(ref_front),
          "descend": descend, "phases": [dict(t) for t in rep.trajectory]})
    check(rep.best.t_exe == full.stats["t_exe_min"],
          f"optimize: best {rep.best.t_exe} != grid min "
          f"{full.stats['t_exe_min']}")
    check(recall >= 0.95, f"optimize: front recall {recall}")
    check(rep.evals_fraction < 0.01,
          f"optimize: evals fraction {rep.evals_fraction}")
    check(descend["lanes"] > 0 and "skipped" not in descend,
          f"optimize: the descent did not run: {descend}")


def phase_validate(device):
    """``Session.validate`` over the seven card-scale kernels; returns the
    report (the workload phase calibrates a session with it)."""
    import numpy as np

    import repro_torch as rt
    from repro_torch.core.validate import default_cases

    rep = rt.Session(device=device).validate(default_cases(small=False),
                                            iters=10, warmup=3)
    check(rep.failures == [], f"validate failures: {rep.failures}")
    check([r.name for r in rep.results] == [c.name for c in default_cases()],
          "validate: the reference's seven kernels expected, in its order")
    rows = []
    for r in rep.results:
        check(np.isfinite(r.err_pct) and r.measured_s > 0
              and np.isfinite(r.predicted_s), f"validate {r.name}: {r}")
        gbs = r.bytes_moved / r.measured_s
        rows.append({"kernel": r.name, "measured_ms": r.measured_s * 1e3,
                     "predicted_ms": r.predicted_s * 1e3,
                     "err_pct": r.err_pct, "bytes": r.bytes_moved,
                     "gb_per_s": gbs / 1e9,
                     "share_of_3.35TBps": gbs / PEAK_BYTES_PER_S})
    anchor = next(r for r in rep.results if r.name == "membench_aligned")
    check(anchor.err_pct < 1e-6, f"anchor error {anchor.err_pct}")
    emit({"phase": "validate", "measured_bw_gbs": rep.measured_bw / 1e9,
          "calibration_factor": rep.calibration_factor, "rows": rows})
    return rep


#: The reference's ``serve_smoke`` traffic (benchmarks/serve_bench.py).
SERVE_CLIENTS = 32
SERVE_HOT_POOL = 64
SERVE_HOT_PASSES = 4
SERVE_COLD_PER_CLIENT = 48
SERVE_HOT_P99_BUDGET = 5.0
SERVE_THINK_S = (0.5e-3, 2e-3)


def _serve_pool(n: int, tag: str):
    """The reference bench's design pool: every LSU type, 1-4 global
    accesses, SIMD 1-16, strides 1-7, 2^12-2^16 elements."""
    import itertools

    import repro_torch as rt

    types = [rt.LsuType.BC_ALIGNED, rt.LsuType.BC_NON_ALIGNED,
             rt.LsuType.BC_WRITE_ACK, rt.LsuType.ATOMIC_PIPELINED]
    combos = itertools.cycle(
        (t, g, s, d) for t in types for g in (1, 2, 3, 4)
        for s in (1, 4, 16) for d in (1, 3, 7))
    return [rt.Design.microbench(t, n_ga=g, simd=s, delta=d,
                                 n_elems=1 << (12 + i % 5),
                                 name=f"{tag}-{i}")
            for i, (t, g, s, d) in zip(range(n), combos)]


def _pcts_us(lat_s: list) -> dict:
    """p50/p99/mean in microseconds (the reference bench's index rule)."""
    lat = sorted(lat_s)
    n = len(lat)
    pct = lambda q: lat[min(n - 1, int(q * (n - 1) + 0.999999))]  # noqa: E731
    return {"p50_us": pct(0.50) * 1e6, "p99_us": pct(0.99) * 1e6,
            "mean_us": sum(lat) / n * 1e6}


def _hammer(estimate, worklists, think_s=None):
    """One client thread per worklist; per-request latencies, the results
    in request order per client, and the wall time."""
    import threading

    import numpy as np

    lats = [[] for _ in worklists]
    outs = [[] for _ in worklists]
    errors = []
    start = threading.Barrier(len(worklists))

    def client(i: int) -> None:
        rng = np.random.default_rng(i)
        start.wait()
        try:
            for d in worklists[i]:
                t0 = time.perf_counter()
                est = estimate(d)
                lats[i].append(time.perf_counter() - t0)
                outs[i].append(est)
                if think_s is not None:
                    time.sleep(rng.uniform(*think_s))
        except BaseException as exc:  # noqa: BLE001 — fail in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(worklists))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"serve: client errors {errors[:3]}")
    return [x for per in lats for x in per], outs, wall


def _same_estimate(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in (
        "t_exe", "t_ideal", "t_ovh", "bound_ratio", "memory_bound",
        "total_bytes", "n_lsu"))


def phase_serve(device) -> None:
    """``serve_smoke`` on the card: the serial single-request baseline, 32
    hot clients over a cached 64-design pool (4 passes, 0.5-2 ms think
    time) and 32 cold clients of 48 distinct designs each with the cache
    off.  Every served estimate must be bit-equal to a serial
    ``estimate`` on the same card session, and hot p99 within 5x single."""
    import repro_torch as rt

    sess = rt.Session(device=device)
    t_phase = time.perf_counter()
    pool = _serve_pool(SERVE_HOT_POOL, "hot")
    serial = {}
    for d in pool:                                   # warm, and the oracle
        serial[d.name] = sess.estimate(d)
    lat = []
    for d in pool * 2:
        t0 = time.perf_counter()
        sess.estimate(d)
        lat.append(time.perf_counter() - t0)
    single = {"scenario": "single", "clients": 1, "requests": len(lat),
              **_pcts_us(lat), "qps": len(lat) / sum(lat)}

    with sess.serve(max_batch=64, max_wait_ms=0.5) as srv:
        for d in pool:                               # one miss per design
            srv.estimate(d)
        work = [[pool[(i * 7 + k) % len(pool)]
                 for k in range(SERVE_HOT_PASSES * len(pool))]
                for i in range(SERVE_CLIENTS)]
        lat, outs, wall = _hammer(srv.estimate, work, think_s=SERVE_THINK_S)
        st = srv.stats()
    hot = {"scenario": "serve_hot", "clients": SERVE_CLIENTS,
           "requests": len(lat), **_pcts_us(lat), "qps": len(lat) / wall,
           "cache_hit_rate": st["cache_hit_rate"]}
    hot["x_single"] = hot["p99_us"] / single["p50_us"]
    mismatched = sum(not _same_estimate(e, serial[d.name])
                     for w, o in zip(work, outs) for d, e in zip(w, o))
    check(mismatched == 0, f"serve hot: {mismatched} served != serial")

    cold_work = [_serve_pool(SERVE_COLD_PER_CLIENT, f"cold-{i}")
                 for i in range(SERVE_CLIENTS)]
    with sess.serve(max_batch=SERVE_CLIENTS, max_wait_ms=0.25,
                    cache_size=0) as srv:
        lat, outs, wall = _hammer(srv.estimate, cold_work)
        st = srv.stats()
    cold = {"scenario": "serve_cold", "clients": SERVE_CLIENTS,
            "requests": len(lat), **_pcts_us(lat), "qps": len(lat) / wall,
            "mean_batch": st["mean_batch"], "batches": st["batches"],
            "max_batch_seen": st["max_batch_seen"]}
    # the cold designs repeat the hot pool's first 48 numerically (only the
    # names differ), so the serial oracle covers them by position
    mismatched = sum(not _same_estimate(e, serial[pool[k].name])
                     for o in outs for k, e in enumerate(o))
    check(mismatched == 0, f"serve cold: {mismatched} served != serial")
    check(hot["requests"] == SERVE_CLIENTS * SERVE_HOT_PASSES * len(pool)
          and cold["requests"] == SERVE_CLIENTS * SERVE_COLD_PER_CLIENT,
          "serve: request counts")
    check(hot["x_single"] <= SERVE_HOT_P99_BUDGET,
          f"serve: hot p99 {hot['p99_us']:.1f} us is "
          f"{hot['x_single']:.2f}x single, budget {SERVE_HOT_P99_BUDGET}x")
    check(cold["mean_batch"] > 1.0, "serve: the cold run did not batch")
    emit({"phase": "serve", "rows": [single, hot, cold],
          "served_equal_serial": True,
          "seconds": time.perf_counter() - t_phase})


def phase_paper(device) -> None:
    """Table IV through the scalar model and the card's torch backend (to
    rtol 1e-12), held to ``BENCH_smoke.json``'s recorded rows; Table V and
    Fig. 5 with the port's simulator and baselines and the card session's
    estimates, held to the same tables on the scalar backend."""
    import repro_torch as rt
    from repro_torch import paper_tables
    from repro_torch.core import apps, model

    t_phase = time.perf_counter()
    card = rt.Session(dram=rt.DDR4_1866, device=device)
    scalar = rt.Session(dram=rt.DDR4_1866, backend="scalar", device="cpu")
    rows = apps.table4_rows()
    worst = 0.0
    for app, row in zip(apps.APPS.values(), rows):
        lsus = app.lsus(row["n_elems"])
        want = model._estimate(lsus, card.dram, card.bsp).t_exe
        got = card.estimate(rt.Design(lsus=tuple(lsus), name=app.name)).t_exe
        worst = max(worst, abs(got - want) / want)
    check(worst <= 1e-12, f"paper: Table IV on the card off by {worst:.3g}")
    recorded = json.loads((ROOT / "BENCH_smoke.json").read_text())
    check(rows == recorded["details"]["table4_applications"],
          "paper: Table IV rows differ from BENCH_smoke.json")
    errs = [r["err_pct"] for r in rows]
    max_err, mean_err = max(errs), sum(errs) / len(errs)
    derived = next(r["derived"] for r in recorded["summary"]
                   if r["name"] == "table4_applications")
    check(derived.startswith(
        f"max_err={max_err:.1f}% mean_err={mean_err:.1f}%"),
        f"paper: Table IV errors {max_err}/{mean_err} vs {derived!r}")

    t5 = paper_tables.table5_comparison(card)
    check(t5 == paper_tables.table5_comparison(scalar),
          "paper: Table V on the card differs from the scalar model's")
    mean = {k: sum(r[k] for r in t5) / len(t5)
            for k in ("err_ours_pct", "err_wang_pct", "err_hlscope_pct")}
    check(2 * mean["err_ours_pct"] <= min(mean["err_wang_pct"],
                                          mean["err_hlscope_pct"]),
          f"paper: Table V claim (2x less error) fails: {mean}")
    f5 = paper_tables.fig5_stride(card)
    check(f5 == paper_tables.fig5_stride(scalar),
          "paper: Fig. 5 on the card differs from the scalar model's")
    knee = {r["delta"]: r["t_norm"] for r in f5 if r["lsu"] == "bca"}
    check(knee[4] == 4.0, f"paper: Fig. 5 aligned delta 4 -> {knee[4]}")
    emit({"phase": "paper", "table4_max_err_pct": max_err,
          "table4_mean_err_pct": mean_err, "table4_card_rel_err": worst,
          "table5_mean_err_pct": mean, "table5": t5, "fig5": f5,
          "seconds": time.perf_counter() - t_phase})


def phase_predict(device) -> None:
    """``Session.predict``, ``Design.from_hlo`` and ``Session.roofline`` on
    the committed HLO fixtures against the reference's results: the HLO
    analysis is host Python and must be exact; the roofline's estimate
    runs on the card (rtol 1e-12)."""
    import repro_torch as rt
    from repro_torch.core import hlo_counter, predictor, roofline

    def same(a, b) -> bool:
        return json.loads(json.dumps(a, sort_keys=True)) == \
            json.loads(json.dumps(b, sort_keys=True))

    t_phase = time.perf_counter()
    sess = rt.Session(device=device)
    data = ROOT / "tests" / "data" / "torch_hlo"
    names = sorted(p.stem for p in data.glob("*.txt"))
    check({"matmul", "elementwise", "gather", "scan", "psum"} <= set(names),
          f"predict: fixtures missing ({names})")
    rows, roof_err = [], 0.0
    with sess.serve() as srv:
        for name in names:
            text = (data / f"{name}.txt").read_text()
            rec = json.loads((data / f"{name}.json").read_text())
            check(same(hlo_counter.record(hlo_counter.analyze(text)),
                       rec["analyze_fused"]), f"predict {name}: analyze")
            pred = sess.predict(text, rec["cost"])
            check(same(predictor.record(pred), rec["predict_step"]),
                  f"predict {name}: predict_step")
            check(srv.predict(text, rec["cost"]) is
                  srv.predict(text, rec["cost"]),
                  f"predict {name}: Server.predict not memoized")
            cell = roofline.build_cell(
                arch=name, shape="fixture", mesh=f"{rec['chips']}",
                chips=rec["chips"], hlo_text=text, cost=rec["cost"],
                model_flops_global=pred.flops * rec["chips"])
            check(same(cell.as_row(), rec["cell"]),
                  f"predict {name}: build_cell")
            design = rt.Design.from_hlo(text, name=name)
            check(same([[l.lsu_type.value, l.ls_width, l.ls_acc, l.ls_bytes,
                         l.delta, l.is_write, l.name] for l in design.lsus],
                       rec["design"]["lsus"])
                  and design.flops == rec["design"]["flops"],
                  f"predict {name}: Design.from_hlo")
            got = sess.roofline(design).rows()[0]
            want = rec["roofline"]
            for k, v in want.items():
                if isinstance(v, float) and math.isfinite(v) and v:
                    roof_err = max(roof_err, abs(got[k] - v) / abs(v))
                else:
                    check(got[k] == v, f"predict {name}: roofline {k}")
            rows.append({"module": name, "bottleneck": pred.bottleneck,
                         "t_step_ms": pred.t_step_overlapped * 1e3,
                         "roofline_bottleneck": got["bottleneck"]})
    check(roof_err <= 1e-12, f"predict: roofline off by {roof_err:.3g}")
    emit({"phase": "predict", "rows": rows, "roofline_rel_err": roof_err,
          "seconds": time.perf_counter() - t_phase})


#: The model phase: each arch of the zoo that the port serves, at its
#: published widths, bf16 activations over weights drawn from seed 0 on
#: the card and cast once (``convert.to_serving``), with all its layers
#: unless a stated deployment shares them out (``layers``, ``experts``).
#: Prefill is ``prefill_32k`` cut in batch 32 -> 2 and sequence 32,768 ->
#: 4,096 (2,048 for xlstm-1.3b); hubert-xlarge's rows are 4,096 feature
#: rows of a numpy seed, internvl2-2b's 256 patch rows of a numpy seed and
#: 3,840 text tokens.  Decode is ``decode_32k``'s one step at its last
#: position over states drawn from a seed, at batch 128 where the states
#: fit (the rings and RG-LRU states of recurrentgemma-9b: 3.4 GB), cut to
#: 8 for qwen2-7b (15.0 GB of KV cache) and qwen3-moe-235b-a22b (25.2 GB;
#: 8 is also the global batch of 128 over the reference mesh's 16-wide
#: ``data`` axis), to 16 for internvl2-2b (51.5 GB) and to 32 for
#: xlstm-1.3b (22.5 GB of mLSTM state); an encoder (hubert-xlarge) has no
#: decode and no server (``cell_status``).  ``long_500k`` runs uncut
#: where the arch is sub-quadratic and has a ring; the server takes the
#: reference serve CLI's own traffic.
#:
#: qwen3-moe-235b-a22b (235 B parameters) runs as one chip's share of the
#: reference's expert-parallel plan (``launch/sharding.py``: its 128
#: experts over the 16-wide ``model`` axis, 8 a chip), its 94 layers read
#: as two pipeline stages of 47: experts 0-7 of each of 47 layers, the
#: router at its 128 outputs and 8 experts a token, attention whole (more
#: than a chip's share) and the whole vocabulary.
MODEL_RUNS = {
    # the plain path timed too: the workload phase predicts it
    "qwen2-7b": dict(prefill=(2, 4096), decode=(8, 32768), time_plain=True),
    "recurrentgemma-9b": dict(prefill=(2, 4096), decode=(128, 32768),
                              long=(1, 524288)),
    # prefill cut to S 2,048: the six sLSTM layers are an eager loop over
    # time (~0.9 s a layer at 4,096 steps), run seven times by the phase
    "xlstm-1.3b": dict(prefill=(2, 2048), decode=(32, 32768)),
    "qwen3-moe-235b-a22b": dict(prefill=(2, 4096), decode=(8, 32768),
                                layers=47, experts=(0, 8)),
    "hubert-xlarge": dict(prefill=(2, 4096)),
    "internvl2-2b": dict(prefill=(2, 4096), decode=(16, 32768)),
}
MODEL_SERVE = dict(batch_slots=4, max_len=128, requests=8, max_new=16)
#: How the decode states are drawn (``_fill_states``).
STATE_DRAW = ("torch.Generator(seed 1): every state tensor N(0, 1) (K/V "
              "rows, h, conv, C, c, m), the normalizers n |N(0, 1)|")


def _rel_l2(got, want) -> float:
    import torch

    g, w = got.float(), want.float()
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))


def logits_check(kern, plain, exact, vocab: int, what: str) -> dict:
    """The kernel path's logits against the plain path's (``TOL
    ["model_logits"]``), over the real vocabulary: within ``of_floor``
    times the plain path's own distance from ``exact``, the plain path run
    with f32 activations on the same weights."""
    import torch

    k, p, e = (t[..., :vocab].float() for t in (kern, plain, exact))
    check(k.shape == p.shape == e.shape and bool(torch.isfinite(k).all()),
          f"{what}: logits not finite or misshapen")
    floor = _rel_l2(p, e)
    dist = _rel_l2(k, p)
    bound = TOL["model_logits"]["of_floor"] * floor
    row = {"rel_l2_kernel_vs_plain": dist, "rel_l2_plain_vs_f32": floor,
           "rel_l2_kernel_vs_f32": _rel_l2(k, e), "bound": bound,
           "greedy_agreement": float((k.argmax(-1) == p.argmax(-1))
                                     .float().mean())}
    check(0.0 < floor and dist <= bound,
          f"{what}: kernel path logits {dist:.3g} from the plain path's, "
          f"bound {bound:.3g}")
    return row


def _weight_bytes(model) -> int:
    """Bytes of every parameter a step reads whole: all but the embedding
    table, of which a step reads only its tokens' rows."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if name != "embed")


def _expert_bytes(model) -> tuple[int, int]:
    """(bytes of one held expert's wi, wg and wo in one layer, of every held
    expert in every layer); (0, 0) without MoE."""
    mods = [layer.moe for layer in model.layers if hasattr(layer, "moe")]
    if not mods:
        return 0, 0
    total = sum(getattr(m, k).numel() * getattr(m, k).element_size()
                for m in mods for k in ("wi", "wg", "wo"))
    return total // (len(mods) * mods[0].wi.shape[0]), total


def _product_params(model) -> tuple[int, int]:
    """(weights the layers multiply in bf16 on the tensor cores for every
    token, weights they multiply in f32): every dense weight and the
    mLSTM's per-head maps; the sLSTM's input projection and the MoE router
    are f32 (``to_serving`` keeps them).  The MoE experts multiply only
    the rows routed to them (``_moe_rows``)."""
    bf16 = f32 = 0
    for name, p in model.layers.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(("cell.w.w", "moe.router.w")):
            f32 += p.numel()
        elif leaf == "w" or leaf in ("wq", "wk", "wv"):
            bf16 += p.numel()
    return bf16, f32


def _bound(nbytes: float, flops: float, f32_flops: float = 0.0) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_TENSOR_FLOPS + f32_flops / PEAK_FP32_FLOPS
    return {"bytes": nbytes, "flops": flops + f32_flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _state_bytes(cfg, caches, index: int) -> float:
    """Bytes one decode step at ``index`` must move through the states: the
    live rows of every KV cache or ring read once (and the new row
    written), every recurrent state read and written once."""
    total = 0.0
    for kind, cache in zip(cfg.block_kinds, caches):
        if kind in ("attn", "local"):
            k = cache["k"]
            live = min(index + 1, k.shape[1])
            total += 2 * (live + 1) * k[:, 0].numel() * k.element_size()
        else:
            total += 2 * sum(t.numel() * t.element_size()
                             for t in cache.values())
    return total


def _fill_states(caches, seed: int = 1) -> None:
    """Every decode state drawn from a seed (``STATE_DRAW``)."""
    import torch

    gen = torch.Generator(device=caches[0][next(iter(caches[0]))].device)
    gen.manual_seed(seed)
    for cache in caches:
        for name, t in cache.items():
            t.normal_(generator=gen)
            if name == "n":
                t.abs_()


def _snapshot(cfg, caches, index: int) -> list[dict]:
    """What a decode step at ``index`` writes: of a KV cache or ring the
    row at its slot (``index`` modulo its length), of a recurrent state
    the whole tensor.  (slot or None, copy) by state name."""
    snap = []
    for kind, cache in zip(cfg.block_kinds, caches):
        slot = (index % cache["k"].shape[1]
                if kind in ("attn", "local") else None)
        snap.append({name: (slot, (t if slot is None else t[:, slot]).clone())
                     for name, t in cache.items()})
    return snap


def _restore(caches, snap) -> None:
    for cache, saved in zip(caches, snap):
        for name, (slot, t) in saved.items():
            (cache[name] if slot is None else cache[name][:, slot]).copy_(t)


class first_calls:
    """Within the block, record the arguments of the first call of each
    model-path kernel entry (``ATT.mha``, ``ATT.gqa_decode``,
    ``REC.rglru_scan``, ``ML.chunked_mlstm``, ``MOE.combine``) and of
    ``XL.slstm_forward``
    as the model makes it; the calls go through unchanged and are counted
    by the wrappers as ever."""

    def __init__(self):
        from repro_torch.kernels.mlstm_chunk import ops as ML
        from repro_torch.models import attention as ATT
        from repro_torch.models import moe as MOE
        from repro_torch.models import recurrent as REC
        from repro_torch.models import xlstm as XL

        self.sites = {"mha": ATT, "gqa_decode": ATT, "rglru_scan": REC,
                      "chunked_mlstm": ML, "combine": MOE,
                      "slstm_forward": XL}
        self.calls: dict = {}

    def __enter__(self):
        self.saved = {name: getattr(mod, name)
                      for name, mod in self.sites.items()}
        for name, mod in self.sites.items():
            def wrapper(*args, _name=name, **kwargs):
                self.calls.setdefault(_name, (args, kwargs))
                return self.saved[_name](*args, **kwargs)
            setattr(mod, name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        for name, mod in self.sites.items():
            setattr(mod, name, self.saved[name])


class last_rows:
    """Within the block, record every layer's output at the last position
    (``TF._block_forward``), f32: where the paths of ``logits_check``
    part along the stack; with ``inputs``, also each layer's whole input
    and RoPE tables (``_fed_layers``)."""

    def __init__(self, inputs: bool = False):
        from repro_torch.models import transformer as TF

        self.TF, self.rows, self.inputs = TF, [], [] if inputs else None

    def __enter__(self):
        self.saved = self.TF._block_forward

        def wrapper(p, cfg, kind, x, rot):
            if self.inputs is not None:
                self.inputs.append((x, rot))
            out = self.saved(p, cfg, kind, x, rot)
            self.rows.append(out[0][:, -1].float())
            return out
        self.TF._block_forward = wrapper
        return self

    def __exit__(self, *exc):
        self.TF._block_forward = self.saved


class routing:
    """Within the block, record every MoE layer call's routing as the model
    computes it (``MOE.assign``): its experts and keep mask, (tokens, k)."""

    def __init__(self):
        from repro_torch.models import moe as MOE

        self.MOE, self.calls = MOE, []

    def __enter__(self):
        self.saved = self.MOE.assign

        def wrapper(p, cfg, x, impl):
            out = self.saved(p, cfg, x, impl)
            experts, pos, C = out[2], out[3], out[4]
            k = experts.shape[-1]
            self.calls.append((experts.reshape(-1, k), (pos < C).reshape(-1, k)))
            return out
        self.MOE.assign = wrapper
        return self.calls

    def __exit__(self, *exc):
        self.MOE.assign = self.saved


def _moe_rows(calls, held: tuple[int, int]) -> dict:
    """Per MoE layer call and held expert: the (token, slot) pairs routed
    to it and those kept under the capacity; the held experts that kept a
    pair; the pairs dropped over all experts."""
    import torch

    experts = torch.stack([e for e, _ in calls])
    keep = torch.stack([k for _, k in calls])
    hit = experts[..., None] == torch.arange(*held, device=experts.device)
    routed = hit.sum((1, 2))
    kept = (hit & keep[..., None]).sum((1, 2))
    return {"routed": routed.tolist(), "kept": kept.tolist(),
            "touched": (kept > 0).sum(-1).tolist(),
            "pairs": experts.numel(),
            "dropped_all_experts": int((~keep).sum())}


def _routing_summary(rows: dict) -> dict:
    """The first layer call's routing by held expert, and the sums."""
    routed, kept = rows["routed"], rows["kept"]
    return {"first_call": {"routed": routed[0], "kept": kept[0],
                           "dropped": [r - k for r, k in zip(routed[0],
                                                              kept[0])]},
            "calls": len(routed), "pairs": rows["pairs"],
            "routed_to_held": sum(map(sum, routed)),
            "kept_by_held": sum(map(sum, kept)),
            "dropped_by_capacity_held": sum(map(sum, routed))
            - sum(map(sum, kept)),
            "dropped_by_capacity_all": rows["dropped_all_experts"],
            "held_touched_by_call": rows["touched"]}


def _choice_flips(a, b) -> list[int]:
    """Per MoE layer call, the (token, slot) choices of run ``a`` that run
    ``b`` did not make for the same token."""
    return [int((~(ea[:, :, None] == eb[:, None, :]).any(-1)).sum())
            for (ea, _), (eb, _) in zip(a, b)]


def _fed_layers(model, cfgs: dict, inputs) -> list:
    """Each layer fed the plain path's input to it, on every configuration
    of ``cfgs`` (kernel, plain, f32): rel-L2 over every position of the
    layer's output, kernel path vs plain and plain vs f32."""
    import torch

    from repro_torch.models import transformer as TF

    out = []
    with torch.no_grad():
        for layer, kind, (x, rot) in zip(model.layers,
                                         cfgs["plain"].block_kinds, inputs):
            y = {name: TF._block_forward(
                layer, c, kind, x.float() if name == "f32" else x, rot)[0]
                for name, c in cfgs.items()}
            out.append([_rel_l2(y["kernel"], y["plain"]),
                        _rel_l2(y["plain"], y["f32"])])
    return out


def _of_floor(pairs) -> float:
    """The worst ratio of a distance to its floor over [distance, floor]
    pairs."""
    return max(k / f if f else (math.inf if k else 0.0) for k, f in pairs)


def _layer_checks(calls: dict) -> dict:
    """Each model-path kernel on the inputs of its first call in the
    counted run, against its plain version within its card tolerance."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.mlstm_chunk import ops as ML
    from repro_torch.kernels.moe_combine import ops as MC
    from repro_torch.kernels.rglru import ops as RG

    out = {}
    for name, (args, kw) in calls.items():
        if name == "mha":
            ref = functools.partial(FA.attention_ref,
                                    causal=kw.get("causal", True),
                                    window=kw.get("window"),
                                    softcap=kw.get("softcap", 0.0))
            q, k, v = args
            row = compare(FA.mha(*args, **kw), ref(q, k, v), "flash_card",
                          ref(q, k, v.abs()).float())
        elif name == "gqa_decode":
            row = compare(DA.gqa_decode(*args, **kw),
                          DA.gqa_decode_ref(*args, **kw), "bfloat16_card")
        elif name == "rglru_scan":
            row = compare(RG.scan(*args), RG.rglru_scan_ref(*args),
                          "rglru_card")
        elif name == "chunked_mlstm":
            row = compare(ML.chunked_mlstm(*args, **kw),
                          ML.chunked_mlstm_ref(*args, **kw), "mlstm_card",
                          ML.chunked_mlstm_spread(*args, **kw))
        elif name == "combine":
            row = compare(MC.combine(*args), MC.combine_ref(*args),
                          "moe_combine_card", combine_spread(*args))
        else:
            continue
        err, of_bound, ok = row
        check(ok, f"model: the first {name} call off by {err}")
        out[name] = {"shapes": _shapes(args), "max_abs_err": err,
                     "err_of_bound": of_bound}
    return out


def _prefill_batch(cfg, B: int, S: int, rng, device) -> dict:
    """S rows of a prefill: token ids, or stub-frontend features from a
    numpy seed (every row for audio; ``vision_patches(S)`` rows before the
    text for vision)."""
    import numpy as np
    import torch

    from repro_torch.configs.shapes import vision_patches

    n_feat = {"audio": S, "vision": vision_patches(S)}.get(cfg.frontend, 0)
    batch = {}
    if n_feat:
        batch["features"] = torch.as_tensor(
            rng.standard_normal((B, n_feat, cfg.frontend_dim),
                                dtype=np.float32), device=device
        ).to(cfg.activation_dtype)
    if S > n_feat:
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (B, S - n_feat)),
            dtype=torch.int32, device=device)
    return batch


def phase_model(device, wrappers: dict, arch: str, runs: dict | None = None,
                model=None) -> dict:
    """One arch of the zoo served on the card through its entry points:
    (a) ``make_prefill_step`` (K5 once an attention layer, K6 once an
    RG-LRU layer, K7 once an mLSTM layer, K8 once an MoE layer of the
    einsum semantics), (b) one ``make_decode_step`` at
    position 32,767 over states drawn from a seed (K4 once an attention
    layer; the recurrent layers run no kernel), (b') the same at position
    524,287 where the arch runs ``long_500k``, (c) ``BatchedServer`` with
    the reference CLI's traffic (K4 once an attention layer a step); an
    encoder runs (a) alone.  Each part is driven with every launch
    counter at zero and read just after; each kernel is then held to its
    plain version on the inputs of its first call (``first_calls``), and
    the logits to the plain path's and an f32 run's (``logits_check``),
    with every state restored between the three.  An MoE model records
    its routing (``routing``) on each part's counted run and the choices
    that the plain and f32 runs make otherwise; its bounds multiply the
    rows the held experts keep and read the held experts that kept one.
    The checks and timings launch more and are not counted; with
    ``time_plain`` the plain path's prefill and decode step are timed too.
    ``runs`` defaults to ``MODEL_RUNS[arch]``; ``server=False`` in it
    leaves (c) out.  ``model``: parameters to serve (the train phase's
    trained model, cast here) in place of the seed-0 draw.  Returns the
    counts by part and the parts' results (with ``init``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, cell_status
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.mlstm_chunk import ops as ML
    from repro_torch.launch import serve as SERVE
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.models.convert import to_serving

    # the f32 reference run in full f32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    runs = runs or MODEL_RUNS[arch]
    cfg = get_config(arch)
    if runs.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=runs["layers"])
    check(("decode" in runs) == cell_status(cfg, SHAPES["decode_32k"])[0],
          f"{arch}: a decode part where the arch has none, or none where "
          "it has one")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    f32_cfg = dataclasses.replace(plain_cfg, dtype="float32")
    V = cfg.vocab_size
    kinds = cfg.block_kinds
    n_attn = sum(k in ("attn", "local") for k in kinds)
    rng = np.random.default_rng(0)

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def counts(what: str, **want_nonzero) -> dict:
        got = {name: fn.launches for name, fn in wrappers.items()}
        want = dict.fromkeys(got, 0)
        want.update({k: v for k, v in want_nonzero.items() if v})
        check(got == want, f"model {arch} {what}: launches {got}, "
              f"expected {want}")
        return got

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    held = runs.get("experts")
    weights = "trained (train phase)" if model is not None else "seed 0"
    if model is None:
        model = TF.init_params(cfg, seed=0, device=device, experts=held)
    built_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    model = to_serving(model)
    torch.cuda.synchronize()
    init = {"weights": weights,
            "seconds": time.perf_counter() - t0, "layers": cfg.n_layers,
            "param_bytes_as_built": built_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "serving_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters())}
    launches = {}
    bf16_params, f32_params = _product_params(model)
    expert_one, expert_all = _expert_bytes(model)
    if cfg.is_moe:
        held = held or (0, cfg.n_experts)
        d, f = cfg.d_model, cfg.d_ff
        init.update(experts_held=list(held), n_experts=cfg.n_experts,
                    expert_bytes_held=expert_all)

    def expert_flops(rows: dict) -> float:
        """Products of the rows the held experts keep (wi, wg, wo)."""
        return 6.0 * d * f * sum(map(sum, rows["kept"])) if cfg.is_moe else 0.0

    # (a) prefill
    t_part = time.perf_counter()
    B, S = runs["prefill"]
    torch.cuda.reset_peak_memory_stats()
    batch = _prefill_batch(cfg, B, S, rng, device)
    prefill = make_prefill_step(cfg)
    zero()
    with first_calls() as calls, routing() as routed:
        logits = prefill(model, batch)
        torch.cuda.synchronize()
    launches["prefill"] = counts(
        "prefill", flash_attention=n_attn,
        rglru_scan=kinds.count("rglru"), mlstm_chunk=kinds.count("mlstm"),
        moe_combine=n_attn if cfg.is_moe and cfg.moe_impl == "einsum" else 0)
    part_a = {"batch": B, "seq": S,
              "features": tuple(batch["features"].shape)
              if "features" in batch else None,
              "layers": _layer_checks(calls)}
    rows, routes = {}, {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg), ("f32", f32_cfg)):
        with last_rows(inputs=cfg.is_moe and name == "plain") as rows[name], \
                routing() as routes[name]:
            out = make_prefill_step(c)(model, batch)
        if name != "kernel":
            part_a[f"{name}_logits"] = out
    part_a.update(logits_check(logits, part_a.pop("plain_logits"),
                               part_a.pop("f32_logits"), V, f"{arch} prefill"))
    # rel-L2 at the last position after each layer: kernel path vs plain
    # path, and plain path vs its f32 run (the noise floor)
    part_a["by_layer"] = [
        [_rel_l2(k, p), _rel_l2(p, e)]
        for k, p, e in zip(rows["kernel"].rows, rows["plain"].rows,
                           rows["f32"].rows)]
    worst = _of_floor(part_a["by_layer"])
    deferred = []
    if not (len(part_a["by_layer"]) == cfg.n_layers
            and worst <= TOL["model_logits"]["of_floor"]):
        deferred.append(f"{arch} prefill: a layer's output on the kernel "
                        f"path is {worst:.3g} times the plain path's "
                        "distance from f32")
    part_a["by_layer_worst_of_floor"] = worst
    part_a["by_layer"] = [[round(k, 5), round(f, 5)]
                          for k, f in part_a["by_layer"]]
    if cfg.is_moe:
        moe_rows = _moe_rows(routed, held)
        g, _, C = MOE.groups(cfg, B, S, "einsum")
        part_a["routing"] = {
            **_routing_summary(moe_rows), "groups": g, "capacity": C,
            "flips_kernel_vs_plain": _choice_flips(routes["kernel"],
                                                   routes["plain"]),
            "flips_plain_vs_f32": _choice_flips(routes["plain"],
                                                routes["f32"])}
        fed = _fed_layers(model, {"kernel": cfg, "plain": plain_cfg,
                                  "f32": f32_cfg}, rows["plain"].inputs)
        part_a["fed_layers"] = [[round(k, 5), round(f, 5)] for k, f in fed]
        part_a["fed_layers_worst_of_floor"] = _of_floor(fed)
    del rows, routes
    flops = 2.0 * B * S * bf16_params
    for kind in kinds:
        if kind in ("attn", "local"):
            flops += 4.0 * B * cfg.n_heads * cfg.head_dim * FA.live_pairs(
                S, S, window=cfg.local_window if kind == "local" else None,
                causal=cfg.is_decoder)
    if "chunked_mlstm" in calls:
        args, kw = calls["chunked_mlstm"]
        flops += kinds.count("mlstm") * ML.mlstm_chunk_traffic(*args,
                                                               **kw)["flops"]
    if "features" in batch:
        flops += 2.0 * batch["features"].numel() * cfg.d_model
    flops += 2.0 * B * cfg.d_model * cfg.padded_vocab
    if cfg.is_moe:
        flops += expert_flops(moe_rows)
        part_a["routing"]["rows_multiplied"] = (
            (held[1] - held[0]) * g * C * cfg.n_layers)
    nbytes = (_weight_bytes(model) + B * S * cfg.d_model * 2
              + B * cfg.padded_vocab * 2)
    part_a.update(_bound(nbytes, flops, 2.0 * B * S * f32_params))
    part_a["ms"] = time_ms(lambda: prefill(model, batch), device, iters=2,
                           warmup=1)
    part_a["tok_per_s"] = B * S / part_a["ms"] * 1e3
    if runs.get("time_plain"):
        plain_step = make_prefill_step(plain_cfg)
        part_a["plain_ms"] = time_ms(lambda: plain_step(model, batch), device,
                                     iters=1, warmup=1)
    part_a["profile"] = device_profile(lambda: prefill(model, batch), top=8)
    if "slstm_forward" in calls:
        from repro_torch.models import xlstm as XL

        args, kw = calls["slstm_forward"]
        one = time_ms(lambda: XL.slstm_forward(*args, **kw), device, iters=1,
                      warmup=1)
        part_a["slstm_loops_ms"] = one * kinds.count("slstm")
        part_a["slstm_layers"] = kinds.count("slstm")
    part_a["peak_bytes"] = torch.cuda.max_memory_allocated()
    part_a["seconds"] = time.perf_counter() - t_part
    del logits, calls, batch, routed
    torch.cuda.empty_cache()

    def moe_weight_bytes(touched: float) -> dict:
        """Weights a step reads where the held experts that kept a pair
        are ``touched`` (summed over layers); all held beside them."""
        return {"weight_bytes": _weight_bytes(model) - expert_all
                + touched * expert_one,
                "weight_bytes_all_held": _weight_bytes(model)}

    # (b) one decode step at depth, and (b') at the long shape
    def decode_part(what: str, B: int, S: int) -> dict:
        t_part = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        caches = TF.init_caches(cfg, B, S, device=device)
        _fill_states(caches)
        snap = _snapshot(cfg, caches, S - 1)
        tok = torch.as_tensor(rng.integers(0, V, (B, 1)), dtype=torch.int32,
                              device=device)
        index = torch.tensor([S - 1], device=device)
        step = make_decode_step(cfg)
        zero()
        with first_calls() as calls, routing() as routed:
            _, logits, _ = step(model, tok, caches, index)
            torch.cuda.synchronize()
        launches[what] = counts(what, decode_attention=n_attn)
        part = {"batch": B, "index": S - 1, "layers": _layer_checks(calls)}
        runs_, routes = {}, {"kernel": routed}
        for name, c in (("plain", plain_cfg), ("f32", f32_cfg)):
            _restore(caches, snap)
            with routing() as routes[name]:
                runs_[name] = make_decode_step(c)(model, tok, caches, index)[1]
        if n_attn:
            part.update(logits_check(logits, runs_["plain"], runs_["f32"], V,
                                     f"{arch} {what}"))
        else:
            # no kernel runs: use_kernels must change nothing
            check(torch.equal(logits, runs_["plain"]),
                  f"{arch} {what}: the plain path's logits differ from the "
                  "kernel path's though no kernel ran")
            part["kernel_equals_plain"] = True
            part["rel_l2_plain_vs_f32"] = _rel_l2(runs_["plain"][..., :V],
                                                  runs_["f32"][..., :V])
        _restore(caches, snap)
        del snap, runs_
        torch.cuda.empty_cache()
        states = _state_bytes(cfg, caches, S - 1)
        weights = {"weight_bytes": _weight_bytes(model)}
        flops = 2.0 * B * bf16_params
        if cfg.is_moe:
            moe_rows = _moe_rows(routed, held)
            part["routing"] = {
                **_routing_summary(moe_rows), "capacity": MOE.capacity(cfg, B),
                "flips_kernel_vs_plain": _choice_flips(routes["kernel"],
                                                       routes["plain"]),
                "flips_plain_vs_f32": _choice_flips(routes["plain"],
                                                    routes["f32"])}
            weights = moe_weight_bytes(sum(moe_rows["touched"]))
            part["bound_all_held"] = _bound(
                weights["weight_bytes_all_held"] + states
                + B * cfg.d_model * 2 + B * cfg.padded_vocab * 2,
                flops + expert_flops(moe_rows), 2.0 * B * f32_params)
            flops += expert_flops(moe_rows)
        part.update(_bound(weights["weight_bytes"] + states
                           + B * cfg.d_model * 2 + B * cfg.padded_vocab * 2,
                           flops, 2.0 * B * f32_params))
        part.update(state_bytes=states, **weights, states_drawn=STATE_DRAW)
        ms = time_ms(lambda: step(model, tok, caches, index), device,
                     iters=5, warmup=2)
        if runs.get("time_plain"):
            plain_step = make_decode_step(plain_cfg)
            part["plain_ms_per_step"] = time_ms(
                lambda: plain_step(model, tok, caches, index), device,
                iters=3, warmup=1)
        part.update(ms_per_step=ms, tok_per_s=B / ms * 1e3,
                    bound_tok_per_s=B / part["bound_ms"] * 1e3,
                    profile=device_profile(
                        lambda: step(model, tok, caches, index), top=8),
                    peak_bytes=torch.cuda.max_memory_allocated())
        # the profiler slows the host, so its own wall time overstates the
        # step; the device's share of the step as timed above
        part["device_share_of_step"] = part["profile"]["device_ms"] / ms
        part["seconds"] = time.perf_counter() - t_part
        del caches, logits, calls, routed, routes
        torch.cuda.empty_cache()
        return part

    parts = {"prefill": part_a}
    if "decode" in runs:
        parts["decode"] = decode_part("decode", *runs["decode"])
    if "long" in runs:
        parts["long"] = decode_part("long", *runs["long"])

    # (c) the batched server, the reference CLI's traffic
    if "decode" in runs and runs.get("server", True):
        sv = MODEL_SERVE
        torch.cuda.reset_peak_memory_stats()
        server = SERVE.BatchedServer(cfg, batch_slots=sv["batch_slots"],
                                     max_len=sv["max_len"], params=model,
                                     device=device)
        reqs = SERVE.cli_requests(cfg, sv["requests"], sv["max_new"])
        zero()
        t0 = time.perf_counter()
        with routing() as routed:
            server.run(reqs)
        wall = time.perf_counter() - t0
        m = server.metrics
        steps = m["prefill_steps"] + m["decode_steps"]
        launches["serve"] = counts("serve", decode_attention=n_attn * steps)
        check(all(len(r.generated) == sv["max_new"] and r.done
                  and all(0 <= t < V for t in r.generated) for r in reqs),
              f"model {arch} serve: a request lacks its tokens or has one "
              "outside the vocabulary")
        weights = {"weight_bytes": _weight_bytes(model)}
        if cfg.is_moe:
            moe_rows = _moe_rows(routed, held)
            weights = moe_weight_bytes(sum(moe_rows["touched"]) / steps)
            served_routing = {"held_touched_a_step": sum(moe_rows["touched"])
                              / steps, "dropped_by_capacity_all":
                              moe_rows["dropped_all_experts"]}
        step_bound = _bound(weights["weight_bytes"] + _state_bytes(
            cfg, server.caches, sv["max_len"] - 1), 0.0)
        parts["serve"] = {
            **sv, "seconds": wall, **m,
            "decode_tok_per_s": m["new_tokens"] / m["decode_s"],
            "ms_per_step": (m["prefill_s"] + m["decode_s"]) / steps * 1e3,
            "bound_ms_per_step": step_bound["bound_ms"],
            "bound_decode_tok_per_s": sv["batch_slots"]
            / step_bound["bound_ms"] * 1e3, **weights,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "first_tokens": [r.generated[:4] for r in reqs[:2]]}
        if cfg.is_moe:
            parts["serve"]["routing"] = served_routing
        del server, routed
    emit({"phase": "model", "arch": cfg.name, "init": init, **parts,
          "launches": launches, "tolerance": TOL["model_logits"],
          "seconds": time.perf_counter() - t_phase})
    del model
    torch.cuda.empty_cache()
    check(not deferred, "; ".join(deferred))
    return launches, {"init": init, **parts}


#: The train phase: stablelm-3b, whose f32 parameters, gradients and AdamW
#: moments (16 bytes a parameter, 44.8 GB at 2.80 B) fit on one card with
#: room for activations; qwen2-7b (122 GB) and recurrentgemma-9b (153 GB)
#: do not.  (b) runs it at full width and depth, the batch cut from the
#: reference mesh's 16 x 4,096 a shard to 4 x 4,096: at 16 the f32 logits
#: and their gradient (~33 GB) do not fit beside the 44.8 GB of state.
TRAIN_ARCH = "stablelm-3b"
TRAIN_FULL = dict(batch=4, seq=4096, steps=5, lr=3e-4, warmup_steps=1,
                  seed=0)
#: (a) and (c) at ``reduced_config`` in f32: the reference e2e tests'
#: optimizer (lr 5e-3, warmup 2), decay 0.1 in (a).
TRAIN_SMALL = dict(batch=4, seq=64, steps=3, lr=5e-3, warmup_steps=2)
TRAIN_RESUME_ARCH = "xlstm-1.3b"
#: (d) serves the trained model: prefill at B 2 x 4,096, one decode step at
#: B 8 over 4,096 rows (at 32,768 its KV cache would take 86 GB).
TRAIN_SERVE = dict(prefill=(2, 4096), decode=(8, 4096), server=False)
#: card against CPU: losses and each parameter (relative L2 a leaf).
TRAIN_TOL = 1e-4


def _leaf_rel_l2(got: dict, want: dict) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(got[k].float().cpu()
                                              - want[k].float().cpu())
                     / torch.linalg.vector_norm(want[k].float().cpu()))
            for k in want}


def phase_train(device, wrappers: dict) -> tuple[dict, dict]:
    """Training on the card (``make_train_step``, ``train_loop``,
    ``CheckpointManager``), on the plain path: the kernels have no
    backward, so a train step launches none, which the phase checks.
    (a) ``reduced_config(stablelm-3b)`` in f32, the same seed-0 weights
    (drawn on the CPU and copied) and three ``SyntheticDataset`` batches on
    the card and on the CPU: losses and final parameters to rtol
    ``TRAIN_TOL``.  (b) stablelm-3b at full width and depth (2.80 B f32
    parameters, bf16 activations, remat, f32 moments), ``TRAIN_FULL``'s
    fixed batch for five steps: every loss finite and the last below the
    first; ms a step beside the products' bound, tokens/s, peak memory,
    and the device's share of a sixth step under the profiler.  (c)
    ``train_loop`` at ``reduced_config(xlstm-1.3b)``: ten steps equal
    five, a stop and five resumed (rel 1e-4), and a checkpoint of bf16
    moments restored bit for bit.  (d) the trained model, its optimizer
    state freed, cast once and served by ``phase_model`` (K5 on prefill,
    K4 on decode).  Returns (d)'s launch counts by part, its parts, and
    (b)'s step measured for the mesh phase's (e) (``live_bytes``)."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train as TRAIN
    from repro_torch.launch.steps import (TrainConfig, build_step,
                                          make_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.models.convert import load
    from repro_torch.optim.adamw import OptimizerConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    for fn in wrappers.values():
        fn.launches = 0
    out = {"arch": TRAIN_ARCH}

    # (a) the card against the CPU
    t0 = time.perf_counter()
    sm = TRAIN_SMALL
    cfg = dataclasses.replace(reduced_config(get_config(TRAIN_ARCH)),
                              dtype="float32", use_kernels=False)
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        lr=sm["lr"], warmup_steps=sm["warmup_steps"], total_steps=30))
    ds = SyntheticDataset(cfg, DataConfig(seq_len=sm["seq"],
                                          batch_size=sm["batch"], seed=1))
    weights = TF.init_params(cfg, seed=0, device="cpu").state_dict()
    runs = []
    for where in (device, torch.device("cpu")):
        model = load(cfg, {k: v.clone() for k, v in weights.items()},
                     device=where)
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        step = make_train_step(cfg, tcfg)
        losses = []
        for i in range(sm["steps"]):
            model, opt, m = step(model, opt, ds.get_batch(i))
            losses.append(float(m["loss"]))
        runs.append((losses, {k: p.detach() for k, p in
                              model.named_parameters()}))
    (card_loss, card_p), (cpu_loss, cpu_p) = runs
    loss_err = max(abs(a / b - 1) for a, b in zip(card_loss, cpu_loss))
    leaf_err = _leaf_rel_l2(card_p, cpu_p)
    worst = max(leaf_err, key=leaf_err.get)
    out["card_vs_cpu"] = {
        "config": cfg.name, "dtype": cfg.dtype, "batch": sm["batch"],
        "seq": sm["seq"], "steps": sm["steps"], "losses_card": card_loss,
        "losses_cpu": cpu_loss, "loss_rel_err": loss_err,
        "param_rel_l2_worst": [worst, leaf_err[worst]], "tol": TRAIN_TOL,
        "seconds": time.perf_counter() - t0}
    check(loss_err <= TRAIN_TOL and leaf_err[worst] <= TRAIN_TOL,
          f"train (a): the card's losses {card_loss} or parameter {worst} "
          f"({leaf_err[worst]:.3g}) differ from the CPU's beyond "
          f"{TRAIN_TOL}")
    del runs, card_p, cpu_p, model, opt

    # (b) full width and depth
    t0 = time.perf_counter()
    fw = TRAIN_FULL
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tcfg, model, opt, batch, step = _train_full(device)
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = torch.cuda.memory_allocated()
    metrics, walls = [], []
    for _ in range(fw["steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train (b): losses {losses} not finite or not falling")
    profile = device_profile(lambda: step(model, opt, batch), top=8)
    # the mesh phase's (e): a seventh step's peak rise against its capture
    live = live_bytes("train", step, (model, opt, batch),
                      lambda: _train_fakes(cfg, tcfg, batch, device))
    tokens = fw["batch"] * fw["seq"]
    layer_bf16, _ = _product_params(model)
    head = cfg.d_model * cfg.padded_vocab
    pairs = FA.live_pairs(fw["seq"], fw["seq"], window=None, causal=True)
    # forward, remat recompute and backward (twice the forward) of every
    # layer product; forward and backward of the head; the causal
    # attention's two products the same four times
    flops = tokens * (8.0 * layer_bf16 + 6.0 * head) + 16.0 * fw["batch"] \
        * cfg.n_heads * cfg.head_dim * pairs * cfg.n_layers
    # each parameter read and written, its gradient written and read, both
    # moments read and written (f32), the batch read once
    nbytes = 4.0 * n_params * (2 + 2 + 4) + 2 * tokens * 4
    steady = walls[1:]
    ms = sorted(w * 1e3 for w in steady)
    med = ms[len(ms) // 2] if len(ms) % 2 else sum(ms[len(ms) // 2 - 1:
                                                   len(ms) // 2 + 1]) / 2
    out["full_width"] = {
        "config": cfg.name, "params": n_params, "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "remat": cfg.remat,
        "state_dtype": tcfg.optimizer.state_dtype, "batch": fw["batch"],
        "seq": fw["seq"], "lr": fw["lr"], "warmup_steps": fw["warmup_steps"],
        "total_steps": fw["steps"], "losses": losses,
        "lr_by_step": [m["lr"] for m in metrics],
        "grad_norm_by_step": [m["grad_norm"] for m in metrics],
        "step_ms": [w * 1e3 for w in walls],
        "ms_per_step_median_steps_2_to_5": med,
        "ms_per_step_min_max_steps_2_to_5": [ms[0], ms[-1]],
        "tok_per_s": tokens / med * 1e3,
        "state_bytes_before_step": state_bytes, "peak_bytes": peak,
        **_bound(nbytes, flops),
        "profile_step_6": profile,
        "device_share_of_step": profile["device_ms"] / med,
        "live_bytes_step_7": live,
        "seconds": time.perf_counter() - t0}
    del opt, batch, step
    torch.cuda.empty_cache()

    # (c) the loop: resume and bf16 moments
    t0 = time.perf_counter()
    rcfg = dataclasses.replace(reduced_config(get_config(TRAIN_RESUME_ARCH)),
                               use_kernels=False)
    rt = TrainConfig(optimizer=OptimizerConfig(
        lr=sm["lr"], warmup_steps=sm["warmup_steps"], total_steps=10,
        weight_decay=0.0))
    built = build_step(rcfg, ShapeSpec("t", 32, 4, "train"), rt,
                       device=device)
    data_cfg = DataConfig(seq_len=32, batch_size=4, seed=3)
    kw = dict(data_cfg=data_cfg, ckpt_every=100, log_every=100)
    with tempfile.TemporaryDirectory() as tmp:
        m1 = TRAIN.train_loop(rcfg, built, rt, steps=10,
                              ckpt_dir=f"{tmp}/whole",
                              preemption=TRAIN.PreemptionHandler(), **kw)
        TRAIN.train_loop(rcfg, built, rt, steps=5, ckpt_dir=f"{tmp}/split",
                         preemption=TRAIN.PreemptionHandler(), **kw)
        m2 = TRAIN.train_loop(rcfg, built, rt, steps=10,
                              ckpt_dir=f"{tmp}/split",
                              preemption=TRAIN.PreemptionHandler(), **kw)
        resume_err = abs(m2["loss"] / m1["loss"] - 1)
        check(m1["final_step"] == m2["final_step"] == 10
              and resume_err <= 1e-4,
              f"train (c): resumed loss {m2['loss']} against "
              f"{m1['loss']} uninterrupted")
        bt = dataclasses.replace(rt, optimizer=dataclasses.replace(
            rt.optimizer, state_dtype="bfloat16"))
        bbuilt = build_step(rcfg, ShapeSpec("t", 32, 4, "train"), bt,
                            device=device)
        TRAIN.train_loop(rcfg, bbuilt, bt, steps=2, ckpt_dir=f"{tmp}/bf16",
                         preemption=TRAIN.PreemptionHandler(), **kw)
        p = TF.init_params(rcfg, seed=0, device=device)
        like = TRAIN.train_state(p, adamw_init(dict(p.named_parameters()),
                                               bt.optimizer))
        state, at = CheckpointManager(f"{tmp}/bf16").restore(like)
        mgr = CheckpointManager(f"{tmp}/again")
        mgr.save(at, state)
        again, _ = mgr.restore(like)
        moments = [(again["opt"][g][k], t) for g in ("m", "v")
                   for k, t in state["opt"][g].items()]
        exact = all(a.dtype == t.dtype == torch.bfloat16
                    and a.device.type == device.type
                    and torch.equal(a.view(torch.int16), t.view(torch.int16))
                    for a, t in moments)
        check(at == 2 and exact and any(bool(t.any()) for _, t in moments),
              "train (c): bf16 moments did not come back bit for bit")
    out["loop"] = {"config": rcfg.name, "loss_uninterrupted": m1["loss"],
                   "loss_resumed": m2["loss"], "rel_err": resume_err,
                   "median_step_s": m1["median_step_s"],
                   "bf16_moments_bit_exact": exact,
                   "bf16_leaves": len(moments),
                   "seconds": time.perf_counter() - t0}
    train_launches = {name: fn.launches for name, fn in wrappers.items()}
    check(not any(train_launches.values()),
          f"train: a train step launched a kernel: {train_launches}")
    out["train_launches"] = train_launches
    out["seconds_train"] = time.perf_counter() - t_phase
    emit({"phase": "train", **out})

    # (d) serve what was trained
    return (*phase_model(device, wrappers, TRAIN_ARCH, runs=TRAIN_SERVE,
                         model=model), live)


#: The workload phase captures the arch of the model phase's first run at
#: the shapes that phase serves it at: prefill and train at its prefill
#: shape, decode at its decode shape.
WORKLOAD_ARCH = "qwen2-7b"
WORKLOAD_HARDWARE = ("stratix10_ddr4_1866", "tpu_v5e")
#: The model sweeps: (prefill, decode) x batch (1, 8) at 4,096 rows, and
#: decode at 32,768, each over shards (1, 4, 8) and three hardware specs.
#: Prefill at 32,768 is left out: the plain path's blocked attention runs
#: 1,056 (q-block, kv-block) pairs a layer there, ~620,000 ATen ops a
#: capture at ~0.5 ms each under FakeTensorMode.
WORKLOAD_SWEEPS = (dict(phases=("prefill", "decode"), batch=(1, 8),
                        seq_len=(4096,)),
                   dict(phases=("decode",), batch=(1, 8), seq_len=(32768,)))
WORKLOAD_SWEEP_AXES = dict(shards=(1, 4, 8),
                           hardware=(None, "tpu_v5e", "stratix10_ddr4_1866"))
WORKLOAD_CHUNK = 7


def _bytes_by_class(records) -> dict:
    out: dict = {}
    for r in records:
        for k, v in r.bytes_by_class.items():
            out[k] = out.get(k, 0.0) + v
    return out


def phase_workload(device, wrappers: dict, model_parts: dict,
                   validated) -> None:
    """Whole-model estimation on the card (``repro_torch.workload``) for
    ``WORKLOAD_ARCH`` at the model phase's shapes, launching no kernel:

    1. capture ``prefill`` and ``train`` at the prefill shape and
       ``decode`` at the decode shape (``workload.steps``, FakeTensorMode:
       no device memory may be allocated); the prefill's products must
       equal, within 1 %, the operations the model phase's prefill bound
       counts once the plain path's whole diagonal blocks are added (the
       bound counts the causal pairs alone), the train's hold its
       backward, and ``param_bytes`` equal the bytes of the model that
       phase built;
    2. compose them on the card under each of ``WORKLOAD_HARDWARE``: every
       phase total equals the sum of per-op ``Session.estimate`` at 1e-6,
       every per-op time equals a CPU session's to rtol 1e-12, and
       ``estimate_model`` from the config gives the composed decode total;
    3. ``sweep_model`` over ``WORKLOAD_SWEEPS`` on the card: streaming
       (chunk ``WORKLOAD_CHUNK``) equals the materialized grid bit for bit;
       points/s;
    4. recorded, not gated: a session calibrated by the validate phase's
       report predicts the captured prefill and decode, beside the model
       phase's measured plain-path (what was captured) and kernel-path ms;
    5. every wrapper's launch count is unchanged across the phase.
    """
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.core.stream import StatsReducer
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models.layers import _block_schedule
    from repro_torch.workload import compose_model, steps

    t_phase = time.perf_counter()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    cfg = get_config(WORKLOAD_ARCH)
    runs = MODEL_RUNS[WORKLOAD_ARCH]
    shapes = {"prefill": runs["prefill"], "train": runs["prefill"],
              "decode": runs["decode"]}

    # (1) capture at full width
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    records, capture = {}, {}
    for phase, (B, S) in shapes.items():
        t0 = time.perf_counter()
        recs = steps.phase_records(cfg, phase, batch=B, seq_len=S,
                                   device=device)
        records[phase] = recs
        capture[phase] = {
            "batch": B, "seq": S, "seconds": time.perf_counter() - t0,
            "records": len(recs), "bytes_by_class": _bytes_by_class(recs),
            "flops": sum(r.flops for r in recs),
            "matmul_flops": sum(r.flops for r in recs
                                if r.op_class == "matmul")}
    # FakeTensorMode probes the device context with a one-element tensor
    # (init_gpu_context: 4 bytes, one 512-byte block); the smallest
    # parameter of the arch (a K bias, f32) is 2 KiB
    grown = torch.cuda.max_memory_allocated() - allocated
    capture["device_bytes_peak_growth"] = grown
    check(torch.cuda.memory_allocated() == allocated and grown <= 1024,
          f"workload: a capture allocated device memory ({grown} B at peak)")
    # The bound counts the causal pairs the flash kernel multiplies; the
    # captured plain path multiplies whole blocks of its schedule.
    B, S = shapes["prefill"]
    bq, bkv = min(cfg.attn_block_q, S), min(cfg.attn_block_kv, S)
    blocked = bq * bkv * len(_block_schedule(
        -(-S // bq), -(-S // bkv), bq, bkv, causal=True, window=None,
        q_offset=0))
    check(set(cfg.block_kinds) == {"attn"}, "workload: a dense arch expected")
    whole_blocks = 4.0 * B * cfg.n_heads * cfg.head_dim * cfg.n_layers * (
        blocked - FA.live_pairs(S, S))
    bound_ops = model_parts["prefill"]["flops"]
    got = capture["prefill"]["matmul_flops"]
    capture["prefill"].update(
        model_bound_flops=bound_ops, whole_block_flops=whole_blocks,
        matmul_flops_over_model_bound=got / bound_ops,
        matmul_flops_over_bound_with_whole_blocks=got
        / (bound_ops + whole_blocks))
    check(abs(got - bound_ops - whole_blocks) <= 0.01 * bound_ops,
          f"workload: prefill products {got:.6g} against the model phase's "
          f"{bound_ops:.6g} and {whole_blocks:.6g} of whole blocks")
    # the backward (two products a forward product) was recorded too
    check(capture["train"]["matmul_flops"]
          >= 3 * capture["prefill"]["matmul_flops"],
          "workload: the train capture lacks its backward")
    pbytes = steps.param_bytes(cfg)
    check(pbytes == model_parts["init"]["param_bytes_as_built"],
          f"workload: param_bytes {pbytes} against the built model's "
          f"{model_parts['init']['param_bytes_as_built']}")

    # (2) estimate on the card, against the CPU and per-op estimates
    card, cpu = rt.Session(device=device), rt.Session(device="cpu")
    estimates = {}
    for name in WORKLOAD_HARDWARE:
        spec = hw.get(name)
        on_card, on_cpu = card.with_hardware(spec), cpu.with_hardware(spec)
        t0 = time.perf_counter()
        rep = compose_model(on_card, cfg.name, records)
        seconds = time.perf_counter() - t0
        ref = compose_model(on_cpu, cfg.name, records)
        single: dict = {}
        rows = {}
        for ph, ph_cpu in zip(rep.phases, ref.phases):
            a = np.array([op.t_exe for op in ph.ops])
            b = np.array([op.t_exe for op in ph_cpu.ops])
            check(len(a) == len(b) and np.allclose(a, b, rtol=1e-12, atol=0),
                  f"workload {name} {ph.name}: card per-op times differ from "
                  "the CPU's")
            summed = 0.0
            for op in ph.ops:
                key = (op.design.lsus, op.design.f)
                if key not in single:
                    single[key] = on_card.estimate(op.design).t_exe
                summed += single[key]
            check(abs(ph.t_total - summed) <= 1e-6 * summed,
                  f"workload {name} {ph.name}: total {ph.t_total} is not the "
                  f"sum of per-op estimates {summed}")
            rows[ph.name] = {
                "t_total_ms": ph.t_total * 1e3,
                "t_compute_ms": ph.t_compute * 1e3,
                "bottleneck": ph.bottleneck, "scored_ops": len(ph.ops),
                "max_rel_card_vs_cpu": float(np.max(
                    np.abs(a - b) / np.maximum(np.abs(b), 1e-300))),
                "by_class_ms": {d["op_class"]: d["t_exe"] * 1e3
                                for d in ph.by_class()}}
        entry = on_card.estimate_model(cfg, phases=("decode",),
                                       batch=shapes["decode"][0],
                                       seq_len=shapes["decode"][1])
        check(entry.total_latency() == rep.phase("decode").t_total,
              f"workload {name}: estimate_model's decode differs from the "
              "composed capture")
        estimates[name] = {"compose_seconds": seconds,
                           "distinct_designs": len(single),
                           "split": rep.split(), "phases": rows}

    # (3) model sweeps on the card: streaming == materialized
    sweeps = []
    for grid in WORKLOAD_SWEEPS:
        t0 = time.perf_counter()
        plan = card.plan_model(cfg, **grid, **WORKLOAD_SWEEP_AXES,
                               chunk_size=WORKLOAD_CHUNK)
        t_plan = time.perf_counter() - t0
        check(plan.device == str(device), f"workload: plan on {plan.device}")
        t0 = time.perf_counter()
        full = plan.materialize()
        t_full = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = card.sweep_model(plan=plan, chunk_size=WORKLOAD_CHUNK)
        t_stream = time.perf_counter() - t0
        ids = streamed.cols["id"].astype(np.int64)
        check(streamed.streaming and streamed.n_points == plan.n
              and all(np.array_equal(np.asarray(full[k])[ids],
                                     streamed.cols[k]) for k in full),
              f"workload: streamed sweep {grid} differs from the "
              "materialized one")
        # a chunk's float sum rounds by the chunk: sums to 1e-12
        whole = StatsReducer()
        whole.update(full)
        want = whole.summary()
        check(all(streamed.stats[k] == want[k] for k in (
            "n_points", "memory_bound_points", "t_exe_min", "t_exe_min_id",
            "total_bytes_sum")) and all(math.isclose(
                streamed.stats[k], want[k], rel_tol=1e-12)
                for k in ("t_exe_sum", "t_exe_mean", "t_exe_var")),
              f"workload: streamed stats {grid} differ from the "
              "materialized grid's")
        sweeps.append({**{k: list(v) for k, v in grid.items()},
                       "points": plan.n, "plan_seconds": t_plan,
                       "materialized_points_per_s": plan.n / t_full,
                       "streamed_points_per_s": plan.n / t_stream,
                       "best": streamed.best()})

    # (4) the calibrated session's prediction beside the measured steps
    calibrated = compose_model(card.with_calibration(validated), cfg.name,
                               {p: records[p] for p in ("prefill", "decode")})
    measured = {"prefill": (model_parts["prefill"]["plain_ms"],
                            model_parts["prefill"]["ms"]),
                "decode": (model_parts["decode"]["plain_ms_per_step"],
                           model_parts["decode"]["ms_per_step"])}
    predicted = {
        p: {"predicted_ms": calibrated.phase(p).t_total * 1e3,
            "measured_plain_ms": measured[p][0],
            "measured_kernel_ms": measured[p][1],
            "predicted_over_plain": calibrated.phase(p).t_total * 1e3
            / measured[p][0]} for p in measured}

    # (5) no kernel launched
    after = {name: fn.launches for name, fn in wrappers.items()}
    check(after == launches, f"workload: kernels launched {launches} -> "
          f"{after}")
    emit({"phase": "workload", "arch": cfg.name, "capture": capture,
          "param_bytes": pbytes, "estimate": estimates, "sweeps": sweeps,
          "calibrated": {"measured_bw_gbs": validated.measured_bw / 1e9,
                         "calibration_factor": validated.calibration_factor,
                         **predicted},
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# mesh: the dry-run, sharded steps on the card, autotune, elastic resume
# ---------------------------------------------------------------------------

#: (a) the dry-run cells on the 16x16 pod mesh, full width: (arch, shape,
#: layers kept); stablelm-3b's train_4k is cut to 4 of its 32 layers
#: (per-layer counts are read from one layer's records).
MESH_DRYRUN = (("qwen2-7b", "decode_32k", None),
               ("grok-1-314b", "decode_32k", None),
               ("stablelm-3b", "train_4k", 4))
#: (b) qwen2-7b at full width cut to 4 layers on a 2x2 mesh of threaded
#: ranks on the one card: one prefill at B 2 x 1,024 and one decode step
#: at B 8 over 4,096 rows; reduced stablelm-3b's train step in f32.
MESH_LAYOUT = ((2, 2), ("data", "model"))
MESH_ARCH, MESH_LAYERS = "qwen2-7b", 4
MESH_PREFILL = (2, 1024)
MESH_DECODE = (8, 4096)
MESH_TRAIN = (4, 64)            # B x S of the reduced train step
#: the loss, each first moment ((1 - b1) times the clipped gradient) and
#: each update (after - before, beside one f32 rounding of the parameter),
#: relative L2; AdamW's eps 1e-3 keeps the first step linear in the
#: gradient and N(0, 0.02^2) on the weights leaves no leaf zero
MESH_TRAIN_TOL = 1e-5
#: (d) the 2x2 checkpoint restored on 4x1
MESH_ELASTIC = ((4, 1), ("data", "model"))
CARD_BYTES = 80e9
#: (e) the dry-run's memory accounting against the card, on plain-path
#: steps: the predicted rise (``total_bytes`` less the arguments: the peak
#: of the storages the step creates) within this share of the measured
#: one (``max_memory_allocated`` after the step less the bytes allocated
#: before it); the train phase measures its full-width stablelm-3b step,
#: the mesh phase the unsharded prefill of (b)
LIVE_TOL = 0.10


def live_bytes(label: str, step, args: tuple, fakes) -> dict:
    """(e) for one step: ``step(*args)`` once on the card, its peak rise
    measured, against ``capture_call(step, *fakes())`` (fake tensors of
    the same shapes, dtypes and device: the dry-run's accounting).  A
    warm call must precede it: cuBLAS's workspace of each thread's handle
    is allocated at its first product and held from then on, so it lies
    outside the rise, as it lies outside the capture."""
    import torch

    from repro_torch.workload.capture import capture_call
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = step(*args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    after = torch.cuda.memory_allocated() - before
    del result
    t0 = time.perf_counter()
    records, call = capture_call(step, *fakes())
    predicted = call.total_bytes - call.argument_bytes
    row = {"step": label, "measured_rise_bytes": rise,
           "predicted_rise_bytes": predicted,
           "predicted_over_measured": predicted / rise,
           "measured_held_after_bytes": after,
           "argument_bytes": call.argument_bytes,
           "output_bytes": call.output_bytes,
           "alias_bytes": call.alias_bytes, "temp_bytes": call.temp_bytes,
           "total_bytes": call.total_bytes, "n_ops": len(records),
           "capture_s": time.perf_counter() - t0, "tol": LIVE_TOL}
    check(abs(predicted / rise - 1) <= LIVE_TOL,
          f"live bytes ({label}): the capture predicts a rise of "
          f"{predicted:.4g} bytes, the card rose {rise:.4g}")
    return row


def _train_fakes(cfg, tcfg, batch: dict, device):
    """Fake arguments of the full-width train step: a model, its AdamW
    state and the batch's shapes, as the dry-run builds them."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.workload.capture import fake_mode
    with fake_mode():
        model = TF.Transformer(cfg, device=device)
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        fb = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
              for k, v in batch.items()}
    return model, opt, fb


def _train_full(device):
    """(cfg, train config, model, AdamW state, batch, step) of the train
    phase's full-width stablelm-3b step (``TRAIN_FULL``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.steps import (TrainConfig, batch_to_device,
                                          make_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import OptimizerConfig, adamw_init

    fw = TRAIN_FULL
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), use_kernels=False)
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        lr=fw["lr"], warmup_steps=fw["warmup_steps"],
        total_steps=fw["steps"]))
    model = TF.init_params(cfg, seed=0, device=device)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    batch = batch_to_device(SyntheticDataset(cfg, DataConfig(
        seq_len=fw["seq"], batch_size=fw["batch"], seed=fw["seed"]
    )).get_batch(0), device)
    return cfg, tcfg, model, opt, batch, make_train_step(cfg, tcfg)


def live_bytes_train(device) -> dict:
    """(e)'s train step alone (``tools/mesh_phase.py``): the full-width
    state built, one warm step, then :func:`live_bytes`."""
    cfg, tcfg, model, opt, batch, step = _train_full(device)
    step(model, opt, batch)
    return live_bytes("train", step, (model, opt, batch),
                      lambda: _train_fakes(cfg, tcfg, batch, device))


def _mesh_dryrun(arch: str, shape_name: str, layers) -> dict:
    """One dry-run cell on the 16x16 pod mesh: rank 0's counts, its
    parameter (and state, cache) bytes against the card's 80 GB, the
    capture's seconds, and with ``layers`` the config cut to that depth
    and one layer's counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import POD, POD_AXES, fake_world, init_mesh

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    tcfg = DR.default_train_config(get_config(arch))
    t0 = time.perf_counter()
    with fake_world(256):
        mesh = init_mesh(POD, POD_AXES, device_type="cpu")
        records, mem = DR.capture_step(cfg, shape, tcfg, mesh)
        from repro_torch.launch import sharding as SH
        plan = SH.make_plan(cfg, mesh, global_batch=shape.global_batch,
                            kv_shard=tcfg.kv_shard, kind=shape.kind,
                            fsdp_decode=tcfg.fsdp_decode)
    dt = time.perf_counter() - t0
    hc = DR.summarize(records)
    check(hc["flops"] > 0 and hc["n_collectives"] > 0,
          f"dry-run {arch} {shape_name}: no products or no collectives")
    check(all(k in mem for k in DR.MEMORY_KEYS) and mem["peak_live_bytes"]
          == mem["total_bytes"] > mem["argument_size_in_bytes"] > 0,
          f"dry-run {arch} {shape_name}: memory_analysis {mem}")
    row = {"arch": arch, "shape": shape_name, "mesh": "16x16",
           "mesh_device": "cpu", "layers": cfg.n_layers,
           "of_layers": get_config(arch).n_layers,
           "capture_s": dt, "n_ops": len(records),
           "flops_per_rank": hc["flops"],
           "bytes_by_class": hc["bytes_by_class"],
           "collective_by_kind": hc["collective_by_kind"],
           "collective_wire_bytes": hc["collective_wire_bytes"],
           "n_collectives": hc["n_collectives"],
           "memory": mem, "param_bytes_of_80GB": mem["param_bytes"] / CARD_BYTES,
           "total_bytes_of_80GB": mem["total_bytes"] / CARD_BYTES,
           "plan": dataclasses.asdict(plan)}
    if shape.kind == "decode" and cfg.n_heads:
        # the q, k and v products: each rank its share of their columns,
        # so the ranks' shares add up to the whole products once
        qkv = sum(r.flops for r in records if r.op_class == "matmul"
                  and r.scope.rsplit(".", 1)[-1] in ("wq", "wk", "wv"))
        whole = 2.0 * shape.global_batch * cfg.d_model * cfg.n_layers * (
            cfg.q_dim + 2 * cfg.kv_dim)
        row["qkv_products_ranks_over_whole"] = qkv * 256 / whole
        check(abs(qkv * 256 / whole - 1) < 1e-9,
              f"dry-run {arch}: the ranks' q, k and v products add up to "
              f"{qkv * 256 / whole:.4g} of the whole")
    if shape.kind == "decode" and cfg.family == "moe":
        # the router's products: each rank routes its batch shard's tokens
        # only (``moe._forward_sort_split``), so the batch shards' products
        # add up to the whole router product once; a shard's ranks over
        # ``model`` route the same tokens, as the reference's program does
        router = [r for r in records if r.op_class == "matmul"
                  and r.opcode == "mm" and r.scope.endswith(".moe")]
        whole = 2.0 * shape.global_batch * cfg.d_model * cfg.n_experts \
            * len(router)
        shards = math.prod(POD[POD_AXES.index(a)]
                           for a in plan.batch_axes or ())
        mine = sum(r.flops for r in router)
        row["router_products_shards_over_whole"] = mine * shards / whole
        row["router_products_ranks_over_whole"] = mine * 256 / whole
        check(len(router) == cfg.n_layers
              and abs(mine * shards / whole - 1) < 1e-9,
              f"dry-run {arch}: {len(router)} router products of "
              f"{cfg.n_layers} layers; the {shards} batch shards' add up "
              f"to {mine * shards / whole:.4g} of the whole")
    if layers:
        one = [r for r in records if r.scope.startswith("layers.1.")
               or r.scope == "layers.1"]
        row["layer_1"] = {"flops": sum(r.flops for r in one),
                          "bytes": sum(r.total_bytes for r in one),
                          "n_ops": len(one)}
    if arch == "grok-1-314b":
        # the stated deployment: each rank's slice of every expert's FFN
        row["expert_ff_slice"] = {"axis": plan.expert_ff_axes,
                                  "d_ff": cfg.d_ff,
                                  "per_rank": cfg.d_ff // POD[1],
                                  "experts_per_rank": cfg.n_experts}
    return row


def _mesh_param_bytes(params, cfg, plan, mesh) -> tuple[int, int]:
    """(bytes this rank holds, bytes the plan gives it): each parameter's
    local extent from its placements by DTensor's chunking."""
    import math

    from repro_torch.launch import sharding as SH
    from repro_torch.models.pspec import local_extent

    named = dict(params.named_parameters())
    held = SH.local_bytes(named)
    want = sum(math.prod(local_extent(named[k].shape, mesh, place)[0])
               * named[k].to_local().element_size()
               for k, place in SH.param_shardings(params, cfg, plan,
                                                  mesh).items())
    return held, want


def phase_mesh(device, wrappers: dict, live_train: dict) -> dict:
    """The mesh layer (``repro_torch.launch.mesh``, ``sharding``,
    ``dryrun``, ``models.pspec``, ``runtime.elastic``, ``Session.autotune``):
    (a) the dry-run of ``MESH_DRYRUN`` on a fake 256-rank group (rank 0
    captured under FakeTensorMode, nothing launched); (b) ``MESH_ARCH``
    sharded on a 2x2 mesh of threaded ranks on the card, its prefill and
    decode logits held to the unsharded model's (plain path both; bound:
    ``TOL["model_logits"]["of_floor"]`` times the unsharded bf16 logits'
    distance from the f32-activation run), each rank's parameter bytes to
    the plan's, and reduced stablelm-3b's f32 train step held to the
    unsharded step by its loss, updates and first moments
    (``MESH_TRAIN_TOL``); (c) ``Session(device="cuda")
    .autotune`` on (a)'s qwen2-7b cell: kv-heads a ``TrialFailure`` (4 kv
    heads over 16), the ranking, and a second call served from the cache;
    (d) (b)'s 2x2 train state checkpointed and resumed on 4x1 through
    ``resume_on_mesh``, bit for bit; (e) the dry-run's memory accounting
    on the card (``live_bytes``): (b)'s unsharded prefill here, beside the
    train phase's full-width step (``live_train``), each captured peak
    rise within ``LIVE_TOL`` of the measured one.  The mesh path is the
    plain path: no kernel launches, which the phase checks."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import Session
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.core.autotune import default_candidates
    from repro_torch.core.cache import HloAnalysisCache
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import init_mesh, threaded_ranks
    from repro_torch.models import transformer as TF
    from repro_torch.models.convert import to_serving
    from repro_torch.optim.adamw import OptimizerConfig, adamw_init
    from repro_torch.runtime.elastic import resume_on_mesh

    for fn in wrappers.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    out: dict = {"phase": "mesh"}

    # (a) the dry-run
    out["dryrun"] = [_mesh_dryrun(*cell) for cell in MESH_DRYRUN]

    # (b) sharded steps on the card
    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=MESH_LAYERS,
                              use_kernels=False)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator().manual_seed(5)
    Bp, Sp = MESH_PREFILL
    Bd, Sd = MESH_DECODE
    prompt = torch.randint(0, cfg.vocab_size, (Bp, Sp), generator=g)
    dtok = torch.randint(0, cfg.vocab_size, (Bd, 1), generator=g)
    index = Sd - 1
    pshape = ShapeSpec("mesh_prefill", Sp, Bp, "prefill")
    dshape = ShapeSpec("mesh_decode", Sd, Bd, "decode")

    def filled_caches(c, mesh=None, plan=None):
        caches = TF.init_caches(c, Bd, Sd, device=device)
        gen = torch.Generator(device=device).manual_seed(7)
        for layer in caches:
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=gen, device=device,
                                    dtype=torch.float32).to(t.dtype))
        return caches if mesh is None else ST.place_caches(caches, plan,
                                                           mesh)

    def run_steps(c, mesh=None):
        """Prefill and decode logits (whole), ms of each (a warm call
        first), and the rank's parameter bytes against the plan's."""
        row = {}
        for kind, shape in (("prefill", pshape), ("decode", dshape)):
            built = ST.build_step(c, shape, mesh=mesh, device=device)
            params = to_serving(TF.init_params(c, seed=0, device=device))
            if mesh is not None:
                ST.place_params(params, c, built.plan, mesh)
                if kind == "prefill":
                    row["param_bytes"] = _mesh_param_bytes(
                        params, c, built.plan, mesh)
            if kind == "prefill":
                batch = {"tokens": prompt.to(device)}

                def call():
                    return built.fn(params, batch)
            else:
                caches = filled_caches(c, mesh, built.plan)
                tok, idx = dtok.to(device), torch.tensor([index],
                                                          device=device)

                def call():
                    return built.fn(params, tok, caches, idx)[1]
            logits = call()                 # warm: DTensor's first dispatch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = call()
            torch.cuda.synchronize()
            row[f"{kind}_ms"] = (time.perf_counter() - t0) * 1e3
            if hasattr(logits, "full_tensor"):
                logits = logits.full_tensor()
            row[kind] = logits.reshape(-1, logits.shape[-1]).float().cpu()
            del params, built
        return row

    plain = run_steps(cfg)
    exact = run_steps(cfg32)

    def mesh_rank(rank):
        return run_steps(cfg, init_mesh(*MESH_LAYOUT, device_type="cuda"))
    t0 = time.perf_counter()
    ranks = threaded_ranks(4, mesh_rank)
    out["sharded_s"] = time.perf_counter() - t0
    steps_row = {}
    v = cfg.vocab_size
    for kind in ("prefill", "decode"):
        got, want, f32 = (r[kind][:, :v] for r in (ranks[0], plain, exact))
        floor = _rel_l2(want, f32)
        dist = _rel_l2(got, want)
        bound = TOL["model_logits"]["of_floor"] * floor
        steps_row[kind] = {
            "rel_l2_sharded_vs_unsharded": dist,
            "rel_l2_unsharded_vs_f32": floor, "bound": bound,
            "max_abs": float((got - want).abs().max()),
            "greedy_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean()),
            "sharded_ms": ranks[0][f"{kind}_ms"],
            "unsharded_ms": plain[f"{kind}_ms"]}
        check(all(bool(torch.equal(r[kind], ranks[0][kind])) for r in ranks),
              f"mesh {kind}: the ranks' logits differ")
        check(0.0 < floor and dist <= bound,
              f"mesh {kind}: sharded logits {dist:.3g} from the unsharded "
              f"ones, bound {bound:.3g}")
    for r, row in enumerate(ranks):
        held, want = row["param_bytes"]
        check(held == want, f"mesh rank {r}: holds {held} parameter bytes, "
              f"the plan gives {want}")
    steps_row["param_bytes_by_rank"] = [r["param_bytes"][0] for r in ranks]
    out["steps"] = steps_row

    # (e) the dry-run's memory accounting against the card: the unsharded
    # prefill of (b) here, the train phase's full-width step there
    built = ST.build_step(cfg, pshape, device=device)
    params = to_serving(TF.init_params(cfg, seed=0, device=device))
    batch = {"tokens": prompt.to(device)}
    built.fn(params, batch)                 # warm

    def prefill_fakes():
        from repro_torch.workload.capture import fake_mode
        with fake_mode():
            return (to_serving(TF.Transformer(cfg, device=device)),
                    {"tokens": torch.zeros(prompt.shape, dtype=prompt.dtype,
                                           device=device)})
    live = {"prefill": live_bytes("prefill", built.fn, (params, batch),
                                  prefill_fakes)}
    del params, built, batch
    out["live_bytes"] = {**live, "train": live_train}

    # (b) the train step, and (d) its state resumed on 4x1
    tcfg32 = dataclasses.replace(reduced_config(get_config("stablelm-3b")),
                                 dtype="float32", use_kernels=False)
    tB, tS = MESH_TRAIN
    ttok = torch.randint(0, tcfg32.vocab_size, (tB, tS), generator=g)
    tbatch = {"tokens": ttok, "labels": torch.roll(ttok, -1, 1)}
    tshape = ShapeSpec("mesh_train", tS, tB, "train")
    topt = ST.TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                    eps=1e-3))
    gen = torch.Generator().manual_seed(11)
    tnoise = {k: 0.02 * torch.randn(w.shape, generator=gen)
              for k, w in TF.init_params(tcfg32, seed=0, device="cpu")
              .named_parameters()}

    def fresh():
        params = TF.init_params(tcfg32, seed=0, device=device)
        with torch.no_grad():
            for k, w in params.named_parameters():
                w.add_(tnoise[k].to(device))
        return params

    def train(mesh=None, ckpt_dir=None):
        built = ST.build_step(tcfg32, tshape, topt, mesh=mesh, device=device)
        params = fresh()
        opt = adamw_init(dict(params.named_parameters()), topt.optimizer)
        if mesh is not None:
            ST.place_params(params, tcfg32, built.plan, mesh)
            opt = ST.place_opt_state(opt, params, tcfg32, built.plan, mesh)
        built.fn(params, opt, tbatch)       # warm
        params = fresh()
        opt = adamw_init(dict(params.named_parameters()), topt.optimizer)
        if mesh is not None:
            ST.place_params(params, tcfg32, built.plan, mesh)
            opt = ST.place_opt_state(opt, params, tcfg32, built.plan, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = built.fn(params, opt, tbatch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        state = {"params": dict(params.named_parameters()), "opt": opt}
        if ckpt_dir is not None:
            CheckpointManager(ckpt_dir).save(1, state)
        whole = SH.gather_tree({k: v for k, v in state["params"].items()})
        return float(m["loss"]), {k: v.detach().cpu() for k, v in
                                  whole.items()}, ms, SH.gather_tree(opt)

    def update_err(p1, p0, before) -> float:
        """The gap of two updates over ``MESH_TRAIN_TOL`` of the update's
        norm plus one f32 rounding of the parameter."""
        nrm = torch.linalg.vector_norm
        allowed = (MESH_TRAIN_TOL * nrm(p0 - before)
                   + torch.finfo(torch.float32).eps * nrm(p0))
        return float(nrm(p1 - p0) / allowed)

    before = {k: w.detach().cpu() for k, w in fresh().named_parameters()}
    loss0, p0, ms0, opt0 = train()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        res = threaded_ranks(4, lambda r: train(
            init_mesh(*MESH_LAYOUT, device_type="cuda"), ckpt_dir))
        loss1, p1, ms1, opt1 = res[0]
        upd = {k: update_err(p1[k], p0[k], before[k]) for k in p0}
        mom = _leaf_rel_l2(opt1["m"], opt0["m"])
        wu, wm = max(upd, key=upd.get), max(mom, key=mom.get)
        out["train"] = {"loss_sharded": loss1, "loss_unsharded": loss0,
                        "loss_rel": abs(loss1 - loss0) / abs(loss0),
                        "worst_update": wu,
                        "worst_update_of_allowed": upd[wu],
                        "worst_moment": wm, "worst_moment_rel_l2": mom[wm],
                        "sharded_ms": ms1, "unsharded_ms": ms0}
        check(abs(loss1 - loss0) <= MESH_TRAIN_TOL * abs(loss0)
              and upd[wu] <= 1.0 and mom[wm] <= MESH_TRAIN_TOL,
              f"mesh train: loss {loss1} vs {loss0}, update {wu} "
              f"{upd[wu]:.3g} of allowed, moment {wm} {mom[wm]:.3g}")

        def resume(rank):
            mesh = init_mesh(*MESH_ELASTIC, device_type="cuda")
            built = ST.build_step(tcfg32, tshape, topt, mesh=mesh,
                                  device=device)
            params = TF.init_params(tcfg32, seed=1, device=device)
            opt = adamw_init(dict(params.named_parameters()), topt.optimizer)
            like = {"params": dict(params.named_parameters()), "opt": opt}
            place = {"params": built.shardings["params"],
                     "opt": dict(built.shardings["opt"], step=None)}
            state, step = resume_on_mesh(CheckpointManager(ckpt_dir), like,
                                         mesh, place)
            leaves = state["params"]
            return step, {k: v.full_tensor().cpu() for k, v in leaves.items()}, \
                [tuple(v.placements) for v in leaves.values()][:2], \
                SH.gather_tree(state["opt"])
        step, p4, place4, opt4 = threaded_ranks(4, resume)[0]
    same = all(torch.equal(p4[k], p1[k]) for k in p1) and all(
        torch.equal(opt4[g_][k].cpu(), opt1[g_][k].cpu())
        for g_ in ("m", "v") for k in opt1[g_])
    out["elastic"] = {"from": "2x2", "to": "4x1", "step": step,
                      "bit_equal": same,
                      "placements": [str(p) for p in place4]}
    check(step == 1 and same, "elastic: the 4x1 restore differs from the "
          "2x2 state")

    # (c) autotune on (a)'s qwen2-7b cell, scored on the card
    cell_cfg, cell_shape = get_config("qwen2-7b"), SHAPES["decode_32k"]
    layout = ((16, 16), ("data", "model"))
    with tempfile.TemporaryDirectory() as cache_dir:
        cache = HloAnalysisCache(cache_dir)
        sess = Session(device="cuda")
        t0 = time.perf_counter()
        rep = sess.autotune(cell_cfg, cell_shape, layout, cache=cache)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = sess.autotune(cell_cfg, cell_shape, layout, cache=cache)
        t_again = time.perf_counter() - t0
    names = [c.name for c in default_candidates("decode")]
    out["autotune"] = {"candidates": names, "ranking": rep.rows(),
                       "first_s": t_first, "cached_s": t_again,
                       "all_cached": all(t.cached for t in again)}
    check([f.candidate.name for f in rep.failures] == ["kv-heads"]
          and "kv heads not divisible" in rep.failures[0].error_msg,
          f"autotune: kv-heads should fail as the reference's does: "
          f"{[f.summary() for f in rep.failures]}")
    check(len(rep) == len(names) - 1 and all(t.cached for t in again)
          and [t.candidate.name for t in again] ==
          [t.candidate.name for t in rep],
          "autotune: the second call was not served from the cache")

    out["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    check(not any(out["launches"].values()),
          f"the mesh path launched kernels: {out['launches']}")

    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


#: The port's five examples as the ``examples`` phase runs them: script,
#: small arguments (``--device`` is the card's by default).
EXAMPLES = (
    ("torch_quickstart.py", ()),
    ("torch_membound_explorer.py", ("--validate",)),
    ("torch_serve_lm.py", ("--requests", "3", "--max-new", "4")),
    ("torch_train_lm.py", ("--steps", "3", "--seq-len", "32", "--batch",
                           "2")),
    ("torch_autotune_sharding.py", ()),
)
EXAMPLE_TIMEOUT_S = 180


def phase_examples() -> None:
    """The port's five examples (``examples/torch_*.py``), each a process
    of its own on the card, all started together: each exits 0, and the
    explorer's ``--validate`` launches each of the seven kernels (the
    launch counts it prints, from the wrappers' ``launches``).  Every
    process is waited for, or killed at its time limit."""
    import gc
    import os
    import tempfile

    import torch

    # the earlier phases' cached blocks back to the card for the examples
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs, ended = {}, {}
        for script, args in EXAMPLES:
            if script == "torch_train_lm.py":
                args = (*args, "--ckpt-dir", os.path.join(tmp, "ckpt"))
            log = pathlib.Path(tmp, script)
            with open(log.with_suffix(".out"), "w") as out, \
                    open(log.with_suffix(".err"), "w") as err:
                procs[script] = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / script), *args],
                    cwd=ROOT, env=env, stdout=out, stderr=err)
        while len(ended) < len(procs):
            late = time.perf_counter() - t0 > EXAMPLE_TIMEOUT_S
            for script, proc in procs.items():
                if script not in ended and (late or proc.poll() is not None):
                    if late:
                        proc.kill()
                    proc.wait()
                    ended[script] = time.perf_counter() - t0
            time.sleep(0.05)
        rows = {}
        for script, proc in procs.items():
            log = pathlib.Path(tmp, script)
            rows[script] = {
                "rc": proc.returncode, "seconds": ended[script],
                "stdout_tail": log.with_suffix(".out").read_text()
                .splitlines()[-12:],
                "stderr_tail": log.with_suffix(".err").read_text()
                .splitlines()[-8:]}
    explorer = rows["torch_membound_explorer.py"]["stdout_tail"]
    line = next((ln for ln in explorer
                 if ln.startswith("kernel launches: ")), None)
    launches = json.loads(line.split(": ", 1)[1]) if line else {}
    emit({"phase": "examples", "seconds": time.perf_counter() - t0,
          "explorer_validate_launches": launches, "runs": rows})
    for script, row in rows.items():
        check(row["rc"] == 0, f"example {script} exited {row['rc']}: "
              f"{row['stderr_tail']}")
    check(set(launches) == set(kernel_table()) - MODEL_PATH_ONLY
          and all(n > 0 for n in launches.values()),
          f"the explorer's --validate launches: {launches}")


def time_ms(fn, device, iters=20, warmup=3) -> float:
    from repro_torch.core.validate import time_callable

    return time_callable(fn, (), device=device, iters=iters,
                         warmup=warmup) * 1e3


def _timing(c: dict, device) -> dict:
    """One card case's time beside its bound, its plain version and, for
    the attention kernels, ``scaled_dot_product_attention`` (causal
    prefill, with the window's band as a boolean mask where the case has
    one; decode over every row).  The
    operations bound takes the peak of the unit the inputs' dtype allows:
    the tensor cores for bfloat16, the CUDA cores for float32."""
    import torch
    import torch.nn.functional as F

    bf16 = next(_tensors(c["args"])).dtype == torch.bfloat16
    t_bytes = c["traffic"]["total_bytes"] / PEAK_BYTES_PER_S
    t_ops = c["traffic"]["flops"] / (PEAK_BF16_TENSOR_FLOPS if bf16
                                     else PEAK_FP32_FLOPS)
    library_ms = None
    if c["name"] in ("decode_attention", "flash_attention"):
        qt, kt, vt = (t.transpose(1, 2) for t in c["args"][:3])
        causal = c.get("causal", c["name"] == "flash_attention")
        mask = None
        if c.get("window"):
            # SDPA has no window: the causal band as a boolean mask
            i = torch.arange(qt.shape[2], device=device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - c["window"])
            causal = False
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=True),
            device)
    elif c["name"].startswith("membench"):
        library_ms = time_ms(_membench_library(c), device)
    return {"ms": time_ms(c["run"], device),
            "plain_ms": time_ms(c["plain"], device, iters=3, warmup=1),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _membench_library(c: dict):
    """The one PyTorch call that computes a membench case's function, on its
    inputs stacked once into one (G, n) tensor (outside the timing): K1
    ``torch.sum(x, 0, dtype=float32)``; K2 the same over the strided view
    of the blocks it reads; K3 the gather ``x[:, idx]`` and then the sum,
    two calls (no single call gathers and sums).  The block geometry is
    the case's plain version's; the call is held to it (1e-6)."""
    import torch

    xs = c["args"][0]
    geo = getattr(c["ref"], "keywords", {})
    blocks = torch.stack(xs).reshape(len(xs), -1,
                                     geo.get("block", xs[0].numel()))
    idx = c["args"][1].long() if c["name"] == "membench_gather" else None
    delta = geo.get("delta", 1)

    def call():
        picked = (blocks[:, idx] if idx is not None
                  else blocks[:, ::delta][:, :blocks.shape[1] // delta])
        return torch.sum(picked, 0, dtype=torch.float32)

    check(torch.allclose(call().reshape(-1), c["plain"]().float(), rtol=1e-6,
                         atol=1e-6),
          f"{c['name']}: the library call does not compute the case")
    return call


def phase_kernels(device, card: list[dict], launches: dict,
                  card_err: dict) -> list[dict]:
    """Each kernel at the main path's shape (``_timing``); ``launches`` is
    the kernel's count over every driven path, by path in
    ``launches_by_path``."""
    table = kernel_table()
    out = []
    for c in card:
        if not c["timed"]:
            continue
        _, source, replaces = table[c["name"]]
        by_path = {path: counts[c["name"]] for path, counts in launches.items()}
        out.append({
            "name": c["name"], "case": c["label"], "route": "cuda",
            "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": card_err[c["name"]], **_timing(c, device)})
    return out


def phase_head_sizes(device, card: list[dict]) -> None:
    """The zoo's other head sizes (``head_size_cases``) timed as the
    kernels line times the main path's shapes."""
    rows = [{"kernel": c["name"], "case": c["label"], **_timing(c, device)}
            for c in card if c.get("head_size")]
    emit({"phase": "head_sizes", "rows": rows})


def main() -> int:
    import torch

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import compat

    device = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    built = compat.build()
    ptxas = {name: [ln.strip() for ln in (compat.BUILD_DIR / f"{name}.log")
                    .read_text().splitlines() if "registers" in ln or "spill" in ln]
             for name in built}
    sass = {name: sass_counts(compat.library_path(name))
            for name in compat.SOURCES}
    registers = {}
    for name in ("decode_attention", "flash_attention"):
        registers.update(ptxas_report((compat.BUILD_DIR / f"{name}.log").read_text()))
    residency = bulk_residency()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": built, "ptxas": ptxas, "registers_and_spills": registers,
          "bulk_ctas_per_sm": residency, "sass": sass})
    check_sass(sass)
    check(len(registers) == 2 + 8 + 2 + 8,
          f"ptxas report of {PTXAS_REPORTED}: {sorted(registers)}")
    check_ptxas(registers)
    for shape, r in residency.items():
        check(r["predicted"] == r["card"], f"decode_bulk at {shape}: ops.bulk_ctas_per_sm "
              f"predicts {r['predicted']} CTAs an SM, the card holds {r['card']}")

    card = card_cases(device)
    card_err = phase_parity(device, card)
    phase_head_sizes(device, card)

    # The main path: estimate -> sweep -> streaming sweeps -> optimize ->
    # validate, with every launch counter at zero just before it and read
    # just after.
    wrappers = {name: spec[0] for name, spec in kernel_table().items()}
    for fn in wrappers.values():
        fn.launches = 0
    phase_estimator(device)
    phase_optimize(device, phase_stream(device))
    validated = phase_validate(device)
    main_path = {name: fn.launches for name, fn in wrappers.items()}
    for name, count in main_path.items():
        if name in MODEL_PATH_ONLY:
            check(count == 0, f"{name} launched {count} times on the main path")
        else:
            check(count > 0, f"{name} was never launched on the main path")

    # The model paths: each arch's prefill, decode and server, each part
    # with the counts at zero just before it and read just after.
    launches = {"main_path": main_path}
    by_part, model_parts = {}, {}
    for arch in MODEL_RUNS:
        by_part[arch], model_parts[arch] = phase_model(device, wrappers, arch)
        launches[f"model_path/{arch}"] = {
            name: sum(part[name] for part in by_part[arch].values())
            for name in wrappers}
    # Training: its steps launch no kernel; the trained model is served
    # through K5 and K4 like the model paths.
    by_part[f"trained/{TRAIN_ARCH}"], _, live_train = phase_train(device,
                                                                  wrappers)
    launches[f"trained_model_path/{TRAIN_ARCH}"] = {
        name: sum(part[name] for part in
                  by_part[f"trained/{TRAIN_ARCH}"].values())
        for name in wrappers}
    emit({"phase": "launches", **launches, "model_path_by_part": by_part})

    # Whole-model estimation of the first arch's phases launches no kernel.
    phase_workload(device, wrappers, model_parts[WORKLOAD_ARCH], validated)

    # Serving, the paper's tables and the HLO predictor launch no kernel.
    phase_serve(device)
    phase_paper(device)
    phase_predict(device)

    # The mesh layer runs the plain path: no kernel launches.
    phase_mesh(device, wrappers, live_train)

    # The five examples, each in a process of its own: their launches are
    # theirs, not this process's counts.
    phase_examples()

    kernels = phase_kernels(device, card, launches, card_err)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
