"""One run of one cell, found by name: set-up, the window, the check, the
metrics, and the result line.

The layout is the harness's alone (``Layout``): ``BENCHMARK.json`` names
the cells and metrics; ``workloads/<cell>.json`` holds a cell's traffic
kind, its parameters and its limits; ``configs/<config>.json`` a
configuration, which names its model family (``architecture.family``,
``qwen`` where it names none); ``archs/<family>.py`` the family: its
sizes, weight draw, reference, counts, kernels and adapter to the program
(the contract is in ``archs/__init__.py``); ``traffic/<kind>.py`` the
code of a traffic kind, which reaches the model only through the family
(``cell.arch``); ``metrics/<metric>.py`` the reader of one metric.  A
later change adds an architecture, a configuration, a cell, a kind or a
metric by adding such files and entries, and edits none.

:func:`run_cell` is the whole run; ``run.py`` is its command line.  The
tests drive it on the CPU at a tiny configuration, past the look for a
card (``need_card=False``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

from portbench.archs import DEFAULT as DEFAULT_FAMILY

HERE = pathlib.Path(__file__).resolve().parent
#: Top-level module names that no run may load (compared whole: the
#: port's ``repro_torch`` is not ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The share of a traced run's ``--seconds`` that runs untraced first:
#: the per-layer metrics read by the host's clock come from it, those of
#: the device's trace from the rest.
UNTRACED_SHARE = 0.5


class Layout:
    """The benchmark's files under ``root`` (a checkout's root)."""

    def __init__(self, root: pathlib.Path, bench_dir: pathlib.Path = HERE):
        self.root = pathlib.Path(root)
        self.dir = pathlib.Path(bench_dir)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, sub: str, name: str) -> dict:
        return json.loads((self.dir / sub / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        """The ``BENCHMARK.json`` entry of the cell ``name``."""
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def _module(self, sub: str, name: str):
        path = self.dir / sub / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{sub}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        # registered before it runs, as an import would: a dataclass
        # looks its module up by name
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod

    def arch(self, cfg: dict):
        """The family module of the configuration ``cfg``."""
        return self._module("archs", cfg["architecture"].get("family",
                                                             DEFAULT_FAMILY))

    def kind(self, name: str):
        return self._module("traffic", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def metrics_of(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``--trace 0``, the per-layer ones with ``--trace 1``; a metric
        with ``workloads`` only in those cells."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[key]
                if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Cell:
    """What a traffic kind reads: the cell, its family (``arch``, the
    module ``archs/<family>.py``) and sizes, its traffic, the seed and
    the device; ``control``: also compute the control's numbers (the
    reference in fp8 put in the program's place)."""
    name: str
    workload: dict
    arch: object
    geometry: object
    seed: int
    device: object
    control: bool = False
    #: seconds of each stage of the set-up (``mark``), in order, and when
    #: the last one closed
    stages: dict = dataclasses.field(default_factory=dict)
    marked: float = 0.0

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def launches_off(self, phase: str, n: int, launched: dict) -> dict:
        """Each kernel's launches (``launched``) short of, or past, what
        the family expects of ``n`` prefill calls or decode steps, under
        the family's name of the number; none are expected off the
        card."""
        want = self.arch.expected_launches(self.geometry, phase, n)
        if self.device.type != "cuda":
            want = dict.fromkeys(want, 0)
        return {self.arch.LAUNCH_CHECKS[k]: abs(launched[k] - w)
                for k, w in want.items()}

    def kernel_bounds(self, phase: str, shapes) -> dict:
        """Each kernel's bound seconds by the family's counts, summed over
        ``shapes``: (batch, length) of prefill calls, or (batch,
        position) of decode steps."""
        out = {}
        for b, n in shapes:
            for k, s in self.arch.kernel_bounds(self.geometry, phase, b,
                                                n).items():
                out[k] = out.get(k, 0.0) + s
        return out

    def mark(self, stage: str) -> None:
        """Close the set-up stage ``stage`` (since the previous mark)."""
        import torch

        if self.device.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stages[stage] = now - self.marked
        self.marked = now


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_of(chips: int, need_card: bool, device: str | None):
    import torch

    if need_card:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark measures the card "
                             "and prints no result without one")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"the cell asks for {chips} cards, "
                             f"{torch.cuda.device_count()} are visible")
    return torch.device(device or "cuda")


def run_cell(layout: Layout, name: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, need_card: bool = True,
             device: str | None = None, control: bool = False) -> dict:
    """One run: returns the result line's object, with the check's record
    (``"_checked"``) and the windows' (``"_windows"``), which are not
    printed; with ``control``, also ``"control_correct"``, the verdict on
    the control's numbers."""
    import torch

    from portbench import port
    from portbench.trace import Spans, Tracer, breakdown, summarize

    entry = layout.cell(name)
    dev = device_of(entry["chips"], need_card, device)
    wl = layout.workload(name)
    if wl["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names the configuration "
                         f"{entry['config']}, its file {wl['config']}")
    cfg = layout.config(entry["config"])
    arch = layout.arch(cfg)
    cell = Cell(name=name, workload=wl, arch=arch, geometry=arch.geometry(cfg),
                seed=seed, device=dev, control=control, marked=t_start)
    cell.mark("start and imports")
    kind = layout.kind(wl["kind"])
    port.import_program()
    cell.mark("program import")
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cell.mark("device init")
    port.build_kernels(arch, dev)
    cell.mark("kernel build")
    st = kind.setup(cell)
    # what set-up made lives to the end: no collection walks it again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    port.zero_launches(arch)
    plain = None
    if trace:
        # the host's clock is read where the profiler does not slow the
        # host: an untraced first part of the window; the device's record
        # comes from the traced rest, whose outputs are judged
        plain = kind.window(cell, st, seconds * UNTRACED_SHARE, Spans())
        plain.pop("outs", None)
        seconds -= plain["seconds"]
        port.zero_launches(arch)
    spans = Spans()
    with Tracer(trace) as tracer:
        rec = kind.window(cell, st, seconds, spans)
    launched = port.launches(arch)
    summary = summarize(tracer, spans, rec["t_first"], rec["t_last"]) \
        if trace else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = kind.judged(cell, st, rec)
    del st, tracer
    rec.pop("outs", None)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gc.unfreeze()
    checked = kind.check(cell, out, rec, launched)
    del out
    numbers = checked["numbers"]
    limits = wl["limits"]
    if set(numbers) != set(limits):
        raise KeyError(f"{name}: numbers {sorted(numbers)} against limits "
                       f"{sorted(limits)}")
    correct = within(numbers, limits)

    window = plain or rec
    run = {"setup_s": setup_s, "window": window,
           "counts": kind.counts(cell, window, checked),
           "traced": None if not trace else {
               "window": rec, "counts": kind.counts(cell, rec, checked),
               "trace": summary},
           "arch": arch, "geometry": cell.geometry, "device": dev.type}
    metrics = {}
    for m in layout.metrics_of(name, trace):
        value = layout.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = rec["attempted"] + (plain["attempted"] if plain else 0)
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted,
              "metrics": metrics, "device": device_record(dev, entry["chips"],
                                                           peak, summary)}
    if summary is not None:
        result["breakdown"] = breakdown(summary)
    result["setup_stages_s"] = cell.stages
    if "control" in checked:
        control = checked["control"]
        if not control or not set(control) <= set(limits):
            raise KeyError(f"{name}: control numbers {sorted(control)} "
                           f"against limits {sorted(limits)}")
        # the same verdict on the control's outputs; it launches none of
        # the program's kernels, so it has no launch counts to judge
        result["control_correct"] = within(control, limits)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    result["_checked"] = checked
    result["_windows"] = {"untraced": plain, "traced": rec} if trace \
        else {"window": rec}
    return result


def within(numbers: dict, limits: dict) -> bool:
    """The verdict ``correct``: every compared number finite and at most
    its limit."""
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())


def device_record(dev, chips: int, peak: int, summary) -> dict:
    import torch

    if dev.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": chips, "memory_peak_bytes": peak}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": chips,
               "memory_peak_bytes": peak}
    if summary is not None:
        rec["busy_s"] = summary["busy_s"]
        rec["window_s"] = summary["window_s"]
    return rec
