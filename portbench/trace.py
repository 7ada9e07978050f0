"""The traced run: the device's record of the window, and the harness's spans.

``Spans`` records what the harness's host thread was doing (issuing a
step, waiting for its tokens, feeding the next input) as intervals of
``time.perf_counter``; it costs a list append a span.  ``Tracer`` runs the
window under ``torch.profiler`` with device activity only (host operators
would slow the host-bound steps it measures) and, as
``chip_smoke.device_profile`` does, sums the raw kineto events as they
come instead of building the profiler's tables, and writes no chrome
trace: a decode window is ~10^6 events.  :func:`summarize` reduces them to
what the per-layer metrics read: time and count by kernel name, the union
of the device's busy intervals (not the sum of durations, which counts
overlapping kernels twice), and the idle gaps, each named by the harness
span that covers it.
"""
from __future__ import annotations

import collections
import time

import numpy as np

#: Names of device activity that is a copy or a fill, not a kernel.
NOT_KERNELS = ("Memcpy", "Memset")


class Spans:
    """Labelled host intervals (perf_counter seconds)."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, label: str, t0: float, t1: float) -> None:
        self.items.append((label, t0, t1))


class Tracer:
    """``with Tracer(on):`` profiles the block's device activity where
    ``on``; ``summarize`` after it."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.anchor = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        # one instant on the clocks the trace may be stamped with
        self.anchor = (time.perf_counter(), time.time_ns(),
                       time.monotonic_ns())
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def events(self):
        """(names, starts ns, ends ns) of the device activity recorded."""
        from torch.autograd import DeviceType

        names, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                names.append(e.name())
                s = e.start_ns()
                starts.append(s)
                ends.append(s + e.duration_ns())
        return names, np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def _to_host(starts: np.ndarray, anchor, t_first: float,
             t_last: float):
    """The trace's stamps as perf_counter seconds, on whichever clock (wall
    or monotonic) puts the events inside the host's window; None where
    neither does."""
    perf0, wall0, mono0 = anchor
    for zero in (mono0, wall0):
        host = perf0 + (starts - zero) * 1e-9
        inside = np.mean((host >= t_first - 1e-3) & (host <= t_last + 1.0))
        if inside >= 0.95:
            return zero
    return None


def summarize(tracer: Tracer, spans: Spans, t_first: float,
              t_last: float) -> dict:
    """The window's device record, ``t_first``..``t_last`` its host
    interval (perf_counter)."""
    names, starts, ends = tracer.events()
    window_s = t_last - t_first
    by_name = collections.defaultdict(lambda: [0.0, 0])
    kernels = 0
    for name, s, e in zip(names, starts, ends):
        row = by_name[name]
        row[0] += (e - s) * 1e-9
        row[1] += 1
        kernels += not name.startswith(NOT_KERNELS)
    out = {"window_s": window_s, "by_name": dict(by_name),
           "kernels": kernels, "busy_s": 0.0, "gaps": {}}
    if not names:
        return out
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    gap = s[1:] - reach[:-1]
    inner = gap > 0
    out["busy_s"] = ((reach[-1] - s[0]) - gap[inner].sum()) * 1e-9
    zero = _to_host(s, tracer.anchor, t_first, t_last)
    lo = np.concatenate([reach[:-1][inner], [reach[-1]]])
    hi = np.concatenate([s[1:][inner], [0]])
    if zero is None:
        out["gaps"] = {"clocks not aligned": [float(gap[inner].sum() * 1e-9),
                                              int(inner.sum()),
                                              float(gap.max(initial=0)
                                                    * 1e-9)]}
        return out
    perf0 = tracer.anchor[0]
    lo_h = perf0 + (lo - zero) * 1e-9
    hi_h = perf0 + (hi - zero) * 1e-9
    # the tail: from the last kernel's end to the window's close
    hi_h[-1] = t_last
    # the head: from the window's open to the first kernel
    first_h = perf0 + (s[0] - zero) * 1e-9
    lo_h = np.concatenate([[t_first], lo_h])
    hi_h = np.concatenate([[first_h], hi_h])
    span_lo = np.asarray([t0 for _, t0, _ in spans.items])
    span_hi = np.asarray([t1 for _, _, t1 in spans.items])
    labels = [label for label, _, _ in spans.items]
    gaps = collections.defaultdict(lambda: [0.0, 0, 0.0])
    for a, b in zip(lo_h, hi_h):
        dur = b - a
        if dur <= 0:
            continue
        mid = 0.5 * (a + b)
        j = int(np.searchsorted(span_lo, mid, side="right")) - 1
        label = labels[j] if j >= 0 and mid < span_hi[j] \
            else "outside the harness's spans"
        row = gaps[label]
        row[0] += dur
        row[1] += 1
        row[2] = max(row[2], dur)
    out["gaps"] = dict(gaps)
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the idle time by what the host was doing."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1][0])
    return {"device_ops": [[name[:160], secs]
                           for name, (secs, _) in ops[:top]],
            "idle_gaps": [[f"{label} ({n} gaps, longest {longest} s)", secs]
                          for label, (secs, n, longest) in gaps[:top]]}


def kernel_seconds(summary: dict, fragments) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds any of
    ``fragments``."""
    secs, n = 0.0, 0
    for name, (s, c) in summary["by_name"].items():
        if any(f in name for f in fragments):
            secs += s
            n += c
    return secs, n


#: Name fragments of the library's (cuBLAS) matrix products.
PRODUCTS = ("gemm", "nvjet", "cutlass", "xmma", "gemv", "splitk")


def is_product(name: str) -> bool:
    low = name.lower()
    return any(f in low for f in PRODUCTS)


def is_port_kernel(name: str, kernels: dict) -> bool:
    """Whether ``name`` is one of the program's own kernels, ``kernels``
    a family's ``KERNELS``."""
    return any(f in name for frags in kernels.values() for f in frags)
