"""Spans inside the model's steps, recorded while a ``torch.profiler``
session is active.

A step opens a root span (:func:`root`: ``prefill_step``, ``decode_step``)
and the layers under it open spans of their own (:func:`span`:
``attention``, inside latent attention's ``mla.project`` and
``mla.core``, ``mlp``, the MoE layer's ``moe.route``, ``moe.dispatch``,
``moe.experts``, ``moe.combine`` and ``moe.shared``).  One switch turns
recording on: a profiler session.  Each root asks whether one is active
(one call into torch, a fraction of a microsecond); when the answer turns
from no to yes, the buffer is cleared and a new recording starts.  While it is no, or
outside a recording root, a span is one shared object that does nothing.

A recorded span keeps its name, the index of the span that opened it (its
parent), its root's step number (every span of one step shares it) and
``time.perf_counter_ns()`` at entry and exit, the clock that
``time.perf_counter`` reads, so the spans line up with a caller's own.
Under a root given a CUDA device each edge also records a CUDA event on
that device's current stream (from a pool kept across recordings).
Nothing waits for the device while recording: :func:`totals` reads the
events once the recording is over.  An event costs the host far more
inside a step than alone (~60 µs against ~5 µs on an H100 machine), so a
step whose host paces the device (a decode step) gives its root no
device, and its spans are timed on the host's clock alone.

A span's self time is its duration less the union of its children's
intervals, on the host's clock and on the device's.  The device time of a
span is the stream's time between its two events: the device's work on it
where the host keeps the stream full, and idle time besides where the
host is slower than the device.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span: ``parent`` the index of the span that opened it
    (None for a root), ``step`` its root's step, ``t0``/``t1`` the host's
    ``perf_counter_ns`` at entry and exit, ``e0``/``e1`` its CUDA events
    (None off CUDA)."""

    __slots__ = ("name", "parent", "step", "t0", "t1", "e0", "e1", "_rec")

    def __init__(self, name: str, parent: int | None, step: int,
                 t0: int = 0, t1: int = 0, e0=None, e1=None):
        self.name, self.parent, self.step = name, parent, step
        self.t0, self.t1, self.e0, self.e1 = t0, t1, e0, e1
        self._rec = None

    def __enter__(self):
        if self.e0 is not None:
            self.e0.record(self._rec._local.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.e1 is not None:
            self.e1.record(self._rec._local.stream)
        self.t1 = time.perf_counter_ns()
        self._rec._local.stack.pop()
        if self.parent is None:
            self._rec.open_roots -= 1
        return False


class _Off:
    """A span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Total(NamedTuple):
    """The spans of one name in a recording: how many, and their seconds
    in all and of their own (children's time taken out) on the host's
    clock and on the device's (None where a span of the name has no
    device interval)."""
    count: int
    host_s: float
    host_self_s: float
    device_s: float | None
    device_self_s: float | None


def _union(intervals):
    """The length of the union of (start, end) intervals."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def tally(spans: list[Span], device: list | None = None) -> dict[str, Total]:
    """Each name's :class:`Total` over ``spans``; ``device`` gives each
    span's device interval in seconds (on one clock within its step), or
    None for a span without one."""
    if device is None:
        device = [None] * len(spans)
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent is not None:
            kids[s.parent].append(i)
    acc: dict[str, list] = {}
    for i, s in enumerate(spans):
        host = s.t1 - s.t0
        host_self = host - _union((spans[j].t0, spans[j].t1)
                                  for j in kids[i])
        a = acc.setdefault(s.name, [0, 0, 0, 0.0, 0.0, True])
        a[0] += 1
        a[1] += host
        a[2] += host_self
        d = device[i]
        if d is None or any(device[j] is None for j in kids[i]):
            a[5] = False
            continue
        a[3] += d[1] - d[0]
        a[4] += d[1] - d[0] - _union(device[j] for j in kids[i])
    return {name: Total(a[0], a[1] * 1e-9, a[2] * 1e-9,
                        a[3] if a[5] else None, a[4] if a[5] else None)
            for name, a in acc.items()}


class _Thread(threading.local):
    """A thread's open spans (their indices, innermost last) and the
    stream its root's events are recorded on."""

    def __init__(self):
        self.stack: list[int] = []
        self.stream = None


class Recorder:
    """The buffer of one recording and the switch that starts it."""

    def __init__(self):
        self.spans: list[Span] = []
        #: recording roots open, in every thread: none, and a span is off
        #: without a look at its thread's stack
        self.open_roots = 0
        self._on = False
        self._steps = 0
        self._local = _Thread()
        self._events: list = []
        self._used = 0
        self._totals: tuple[int, dict] | None = None

    def _event(self):
        if self._used == len(self._events):
            self._events.append(torch.cuda.Event(enable_timing=True))
        self._used += 1
        return self._events[self._used - 1]

    def _open(self, name: str, parent: int | None, step: int,
              timed: bool) -> Span:
        s = Span(name, parent, step)
        if timed:
            s.e0, s.e1 = self._event(), self._event()
        s._rec = self
        self._local.stack.append(len(self.spans))
        self.spans.append(s)
        return s

    def root(self, name: str, device=None):
        on = _profiling()
        if on and not self._on:
            self.spans, self._used, self._totals = [], 0, None
        self._on = on
        if not on:
            return _OFF
        self._steps += 1
        self.open_roots += 1
        timed = device is not None and torch.device(device).type == "cuda"
        if timed:
            self._local.stream = torch.cuda.current_stream(device)
        return self._open(name, None, self._steps, timed)

    def span(self, name: str):
        if not self.open_roots:
            return _OFF
        stack = self._local.stack
        if not stack:
            return _OFF
        top = self.spans[stack[-1]]
        return self._open(name, stack[-1], top.step, top.e0 is not None)

    def totals(self) -> dict[str, Total]:
        n = len(self.spans)
        if self._totals is None or self._totals[0] != n:
            self._totals = (n, tally(self.spans, self._device_intervals()))
        return self._totals[1]

    def _device_intervals(self) -> list:
        """Each span's events as seconds from its step's first event (the
        root's: cudaEventElapsedTime is a float of milliseconds, so the
        origin stays near)."""
        out, origin = [], {}
        for s in self.spans:
            if s.e0 is None:
                out.append(None)
                continue
            zero = origin.setdefault(s.step, s.e0)
            s.e1.synchronize()
            out.append((zero.elapsed_time(s.e0) * 1e-3,
                        zero.elapsed_time(s.e1) * 1e-3))
        return out


_RECORDER = Recorder()


def root(name: str, device=None):
    """``with root(name, device):`` the span of one step, its spans timed
    on ``device``'s stream too where that is a CUDA device: starts a
    recording where a profiler session has started since the last root,
    and records nothing outside a session."""
    return _RECORDER.root(name, device)


def span(name: str):
    """``with span(name):`` a span under the innermost open span of this
    thread; records nothing outside a recording root."""
    return _RECORDER.span(name)


def totals() -> dict[str, Total]:
    """The current recording's :class:`Total` by span name (computed once
    a recording, after its last span has closed; reads the device's
    events, waiting for them)."""
    return _RECORDER.totals()


def records() -> list[Span]:
    """The current recording's spans, in the order they opened."""
    return _RECORDER.spans
