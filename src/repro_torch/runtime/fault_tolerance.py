"""Fault tolerance for long training runs.

Port of ``repro.runtime.fault_tolerance`` (plain Python).  Pieces, wired
together by ``launch/train.py``:

* :class:`PreemptionHandler`: SIGTERM (or any given signal) sets a flag;
  the loop checkpoints and exits cleanly at the next step boundary;
* :class:`StepWatchdog`: per-step wall times with a robust outlier rule
  (a step over ``factor`` times the running median is a straggler);
* auto-resume: ``CheckpointManager.latest_step`` and data that is a pure
  function of ``(seed, step, shard)`` make a restart exact without
  replaying the data stream.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable


class PreemptionHandler:
    """Convert SIGTERM/SIGINT into a cooperative should-stop flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._installed = False
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            try:
                signal.signal(s, self._handler)
            except ValueError:
                pass  # not in the main thread
        self._installed = True
        return self

    def _handler(self, signum, frame):
        del frame
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def trigger(self) -> None:
        """Set the flag as a signal would."""
        self._stop = True


class StepWatchdog:
    """Straggler detection from per-step wall times (``time.monotonic``)."""

    def __init__(self, *, factor: float = 3.0, window: int = 50,
                 warmup: int = 5,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.times: list[float] = []
        self.straggler_steps: list[int] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.monotonic()

    def end_step(self) -> float:
        if self._t0 is None:
            raise RuntimeError("end_step without start_step")
        dt = time.monotonic() - self._t0
        history = self.times[-self.window:]
        if len(history) >= self.warmup:
            med = statistics.median(history)
            if dt > self.factor * med:
                self.straggler_steps.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, dt, med)
        self.times.append(dt)
        return dt

    @property
    def median_step_time(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
