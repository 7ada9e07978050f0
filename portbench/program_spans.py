"""The program's own spans in a traced run (``repro_torch.runtime.tracing``).

The program records spans at its layer boundaries while a profiler session
is active, which in a traced run is the traced window alone: one root a
step (``prefill_step``, ``decode_step``) and, under it, ``attention``,
``mlp`` and the MoE layer's ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine``.  Each span's host time is read on
``time.perf_counter``, the clock of the harness's own spans, and its
device time from CUDA events at its edges on the stream.  Like ``port.py``
this module touches the program, and imports it inside its functions.
"""
from __future__ import annotations


def totals(run: dict, root: str, key: str):
    """The program's span totals by name (``tracing.totals()``: count,
    host seconds, host self seconds, device seconds, device self seconds)
    of the traced window, whose steps are the roots named ``root`` and
    counted by the window's ``key`` (``calls`` or ``steps``).  None where
    the run was not traced, the program records no spans, or the
    recording is not the traced window's: its first root opened outside
    the window (a buffer left from an earlier session), or its roots are
    not the window's calls or steps."""
    t = run["traced"]
    if t is None or key not in t["window"]:
        return None
    try:
        from repro_torch.runtime import tracing
    except ImportError:             # a program that records no spans
        return None
    spans = tracing.records()
    w = t["window"]
    if not spans or not w["t_first"] <= spans[0].t0 * 1e-9 <= w["t_last"]:
        return None
    got = tracing.totals()
    if root not in got or got[root].count != w[key]:
        return None
    return got


def device_us_per_token(run: dict, name: str):
    """Device microseconds inside the spans ``name`` a prompt token of the
    traced window's prefill calls; None where no such span opened or it
    has no device time (the CPU)."""
    got = totals(run, "prefill_step", "calls")
    if got is None or name not in got or got[name].device_s is None:
        return None
    return got[name].device_s / run["traced"]["window"]["tokens"] * 1e6


def host_ms_per_step(run: dict, name: str):
    """Host milliseconds inside the spans ``name`` a decode step of the
    traced window; None where no such span opened."""
    got = totals(run, "decode_step", "steps")
    if got is None or name not in got:
        return None
    return got[name].host_s / run["traced"]["window"]["steps"] * 1e3
