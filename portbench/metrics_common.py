"""What several metric readers share (``metrics/*.py``)."""
from __future__ import annotations

from portbench.trace import kernel_seconds


def roofline(run: dict, kernel: str):
    """A kernel's roofline share in percent: the bounds of its calls in
    the traced window over its device time in the trace (the kernel's
    names are the family's ``KERNELS``); None where the run was not traced
    or the trace holds none of it."""
    t = run["traced"]
    if t is None:
        return None
    bound = t["counts"]["kernel_bound_s"].get(kernel)
    if bound is None:
        return None
    secs, _ = kernel_seconds(t["trace"], run["arch"].KERNELS[kernel])
    return 100.0 * bound / secs if secs > 0 else None


def idle(run: dict, key: str):
    """The traced window's idle share in percent, in a window of ``key``
    (``calls``: prefill, ``steps``: decode)."""
    t = run["traced"]
    if t is None or key not in t["window"] or t["trace"]["busy_s"] <= 0:
        return None
    s = t["trace"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
