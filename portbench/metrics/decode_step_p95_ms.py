"""The 95th percentile of every step's time in the window, from its issue
until its tokens are on the host: the gap between output tokens."""

import statistics


def read(run: dict):
    w = run["window"]
    if "steps" not in w or w["steps"] < 20:
        return None
    return statistics.quantiles(w["step_s"], n=100)[94] * 1e3
