"""Device kernels in the trace a decode step of the traced window (copies
and fills apart)."""


def read(run: dict):
    t = run["traced"]
    if t is None or "steps" not in t["window"] or not t["trace"]["kernels"]:
        return None
    return t["trace"]["kernels"] / t["window"]["steps"]
