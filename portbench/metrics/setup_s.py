"""Set-up seconds: process start to the first timed call (kernel build
where one is missing, weights, caches, warm-up)."""


def read(run: dict):
    return run["setup_s"]
