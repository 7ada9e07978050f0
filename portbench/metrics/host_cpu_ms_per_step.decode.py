"""The host thread's CPU time (``time.thread_time``) a step, in
milliseconds, over the untraced window: the client loop and the eager
dispatch, with no profiler on the host."""


def read(run: dict):
    w = run["window"]
    if "steps" not in w:
        return None
    return w["host_cpu_s"] / w["steps"] * 1e3
