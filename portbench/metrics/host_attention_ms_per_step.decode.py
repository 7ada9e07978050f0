"""Host time inside the program's ``attention`` spans a decode step of the
traced window, in milliseconds (``perf_counter``, the profiler on)."""

from portbench.program_spans import host_ms_per_step


def read(run: dict):
    return host_ms_per_step(run, "attention")
