"""Device time inside the program's ``moe.shared`` spans (the shared
expert's three products and its activation, and its add to the routed
experts' output), a prompt token of the traced window, in microseconds:
CUDA-event time on the stream between each span's edges."""

from portbench.program_spans import device_us_per_token


def read(run: dict):
    return device_us_per_token(run, "moe.shared")
