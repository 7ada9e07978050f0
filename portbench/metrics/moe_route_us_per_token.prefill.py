"""Device time inside the program's ``moe.route`` spans (the router's
product and top-k, each pair's place in its expert's queue, the keep mask,
the combine weight and each pair's buffer row), a prompt token of the
traced window, in microseconds: CUDA-event time on the stream between each
span's edges."""

from portbench.program_spans import device_us_per_token


def read(run: dict):
    return device_us_per_token(run, "moe.route")
