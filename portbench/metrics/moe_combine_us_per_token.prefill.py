"""Device time inside the program's ``moe.combine`` spans (the gather of
each pair's expert row, its weighting, the sum over the k slots and the
cast), a prompt token of the traced window, in microseconds: CUDA-event
time on the stream between each span's edges."""

from portbench.program_spans import device_us_per_token


def read(run: dict):
    return device_us_per_token(run, "moe.combine")
