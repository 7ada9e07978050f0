"""Device time inside the program's ``attention`` spans (the q/k/v products,
RoPE, K5 and the output product), a prompt token of the traced window, in
microseconds: CUDA-event time on the stream between each span's edges."""

from portbench.program_spans import device_us_per_token


def read(run: dict):
    return device_us_per_token(run, "attention")
