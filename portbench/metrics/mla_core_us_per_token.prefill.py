"""Device time inside the program's ``mla.core`` spans (latent attention's
K5 call at 192/128), a prompt token of the traced window, in
microseconds: CUDA-event time on the stream between each span's edges."""

from portbench.program_spans import device_us_per_token


def read(run: dict):
    return device_us_per_token(run, "mla.core")
