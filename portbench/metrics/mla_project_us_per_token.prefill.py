"""Device time inside the program's ``mla.project`` spans (latent
attention's projections from the layer's input to q, k and v: q_a, its
norm, q_b, kv_a, its norm, kv_b, RoPE and the assembly of k), a prompt
token of the traced window, in microseconds: CUDA-event time on the
stream between each span's edges."""

from portbench.program_spans import device_us_per_token


def read(run: dict):
    return device_us_per_token(run, "mla.project")
