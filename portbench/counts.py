"""The table every share is taken against, and the roofline's bound.

The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at 700 W).  A bound is the least time the card could take: the larger of
operations over the peak rate and bytes over the HBM bandwidth, each
input byte read once and each output byte written once.  Products the
configuration states in f32 (the MoE router) are held to the f32 peak
outside the tensor cores.

The operations and bytes of each kernel and each whole step are the
family's (``archs/<family>.py``: ``prefill_call``, ``decode_step``,
``kernel_bounds``), counted from the configuration's file and never from
the program, so that a change of the program cannot move its own
yardstick.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
PEAK_FP32_FLOPS = 67e12           # f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12        # HBM3
BF16 = 2


def bound_s(flops: float = 0.0, nbytes: float = 0.0,
            f32_flops: float = 0.0) -> float:
    """The roofline's least time of work of ``flops`` bf16 tensor-core
    operations, ``f32_flops`` f32 ones and ``nbytes`` bytes moved."""
    return max(flops / PEAK_BF16_FLOPS + f32_flops / PEAK_FP32_FLOPS,
               nbytes / PEAK_BYTES_PER_S)


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask leaves live in one head."""
    return seq * (seq + 1) // 2
