"""The plain float32 references that decide ``correct``, one a family
(``<family>.py``, named by ``archs/<family>.py``), and what they share:
every product in f32 with TF32 off, and the fp8 rounding of the control.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def exact_matmuls() -> None:
    """f32 products in f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to float8 e4m3 under one scale, back in f32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
