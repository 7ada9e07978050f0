"""The MoE layer's einsum combine: wrapper, plain version, traffic.

Replaces no TPU kernel: the reference combines with an einsum
(``repro.models.moe.forward_einsum``).  Each token's output is its k
slots' expert rows, weighted, summed in f32 in slot order and rounded
once to the activation dtype.  The expert outputs ``y`` are the held
experts' buffer of ``rows`` rows and, last, a zero row; a slot at
``rows`` or past it (a pair dropped, or routed to an expert not held
here) reads the zero row and adds nothing.

On CUDA tensors :func:`combine` launches ``csrc/moe_combine.cu`` (or
raises): one pass that reads only the live rows, each token's slots and
weights once, and writes the output once.  On CPU tensors it runs the
plain version :func:`combine_ref`, which gathers every pair's row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def combine_rows(y: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each pair's expert output: y's row at its slot, the zero row past
    the buffer -> (*slot.shape, d)."""
    rows = y.shape[0] - 1
    return y.index_select(0, slot.clamp(max=rows).reshape(-1)).reshape(
        *slot.shape, y.shape[1])


def combine_ref(y, slot, w):
    """y (rows + 1, d), its last row zero; slot (..., k) int64; w (..., k)
    in y's dtype -> (..., d): the k slots weighted and summed in f32,
    rounded once to y's dtype."""
    return (combine_rows(y, slot).float() * w.float()[..., None]).sum(-2) \
        .to(y.dtype)


def combine(y, slot, w):
    """:func:`combine_ref`'s result; on the card one launch that skips the
    slots past the buffer.  ``y`` must be contiguous; ``slot`` and ``w``
    are made so.  More slots a token than the kernel stages (64) fail at
    the launch."""
    if y.dim() != 2 or slot.dim() < 1 or w.shape != slot.shape:
        raise ValueError(f"y {tuple(y.shape)} must be (rows + 1, d), and "
                         f"slot {tuple(slot.shape)} and w {tuple(w.shape)} "
                         "one (..., k) shape")
    if not (y.device == slot.device == w.device):
        raise ValueError("y, slot and w must be on one device")
    compat.check_real("moe_combine", y, slot, w)
    if y.device.type == "cpu":
        return combine_ref(y, slot, w)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype not in _DTYPES or w.dtype != y.dtype:
        raise TypeError("the MoE combine takes float32 or bfloat16 y and w "
                        "of one dtype")
    if slot.dtype != torch.int64:
        raise TypeError("slot must be int64")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    slot, w = slot.contiguous(), w.contiguous()
    rows, d = y.shape[0] - 1, y.shape[1]
    k = slot.shape[-1]
    if d % (16 // y.element_size()) or y.data_ptr() % 16:
        raise ValueError(f"the MoE combine reads 16-byte vectors: d {d} and "
                         "y's address must be multiples of 16 bytes")
    if rows < 0:
        raise ValueError("y must hold at least its zero row")
    out = y.new_empty((*slot.shape[:-1], d))
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib = compat.load("moe_combine", moe_combine=[i, p, p, p, p, ll, ll, i, i,
                                                  p])
    err = lib.moe_combine(_DTYPES[y.dtype], y.data_ptr(), slot.data_ptr(),
                          w.data_ptr(), out.data_ptr(), rows,
                          out.numel() // d, k, d, compat.stream_ptr(y.device))
    compat.check_launch(err, "moe_combine")
    combine.launches += 1
    return out


combine.launches = 0


def combine_traffic(y, slot) -> dict:
    """Bytes and flops of one ``combine`` call: each live row (a slot
    inside the buffer) read once, the slots and weights read once, the
    output written once; 2 flops an element of a live row."""
    rows, d = y.shape[0] - 1, y.shape[1]
    live = int((slot < rows).sum())
    e = y.element_size()
    T = slot.numel() // max(slot.shape[-1], 1)
    by_class = {"rows": float(live * d * e), "output": float(T * d * e),
                "slots": float(slot.numel() * (slot.element_size() + e))}
    return {"flops": float(2 * live * d),
            "total_bytes": float(sum(by_class.values())),
            "bytes_by_class": by_class}
