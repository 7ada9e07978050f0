"""RG-LRU sequence scan (K6): wrapper, plain version, traffic.

Port of ``repro.kernels.rglru`` (``ops``, ``kernel``, ``ref``):
``h_t = a_t * h_{t-1} + b_t`` along S of ``(B, S, W)`` inputs, the carry in
float32 and the output in the input dtype.  On CUDA tensors :func:`scan`
launches the one-pass scan of ``csrc/rglru.cu`` (or raises); on CPU tensors
it runs the plain PyTorch version :func:`rglru_scan_ref`.

The port reads the reference's blocks as the card's tile: ``block_w``
caps the channels one CTA holds (rounded up to a whole warp, at most
``MAX_TILE``), ``block_s`` the time steps of one stage of its copy ring (at
most ``MAX_STEPS``).  Neither has to divide S or W: the kernel masks the
ragged edges.  One launch per call reads a and b once; nothing else is
allocated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Channels a CTA holds and time steps a stage of its ring, at most.
MAX_TILE = 128
MAX_STEPS = 32


def tile(W: int, block_s: int, block_w: int) -> tuple[int, int]:
    """(channels a CTA, steps a stage) of a call on rows of W channels."""
    return (min(MAX_TILE, -(-min(block_w, W) // 32) * 32),
            min(MAX_STEPS, block_s))


def rglru_scan_ref(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 in float32; a, b: (B, S, W)."""
    af, bf = a.float(), b.float()
    out = torch.empty_like(af)
    h = torch.zeros_like(af[:, 0])
    for t in range(a.shape[1]):
        h = torch.addcmul(bf[:, t], af[:, t], h)
        out[:, t] = h
    return out.to(a.dtype)


def scan(a, b, *, block_s: int = 256, block_w: int = 512):
    """a, b: (B, S, W) float32 or bfloat16 -> (B, S, W) in a's dtype."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "one (B, S, W) shape")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if block_s < 1 or block_w < 1:
        raise ValueError("block_s and block_w must be >= 1")
    compat.check_real("rglru_scan", a, b)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError("the RG-LRU scan takes float32 or bfloat16 a and b "
                        "of one dtype")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    B, S, W = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    cw, steps = tile(W, block_s, block_w)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib = compat.load("rglru", rglru_scan=[i, p, p, p, i, i, i, i, i, p])
    err = lib.rglru_scan(_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), B, S, W, cw, steps,
                         compat.stream_ptr(a.device))
    compat.check_launch(err, "rglru_scan")
    scan.launches += 1
    return out


scan.launches = 0


def rglru_scan_traffic(a, b) -> dict:
    """Bytes and flops of one ``scan`` call: a and b read once and h
    written once, contiguous (``stream``); 2 flops per element."""
    n = a.numel()
    nbytes = 3 * n * a.element_size()
    return {"flops": float(2 * n), "total_bytes": float(nbytes),
            "bytes_by_class": {"stream": float(nbytes)}}
