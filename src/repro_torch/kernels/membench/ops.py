"""The paper's SIV microbenchmarks (K1-K3): wrappers, plain versions, traffic.

Port of ``repro.kernels.membench`` (``ops``, ``kernel``, ``ref``).  The
wrappers take the reference's arguments — a sequence of 1-D arrays of one
dtype (float32 or bfloat16), ``block`` elements per tile — and:

* on CUDA tensors launch ``sum_blocks`` of ``csrc/membench.cu`` (or raise);
* on CPU tensors run the plain PyTorch version beside them (``*_ref``).

``*_traffic`` gives each wrapper's memory traffic from its launch geometry —
each input byte read once, each output byte written once — classed as the
validation harness maps classes onto LSU types: contiguous reads and writes
are ``stream``, the block-strided reads ``strided``, the indexed reads
``gather``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat

#: Inputs one launch sums (the kernel's pointer struct holds this many).
MAX_INPUTS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGNED, _STRIDED, _GATHER = 0, 1, 2


# -- plain versions (the reference's ref.py semantics) ----------------------

def aligned_sum_ref(xs):
    out = xs[0].float()
    for x in xs[1:]:
        out = out + x.float()
    return out.to(xs[0].dtype)


def strided_sum_ref(xs, *, delta, block):
    n_blocks = xs[0].shape[0] // delta // block

    def pick(x):
        # i-th output block reads the (i*delta)-th input block
        return x.reshape(-1, block)[
            torch.arange(n_blocks, device=x.device) * delta].reshape(-1)

    out = pick(xs[0]).float()
    for x in xs[1:]:
        out = out + pick(x).float()
    return out.to(xs[0].dtype)


def gather_sum_ref(xs, idx, *, block):
    idx = idx.long()

    def pick(x):
        return x.reshape(-1, block)[idx].reshape(-1)

    out = pick(xs[0]).float()
    for x in xs[1:]:
        out = out + pick(x).float()
    return out.to(xs[0].dtype)


# -- launch -----------------------------------------------------------------

def _inputs(xs) -> tuple:
    xs = tuple(xs)
    if not 1 <= len(xs) <= MAX_INPUTS:
        raise ValueError(f"need 1..{MAX_INPUTS} input arrays, got {len(xs)}")
    x0 = xs[0]
    if x0.dtype not in _DTYPES:
        raise TypeError(f"membench kernels take float32 or bfloat16, not {x0.dtype}")
    for x in xs:
        if (x.dim() != 1 or x.shape != x0.shape or x.dtype != x0.dtype
                or x.device != x0.device or not x.is_contiguous()):
            raise ValueError("inputs must be contiguous 1-D arrays of one "
                             "shape, dtype and device")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    return xs


def _launch(mode, xs, *, n_out_blocks, block, delta=1, idx=None):
    x0 = xs[0]
    vec = 16 // x0.element_size()
    if block % vec:
        raise ValueError(f"block must be a multiple of {vec} elements "
                         f"(16-byte vectors of {x0.dtype})")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("inputs must be 16-byte aligned")
    out = torch.empty(n_out_blocks * block, dtype=x0.dtype, device=x0.device)
    if n_out_blocks == 0:
        return out
    lib = compat.load("membench", membench_sum=[
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * MAX_INPUTS)(*[x.data_ptr() for x in xs])
    err = lib.membench_sum(
        mode, _DTYPES[x0.dtype], ptrs, len(xs), out.data_ptr(), n_out_blocks,
        block, delta, idx.data_ptr() if idx is not None else None,
        x0.shape[0] // block, compat.stream_ptr(x0.device))
    compat.check_launch(err, "membench_sum")
    return out


# -- wrappers ---------------------------------------------------------------

def aligned_sum(xs, *, block: int = 2048):
    """z = sum of n contiguous arrays, tiled in ``block``-element chunks."""
    xs = _inputs(xs)
    n = xs[0].shape[0]
    block = min(block, n)
    if block < 1 or n % block:
        raise ValueError(f"n={n} is not a multiple of block={block}")
    if xs[0].device.type == "cpu":
        return aligned_sum_ref(xs)
    out = _launch(_ALIGNED, xs, n_out_blocks=n // block, block=block)
    aligned_sum.launches += 1
    return out


def strided_sum(xs, *, delta: int, block: int = 2048):
    """z[i-th block] = sum of x_g[(delta * i)-th block]."""
    xs = _inputs(xs)
    if delta < 1:
        raise ValueError("delta must be >= 1")
    n_out = xs[0].shape[0] // delta
    block = min(block, n_out)
    if block < 1 or n_out % block:
        raise ValueError(f"n/delta={n_out} is not a multiple of block={block}")
    if xs[0].device.type == "cpu":
        return strided_sum_ref(xs, delta=delta, block=block)
    out = _launch(_STRIDED, xs, n_out_blocks=n_out // block, block=block,
                  delta=delta)
    strided_sum.launches += 1
    return out


def gather_sum(xs, idx, *, block: int = 2048):
    """z[i-th block] = sum of x_g[idx[i]-th block]; ``idx`` stays on the
    device and is read there (an index outside the inputs gives NaNs)."""
    xs = _inputs(xs)
    if idx.dim() != 1 or idx.device != xs[0].device:
        raise ValueError("idx must be a 1-D tensor on the inputs' device")
    if block < 1 or xs[0].shape[0] % block:
        raise ValueError(f"n={xs[0].shape[0]} is not a multiple of block={block}")
    if xs[0].device.type == "cpu":
        return gather_sum_ref(xs, idx, block=block)
    idx = idx.to(torch.int32).contiguous()
    out = _launch(_GATHER, xs, n_out_blocks=idx.shape[0], block=block, idx=idx)
    gather_sum.launches += 1
    return out


aligned_sum.launches = 0
strided_sum.launches = 0
gather_sum.launches = 0


# -- traffic from launch geometry -------------------------------------------

def _traffic(bytes_by_class: dict, flops: float) -> dict:
    return {"flops": float(flops),
            "total_bytes": float(sum(bytes_by_class.values())),
            "bytes_by_class": {k: float(v) for k, v in bytes_by_class.items()}}


def aligned_sum_traffic(xs, *, block: int = 2048) -> dict:
    g, n, isz = len(xs), xs[0].shape[0], xs[0].element_size()
    return _traffic({"stream": (g + 1) * n * isz}, (g - 1) * n)


def strided_sum_traffic(xs, *, delta: int, block: int = 2048) -> dict:
    g, isz = len(xs), xs[0].element_size()
    n_out = xs[0].shape[0] // delta
    return _traffic({"strided": g * n_out * isz, "stream": n_out * isz},
                    (g - 1) * n_out)


def gather_sum_traffic(xs, idx, *, block: int = 2048) -> dict:
    g, isz = len(xs), xs[0].element_size()
    m = idx.shape[0]
    # the kernel reads its block indices as int32
    return _traffic({"gather": g * m * block * isz,
                     "stream": m * block * isz + 4 * m},
                    (g - 1) * m * block)
