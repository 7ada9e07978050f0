"""Forward GQA flash attention (K5): wrappers, plain version, traffic.

Port of ``repro.kernels.flash_attention`` (``ops``, ``kernel``, ``ref``).
``mha`` keeps the reference's model layout — q ``(B, Sq, Hq, D)`` over k, v
``(B, Skv, Hkv, D)`` — and ``flash_attention`` the kernel's
``(B, H, S, D)``; both take views, so no layout is copied.  On CUDA
tensors ``flash_attention`` launches ``csrc/flash_attention.cu`` (or
raises); on CPU tensors it runs the plain PyTorch version
:func:`attention_ref`.

``block_q`` and ``block_kv`` are the reference's TPU tile sizes.  The port
accepts them so that callers keep the reference's signature, and otherwise
ignores them: the card's tiles are fixed by the kernel (on the tensor cores
128 query rows and 128 keys, 64 keys at D = 256).

No tensor is padded: where the reference's ``mha`` pads D to 128 lanes,
the tensor-core kernel at D = 80 (stablelm-3b's and hubert-xlarge's) runs
an 80-column instance, a 64-column block and a 16-column tail block, so
that no product touches a column past 80.

v may be narrower than q and k for one pair alone (``V_HEAD_DIMS``):
latent attention's prefill (DeepSeek-V3's MLA), q and k of 192 columns
(128 without position, 64 rotated) and v of 128, which the tensor-core
kernel runs as an instance of its own (bfloat16, no window, no cap).  The
output has v's head size.  Every other mismatch raises.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch import compat

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
NEG_INF = -1e30
#: Query rows the plain version takes at a time, so that it never holds an
#: (Sq, Skv) score matrix of every head (2·28·4096² fp32 is 3.8 GB).
ROW_BLOCK = 512
#: Head sizes the bfloat16 wgmma kernel takes; every other (dtype, D) runs on
#: the CUDA cores.
WGMMA_HEAD_DIMS = (64, 80, 128, 192, 256)
_PATHS = {"simt": 0, "wgmma": 1}
#: v's head size where it is not q's and k's, by theirs: the pairs that
#: only the wgmma kernel runs (bfloat16, no window, no cap).
V_HEAD_DIMS = {192: 128}


def kernel_path(dtype: torch.dtype, D: int) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a CUDA call takes:
    ``"wgmma"`` (bfloat16, D in ``WGMMA_HEAD_DIMS``) or ``"simt"``."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS \
        else "simt"


def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                  scale=None, q_offset=0):
    """q: (B, Sq, Hq, D), k: (B, Skv, Hkv, D), v: (B, Skv, Hkv, Dv) ->
    (B, Sq, Hq, Dv), float32 math; query row i sits at position
    ``q_offset + i``.

    The reference oracle's masked softmax, taken ``ROW_BLOCK`` query rows
    at a time.
    A row whose keys are all masked gives 0, as the kernels give it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    kp = torch.arange(Skv, device=q.device)
    Dv = v.shape[3]
    out = torch.empty((B, Sq, Hq, Dv), dtype=torch.float32, device=q.device)
    for r0 in range(0, Sq, ROW_BLOCK):
        n = min(ROW_BLOCK, Sq - r0)
        qq = q[:, r0:r0 + n].float().reshape(B, n, Hkv, G, D) * scale
        s = torch.einsum("bqhgd,bkhd->bqhgk", qq, kf)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qp = q_offset + torch.arange(r0, r0 + n, device=q.device)
        mask = torch.ones((n, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kp[None, :] <= qp[:, None]
        if window is not None:
            mask &= kp[None, :] > qp[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1) * mask.any(-1)[None, :, None, None, None]
        out[:, r0:r0 + n] = torch.einsum("bqhgk,bkhd->bqhgd", p, vf) \
            .reshape(B, n, Hq, Dv)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, block_q: int = 512,
                    block_kv: int = 512, scale: float | None = None):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) -> (B,
    Hq, Sq, Dv) in q's dtype and order of dimensions; Dv is D but for the
    pairs of ``V_HEAD_DIMS``.  Each may be a view whose last dimension is
    contiguous; off the wgmma kernel's instances of D <= 192 the kernel
    takes q dense and k and v views of one layout alone."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    Dv = v.shape[3]
    if Dv != k.shape[3] and V_HEAD_DIMS.get(k.shape[3]) != Dv:
        raise ValueError(f"v's head size {Dv} differs from k's {k.shape[3]}: "
                         f"only the pairs {V_HEAD_DIMS} run")
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)} "
                         "(batch, head size, and a whole number of query heads "
                         "per kv head)")
    if window is not None and window < 1:
        raise ValueError("window must be None or >= 1")
    if block_q < 1 or block_kv < 1:
        raise ValueError("block_q and block_kv must be >= 1")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    compat.check_real("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             softcap=softcap, scale=scale).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash attention takes float32 or bfloat16 q, k, v "
                        "of one dtype")
    path = kernel_path(q.dtype, D)
    if D in V_HEAD_DIMS:
        if path != "wgmma" or Dv != V_HEAD_DIMS[D] or window is not None \
                or softcap:
            raise ValueError(f"head size {D} runs as the {D}/{V_HEAD_DIMS[D]} "
                             "pair, on the tensor cores in bfloat16, with no "
                             "window and no cap")
    elif D not in HEAD_DIMS:
        raise ValueError(f"head size {D} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v must each have a contiguous last "
                         "dimension")
    # dense, in q's order of dimensions, outermost first
    order = sorted(range(4), key=lambda i: -q.stride(i))
    out = q.new_empty([(B, Hq, Sq, Dv)[i] for i in order]) \
        .permute([order.index(i) for i in range(4)])
    if path == "wgmma" and (
            any(s % 8 for s in (*q.stride()[:3], *k.stride()[:3],
                                *v.stride()[:3]))
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("the tensor-core kernel needs 16-byte aligned rows")
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    f = ctypes.c_float
    lib = compat.load("flash_attention", flash_attention=[
        i, i, i, i, p, p, p, p, i, i, i, i, i, *[ll] * 12, i, i, f, f, p])
    err = lib.flash_attention(
        _PATHS[path], _DTYPES[q.dtype], D, Dv, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, Sq, Skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), int(window or 0), scale, float(softcap),
        compat.stream_ptr(q.device))
    compat.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def mha(q, k, v, *, causal: bool = True, window: int | None = None,
        softcap: float = 0.0, block_q: int = 512, block_kv: int = 512,
        scale: float | None = None):
    """q: (B, Sq, Hq, D), k: (B, Skv, Hkv, D), v: (B, Skv, Hkv, Dv) ->
    (B, Sq, Hq, Dv); ``scale`` defaults to 1 / sqrt(D)."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, S, H, D)")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          softcap=softcap, block_q=block_q, block_kv=block_kv,
                          scale=scale)
    return out.transpose(1, 2)


def live_pairs(Sq: int, Skv: int, *, causal: bool = True,
               window: int | None = None) -> int:
    """(query, key) pairs the masks leave live, per head."""
    pos = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, pos - window + 1) if window is not None \
        else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention_traffic(q, k, v, *, causal: bool = True,
                            window: int | None = None) -> dict:
    """Bytes and flops of one ``mha`` call on (B, S, H, D) inputs (v and
    the output of Dv columns): q, k, v read once and the output written
    once, contiguous rows (``stream``); 2·(D + Dv) flops (Q·Kᵀ and P·V) for
    every live (query, key) pair of every query head."""
    B, Sq, Hq, D = q.shape
    Dv = v.shape[3]
    nbytes = (q.numel() + B * Sq * Hq * Dv + k.numel() + v.numel()) \
        * q.element_size()
    pairs = live_pairs(Sq, k.shape[1], causal=causal, window=window)
    return {"flops": float(2 * B * Hq * (D + Dv) * pairs),
            "total_bytes": float(nbytes),
            "bytes_by_class": {"stream": float(nbytes)}}
