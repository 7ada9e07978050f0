"""One-token GQA decode attention (K4): wrappers, plain version, traffic.

Port of ``repro.kernels.decode_attention`` (``ops``, ``kernel``, ``ref``).
``gqa_decode`` keeps the reference's model layout — q ``(B, 1, Hq, D)``
over ``(B, S, Hkv, D)`` caches, ``kv_len`` a scalar that may live on the
device — and ``decode_attention`` the kernel's grouped layout
``(B, Hkv, G, D)``.  On CUDA tensors ``decode_attention`` launches the
split-S kernel of ``csrc/decode_attention.cu`` (or raises); on CPU tensors
it runs the plain PyTorch version :func:`decode_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import compat

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
#: CTAs per SM the S split aims for: enough waves that the last one is short.
_CTAS_PER_SM = 8


def decode_attention_ref(q, k_cache, v_cache, kv_len, *, softcap=0.0,
                         scale=None):
    """q: (B,Hkv,G,D); caches (B,S,Hkv,D); kv_len scalar -> (B,Hkv,G,D)."""
    B, Hkv, G, D = q.shape
    S = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(())
    mask = torch.arange(S, device=q.device)[None, None, None, :] < kv_len
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.to(q.dtype)


def _plan(S: int, B: int, Hkv: int, block_s: int,
          device) -> tuple[int, int]:
    """(n_split, chunk): split S into ``chunk``-row ranges, each a whole
    number of ``block_s`` blocks, so that the grid holds about
    ``_CTAS_PER_SM`` CTAs per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_blocks = -(-S // block_s)
    n_split = max(1, min(-(-_CTAS_PER_SM * sms // (B * Hkv)), n_blocks))
    chunk = -(-n_blocks // n_split) * block_s
    return -(-S // chunk), chunk


def decode_attention(q, k_cache, v_cache, kv_len, *, softcap: float = 0.0,
                     block_s: int = 512, scale: float | None = None):
    """q: (B, Hkv, G, D) grouped heads; caches (B, S, Hkv, D); ``kv_len`` an
    int or a one-element int tensor (never read on the host) -> (B,Hkv,G,D).
    The cache rows are dealt to CTAs in whole blocks of ``block_s``."""
    B, Hkv, G, D = q.shape
    if (k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[2] != Hkv
            or k_cache.shape[3] != D or v_cache.shape != k_cache.shape):
        raise ValueError(f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len,
                                    softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError("decode attention takes float32 or bfloat16 q and "
                        "caches of q's dtype")
    if D not in HEAD_DIMS:
        raise ValueError(f"head size {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("q and the caches must be contiguous")
    S = k_cache.shape[1]
    if block_s < 1:
        raise ValueError("block_s must be >= 1")
    kv_len = torch.as_tensor(kv_len, device=q.device)
    if kv_len.numel() != 1:
        raise ValueError("kv_len must be a scalar")
    kv_len = kv_len.to(torch.int32).reshape(1).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    n_split, chunk = _plan(S, B, Hkv, min(block_s, S), q.device)
    out = torch.empty_like(q)
    m_part = torch.empty((B * Hkv, n_split, G), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B * Hkv, n_split, G, D), dtype=torch.float32,
                           device=q.device)
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    lib = compat.load("decode_attention", decode_attention=[
        i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, p])
    err = lib.decode_attention(
        _DTYPES[q.dtype], D, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        B, S, Hkv, G, n_split, chunk, scale, float(softcap),
        compat.stream_ptr(q.device))
    compat.check_launch(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def gqa_decode(q, k_cache, v_cache, kv_len, *, softcap: float = 0.0,
               block_s: int = 512):
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D) -> (B, 1, Hq, D)."""
    B, one, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    if one != 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} is not one token of a multiple "
                         f"of {Hkv} heads")
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    out = decode_attention(qg, k_cache, v_cache, kv_len, softcap=softcap,
                           block_s=block_s, scale=1.0 / (D ** 0.5))
    return out.reshape(B, 1, Hq, D)


def gqa_decode_ref(q, k_cache, v_cache, kv_len, *, softcap: float = 0.0):
    """Plain version of :func:`gqa_decode`, on any device."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    out = decode_attention_ref(q.reshape(B, Hkv, Hq // Hkv, D), k_cache,
                               v_cache, kv_len, softcap=softcap)
    return out.reshape(B, 1, Hq, D)


def gqa_decode_traffic(q, k_cache, v_cache, kv_len: int) -> dict:
    """Bytes and flops of one ``gqa_decode`` call: q read and the output
    written once, K and V read for the ``min(kv_len, S)`` live positions
    (the kernel never reads a row past them), all contiguous rows of the
    native layout (``stream``); 4 flops per (head, position, channel)."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    live = max(0, min(int(kv_len), S))
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * B * live * Hkv * D * k_cache.element_size() + 4)
    return {"flops": float(4 * B * Hq * live * D),
            "total_bytes": float(nbytes),
            "bytes_by_class": {"stream": float(nbytes)}}
