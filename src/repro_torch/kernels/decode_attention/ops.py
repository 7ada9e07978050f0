"""One-token GQA decode attention (K4): wrappers, plain version, traffic.

Port of ``repro.kernels.decode_attention`` (``ops``, ``kernel``, ``ref``).
``gqa_decode`` keeps the reference's model layout — q ``(B, 1, Hq, D)``
over ``(B, S, Hkv, D)`` caches, ``kv_len`` a scalar that may live on the
device — and ``decode_attention`` the kernel's grouped layout
``(B, Hkv, G, D)``.  On CUDA tensors ``decode_attention`` launches the
split-S kernel of ``csrc/decode_attention.cu`` (or raises); on CPU tensors
it runs the plain PyTorch version :func:`decode_attention_ref`.

``block_s`` is the reference's TPU tile size.  The port accepts it so that
callers keep the reference's signature, and otherwise ignores it: the card
deals the cache to CTAs in stages of ``STAGE_ROWS`` rows (:func:`_plan`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import compat

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head sizes the kernels take, each natively: the cache is never padded
#: (80: stablelm-3b; 256: recurrentgemma-9b's local attention).
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: Head sizes the bfloat16 bulk-copy kernel takes; every other (dtype, D)
#: runs on the CUDA cores.
BULK_HEAD_DIMS = (64, 128, 256)
_PATHS = {"simt": 0, "bulk": 1}
#: Cache rows per stage: the unit in which the kernels deal S to splits.
STAGE_ROWS = 16
#: Stages of the bulk kernel's ring by head size (``BulkCfg::STAGES``), and
#: the most shared memory they may take; kv heads per CTA
#: (``heads_per_cta``) are cut to fit.
BULK_STAGES = {64: 4, 128: 4, 256: 8}
BULK_SMEM = 200 * 1024
#: The bulk kernel's shape by head size (``BulkCfg`` in the source): bytes
#: of padding after each cache row in shared memory, and the most kv heads
#: a CTA takes.  At D 256 four warps share one head (64 output channels
#: each) over 528-byte rows, one head and 8 stages (135 KB) a CTA, one CTA
#: an SM.
BULK_ROW_PAD = {64: 0, 128: 0, 256: 16}
BULK_MAX_HEADS = {64: 8, 128: 8, 256: 1}
#: Query heads a bulk CTA takes (the tensor cores' M = 16).
MMA_HEADS = 16
#: Shared memory of one H100 SM (228 KiB), and what the card reserves of
#: it for each resident CTA.
SM_SMEM = 228 * 1024
CTA_RESERVED_SMEM = 1024
#: CTAs the CUDA-core kernel keeps resident on an SM, for whole waves.
SIMT_CTAS_PER_SM = 8
#: Fewest stages a split takes where the cache has enough of them: a
#: split writes fp32 partials of about one stage's bytes (G x D floats
#: against 2 x 16 rows x D bf16 at G = 16), so short splits move more
#: partials than cache.  Chosen by timing ``tools/decode_split_floor.py``
#: on the H100 (PERF.md): recurrentgemma-9b's 2,048-row ring was fastest
#: at 16 on the CUDA-core kernel (0.044 and 0.336 ms at B 8 and B 128,
#: against 0.050 and 0.450 with whole waves alone).  Re-timed on the D 256
#: bulk kernel, the B 128 ring takes one split whatever the floor (the
#: fullest last wave, :func:`_plan`) and B 8, host-bound, moves within the
#: run's spread from floor 4 to 32, so 16 stays; qwen2-7b's decode keeps
#: its 33 splits.
MIN_SPLIT_STAGES = 16


def kernel_path(dtype: torch.dtype, D: int) -> str:
    """Which kernel of ``csrc/decode_attention.cu`` a CUDA call takes:
    ``"bulk"`` (bfloat16, D in ``BULK_HEAD_DIMS``) or ``"simt"``."""
    return "bulk" if dtype == torch.bfloat16 and D in BULK_HEAD_DIMS \
        else "simt"


def heads_per_cta(Hkv: int, D: int) -> int:
    """KV heads one bulk CTA covers: the largest divisor of Hkv (at most
    ``BULK_MAX_HEADS[D]``) whose K and V stages fit ``BULK_SMEM``."""
    fits = [hc for hc in range(1, min(Hkv, BULK_MAX_HEADS[D]) + 1)
            if Hkv % hc == 0 and bulk_smem(hc, D) <= BULK_SMEM]
    return max(fits)


def bulk_smem(hc: int, D: int) -> int:
    """Dynamic shared memory of a bulk CTA over ``hc`` kv heads: the ring
    of K and V stages (rows padded by ``BULK_ROW_PAD``) and its full and
    empty barriers."""
    stage = STAGE_ROWS * (hc * D * 2 + BULK_ROW_PAD[D])
    return BULK_STAGES[D] * (2 * stage + 2 * 8)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = dict(
    decode_attention=[_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _F, _F, _P],
    decode_bulk_residency=[_I, _I, ctypes.POINTER(ctypes.c_int)])


def _library():
    return compat.load("decode_attention", **_SIGNATURES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cta_shape(path: str, Hkv: int, D: int) -> tuple[int, int]:
    """(kv heads a CTA, CTAs an SM) of a path's grid."""
    if path == "bulk":
        return heads_per_cta(Hkv, D), bulk_ctas_per_sm(Hkv, D)
    return 1, SIMT_CTAS_PER_SM


def card_bulk_residency(Hkv: int, D: int) -> int:
    """Bulk CTAs one SM of the current CUDA card holds at
    ``heads_per_cta(Hkv, D)`` kv heads a CTA, by the CUDA occupancy
    calculator: what :func:`bulk_ctas_per_sm` predicts (the card only)."""
    ctas = ctypes.c_int(0)
    compat.check_launch(_library().decode_bulk_residency(
        D, heads_per_cta(Hkv, D), ctypes.byref(ctas)), "decode_bulk_residency")
    return ctas.value


def bulk_ctas_per_sm(Hkv: int, D: int) -> int:
    """Bulk CTAs an SM holds, as its shared memory allows: 1 at D 256 (135
    KB) and at qwen2-7b's D 128 over 4 kv heads (128 KB)."""
    need = bulk_smem(heads_per_cta(Hkv, D), D) + CTA_RESERVED_SMEM
    return max(1, SM_SMEM // need)


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



def _plan(S: int, ctas: int, sms: int, per_sm: int = 1,
          fullest: bool = False) -> tuple[int, int]:
    """(n_split, n_stages): S in ``n_stages`` stages of ``STAGE_ROWS`` rows,
    dealt to ``n_split`` splits of whole stages (:func:`split_rows`).  With
    ``ctas`` CTAs per split, ``n_split`` is the least count that fills whole
    waves of ``sms * per_sm`` CTAs, or, where S is too short for that many
    splits of ``MIN_SPLIT_STAGES`` stages each, as many such splits as S
    holds (at least one).  With ``fullest`` (the bulk kernel, whose CTAs
    stream at the card's rate) it is then the count of at most that many
    whose last wave is the fullest, the fewest of those: a split writes
    partials that the merge reads again, so one that fills no wave costs
    bytes and buys no SM.  The CUDA-core kernel is bound by its CTAs'
    arithmetic and takes every split it may."""
    n_stages = -(-S // STAGE_ROWS)
    slots = sms * per_sm
    whole = slots // math.gcd(slots, ctas)
    cap = max(1, n_stages // MIN_SPLIT_STAGES)
    if whole <= cap or not fullest:
        return min(whole, cap), n_stages
    fill = [(ctas * n / (slots * -(-ctas * n // slots)), -n)
            for n in range(1, cap + 1)]
    return -max(fill)[1], n_stages


def split_rows(n_split: int, n_stages: int, S: int) -> list[tuple[int, int]]:
    """The cache rows [lo, hi) of each split, as the kernels compute them:
    split s takes stages [s * n_stages // n_split, (s + 1) * n_stages //
    n_split); the last split stops at S."""
    return [(s * n_stages // n_split * STAGE_ROWS,
             min((s + 1) * n_stages // n_split * STAGE_ROWS, S))
            for s in range(n_split)]


def decode_attention(q, k_cache, v_cache, kv_len, *, softcap: float = 0.0,
                     block_s: int = 512, scale: float | None = None):
    """q: (B, Hkv, G, D) grouped heads; caches (B, S, Hkv, D); ``kv_len`` an
    int or a one-element int tensor (never read on the host) -> (B,Hkv,G,D).
    The cache rows are dealt to CTAs in whole stages of ``STAGE_ROWS``
    (``block_s`` is accepted and ignored, see the module note)."""
    B, Hkv, G, D = q.shape
    if (k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[2] != Hkv
            or k_cache.shape[3] != D or v_cache.shape != k_cache.shape):
        raise ValueError(f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")
    compat.check_real("decode_attention", q, k_cache, v_cache)
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
    path = kernel_path(q.dtype, D)
    if path == "bulk" and any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("the bulk-copy kernel needs 16-byte aligned caches")
    S = k_cache.shape[1]
    if block_s < 1:
        raise ValueError("block_s must be >= 1")
    if not (isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32
            and kv_len.device == q.device):
        kv_len = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    if kv_len.numel() != 1:
        raise ValueError("kv_len must be a scalar")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    hc, per_sm = _cta_shape(path, Hkv, D)
    ctas = B * (Hkv // hc) * -(-G // (MMA_HEADS if path == "bulk" else 8))
    n_split, n_stages = _plan(S, ctas, _sm_count(q.device.index), per_sm,
                              fullest=path == "bulk")
    out = torch.empty_like(q)
    # One scratch for the splits' partials: acc (B * Hkv, n_split, G, D),
    # then m and l (B * Hkv, n_split, G) each, all fp32.
    # The tensor stays referenced until the launch is queued.
    n = B * Hkv * n_split * G
    scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    acc = scratch.data_ptr()
    err = _library().decode_attention(
        _PATHS[path], _DTYPES[q.dtype], D, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        acc + 4 * n * D, acc + 4 * n * (D + 1), acc,
        B, S, Hkv, G, hc, n_split, n_stages, scale, float(softcap),
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
