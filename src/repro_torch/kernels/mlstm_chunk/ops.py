"""Chunkwise-parallel mLSTM (K7): wrappers, plain version, traffic.

Port of ``repro.kernels.mlstm_chunk`` (``ops``, ``kernel``, ``ref``).
``chunked_mlstm`` keeps the reference's model layout — q, k, v
``(B, S, H, dh)``, log gates li, lf ``(B, S, H)`` — and ``mlstm_chunk`` the
kernel's ``(B, H, S, dh)``; both take views, so no layout is copied.  On
CUDA tensors ``mlstm_chunk`` launches ``csrc/mlstm_chunk.cu`` (or raises);
on CPU tensors it runs the plain PyTorch version :func:`mlstm_chunk_ref`,
which repeats the kernel's chunkwise arithmetic in float32.

Which kernels a CUDA call takes is decided by shape (:func:`kernel_path`):
bfloat16 with dh and the chunk multiples of 64 runs on the tensor cores in
three launches (states, scores, outputs), which :func:`mlstm_chunk_staged_ref`
repeats in plain PyTorch; every other call keeps the fp32 CUDA-core kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Largest chunk and head size the CUDA kernels take (shared-memory bound).
MAX_CHUNK = 256
MAX_HEAD = 1024
_PATHS = {"simt": 0, "wgmma": 1}


def kernel_path(dtype: torch.dtype, dh: int, c: int) -> str:
    """Which kernels of ``csrc/mlstm_chunk.cu`` a CUDA call takes for head
    size ``dh`` and chunk ``c``: ``"wgmma"`` (bfloat16, dh and c multiples
    of 64: the tensor cores) or ``"simt"`` (the fp32 CUDA cores)."""
    return "wgmma" if dtype == torch.bfloat16 and dh % 64 == 0 \
        and c % 64 == 0 else "simt"


def scratch_shapes(path: str, B: int, H: int, S: int, dh: int,
                   c: int) -> dict:
    """name -> (shape, dtype) of the scratch a call on ``path`` allocates.
    ``"simt"``: the scores s in float32.  ``"wgmma"``: s in bfloat16 (the
    s v operand), each row's denominator, and the state (C in bfloat16, n
    in float32) entering every chunk after the first (one slot when there
    is a single chunk)."""
    n_chunks = S // c
    if path == "simt":
        return {"s_buf": ((B * H, n_chunks, c, c), torch.float32)}
    n_states = max(n_chunks - 1, 1)
    return {"s_buf": ((B * H, n_chunks, c, c), torch.bfloat16),
            "den": ((B * H, S), torch.float32),
            "states": ((B * H, n_states, dh, dh), torch.bfloat16),
            "n_buf": ((B * H, n_states, dh), torch.float32)}


def chunk_size(S: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, S)``, halved until it divides S."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def mlstm_chunk_ref(q, k, v, li, lf, *, chunk: int = 256):
    """q, k, v: (B, H, S, dh); li, lf: (B, H, S) -> (B, H, S, dh).

    The chunkwise recurrence of ``_mlstm_kernel`` in float32: per chunk the
    inter-chunk term from the state (C, n), the decay-masked intra-chunk
    attention, then the state update."""
    B, H, S, dh = q.shape
    c = chunk_size(S, chunk)
    qf, kf, vf = q.float(), k.float(), v.float()
    lif, lff = li.float(), lf.float()
    # C is (key dh, value dh): under a mesh v may hold a slice of the
    # value dim (``models.xlstm``'s local region), the rest is unchanged
    C = q.new_zeros((B, H, dh, v.shape[-1]), dtype=torch.float32)
    n = q.new_zeros((B, H, dh), dtype=torch.float32)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    outs = []   # one tensor a chunk, no slice writes: autograd records it
    for j in range(S // c):
        rows = slice(j * c, (j + 1) * c)
        qc, kc, vc = qf[:, :, rows], kf[:, :, rows], vf[:, :, rows]
        lic = lif[:, :, rows]
        cum = torch.cumsum(lff[:, :, rows], dim=-1)
        total = cum[..., -1:]
        qd = qc * torch.exp(cum)[..., None]
        inter = qd @ C
        n_inter = (qd @ n[..., None])[..., 0]
        w_log = cum[..., :, None] - cum[..., None, :] + lic[..., None, :]
        w = torch.where(causal, torch.exp(w_log), torch.zeros_like(w_log))
        s = (qc @ kc.transpose(-1, -2)) * w
        intra = s @ vc
        n_intra = w @ kc
        den = n_inter + torch.einsum("bhcd,bhcd->bhc", qc, n_intra)
        outs.append((inter + intra)
                    / torch.clamp(den.abs(), min=1.0)[..., None])
        kw = kc * torch.exp(total - cum + lic)[..., None]
        C = C * torch.exp(total)[..., None] + kw.transpose(-1, -2) @ vc
        n = n * torch.exp(total) + kw.sum(-2)
    return torch.cat(outs, 2).to(q.dtype)


def _staged(q, k, v, li, lf, c: int, rounded: bool):
    """(numerator, denominator) of every row, float32, split as the
    tensor-core kernels split the work: per chunk j the entering state
    (C_j, n_j); the scores s = (q kᵀ) ∘ w and the denominator
    e^cum (q · n_j) + rowsum(s); the numerator e^cum (q C_j) + s v; then
    C_{j+1} = e^total C_j + (k e^(total - cum + li))ᵀ v and n likewise.
    With ``rounded`` the three operands the kernels hand to the tensor
    cores in bfloat16 are rounded to it: C_j in the output product, s in
    s v, and k e^(total - cum + li) in the state update (n sums it
    unrounded, as the kernels do)."""
    B, H, S, dh = q.shape
    rnd = (lambda x: x.to(torch.bfloat16).float()) if rounded else (lambda x: x)
    qf, kf, vf = q.float(), k.float(), v.float()
    lif, lff = li.float(), lf.float()
    C = q.new_zeros((B, H, dh, dh), dtype=torch.float32)
    n = q.new_zeros((B, H, dh), dtype=torch.float32)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    num = torch.empty((B, H, S, dh), dtype=torch.float32, device=q.device)
    den = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for j in range(S // c):
        rows = slice(j * c, (j + 1) * c)
        qc, kc, vc = qf[:, :, rows], kf[:, :, rows], vf[:, :, rows]
        lic = lif[:, :, rows]
        cum = torch.cumsum(lff[:, :, rows], dim=-1)
        total = cum[..., -1:]
        ecum = torch.exp(cum)
        w_log = cum[..., :, None] - cum[..., None, :] + lic[..., None, :]
        w = torch.where(causal, torch.exp(w_log), torch.zeros_like(w_log))
        s = (qc @ kc.transpose(-1, -2)) * w
        den[:, :, rows] = ecum * (qc @ n[..., None])[..., 0] + s.sum(-1)
        num[:, :, rows] = ecum[..., None] * (qc @ rnd(C)) + rnd(s) @ vc
        kw = kc * torch.exp(total - cum + lic)[..., None]
        C = C * torch.exp(total)[..., None] + rnd(kw).transpose(-1, -2) @ vc
        n = n * torch.exp(total) + kw.sum(-2)
    return num, den


def mlstm_chunk_staged_ref(q, k, v, li, lf, *, chunk: int = 256,
                           rounded: bool = False):
    """q, k, v: (B, H, S, dh); li, lf: (B, H, S) -> (B, H, S, dh) in q's
    dtype: the function of :func:`mlstm_chunk_ref`, computed in the three
    stages of the tensor-core kernels (states, scores, outputs) and, with
    ``rounded``, with their bfloat16 operands (see :func:`_staged`)."""
    num, den = _staged(q, k, v, li, lf, chunk_size(q.shape[2], chunk), rounded)
    return (num / torch.clamp(den.abs(), min=1.0)[..., None]).to(q.dtype)


def mlstm_chunk_spread(q, k, v, li, lf, *, chunk: int = 256):
    """Per-element scale of the tensor-core kernels' rounding, (B, H, S, dh)
    float32: the numerator of the float32 arithmetic run on |q|, |k|, |v|
    with the same gates, over the true max(|den|, 1).  Each of the
    bfloat16 operands (C_j, s, k e^(total - cum + li)) moves a term of the
    numerator by at most 2^-9 of its magnitude, and a term meets at most
    two of them (C_j built from rounded k e^..., or s alone), so the
    kernels sit within 2^-8 of this spread of the float32 result."""
    c = chunk_size(q.shape[2], chunk)
    num_abs, _ = _staged(q.abs(), k.abs(), v.abs(), li, lf, c, False)
    _, den = _staged(q, k, v, li, lf, c, False)
    return num_abs / torch.clamp(den.abs(), min=1.0)[..., None]


def mlstm_chunk(q, k, v, li, lf, *, chunk: int = 256):
    """q, k, v: (B, H, S, dh) float32 or bfloat16 views of one layout with
    contiguous rows; li, lf: (B, H, S) float32 views of one layout ->
    (B, H, S, dh) in q's dtype and layout.  The chunk is the reference's
    (``min(chunk, S)`` halved until it divides S)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be one (B, H, S, dh) shape")
    B, H, S, dh = q.shape
    if li.shape != (B, H, S) or lf.shape != (B, H, S):
        raise ValueError(f"gates {tuple(li.shape)}/{tuple(lf.shape)} must be "
                         f"{(B, H, S)}")
    if len({t.device for t in (q, k, v, li, lf)}) != 1:
        raise ValueError("q, k, v and the gates must be on one device")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    compat.check_real("mlstm_chunk", q, k, v, li, lf)
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, li, lf, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the mLSTM kernel takes float32 or bfloat16 q, k, v "
                        "of one dtype")
    if li.dtype != torch.float32 or lf.dtype != torch.float32:
        raise TypeError("the log gates li and lf must be float32")
    c = chunk_size(S, chunk)
    if c > MAX_CHUNK or dh > MAX_HEAD:
        raise ValueError(f"chunk {c} or head size {dh} beyond the kernel's "
                         f"{MAX_CHUNK} / {MAX_HEAD}")
    out = torch.empty_like(q)
    if not (q.stride() == k.stride() == v.stride() == out.stride()
            and q.stride(3) == 1 and li.stride() == lf.stride()):
        raise ValueError("q, k and v must be dense views of one layout with "
                         "contiguous rows, and li and lf views of one layout")
    if out.numel() == 0:
        return out
    path = kernel_path(q.dtype, dh, c)
    if path == "wgmma" and (
            any(st % 8 for st in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k, v, out))):
        raise ValueError("the tensor-core kernels need 16-byte aligned rows")
    bufs = {name: torch.empty(shape, dtype=dt, device=q.device)
            for name, (shape, dt) in scratch_shapes(path, B, H, S, dh,
                                                    c).items()}
    ptr = {name: t.data_ptr() for name, t in bufs.items()}
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib = compat.load("mlstm_chunk", mlstm_chunk=[
        i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
        ll, ll, ll, ll, ll, ll, p])
    err = lib.mlstm_chunk(
        _PATHS[path], _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), li.data_ptr(), lf.data_ptr(), out.data_ptr(),
        ptr["s_buf"], ptr.get("den"), ptr.get("states"), ptr.get("n_buf"),
        B, H, dh, c, S // c, q.stride(0), q.stride(1), q.stride(2),
        li.stride(0), li.stride(1), li.stride(2), compat.stream_ptr(q.device))
    compat.check_launch(err, "mlstm_chunk")
    mlstm_chunk.launches += 1
    return out


mlstm_chunk.launches = 0


def _heads_first(q, k, v, li, lf):
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            li.transpose(1, 2), lf.transpose(1, 2))


def chunked_mlstm(q, k, v, li, lf, *, chunk: int = 256):
    """q, k, v: (B, S, H, dh); li, lf: (B, S, H) -> (B, S, H, dh)."""
    if q.dim() != 4 or li.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} must be (B, S, H, dh) and the "
                         f"gates {tuple(li.shape)} (B, S, H)")
    return mlstm_chunk(*_heads_first(q, k, v, li, lf),
                       chunk=chunk).transpose(1, 2)


def chunked_mlstm_ref(q, k, v, li, lf, *, chunk: int = 256):
    """Plain version of :func:`chunked_mlstm`, on any device."""
    return mlstm_chunk_ref(*_heads_first(q, k, v, li, lf),
                           chunk=chunk).transpose(1, 2)


def chunked_mlstm_spread(q, k, v, li, lf, *, chunk: int = 256):
    """:func:`mlstm_chunk_spread` in the model layout: (B, S, H, dh)."""
    return mlstm_chunk_spread(*_heads_first(q, k, v, li, lf),
                              chunk=chunk).transpose(1, 2)


def mlstm_chunk_traffic(q, k, v, li, lf, *, chunk: int = 256) -> dict:
    """Bytes and flops of one ``chunked_mlstm`` call on (B, S, H, dh)
    inputs: q, k, v, li, lf read once and h written once, contiguous rows
    (``stream``); per row 4·dh² flops for the inter-chunk product and the
    state update, and per chunk 2·dh·c(c+1) for the intra-chunk scores and
    their product with v over the c(c+1)/2 (query, key) pairs the causal
    mask leaves live."""
    B, S, H, dh = q.shape
    c = chunk_size(S, chunk)
    nbytes = (4 * q.numel() * q.element_size()
              + li.numel() * li.element_size() + lf.numel() * lf.element_size())
    return {"flops": float(B * H * S * (4 * dh * dh + 2 * (c + 1) * dh)),
            "total_bytes": float(nbytes),
            "bytes_by_class": {"stream": float(nbytes)}}
