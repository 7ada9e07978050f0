"""GQA attention block: projections, RoPE, the KV cache, and the kernels.

Port of ``repro.models.attention``.  Prefill runs flash attention (K5,
``kernels.flash_attention.ops.mha``) and every decode step decode attention
(K4, ``kernels.decode_attention.ops.gqa_decode``) when ``cfg.use_kernels``;
otherwise the reference's XLA-path attention (``blocked_attention``,
``dense_attention``).

Under a mesh (``models.pspec``) the activations are DTensors and carry
the reference's tags: q on ``heads``, k and v on ``kv_heads`` (repeated
to the query heads by :func:`_maybe_repeat_kv` where the kv heads do not
split over the tensor-parallel axis), the output on ``heads``, the
decode cache on ``kv_seq``/``kv_heads``.  The attention core runs on
each rank's shards (``pspec.local_call``): attention is independent per
(batch row, head), so a rank attends its rows and heads, where DTensor
would run the blocked schedule op by op and cannot split the (Hkv, G)
grouping of an unevenly split head dim.  Where q's and the kv heads'
splits differ the core takes them whole on that axis (each rank there
attends every head: the site that replicates).  Where the plan leaves
the q, k and v weights whole over ``model`` (the kv heads do not divide
it) each rank computes its own columns of their products
(``_project``), as the reference's partitioner splits them, and the
heads are gathered from them.  Decode over a
sequence-split cache is flash-decoding: each rank attends its rows and
the softmax states merge across the axis (``_partial_decode``).  The cache row
is written into each rank's shard (``_write_row``: DTensor has no rule
for ``index_copy_``).  The kernels run on one card only: with a mesh of
more than one rank ``use_kernels`` raises.

K and V stay two products (no fused QKV whose slices would be views with
other strides): flash attention takes k and v of one stride layout, and
decode attention a contiguous q.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import gqa_decode
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models import layers as L
from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import rule_axis_size, shard


def _maybe_repeat_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """Expand grouped KV to the query heads when the KV-head count cannot
    shard over the tensor-parallel axis (and the query heads can): the
    repeated tensor is head-sharded, so each rank's KV bytes stay those
    of its heads.  A no-op without a mesh."""
    model = rule_axis_size("heads")
    if model > 1 and cfg.n_kv_heads % model != 0 and cfg.n_heads % model == 0:
        g = cfg.n_heads // cfg.n_kv_heads
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
        k = shard(k, "batch", "seq", "heads", None)
        v = shard(v, "batch", "seq", "heads", None)
    return k, v


def _no_kernels_on_mesh(cfg: ModelConfig, x: torch.Tensor) -> None:
    if cfg.use_kernels and pspec.is_dtensor(x) and x.device_mesh.size() > 1:
        raise ValueError(
            "the kernels run on one card: a mesh runs the plain path "
            "(build the config with use_kernels=False)")


def _core_placements(q, k) -> tuple:
    """The placements the attention core takes q, k and v in: each mesh
    dim keeps the batch split where q and k share it, and the head split
    where both split their heads evenly over it; else whole."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    pq = pspec.even_placements(q, q.placements)
    pk = pspec.even_placements(k, k.placements)
    for a, b in zip(pq, pk):
        same = isinstance(a, Shard) and a == b and a.dim in (0, 2)
        out.append(a if same else Replicate())
    return tuple(out)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d = cfg.d_model
        self.wq = L.Dense(L.dense_init(gen, d, cfg.q_dim, **init), cfg.qkv_bias)
        self.wk = L.Dense(L.dense_init(gen, d, cfg.kv_dim, **init), cfg.qkv_bias)
        self.wv = L.Dense(L.dense_init(gen, d, cfg.kv_dim, **init), cfg.qkv_bias)
        self.wo = L.Dense(L.dense_init(gen, cfg.q_dim, d, **init), cfg.o_bias)
        if cfg.use_qk_norm:
            self.q_norm = L.Norm(cfg.head_dim, "rmsnorm", device=device)
            self.k_norm = L.Norm(cfg.head_dim, "rmsnorm", device=device)


def _project(p: L.Dense, x: torch.Tensor) -> torch.Tensor:
    """``L.dense(p, x)``; on a mesh, where the weight is whole over a mesh
    dim of the ``heads`` rule on which x is whole too (the plan leaves
    the q, k and v weights whole over ``model`` where the kv heads do not
    divide it), its columns are split over that dim first, a local slice:
    each rank computes its own columns of the product, as the reference's
    partitioner splits it, where it would compute them all."""
    w = p.w
    if not pspec.is_dtensor(w):
        return L.dense(p, x)
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    names = tuple(mesh.mesh_dim_names)
    axes = pspec.axes_of(pspec.logical_to_spec(("heads",))[0])
    split, ranks = [], 1
    for a in axes:
        i = names.index(a)
        if w.placements[i] == Replicate() and (
                not pspec.is_dtensor(x) or x.placements[i] == Replicate()):
            split.append(i)
            ranks *= mesh.size(i)
    if not split or w.shape[1] % ranks:
        return L.dense(p, x)

    def cut(t, dim):
        return t.redistribute(mesh, tuple(
            Shard(dim) if i in split else pl
            for i, pl in enumerate(t.placements)))
    y = x @ cut(w, 1).to(x.dtype)
    if p.b is not None:
        y = y + cut(p.b, 0).to(x.dtype)
    return y


def _heads(y: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(B, S, n*d) -> (B, S, n, d) of a DTensor.  One split on its last
    dim into chunks that are not whole heads (28 heads over 16 ranks: 224
    of 3,584 columns) is taken whole on it first: DTensor cannot cut such
    chunks into heads; the ``heads`` tag then splits the heads again."""
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(y.ndim - 1)
    ranks = 1
    for i, p in enumerate(y.placements):
        if p == last:
            ranks *= y.device_mesh.size(i)
    if n % ranks:
        y = y.redistribute(y.device_mesh, tuple(
            Replicate() if p == last else p for p in y.placements))
    # each rank cuts its own columns (DTensor's view rules would meet the
    # gradient's split in the backward)
    y = pspec.settled(y)
    return pspec.local_call(lambda t: t.unflatten(-1, (-1, d)), (y,),
                            tuple(y.placements))


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H*D): on a DTensor, each rank merges its own
    heads (an uneven head split taken whole first)."""
    if not pspec.is_dtensor(out):
        return out.reshape(*out.shape[:2], -1)
    out = pspec.even(pspec.settled(out))
    return pspec.local_call(lambda t: t.flatten(2), (out,),
                            tuple(out.placements))


def rotary(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE tables at ``positions`` (``layers.rope_tables``), computed once
    a step and shared by every layer."""
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, rot):
    """Projections and RoPE (``rot`` from :func:`rotary` at the tokens'
    positions, where the reference takes the positions).  The tags and
    the head split of a DTensor are taken only under a mesh: one card's
    decode step is host-bound, and runs no helper it does not need."""
    on_mesh = pspec.is_dtensor(x) or pspec.is_dtensor(p.wq.w)
    if on_mesh:
        q, k, v = _project(p.wq, x), _project(p.wk, x), _project(p.wv, x)
        q = _heads(q, cfg.n_heads, cfg.head_dim)
        k = _heads(k, cfg.n_kv_heads, cfg.head_dim)
        v = _heads(v, cfg.n_kv_heads, cfg.head_dim)
    else:
        q, k, v = L.dense(p.wq, x), L.dense(p.wk, x), L.dense(p.wv, x)
        B, S, _ = x.shape
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = L.apply_norm(p.q_norm, q, "rmsnorm")
        k = L.apply_norm(p.k_norm, k, "rmsnorm")
    if cfg.is_decoder or cfg.frontend != "audio":
        q = L.apply_rope(q, rot)
        k = L.apply_rope(k, rot)
    if on_mesh:
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "kv_heads", None)
        v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def forward(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
            local: bool = False, rot=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill); ``rot`` defaults to
    the tables of positions 0..S-1."""
    S = x.shape[1]
    if rot is None:
        rot = rotary(cfg, torch.arange(S, device=x.device)[None, :])
    _no_kernels_on_mesh(cfg, x)
    q, k, v = _qkv(p, cfg, x, rot)
    k, v = _maybe_repeat_kv(cfg, k, v)
    window = cfg.local_window if local else None
    if cfg.use_kernels:
        out = mha(q, k, v, causal=cfg.is_decoder, window=window,
                  softcap=cfg.logit_softcap, block_q=cfg.attn_block_q,
                  block_kv=cfg.attn_block_kv)
    else:
        def core(q, k, v):
            return L.blocked_attention(q, k, v, causal=cfg.is_decoder,
                                       window=window,
                                       block_q=cfg.attn_block_q,
                                       block_kv=cfg.attn_block_kv,
                                       softcap=cfg.logit_softcap)
        out = pspec.local_call(core, (q, k, v), _core_placements(q, k)
                               if pspec.is_dtensor(q) else ())
    out = shard(out, "batch", "seq", "heads", None)
    return L.dense(p.wo, _merge_heads(out))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               local: bool = False, device=None) -> dict:
    """KV cache for one attention layer.  Local layers keep a ring buffer of
    ``local_window`` positions; full layers keep ``max_len``."""
    length = min(cfg.local_window, max_len) if local else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_step(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                index: torch.Tensor, *, local: bool = False, rot=None
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode at position ``index`` (a one-element int64 tensor on
    x's device; ``rot`` defaults to its RoPE tables): the new K/V row is
    written into ``cache`` in place at its slot, then the token attends
    over the cache's first ``kv_len`` rows.  Nothing is read back to the
    host.

    The cache read is the memory-bound hot loop this framework's analytical
    model is about: every step streams the live (B, S, Hkv, D) cache.
    """
    S = x.shape[1]
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    if rot is None:
        rot = rotary(cfg, index.reshape(1, 1))
    q, k, v = _qkv(p, cfg, x, rot)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    slot = index % length if local else index
    kv_len = torch.clamp(index + 1, max=length) if local else index + 1
    if pspec.is_dtensor(q):
        _no_kernels_on_mesh(cfg, q)
        _write_row(ck, k, slot)
        _write_row(cv, v, slot)
        ck = shard(ck, "batch", "kv_seq", "kv_heads", None)
        cv = shard(cv, "batch", "kv_seq", "kv_heads", None)
        out = _decode_attention_mesh(cfg, q, ck, cv, kv_len)
        out = _merge_heads(shard(out, "batch", None, "heads", None))
    else:
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        # the cache is stored in kv_cache_dtype; the attention reads it
        # in q's
        ck_c, cv_c = ck.to(q.dtype), cv.to(q.dtype)
        if cfg.use_kernels:
            # ring buffer: every slot older than the window has been
            # overwritten, so all valid slots attend
            out = gqa_decode(q, ck_c, cv_c, kv_len, softcap=cfg.logit_softcap)
        else:
            out = L.dense_attention(q, ck_c, cv_c, causal=False,
                                    kv_len=kv_len, softcap=cfg.logit_softcap)
        out = out.reshape(x.shape[0], 1, cfg.q_dim)
    return L.dense(p.wo, out), cache


def _write_row(cache: torch.Tensor, row: torch.Tensor, slot) -> None:
    """``cache[:, slot] = row`` in place on a DTensor cache (``slot`` a
    one-element device tensor), shard by shard: the row is taken in the
    cache's placements (whole where the cache splits its rows) and each
    rank writes it where the slot falls in its rows (DTensor has no rule
    for ``index_copy_``)."""
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    want = tuple(Replicate() if getattr(p, "dim", None) == 1 else p
                 for p in cache.placements)
    local = cache.to_local()
    r = row.redistribute(mesh, want).to_local().to(local.dtype)
    _, offset = pspec.local_extent(cache.shape, mesh, cache.placements)
    n = local.shape[1]
    at = slot - offset[1]
    inside = (at >= 0) & (at < n)
    at = at.clamp(0, max(n - 1, 0))
    if n:
        local.index_copy_(1, at, torch.where(
            inside, r, local.index_select(1, at)))


def _decode_attention_mesh(cfg: ModelConfig, q, ck, cv, kv_len):
    """Decode attention over DTensor caches, on each rank's shards: the
    rank's batch rows and kv heads (q's heads taken to match), and where
    the cache splits its rows (``kv_seq``), its rows only, the softmax
    states then merged across those mesh dims (flash-decoding)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ck.device_mesh
    cp = pspec.even_placements(ck, ck.placements)
    ck, cv = ck.redistribute(mesh, cp), cv.redistribute(mesh, cp)
    # q (B, 1, Hq, D): the cache's batch and head splits, whole elsewhere
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in cp)
    seq_dims = [i for i, p in enumerate(cp) if isinstance(p, Shard)
                and p.dim == 1]
    _, offset = pspec.local_extent(ck.shape, mesh, cp)
    ql = q.redistribute(mesh, qp).to_local()
    out = _partial_decode(ql, ck.to_local().to(ql.dtype),
                          cv.to_local().to(ql.dtype), kv_len - offset[1],
                          cfg.logit_softcap,
                          [mesh.get_group(i) for i in seq_dims])
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _partial_decode(q, k, v, kv_len, softcap: float, groups):
    """``L.dense_attention``'s decode (one query row, the first ``kv_len``
    of k's rows attend) over this rank's rows, merged across ``groups``
    (the ranks holding the other rows): the running max, the softmax sum
    and the P·V accumulator are all-reduced (max, then sums)."""
    if not groups:
        return L.dense_attention(q, k, v, causal=False, kv_len=kv_len,
                                 softcap=softcap)
    import math

    import torch.distributed._functional_collectives as fc
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qq = q.reshape(B, 1, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qq.float(), k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    live = torch.arange(k.shape[1], device=q.device) < kv_len
    s = torch.where(live, s, torch.full_like(s, L.NEG_INF))
    m = s.amax(-1, keepdim=True)
    for g in groups:
        m = fc.all_reduce(m, "max", g)
    p = torch.exp(s - m) * live
    den = p.sum(-1, keepdim=True)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    for g in groups:
        den = fc.all_reduce(den, "sum", g)
        acc = fc.all_reduce(acc, "sum", g)
    out = acc / den
    return out.to(v.dtype).reshape(B, 1, Hq, D)
