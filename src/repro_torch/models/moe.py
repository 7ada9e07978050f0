"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

Port of ``repro.models.moe``, with the reference's two semantics selected
as it selects them (``forward``): ``einsum`` (``cfg.moe_impl``, prefill)
and ``sort`` (every decode step).  They drop different (token, slot)
pairs, and the port drops exactly the reference's:

* ``einsum`` applies the capacity per group of ``sg = min(2048, S)``
  tokens (halved until it divides B·S; groups span batch rows), k-slot
  major: every token's slot 0 is placed before any token's slot 1;
* ``sort`` applies it over all T = B·S tokens, token-major (the stable
  argsort of the flattened (token, slot) list).

Both run as index gathers on static shapes where the reference's einsum
form multiplies one-hot tensors ((4, 2048, 128, 160) a layer at the
card's prefill): the dispatch (E_held, g·C, d) is a gather of token rows,
the experts' products are batched matrix products over it, and the
combine is a weighted gather of expert rows.  The combine rounds as
the reference's does: the einsum form sums the k slots in f32 and rounds
once, the sort form adds slot by slot in the activation dtype; the combine
weight is cast to the activation dtype first, and the einsum form
dispatches only where that cast weight is nonzero (its ``dispatch_mask =
combine != 0``).  Positions are running counts of one-hot comparisons
(``_positions``; no ``bincount``, ``nonzero``, float ``index_add_`` or
host read), so every shape follows from ``cfg``, B and S, nothing waits
for the device, and the result does not depend on the order of any
device reduction of floats.

The expert share.  ``MoE(cfg, gen, experts=(lo, hi))`` holds experts
``lo..hi-1``: what one device computes under expert parallelism, without
the exchange.  The router, the top-k, the capacity and every pair's
position stay over all ``n_experts``; the layer computes the rows of its
own experts, a slot routed elsewhere adds zero, and the aux loss is the
whole layer's.  The default holds every expert and is the reference layer.

Under a mesh the experts' weights are DTensors split as the plan splits
them (expert-parallel over ``experts``, or tensor-parallel inside each
expert over ``expert_ff``) and so are the expert products: the dispatched
rows, the hidden activations and the expert outputs carry the
reference's tags (``experts``, ``expert_cap``, ``expert_ff``).  DTensor
has no sharding rule for the stable sort, the scatter and the index
gathers, so routing and dispatch run on local tensors.  The einsum
semantics' groups split over every rank where they divide evenly
(``_forward_einsum_split``): each rank routes its own groups, as the
reference's partitioner splits them, and an all-to-all hands the rows to
the experts' ranks and back.  The sort semantics (a decode step, whose
one group is every token) route each rank's own batch shard where the
batch splits evenly (``_forward_sort_split``): only the (T, k) expert ids
are gathered, every rank assigns the capacity over all T tokens as one
device does, the dispatch gathers the layer's input whole (the MoE
layer's replication site, as in the reference's program) and each rank
combines its own tokens.  Otherwise the whole layer runs on every rank on
the whole token set (``_whole``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import shard


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # pad to a multiple of 8


class Router(nn.Module):
    """``w`` (d, E): the router, multiplied in f32 whatever the activation
    dtype (not a ``Dense``, so ``convert.to_serving`` leaves it f32)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)


class MoE(nn.Module):
    """``router.w`` (d, E) f32; ``wi``, ``wg`` (E_held, d, f) and ``wo``
    (E_held, f, d) for the held experts ``experts = (lo, hi)`` (default:
    all of them)."""

    serving_cast = ("wi", "wg", "wo")

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None,
                 experts: tuple[int, int] | None = None):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        lo, hi = experts or (0, E)
        if not 0 <= lo < hi <= E:
            raise ValueError(f"{cfg.name}: experts {lo}..{hi - 1} of {E}")
        self.experts = (lo, hi)
        init = dict(generator=gen, dtype=getattr(torch, cfg.param_dtype),
                    device=device)
        held = hi - lo
        self.router = Router(torch.randn((d, E), **init).mul_(0.02))
        lim = 1.0 / math.sqrt(d)
        self.wi = nn.Parameter(torch.randn((held, d, f), **init).mul_(lim),
                               requires_grad=False)
        self.wg = nn.Parameter(torch.randn((held, d, f), **init).mul_(lim),
                               requires_grad=False)
        self.wo = nn.Parameter(torch.randn((held, f, d), **init)
                               .mul_(1.0 / math.sqrt(f)), requires_grad=False)


def forward(p: MoE, cfg: ModelConfig, x: torch.Tensor,
            decode: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), the aux load-balance loss (f32 scalar)).
    ``cfg.moe_impl`` selects the semantics; decode steps take ``sort``
    whatever it says, as in the reference."""
    impl = cfg.moe_impl
    if decode and impl == "einsum":
        impl = "sort"
    run = forward_einsum if impl == "einsum" else forward_sort
    if not pspec.is_dtensor(x):
        return run(p, cfg, x)
    if impl == "einsum" and _group_split(cfg, x):
        return _forward_einsum_split(p, cfg, x)
    if impl == "sort" and _batch_split(x):
        return _forward_sort_split(p, cfg, x)
    mesh = x.device_mesh
    out, aux = run(p, cfg, _whole(x))
    from torch.distributed.tensor import DTensor
    # both back on the mesh (whole on every rank): a plain tensor met by a
    # DTensor would hand autograd a DTensor gradient on the local graph
    return tuple(DTensor.from_local(t, mesh, _replicated(mesh),
                                    run_check=False) for t in (out, aux))


def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on this rank (gathered; its gradient whole
    on every rank); a plain tensor as it is."""
    if not pspec.is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, _replicated(t.device_mesh)) \
        .to_local()


def _router(p: MoE, cfg: ModelConfig, xt: torch.Tensor, w=None):
    """Shared routing over all experts, in f32: (probs, top-k weights
    renormalized, top-k experts, aux).  xt: (..., d); ``w`` the router's
    weight as a local tensor (default: ``p.router.w`` whole).  Ties in the
    top-k go to the lower expert, as ``jax.lax.top_k`` gives them (a
    stable descending sort; ``torch.topk`` promises no order)."""
    k, E = cfg.experts_per_token, cfg.n_experts
    logits = xt.float() @ (_whole(p.router.w) if w is None else w).float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = probs.sort(dim=-1, descending=True, stable=True)
    weights, experts = weights[..., :k], experts[..., :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    lead = tuple(range(experts.ndim - 1))
    # one-hot as a comparison: no check that reads the ids to the host
    first = experts[..., :1] == torch.arange(E, device=experts.device)
    aux = E * torch.sum(first.float().mean(lead) * probs.mean(lead))
    return probs, weights, experts, aux


def _positions(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Each pair's place in its expert's queue: for ``experts`` (g, N) in
    priority order along the last axis, how many earlier pairs of its
    group chose the same expert (a running count of an (g, E, N) one-hot,
    along its contiguous last axis)."""
    oh = experts[:, None, :] == torch.arange(E, device=experts.device)[:, None]
    count = torch.cumsum(oh, dim=-1, dtype=torch.int32)
    return count.gather(1, experts[:, None, :])[:, 0] - 1


def _slots(p: MoE, experts, pos, live, C: int) -> torch.Tensor:
    """Each pair's row in the held experts' buffer of E_held * g * C rows
    (expert-major, then group, then position) where it is dispatched here
    (``live`` and routed to a held expert); past the buffer, a row of its
    own, where it is not."""
    g, n, k = experts.shape
    lo, hi = p.experts
    dev = experts.device
    held = live & (experts >= lo) & (experts < hi)
    rows = (experts - lo) * (g * C) + pos \
        + C * torch.arange(g, device=dev)[:, None, None]
    spare = (hi - lo) * g * C + torch.arange(g * n * k, device=dev)
    return torch.where(held, rows, spare.reshape(g, n, k))


def _dispatch(x: torch.Tensor, slot, rows: int, held: int) -> torch.Tensor:
    """The held experts' buffer (held, rows / held, d) of the dispatched
    token rows: x (N, d) and each pair's ``slot`` (``_slots``, over N * k
    pairs); a row no pair fills is zero."""
    N, d = x.shape
    k = slot.shape[-1]
    # src[r]: the token in buffer row r (N: none, a zero row)
    src = torch.full((rows + slot.numel(),), N, dtype=torch.long,
                     device=x.device)
    src.scatter_(0, slot.reshape(-1),
                 torch.arange(slot.numel(), device=x.device) // k)
    xpad = torch.cat([x, x.new_zeros(1, d)])
    return xpad.index_select(0, src[:rows]).reshape(held, rows // held, d)


def _ffn(p: MoE, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """The experts' FFN on their buffer (a DTensor on a mesh: split as the
    plan splits the experts, ``experts``/``expert_cap``/``expert_ff``)."""
    dt = xe.dtype
    h = torch.bmm(xe, p.wi.to(dt))
    a = torch.bmm(xe, p.wg.to(dt))
    h = shard(L.activate(a, cfg.act) * h, "experts", "expert_cap",
              "expert_ff")
    return shard(torch.bmm(h, p.wo.to(dt)), "experts", "expert_cap", None)


def _expert_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor, slot,
                rows: int) -> torch.Tensor:
    """The held experts' FFN on the dispatched rows: x (N, d) and each
    pair's ``slot`` (``_slots``, over N * k pairs) -> y (rows + 1, d) for
    the ``rows`` of the held experts' buffer, its last row zero (where
    the pairs not dispatched here gather)."""
    d = x.shape[1]
    xe = _dispatch(x, slot, rows, p.experts[1] - p.experts[0])
    mesh = p.wi.device_mesh if pspec.is_dtensor(p.wi) else None
    if mesh is not None:
        # the dispatched rows enter the mesh: every rank holds them whole,
        # so taking the plan's split is a local slice
        from torch.distributed.tensor import DTensor
        xe = DTensor.from_local(xe, mesh, _replicated(mesh), run_check=False)
        xe = shard(xe, "experts", "expert_cap", None)
    y = _whole(_ffn(p, cfg, xe))
    return torch.cat([y.reshape(rows, d), y.new_zeros(1, d)])


def _combine_rows(y: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each pair's expert output: y's row at its slot, the zero row past
    the buffer -> (*slot.shape, d)."""
    rows = y.shape[0] - 1
    return y.index_select(0, slot.clamp(max=rows).reshape(-1)).reshape(
        *slot.shape, y.shape[1])


def groups(cfg: ModelConfig, B: int, S: int, impl: str
           ) -> tuple[int, int, int]:
    """(groups g, tokens a group n, capacity C) of one semantics."""
    T = B * S
    if impl == "einsum":
        sg = min(2048, S) if S > 1 else 1
        while T % sg:
            sg //= 2
        return T // sg, sg, capacity(cfg, sg)
    return 1, T, capacity(cfg, T)


def assign(p: MoE, cfg: ModelConfig, x: torch.Tensor, impl: str):
    """Routing and capacity assignment of one semantics: (xg (g, n, d),
    weights, experts and positions (g, n, k), C, aux).  ``einsum``: k-slot
    major priority within each group; ``sort``: token-major over all
    tokens.  A pair is kept where its position is below C."""
    B, S, d = x.shape
    k, E = cfg.experts_per_token, cfg.n_experts
    g, n, C = groups(cfg, B, S, impl)
    xg = x.reshape(g, n, d)
    _, weights, experts, aux = _router(p, cfg, xg)
    if impl == "einsum":
        pos = _positions(experts.transpose(1, 2).reshape(g, k * n), E)
        pos = pos.reshape(g, k, n).transpose(1, 2)
    else:
        pos = _positions(experts.reshape(g, n * k), E).reshape(g, n, k)
    return xg, weights, experts, pos, C, aux


def forward_einsum(p: MoE, cfg: ModelConfig, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's grouped einsum semantics, as gathers: the k slots
    summed in f32, rounded once."""
    xg, weights, experts, pos, C, aux = assign(p, cfg, x, "einsum")
    keep = pos < C
    w = (weights * keep).to(x.dtype)        # the combine weight
    slot = _slots(p, experts, pos, keep & (w != 0), C)
    rows = (p.experts[1] - p.experts[0]) * xg.shape[0] * C
    y = _expert_ffn(p, cfg, xg.reshape(-1, x.shape[-1]), slot, rows)
    out = (_combine_rows(y, slot).float() * w.float()[..., None]).sum(-2)
    return out.to(x.dtype).reshape(x.shape), aux


def _group_split(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """Whether the einsum semantics' groups of ``x`` (a DTensor whose
    batch is split or whole on each mesh dim) split evenly over every
    rank, each batch shard holding whole groups."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    B, S, _ = x.shape
    g, n, _ = groups(cfg, B, S, "einsum")
    split = 1
    for i, pl in enumerate(x.placements):
        if pl == Shard(0):
            split *= mesh.size(i)
        elif pl != Replicate():
            return False
    return g % mesh.size() == 0 and B % split == 0 \
        and (B // split) * S % n == 0


def _forward_einsum_split(p: MoE, cfg: ModelConfig, x: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward_einsum` on a mesh with the groups split over every
    rank, as the reference's partitioner splits them: each rank routes its
    own groups (the capacity applies within a group, so a group's routing
    needs none of the others), fills its groups' rows of every expert's
    buffer, and an all-to-all over each dim that splits the experts hands
    the rows to the ranks holding their experts (the ``experts`` and
    ``expert_cap`` tags), and back for the combine.  The aux loss is the
    layer's: the per-expert sums of the top choices and of the
    probabilities add up over the ranks (a partial sum) before their
    product.  Returns the output in x's placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    B, S, d = x.shape
    k, E = cfg.experts_per_token, cfg.n_experts
    g, n, C = groups(cfg, B, S, "einsum")
    xp = tuple(x.placements)
    whole = [i for i, pl in enumerate(xp) if pl == Replicate()]
    ranks = 1
    for i in whole:
        ranks *= mesh.size(i)
    coord = mesh.get_coordinate()
    mine = 0                  # this rank's share of its batch shard's groups
    for i in whole:
        mine = mine * mesh.size(i) + coord[i]
    cut = (Shard(0),) * mesh.ndim           # the groups over every rank
    rows_cut = (Shard(1),) * mesh.ndim      # their rows of each expert

    def route(xl, w_router):
        xg = xl.reshape(-1, n, d)
        share = xg.shape[0] // ranks
        xg = xg[mine * share:(mine + 1) * share]
        gl = xg.shape[0]
        probs, weights, experts, _ = _router(p, cfg, xg, w_router)
        pos = _positions(experts.transpose(1, 2).reshape(gl, k * n), E)
        pos = pos.reshape(gl, k, n).transpose(1, 2)
        keep = pos < C
        w = (weights * keep).to(xl.dtype)
        slot = _slots(p, experts, pos, keep & (w != 0), C)
        rows = E * gl * C
        xe = _dispatch(xg.reshape(-1, d), slot, rows, E)
        first = experts[..., :1] == torch.arange(E, device=xl.device)
        # this rank's sums as its row of a (ranks, E) tensor: a partial
        # output would hand its gradient back divided among the ranks
        return (xe, slot, w, first.float().sum((0, 1))[None],
                probs.sum((0, 1))[None])
    xe, slot, w, first, probs = pspec.local_call(
        route, (x, p.router.w), [xp, (Replicate(),) * mesh.ndim],
        [rows_cut, cut, cut, cut, cut])
    y = _ffn(p, cfg, shard(xe, "experts", "expert_cap", None))

    def combine(yl, sl, wl):
        ypad = torch.cat([yl.reshape(-1, d), yl.new_zeros(1, d)])
        out = (_combine_rows(ypad, sl).float() * wl.float()[..., None]
               ).sum(-2)
        return out.to(yl.dtype)
    out = pspec.local_call(combine, (y, slot, w), [rows_cut, cut, cut], cut)
    out = pspec.local_call(lambda t: t.reshape(-1, S, d), (out,), xp)
    aux = E * torch.sum((first.sum(0) / (B * S)) * (probs.sum(0) / (B * S)))
    return out, aux.redistribute(mesh, _replicated(mesh))


def _batch_placements(x: torch.Tensor) -> tuple:
    """x's placements with its batch split (``Shard(0)``) kept and every
    other mesh dim whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)


def _batch_split(x: torch.Tensor) -> bool:
    """Whether x's batch splits evenly over the mesh dims that split it."""
    xp = _batch_placements(x)
    return pspec.even_placements(x, xp) == xp


def _forward_sort_split(p: MoE, cfg: ModelConfig, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward_sort` on a mesh, as the reference's partitioner
    splits it: each rank multiplies the router and takes the top-k for
    its own batch shard's tokens only; the (T, k) expert ids and weights
    are gathered (a few bytes a token, not the layer's input), and every
    rank assigns the capacity over all T tokens, token-major, exactly as
    one device does.  The dispatch gathers the layer's input whole (the
    reference's program gathers its rows too), the experts' FFN runs split
    as the plan splits it (:func:`_expert_ffn`), and each rank combines
    its own tokens.  The aux loss is the layer's: the per-expert sums of
    the top choices and of the probabilities add up over the batch shards
    before their product.  Returns the output in x's batch split."""
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    B, S, d = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.n_experts
    xp = _batch_placements(x)

    def route(xl, w_router):
        probs, weights, experts, _ = _router(p, cfg, xl.reshape(-1, d),
                                             w_router)
        first = experts[:, :1] == torch.arange(E, device=xl.device)
        # this shard's sums as its row of a (shards, E) tensor: a partial
        # output would hand its gradient back divided among the ranks
        return (weights, experts.int(), first.float().sum(0)[None],
                probs.sum(0)[None])
    weights, experts, first, probs = pspec.local_call(
        route, (x, p.router.w), [xp, _replicated(mesh)], xp, n_out=4)
    every = _whole(experts).long()           # (T, k), gathered as int32
    pos = _positions(every.reshape(1, T * k), E).reshape(T, k)
    C = capacity(cfg, T)
    keep = pos < C
    slot = _slots(p, every[None], pos[None], keep[None], C)[0]
    y = _expert_ffn(p, cfg, _whole(x).reshape(T, d), slot,
                    (p.experts[1] - p.experts[0]) * C)
    size, offset = pspec.local_extent(x.shape, mesh, xp)
    mine = slice(offset[0] * S, (offset[0] + size[0]) * S)
    w = (weights.to_local() * keep[mine]).to(x.dtype)
    terms = _combine_rows(y, slot[mine]) * w[..., None]
    out = terms[..., 0, :]
    for j in range(1, k):
        out = out + terms[..., j, :]
    out = DTensor.from_local(out.reshape(size[0], S, d), mesh, xp,
                             run_check=False)
    aux = E * torch.sum((first.sum(0) / T) * (probs.sum(0) / T))
    return out, aux.redistribute(mesh, _replicated(mesh))


def forward_sort(p: MoE, cfg: ModelConfig, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's sort semantics: each slot's term rounded to the
    activation dtype, the terms added one by one in it."""
    xt, weights, experts, pos, C, aux = assign(p, cfg, x, "sort")
    keep = pos < C
    slot = _slots(p, experts, pos, keep, C)
    y = _expert_ffn(p, cfg, xt[0], slot, (p.experts[1] - p.experts[0]) * C)
    terms = _combine_rows(y, slot) * (weights * keep).to(x.dtype)[..., None]
    out = terms[..., 0, :]
    for j in range(1, cfg.experts_per_token):
        out = out + terms[..., j, :]
    return out.reshape(x.shape), aux
