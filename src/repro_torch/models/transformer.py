"""Model driver: the layer stack, prefill and decode.

Port of ``repro.models.transformer`` with its entry points (``init_params``,
``embed_inputs``, ``forward_hidden``, ``logits_fn``, ``loss_fn``,
``init_caches``, ``decode_step``), each taking the parameters and the
config as the reference's do.  The parameters are one ``nn.Module``,
:class:`Transformer`, with one ``layers`` entry per layer in
``cfg.block_kinds`` order where the reference stacks each pattern group on
a leading axis and scans it (``convert.from_reference`` maps one onto the
other).  Decode updates each layer's cache or recurrent state in place.

Every block kind runs: ``attn``/``local`` (attention and the MLP, or the
MoE layer when ``cfg.is_moe``), ``mla`` (latent attention, ``models/mla.py``,
and the MLP in an ``MLAConfig``'s leading dense layers, the MoE layer
after them), ``rglru`` (the RG-LRU block and the MLP),
``mlstm`` and ``slstm`` (with its plain gelu FFN); the audio and vision
archs take stub-frontend features (``embed_inputs``).  An MoE model may
hold a share of each layer's experts (``experts=``, ``models/moe.py``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as REC
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import is_dtensor, shard, vocab_pick
from repro_torch.runtime import tracing


class FFN(nn.Module):
    """The sLSTM block's plain two-layer gelu FFN: ``wi``, ``wo``."""

    def __init__(self, cfg: ModelConfig, d_ff: int, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.wi = L.Dense(L.dense_init(gen, cfg.d_model, d_ff, **init))
        self.wo = L.Dense(L.dense_init(gen, d_ff, cfg.d_model, **init))


def _ffn(p: FFN, x: torch.Tensor) -> torch.Tensor:
    return L.dense(p.wo, L.activate(L.dense(p.wi, x), "gelu"))


class Block(nn.Module):
    """One layer of kind ``kind``, with the reference's parameter names:
    ``attn``/``local``: ``ln1``, ``attn``, ``ln2``, ``mlp`` (``moe`` for an
    MoE config, holding ``experts``); ``mla``: the same with ``attn`` an
    ``MLA``, and ``mlp`` (``d_ff_dense`` wide) where layer ``index`` is one
    of the config's leading dense layers; ``rglru``: ``ln1``, ``rec``,
    ``ln2``, ``mlp``; ``mlstm``: ``ln1``, ``cell``; ``slstm``: ``ln1``,
    ``cell``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, kind: str, gen=None, *, device=None,
                 experts: tuple[int, int] | None = None, index: int = 0):
        super().__init__()
        dev = dict(device=device)
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, **dev)
        if kind in ("attn", "local"):
            self.attn = ATT.Attention(cfg, gen, **dev)
        elif kind == "mla":
            self.attn = MLA.MLA(cfg, gen, **dev)
        elif kind == "rglru":
            self.rec = REC.Recurrent(cfg, gen, **dev)
        elif kind == "mlstm":
            self.cell = XL.MLSTM(cfg, gen, **dev)
            return
        elif kind == "slstm":
            self.cell = XL.SLSTM(cfg, gen, **dev)
            self.ln2 = L.Norm(cfg.d_model, cfg.norm, **dev)
            self.ffn = FFN(cfg, int(cfg.d_model * cfg.slstm_proj_factor), gen,
                           **dev)
            return
        else:
            raise ValueError(kind)
        self.ln2 = L.Norm(cfg.d_model, cfg.norm, **dev)
        if kind == "mla" and cfg.is_dense_layer(index):
            self.mlp = MLP.MLP(cfg, gen, d_ff=cfg.d_ff_dense, **dev)
        elif cfg.is_moe and kind in ("attn", "local", "mla"):
            # as the reference
            self.moe = MOE.MoE(cfg, gen, experts=experts, **dev)
        else:
            self.mlp = MLP.MLP(cfg, gen, **dev)


class Transformer(nn.Module):
    """The parameters of a whole model: ``embed`` (decoders and the VLM),
    ``frontend`` (the stub frontend's projection, audio and vision),
    ``layers``, ``ln_f`` and (untied) ``head``, drawn from ``gen`` in that
    order.  ``experts=(lo, hi)``: every MoE layer holds experts lo..hi-1
    (default: all)."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None,
                 experts: tuple[int, int] | None = None):
        super().__init__()
        self.cfg = cfg
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.embed = nn.Parameter(
            L.embed_init(gen, cfg.padded_vocab, cfg.d_model, **init),
            requires_grad=False) \
            if cfg.is_decoder or cfg.family == "vlm" else None
        self.frontend = L.Dense(L.dense_init(gen, cfg.frontend_dim,
                                             cfg.d_model, **init)) \
            if cfg.frontend else None
        self.layers = nn.ModuleList(
            Block(cfg, kind, gen, device=device, experts=experts, index=i)
            for i, kind in enumerate(cfg.block_kinds))
        self.ln_f = L.Norm(cfg.d_model, cfg.norm, device=device)
        self.head = None if cfg.tie_embeddings else L.Dense(
            L.dense_init(gen, cfg.d_model, cfg.padded_vocab, **init))


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                experts: tuple[int, int] | None = None) -> Transformer:
    """Random parameters drawn on ``device`` (default: the CUDA card; raises
    without one) from a ``torch.Generator`` seeded with ``seed``; an MoE
    model's layers hold ``experts`` (default: all)."""
    dev = compat.resolve_device(device)
    return Transformer(cfg, torch.Generator(device=dev).manual_seed(seed),
                       device=dev, experts=experts)


def _mlp(p: Block, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(p.ln2, x, cfg.norm)
    with tracing.span("mlp"):
        h = MLP.forward(p.mlp, cfg, h)
    return x + h


def _attn_ffn(p: Block, cfg: ModelConfig, x: torch.Tensor,
              decode: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """An attention block's branch after attention: x + MLP (aux None), or
    x + MoE and its aux loss where the block holds an MoE layer."""
    if not hasattr(p, "moe"):
        return _mlp(p, cfg, x), None
    m, aux = MOE.forward(p.moe, cfg, L.apply_norm(p.ln2, x, cfg.norm),
                         decode=decode)
    return x + m, aux


def _attention(p: Block, cfg: ModelConfig, kind: str, h: torch.Tensor, rot,
               cache: dict | None = None, index=None) -> torch.Tensor:
    """A block's attention under the span ``attention``: over the whole
    sequence, or one decode step into ``cache`` at ``index``."""
    local = kind == "local"
    with tracing.span("attention"):
        if kind == "mla":
            if cache is None:
                return MLA.forward(p.attn, cfg, h, rot)
            return MLA.decode_step(p.attn, cfg, h, cache, index, rot)
        if cache is None:
            return ATT.forward(p.attn, cfg, h, local=local, rot=rot)
        return ATT.decode_step(p.attn, cfg, h, cache, index, local=local,
                               rot=rot)[0]


def _block_forward(p: Block, cfg: ModelConfig, kind: str, x: torch.Tensor,
                   rot) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One full-sequence layer; ``rot``: the RoPE tables of attention.
    Returns (x, the MoE aux loss or None).  Under a mesh the block takes
    its input whole over the sequence (the boundary's ``act_seq`` split is
    gathered on entry, as the reference's blocks gather it)."""
    x = shard(x, "batch", "seq", None)
    h = L.apply_norm(p.ln1, x, cfg.norm)
    if kind in ("attn", "local", "mla"):
        x = x + _attention(p, cfg, kind, h, rot)
        return _attn_ffn(p, cfg, x)
    if kind == "rglru":
        return _mlp(p, cfg, x + REC.forward(p.rec, cfg, h)), None
    if kind == "mlstm":
        return x + XL.mlstm_forward(p.cell, cfg, h), None
    x = x + XL.slstm_forward(p.cell, cfg, h)
    return x + _ffn(p.ffn, L.apply_norm(p.ln2, x, cfg.norm)), None


def _block_decode(p: Block, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  cache: dict, index: torch.Tensor, rot) -> torch.Tensor:
    """One layer of a decode step; ``cache`` is updated in place."""
    h = L.apply_norm(p.ln1, x, cfg.norm)
    if kind in ("attn", "local", "mla"):
        x = x + _attention(p, cfg, kind, h, rot, cache, index)
        return _attn_ffn(p, cfg, x, decode=True)[0]
    if kind == "rglru":
        return _mlp(p, cfg, x + REC.decode_step(p.rec, cfg, h, cache)[0])
    if kind == "mlstm":
        return x + XL.mlstm_decode_step(p.cell, cfg, h, cache)[0]
    x = x + XL.slstm_decode_step(p.cell, cfg, h, cache)[0]
    return x + _ffn(p.ffn, L.apply_norm(p.ln2, x, cfg.norm))


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, *,
                device=None) -> dict:
    """One layer's decode state: a KV cache (``attn``; a ring of
    ``local_window`` rows for ``local``), the latent cache (``mla``), or
    the recurrent state."""
    if kind == "mla":
        return MLA.init_cache(cfg, batch, max_len, device=device)
    if kind in ("attn", "local"):
        return ATT.init_cache(cfg, batch, max_len, local=(kind == "local"),
                              device=device)
    if kind == "rglru":
        return REC.init_state(cfg, batch, device=device)
    if kind == "mlstm":
        return XL.mlstm_init_state(cfg, batch, device=device)
    if kind == "slstm":
        return XL.slstm_init_state(cfg, batch, device=device)
    raise ValueError(kind)


def embed_inputs(params: Transformer, cfg: ModelConfig, *,
                 tokens: torch.Tensor | None = None,
                 features: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings, stub-frontend features, or both (the VLM prepends
    the features), in the activation dtype: features cast, then projected
    by ``frontend``; embeddings gathered, then cast (the same values as the
    reference's cast-then-gather)."""
    parts = []
    if features is not None:
        parts.append(L.dense(params.frontend,
                             features.to(cfg.activation_dtype)))
    if tokens is not None:
        if is_dtensor(params.embed):
            emb = vocab_pick(params.embed, tokens, 0, lambda t, i, inside:
                             t[i] * inside[..., None].to(t.dtype))
        else:
            emb = params.embed[tokens.long()]
        parts.append(emb.to(cfg.activation_dtype))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
    return shard(x, "batch", "act_seq", None)


def _rotary(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE tables once a step, for a config with attention blocks (YaRN's
    of the rotated columns for latent attention)."""
    if "mla" in cfg.block_kinds:
        return MLA.rotary(cfg, positions)
    return ATT.rotary(cfg, positions) if cfg.has_attention else None


#: ``torch.utils.checkpoint`` as ``jax.checkpoint``: non-reentrant (so
#: checkpoints nest), and no RNG state kept (the blocks draw none).
_REMAT = dict(use_reentrant=False, preserve_rng_state=False)


def forward_hidden(params: Transformer, cfg: ModelConfig, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the block stack.  Returns (hidden, total aux loss): the MoE
    layers' aux losses summed in layer order, zero without MoE.

    With ``cfg.remat`` and autograd recording, the reference's hierarchical
    remat: each pattern group (``cfg.block_pattern``'s consecutive layers)
    is checkpointed, and every block inside it again (the remainder blocks
    only at the block level), so the forward keeps group boundaries and the
    backward recomputes one group, then one block at a time."""
    rot = _rotary(cfg, torch.arange(x.shape[1], device=x.device)[None, :])
    remat = cfg.remat and torch.is_grad_enabled()
    n_pat = len(cfg.block_pattern)

    def block(layer, kind, x, aux):
        if remat:
            x, a = checkpoint(_block_forward, layer, cfg, kind, x, rot,
                              **_REMAT)
        else:
            x, a = _block_forward(layer, cfg, kind, x, rot)
        return x, aux if a is None else aux + a

    def group(g, x, aux):
        for i, kind in enumerate(cfg.block_pattern):
            x, aux = block(params.layers[g * n_pat + i], kind, x, aux)
            # seq-shard the saved boundary activation (Megatron-SP)
            x = shard(x, "batch", "act_seq", None)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.pattern_repeats):
        if remat:
            x, aux = checkpoint(group, g, x, aux, **_REMAT)
        else:
            x, aux = group(g, x, aux)
    rest = cfg.pattern_repeats * n_pat
    for i, kind in enumerate(cfg.remainder_pattern):
        x, aux = block(params.layers[rest + i], kind, x, aux)
    return x, aux


def logits_fn(params: Transformer, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Final norm and head; the vocabulary's padding columns are -1e30.
    Under a mesh the head takes x whole over the sequence."""
    x = shard(x, "batch", "seq", None)
    x = L.apply_norm(params.ln_f, x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params.embed.to(x.dtype).T
    else:
        logits = L.dense(params.head, x)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, L.NEG_INF)
    return shard(logits, "batch", "seq", "vocab")


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch keys: tokens? features? labels, mask? (batch-major).  Where the
    logits outnumber the labels (the VLM's patches lead), the loss takes the
    trailing text positions.  Autograd differentiates it on the dense path
    (the train phase of ``workload.steps`` takes its gradients)."""
    x = embed_inputs(params, cfg, tokens=batch.get("tokens"),
                     features=batch.get("features"))
    x, aux = forward_hidden(params, cfg, x)
    logits = logits_fn(params, cfg, x)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    ce = L.cross_entropy(logits, labels, batch.get("mask"))
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device=None) -> list[dict]:
    """One decode state per layer (``block_cache``), on ``device`` (default:
    the CUDA card; raises without one)."""
    dev = compat.resolve_device(device)
    return [block_cache(cfg, kind, batch, max_len, device=dev)
            for kind in cfg.block_kinds]


def decode_step(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                caches: list[dict], index) -> tuple[torch.Tensor, list[dict]]:
    """One decoding step for the whole stack at position ``index`` (an int
    or a one-element tensor); tokens (B, 1).  Every layer's cache or state
    is updated in place and returned."""
    x = embed_inputs(params, cfg, tokens=tokens)
    index = torch.as_tensor(index, device=x.device).reshape(1).long()
    rot = _rotary(cfg, index.reshape(1, 1))
    for kind, layer, cache in zip(cfg.block_kinds, params.layers, caches):
        x = _block_decode(layer, cfg, kind, x, cache, index, rot)
    logits = logits_fn(params, cfg, x)
    return logits[:, 0], caches
