"""Weights, prompts and decode caches drawn from the run's seed.

Everything is drawn on the run's device by a ``torch.Generator`` seeded
from ``(seed, tag)`` (:func:`seed_of`), so each piece can be drawn again
alone: the reference draws the same weights and cache rows after the
program's state is freed, bit for bit, instead of reading the program's.

The weights are drawn in the dtypes the program serves (bf16 products and
biases; f32 norms and MoE router), one ``randn`` a layer for each dtype
(``ALIGN``-element slots in one buffer, each leaf a view scaled in place),
never leaf by leaf and never on the host.  Which leaves, in which shapes
and dtypes, is the family's plan (``archs/<family>.py``: ``layer_leaves``,
``top_leaves``); names are the benchmark's own (Hugging Face's, with
weights stored (in, out)), and the family's ``load_model`` maps them to
the program's.
"""
from __future__ import annotations

import hashlib
import math

import torch

#: Each leaf starts at a multiple of this many elements of its buffer.
ALIGN = 256
#: Standard deviations of the draws that are not N(0, 1/fan_in).
EMBED_STD = 0.02
BIAS_STD = 0.1
NORM_STD = 0.1                  # norm weights are 1 + N(0, NORM_STD^2)
ROUTER_STD = 0.02


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed for the draw ``tags`` of the run seeded ``seed`` (any
    whole number)."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, *tags))
    return gen


def fan_in(shape) -> float:
    """The N(0, 1/fan_in) scale of a product's weight stored (in, out)."""
    return 1.0 / math.sqrt(shape[-2])


def _draw(leaves, device, seed: int, *tags) -> dict[str, torch.Tensor]:
    """One buffer a dtype, one ``randn`` each; the leaves as views."""
    out = {}
    for dtype in sorted({leaf[2] for leaf in leaves}):
        mine = [leaf for leaf in leaves if leaf[2] == dtype]
        sizes = [math.prod(shape) for _, shape, _, _ in mine]
        total = sum(-(-n // ALIGN) * ALIGN for n in sizes)
        buf = torch.randn(total, dtype=getattr(torch, dtype), device=device,
                          generator=generator(device, seed, *tags, dtype))
        at = 0
        for (name, shape, _, (how, scale)), n in zip(mine, sizes):
            t = buf[at:at + n].view(shape)
            t.mul_(scale)
            if how == "one_plus":
                t.add_(1.0)
            out[name] = t
            at += -(-n // ALIGN) * ALIGN
    return out


def draw_layer(arch, g, seed: int, i: int, device) -> dict:
    """Layer ``i``'s leaves by the family ``arch``'s plan, by their names
    without the layer prefix."""
    return _draw(arch.layer_leaves(g, i), device, seed, "layer", i)


def draw_top(arch, g, seed: int, device) -> dict:
    out = {}
    for leaf in arch.top_leaves(g):
        out.update(_draw([leaf], device, seed, leaf[0]))
    return out


def draw_weights(arch, g, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of the family ``arch``'s plan (``archs/<family>.py``),
    layer leaves as ``layers.<i>.<name>``."""
    out = draw_top(arch, g, seed, device)
    for i in range(g.n_layers):
        out.update({f"layers.{i}.{k}": v
                    for k, v in draw_layer(arch, g, seed, i, device).items()})
    return out


def fill_cache(t: torch.Tensor, seed: int, layer: int, which: str) -> None:
    """A whole cache tensor (the family's ``cache_leaves``, tag
    ``which``) drawn N(0, 1) in place."""
    t.normal_(generator=generator(t.device, seed, "cache", layer, which))


def cache_tensor(shape, dtype, device, seed: int, layer: int,
                 which: str) -> torch.Tensor:
    """:func:`fill_cache`'s draw again, into a new tensor."""
    t = torch.empty(shape, dtype=dtype, device=device)
    fill_cache(t, seed, layer, which)
    return t


def token_pool(seed: int, tag: str, rows: int, cols: int, vocab: int,
               device) -> torch.Tensor:
    """(rows, cols) int32 token ids, uniform over the vocabulary."""
    return torch.randint(0, vocab, (rows, cols), dtype=torch.int32,
                         device=device, generator=generator(device, seed, tag))
