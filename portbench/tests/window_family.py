"""Family ``window``: a decoder whose layers mix sliding-window attention
with full attention, as a model family added by files alone
(``test_portbench_layout.py`` copies this module into a layout as
``archs/window.py``; the contract is in ``archs/__init__.py``).

A configuration of the family is a ``qwen`` one whose ``architecture``
also names the family, the layers' ``pattern`` of ``local`` and ``attn``
kinds (repeated over the layers) and the ``window``: a query of a
``local`` layer attends to the last ``window`` positions, itself
included.  The program runs ``local`` layers with a ring of
``min(window, max_len)`` cache rows, and its K5 and K4 on both kinds.
Leaves, names and kernels are the ``qwen`` family's; the reference, the
cache shapes and the counts are the family's own.
"""
from __future__ import annotations

import dataclasses

from portbench.archs import qwen
from portbench.archs.qwen import (  # noqa: F401  (the same as qwen's)
    BUILD, KERNELS, LAUNCH_CHECKS, counters, expected_launches, init_caches,
    layer_leaves, load_model, make_decode_step, make_prefill_step,
    top_leaves)
from portbench.counts import BF16, bound_s, causal_pairs


@dataclasses.dataclass(frozen=True)
class Geometry(qwen.Geometry):
    pattern: tuple[str, ...] = ("attn",)
    window: int = 0

    def local(self, layer: int) -> bool:
        return self.pattern[layer % len(self.pattern)] == "local"


def geometry(c: dict) -> Geometry:
    arch = c["architecture"]
    g = Geometry(**dataclasses.asdict(qwen.geometry(c)),
                 pattern=tuple(arch["pattern"]), window=arch["window"])
    if g.is_moe or g.n_layers % len(g.pattern):
        raise ValueError(f"{g.name}: a dense model whose layers the pattern "
                         f"{g.pattern} divides")
    return g


def model_config(g: Geometry):
    return dataclasses.replace(qwen.model_config(g), block_pattern=g.pattern,
                               local_window=g.window)


class Reference(qwen.Reference):
    """``qwen``'s reference with the window of ``local`` layers."""

    def live(self, layer, q_pos, k_pos):
        live = super().live(layer, q_pos, k_pos)
        if self.g.local(layer):
            live = live & (k_pos[None, :] > q_pos[:, None] - self.g.window)
        return live


def cache_leaves(g: Geometry, layer: int, batch: int, max_len: int):
    """K and V of ``max_len`` rows, a ring of ``window`` rows in a
    ``local`` layer."""
    rows = min(g.window, max_len) if g.local(layer) else max_len
    shape = (batch, rows, g.n_kv_heads, g.head_dim)
    return [("k", shape, "k"), ("v", shape, "v")]


# -- counts -----------------------------------------------------------------

def pairs(g: Geometry, layer: int, seq: int) -> int:
    """(query, key) pairs live in one head of a prefill of ``seq``: each
    query's last ``window`` positions in a ``local`` layer."""
    if not g.local(layer) or seq <= g.window:
        return causal_pairs(seq)
    return causal_pairs(g.window) + (seq - g.window) * g.window


def live_rows(g: Geometry, layer: int, index: int) -> int:
    """Cache rows a decode step at position ``index`` reads."""
    return min(index + 1, g.window) if g.local(layer) else index + 1


def _attention(g: Geometry, batch: int, tokens: int, keys: int) -> dict:
    """One attention call: ``keys`` live pairs a head (a prefill) or rows
    (a decode), over ``tokens`` queries a row, q, k, v read and the output
    written once (a decode: the live K/V rows, q and the output)."""
    flops = 4.0 * batch * g.n_heads * g.head_dim * keys
    if tokens > 1:
        nbytes = BF16 * batch * tokens * (2 * g.q_dim + 2 * g.kv_dim)
    else:
        nbytes = BF16 * (2 * batch * keys * g.kv_dim + 2 * batch * g.q_dim)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def kernel_bounds(g: Geometry, phase: str, batch: int, n: int) -> dict:
    if phase == "prefill":
        return {"flash_attention": sum(
            _attention(g, batch, n, pairs(g, i, n))["bound_s"]
            for i in range(g.n_layers))}
    return {"decode_attention": sum(
        _attention(g, batch, 1, live_rows(g, i, n))["bound_s"]
        for i in range(g.n_layers))}


def prefill_call(g: Geometry, batch: int, seq: int, kept=0.0) -> dict:
    tokens = batch * seq
    flops = (2.0 * tokens * qwen.layer_product_params(g) * g.n_layers
             + sum(_attention(g, batch, seq, pairs(g, i, seq))["flops"]
                   for i in range(g.n_layers))
             + 2.0 * batch * g.d_model * g.padded_vocab)
    nbytes = (qwen.weight_bytes(g) + BF16 * tokens * g.d_model
              + BF16 * batch * g.padded_vocab)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def decode_step(g: Geometry, batch: int, index: int) -> dict:
    live = [live_rows(g, i, index) for i in range(g.n_layers)]
    flops = (2.0 * batch * (qwen.layer_product_params(g) * g.n_layers
                            + g.d_model * g.padded_vocab)
             + sum(_attention(g, batch, 1, n)["flops"] for n in live))
    cache = sum(BF16 * 2 * batch * (n + 1) * g.kv_dim for n in live)
    nbytes = (qwen.weight_bytes(g) + cache + BF16 * batch * g.d_model
              + BF16 * batch * g.padded_vocab)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}
