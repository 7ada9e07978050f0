"""Gradient compression for the data-parallel reduce.

Port of ``repro.runtime.compression`` on dicts of tensors (``{name:
gradient}``).  Two codecs, applied leaf by leaf before the reduction and
undone after (``TrainConfig.grad_compression``):

* ``"bf16"``: f32 gradients cast to bf16 for the wire;
* ``"int8"``: per-leaf symmetric int8 with an f32 scale, ``max|g| / 127``
  (at least 1e-12 / 127), rounded half to even as the reference's
  ``jnp.round``; an optional error buffer carries each leaf's quantization
  residual to the next step.

On one card there is no reduction, so the train step runs the round trip
(compress, then decompress) where the reduction would sit, as the
reference's step does.
"""
from __future__ import annotations

import torch


def compress_grads(grads: dict[str, torch.Tensor], method: str | None,
                   error_buf: dict[str, torch.Tensor] | None = None
                   ) -> tuple[dict, dict | None]:
    """Returns ``(wire, new_error_buf)``: for ``int8`` the wire holds
    ``(int8 tensor, f32 scale)`` by name and the error buffer each leaf's
    residual; the other codecs pass ``error_buf`` through."""
    if not method or method == "none":
        return grads, error_buf
    if method == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}, error_buf
    if method == "int8":
        if error_buf is not None and error_buf.keys() != grads.keys():
            error_buf = None
        wire, errs = {}, {}
        for k, g in grads.items():
            gf = g.to(torch.float32)
            if error_buf is not None:
                gf = gf + error_buf[k]
            scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
            qg = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            wire[k] = (qg, scale)
            errs[k] = gf - qg.to(torch.float32) * scale
        return wire, errs
    raise ValueError(f"unknown compression {method!r}")


def decompress_grads(wire: dict, method: str | None,
                     like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Undo :func:`compress_grads`: back to ``like``'s dtypes (``bf16``) or
    to f32 (``int8``)."""
    if not method or method == "none":
        return wire
    if method == "bf16":
        return {k: g.to(like[k].dtype) for k, g in wire.items()}
    if method == "int8":
        return {k: qg.to(torch.float32) * scale
                for k, (qg, scale) in wire.items()}
    raise ValueError(f"unknown compression {method!r}")
