"""Assigned input-shape sets and their meta-tensor stand-ins.

Port of ``repro.configs.shapes``.  LM-family shapes (seq_len x global_batch):
    train_4k      4,096 x 256   training
    prefill_32k   32,768 x 32   inference: the full forward
    decode_32k    32,768 x 128  decode: one new token over a KV cache of
                                seq_len
    long_500k     524,288 x 1   long decode; sub-quadratic archs only

Skip rules (from the assignment):
    * decode/long shapes are skipped for encoder-only archs (hubert);
    * long_500k is skipped for pure full-attention archs (needs
      sub-quadratic attention).

``input_specs`` returns tensors on the ``meta`` device, which carry shape
and dtype and hold no memory, where the reference returns
``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig

VISION_PATCHES = 256  # stubbed InternViT patch tokens prepended to the text


def vision_patches(seq_len: int) -> int:
    """Patch-token count for a given total sequence length (256 for the
    assigned shapes; scaled down for tiny smoke-test sequences)."""
    return min(VISION_PATCHES, max(1, seq_len // 8))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch x shape) cell."""
    if shape.kind in ("decode", "long_decode") and not cfg.is_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every input of one step.

    Training/prefill inputs are token ids (and stub-frontend features for
    audio/vlm); decode inputs are the one-token batch, one KV cache per
    layer (``TF.init_caches``' layout) and the position index.
    """
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    act = cfg.activation_dtype

    def token_batch(with_labels: bool) -> dict:
        batch: dict = {}
        if cfg.frontend == "audio":
            batch["features"] = _meta((B, S, cfg.frontend_dim), act)
            if with_labels:
                batch["labels"] = _meta((B, S), i32)
                batch["mask"] = _meta((B, S), f32)
            return batch
        if cfg.frontend == "vision":
            patches = vision_patches(S)
            text = S - patches
            batch["features"] = _meta((B, patches, cfg.frontend_dim), act)
            batch["tokens"] = _meta((B, text), i32)
            if with_labels:
                batch["labels"] = _meta((B, text), i32)
            return batch
        batch["tokens"] = _meta((B, S), i32)
        if with_labels:
            batch["labels"] = _meta((B, S), i32)
        return batch

    if shape.kind == "train":
        return {"batch": token_batch(with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": token_batch(with_labels=False)}
    # decode / long_decode
    caches = [TF.block_cache(cfg, kind, B, S, device="meta")
              for kind in cfg.block_kinds]
    return {"tokens": _meta((B, 1), i32), "caches": caches,
            "index": _meta((), i32)}
