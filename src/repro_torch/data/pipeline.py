"""Deterministic, restart-safe data pipeline.

Port of ``repro.data.pipeline``.  A batch is a pure function of ``(seed,
step, shard)``, with no iterator state: a restart needs only the step
counter, and any host can recompute its shard of any step.  Batches are
numpy arrays drawn by the same counter-based Philox generator as the
reference's, so they are bit-equal to its batches; the trainer moves them
to the device.

* :class:`SyntheticDataset`: a Zipf-ish token stream keyed by ``(seed,
  step, shard)``, with the stub frontends' extras (audio features, labels
  and a mask; vision patches before the text);
* :class:`MemmapDataset`: a binary token file (uint16/uint32) read at
  windows drawn from the same kind of key.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

from repro_torch.configs.shapes import vision_patches
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    batch_size: int            # per-shard batch
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


class SyntheticDataset:
    """Counter-based synthetic LM data: batch = f(seed, step, shard)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=self.data.seed, counter=[0, 0, self.data.shard, step]))

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        cfg, d = self.cfg, self.data
        rng = self._rng(step)
        B, S = d.batch_size, d.seq_len
        if cfg.frontend == "audio":
            feats = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            mask = (rng.random((B, S)) < 0.08).astype(np.float32)  # HuBERT-style masking
            return {"features": feats, "labels": labels, "mask": mask}
        # Zipfian token stream (approximates natural-language unigrams)
        z = rng.zipf(1.2, size=(B, S + 1))
        toks = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
        if cfg.frontend == "vision":
            patches = vision_patches(S)
            n_text = S - patches
            feats = rng.standard_normal(
                (B, patches, cfg.frontend_dim)).astype(np.float32)
            return {"features": feats,
                    "tokens": toks[:, :n_text],
                    "labels": toks[:, 1:n_text + 1]}
        return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}


class MemmapDataset:
    """Token file dataset: deterministic strided windows over a memmap."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, path: str,
                 dtype=np.uint16):
        self.cfg = cfg
        self.data = data
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) < data.seq_len + 1:
            raise ValueError("token file shorter than one sequence")

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        d = self.data
        B, S = d.batch_size, d.seq_len
        n_windows = (len(self.tokens) - 1) // S
        rng = np.random.Generator(np.random.Philox(
            key=d.seed, counter=[0, 1, d.shard, step]))
        idx = rng.integers(0, n_windows, size=B)
        tokens = np.stack([self.tokens[i * S:i * S + S] for i in idx])
        labels = np.stack([self.tokens[i * S + 1:i * S + S + 1] for i in idx])
        v = self.cfg.vocab_size
        return {"tokens": (tokens % v).astype(np.int32),
                "labels": (labels % v).astype(np.int32)}


def make_dataset(cfg: ModelConfig, data: DataConfig,
                 path: str | None = None) -> Any:
    """A :class:`MemmapDataset` over ``path`` where that file exists, else a
    :class:`SyntheticDataset`."""
    if path and os.path.exists(path):
        return MemmapDataset(cfg, data, path)
    return SyntheticDataset(cfg, data)
