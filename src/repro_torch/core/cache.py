"""Caches keyed by content hash: on-disk HLO analyses + in-memory LRU.

Port of ``repro.core.cache`` (standard library only).  Lower+compile is the expensive step of model-guided search (seconds per
candidate); the analytical scoring is microseconds.  Caching the *analysis*
(the `HloCost` numbers, not the HLO text) makes re-ranking a design space
under different hardware parameters, or resuming an interrupted sweep, free.

Records are plain JSON dicts, one file per key, written atomically so
concurrent autotune runs can share a cache directory.  The key is a SHA-256
over a canonical JSON encoding of the configuration (plus a cache schema
version; a caller that analyzes compiled programs adds its compiler's
version, since recompiling under a different compiler can change the
counts).

:class:`LruCache` is the in-memory layer above that disk cache: a bounded,
thread-safe, recency-evicting map with hit/miss counters.  The serving
layer (:mod:`repro_torch.core.serving`) keys it with the same
:func:`config_hash` to memoize whole estimate results per canonical
``Design`` + hardware context.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Mapping

CACHE_VERSION = 1

#: Default cache root; override with the REPRO_TORCH_CACHE_DIR environment
#: variable (or pass ``root``).
DEFAULT_ROOT = os.environ.get(
    "REPRO_TORCH_CACHE_DIR", os.path.join("~", ".cache", "repro_torch"))


def config_hash(obj: Any, *, salt: str = "") -> str:
    """Stable hex digest of an arbitrary JSON-encodable configuration.

    Non-JSON values fall back to ``repr`` — good enough for dataclasses,
    enums and mesh shapes, and stable within a process generation.
    """
    blob = json.dumps({"v": CACHE_VERSION, "salt": salt, "obj": obj},
                      sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


class LruCache:
    """Bounded, thread-safe, least-recently-used map with hit/miss counters.

    ``get`` refreshes recency; ``put`` evicts the coldest entry past
    ``capacity``.  Values are returned as stored (no copying) — callers
    cache immutable records (frozen dataclasses, result tuples).  A
    ``capacity`` of 0 disables storage but keeps counting misses, so a
    cache-off server still reports honest stats.
    """

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = int(capacity)
        self._data: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            try:
                self._data.move_to_end(key)
            except KeyError:
                self.misses += 1
                return default
            self.hits += 1
            return self._data[key]

    def put(self, key: str, value: Any) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __contains__(self, key: str) -> bool:
        with self._lock:          # membership does not refresh recency
            return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> dict:
        return {"size": len(self._data), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses}


class HloAnalysisCache:
    """Directory of ``<key>.json`` analysis records."""

    def __init__(self, root: str | os.PathLike | None = None,
                 namespace: str = "hlo"):
        base = pathlib.Path(root if root is not None else DEFAULT_ROOT)
        self.root = base.expanduser() / namespace

    def _path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    def get(self, key: str) -> dict | None:
        try:
            with open(self._path(key)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None      # missing or corrupt — recompute

    def put(self, key: str, record: Mapping[str, Any]) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(dict(record), fh, sort_keys=True, default=repr)
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __contains__(self, key: str) -> bool:
        return self._path(key).is_file()

    def __len__(self) -> int:
        if not self.root.is_dir():
            return 0
        return sum(1 for _ in self.root.glob("*.json"))

    def clear(self) -> int:
        """Delete every record; returns the number removed."""
        n = 0
        if self.root.is_dir():
            for p in self.root.glob("*.json"):
                try:
                    p.unlink()
                    n += 1
                except OSError:
                    pass
        return n
