"""Micro-batched design-advisor serving: the long-lived query front door.

Port of ``repro.core.serving``.  The estimator is a pure function that
answers "how fast will this design run"; the interactive-advisor use case
needs a concurrent front door.  :class:`Server` (built by
``Session.serve()``) turns one :class:`~repro_torch.api.Session` into a
query service:

* **Micro-batching** — ``estimate``/``submit`` calls from many threads land
  on a bounded queue; a background batcher thread collects up to
  ``max_batch`` requests (waiting at most ``max_wait_ms`` after the first),
  scores them in **one** batched ``estimate_many`` pass, and scatters the
  per-row results back to per-request futures.  Row ``i`` of a batch is
  bit-equal to the same design scored alone: the array core is row-
  independent and its per-kernel segment sums add in a fixed order on
  every device (``model_batch._fixed_order_segments``), so batching is
  invisible to callers except in latency.  The batch is scored unpadded
  on the session's device; :func:`pad_group_batch` keeps the reference's
  fixed-shape padding (real rows bit-equal) for callers that need fixed
  shapes.
* **Result caching** — a content-hash LRU
  (:class:`repro_torch.core.cache.LruCache`, keyed on the canonical
  ``Design`` + hardware + calibration + device hash) sits in front of the
  batcher, one level above the on-disk HLO-analysis cache of
  :mod:`repro_torch.core.cache`: repeat queries (the advisor steady state) return
  without touching the queue, marked ``Estimate.cached``.  Identical
  designs *in flight* coalesce onto one future, so a miss storm for one hot
  design costs one batch slot.
* **Operability** — ``stats()`` exposes hit/miss/latency counters (p50/p99
  over a sliding window), ``close(drain=True)`` performs a graceful drain,
  per-request deadlines fast-fail expired work before scoring, and a full
  queue fast-fails new submissions with :class:`ServerOverloaded` instead
  of building unbounded backlog.

Only the batcher thread touches the device.  The server resolves the
session's device to an explicit one in the caller's thread when it is
built, and the batcher makes it current before it scores anything, so a
CUDA session serves from the card it was built on.
"""
from __future__ import annotations

import dataclasses
import queue
import statistics
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core import model_batch as _mb
from repro_torch.core.cache import LruCache, config_hash

if TYPE_CHECKING:  # pragma: no cover — import cycle is runtime-lazy
    from repro_torch.api import Design, Estimate, Session


class ServerError(RuntimeError):
    """Base class of serving-layer failures."""


class ServerClosed(ServerError):
    """The server no longer accepts (or could not finish) this request."""


class ServerOverloaded(ServerError):
    """The bounded request queue is full — fast-fail, caller may retry."""


class RequestTimeout(ServerError, TimeoutError):
    """The request's deadline passed before a result was produced."""


@dataclasses.dataclass
class _Request:
    """One queued estimate request (internal currency of the batcher)."""

    design: "Design"
    key: str
    future: Future
    t_enqueue: float
    deadline: float | None        # monotonic seconds; None = no deadline


_SHUTDOWN = object()              # queue sentinel: drain then exit


def _design_key(design: "Design", salt: str) -> str:
    """Canonical content hash of one design under one session context.

    ``name`` participates so coalesced requests always get back a result
    carrying *their* design verbatim; ``flops`` rides along in the repr.
    The session salt folds in hardware, calibration, backend and device,
    so one server never serves another context's numbers.
    """
    return config_hash({
        "lsus": [repr(l) for l in design.lsus],
        "dram": repr(design.dram), "bsp": repr(design.bsp),
        "f": design.f, "name": design.name, "flops": design.flops,
    }, salt=salt)


def _session_salt(session: "Session") -> str:
    return config_hash({
        "dram": repr(session.dram), "bsp": repr(session.bsp),
        "hw": repr(session.hw), "backend": session.backend,
        "calibration": session.calibration_factor,
        "hardware": repr(session.hardware), "device": str(session.device),
    }, salt="serve-session")


def _explicit_device(device) -> torch.device:
    """``device`` with its index filled in: ``cuda`` means the caller's
    current card, and the batcher thread must not read its own."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def pad_group_batch(batch: "_mb.GroupBatch", n_kernels: int, m_groups: int,
                    ) -> "_mb.GroupBatch":
    """Pad a ragged GroupBatch to fixed ``(n_kernels, m_groups)`` shape.

    Padding groups repeat row 0 (a real, finite row, so no padded group
    divides by zero) but belong to fresh *padding kernels* beyond the
    real ones, so every real kernel's segment sums are untouched and rows
    ``[0, real_n)`` of the padded estimate are bit-equal to the unpadded
    ones.  Mirrors the streaming engine's pad-the-last-chunk trick
    (:func:`repro_torch.core.stream.run_stream`), applied to the request
    axis.
    """
    m = len(np.asarray(batch.kernel))
    if batch.n_kernels > n_kernels or m > m_groups:
        raise ValueError(
            f"batch ({batch.n_kernels} kernels, {m} groups) exceeds the "
            f"padding target ({n_kernels}, {m_groups})")
    if (batch.n_kernels == n_kernels and m == m_groups) or m == 0:
        return batch        # nothing to pad from (or with): keep as-is
    pad = m_groups - m
    kernel = np.concatenate([
        np.asarray(batch.kernel, dtype=np.int64),
        # spread padding rows over the padding kernels (wrapping) so no
        # padding kernel ever aggregates an outsized segment
        (n_kernels - 1 - (np.arange(pad, dtype=np.int64)
                          % max(1, n_kernels - batch.n_kernels)))
        if pad else np.empty(0, dtype=np.int64)])
    out = {"kernel": kernel, "n_kernels": n_kernels}
    for fld in dataclasses.fields(_mb.GroupBatch):
        if fld.name in out:
            continue
        col = np.asarray(getattr(batch, fld.name))
        out[fld.name] = np.concatenate(
            [col, np.repeat(col[:1], pad, axis=0)]) if pad else col
    return _mb.GroupBatch(**out)


class Server:
    """Concurrent micro-batching front door over one :class:`Session`.

    Build one with ``Session.serve(...)``; use it from any number of
    threads; close it (or use it as a context manager) when done::

        with Session().serve(max_batch=64) as srv:
            est = srv.estimate(design)            # blocking
            fut = srv.submit(design)              # Future[Estimate]
            print(srv.stats()["latency_ms"])

    Results are bit-equal to ``session.estimate(design)`` called serially,
    whatever batch a request lands in.
    """

    def __init__(self, session: "Session", *, max_batch: int = 64,
                 max_wait_ms: float = 1.0, cache_size: int = 4096,
                 max_queue: int = 1024, timeout_ms: float | None = None,
                 latency_window: int = 4096):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if timeout_ms is not None and timeout_ms <= 0:
            raise ValueError("timeout_ms must be > 0 (or None)")
        self.session = session
        self._device = _explicit_device(session.device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.timeout_s = None if timeout_ms is None else float(timeout_ms) / 1e3
        self._salt = _session_salt(session)
        self._queue: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._cache: LruCache = LruCache(int(cache_size))
        self._lock = threading.Lock()
        self._inflight: dict[str, Future] = {}
        # id -> (design, key): advisor clients replay the same Design
        # objects, so skip re-hashing them on the hot path.  The strong ref
        # in the value pins the id for as long as the entry lives, and the
        # `is` check on read makes a stale id harmless either way.
        self._key_memo: dict[int, tuple] = {}
        self._closed = False
        self._latencies: deque[float] = deque(maxlen=int(latency_window))
        self._counters = {
            "submitted": 0, "served": 0, "errors": 0, "coalesced": 0,
            "rejected_overload": 0, "expired": 0, "batches": 0,
            "batched_requests": 0, "max_batch_seen": 0,
        }
        self._thread = threading.Thread(
            target=self._batcher, name="repro-torch-serve-batcher",
            daemon=True)
        self._thread.start()

    # -- client surface -----------------------------------------------------

    def submit(self, design: "Design",
               timeout_ms: float | None = None) -> Future:
        """Enqueue one design; returns a ``Future[Estimate]``.

        Fast paths: a cache hit resolves immediately without touching the
        queue; an identical design already in flight shares that request's
        future.  A full queue raises :class:`ServerOverloaded` *now* (the
        fast-fail overload policy) rather than queueing unboundedly.
        """
        if self._closed:
            raise ServerClosed("server is closed")
        memo = self._key_memo.get(id(design))
        if memo is not None and memo[0] is design:
            key = memo[1]
        else:
            key = _design_key(design, self._salt)
            if len(self._key_memo) >= 4 * self._cache.capacity + 64:
                self._key_memo.clear()
            self._key_memo[id(design)] = (design, key)
        t0 = time.monotonic()
        with self._lock:
            self._counters["submitted"] += 1
            hit = self._cache.get(key)
            if hit is not None:
                fut: Future = Future()
                fut.set_result(self._as_cached(hit, design))
                self._latencies.append(time.monotonic() - t0)
                self._counters["served"] += 1
                return fut
            shared = self._inflight.get(key)
            if shared is not None:
                self._counters["coalesced"] += 1
                return shared
            fut = Future()
            self._inflight[key] = fut
        t = timeout_ms if timeout_ms is not None else (
            None if self.timeout_s is None else self.timeout_s * 1e3)
        req = _Request(design=design, key=key, future=fut, t_enqueue=t0,
                       deadline=None if t is None else t0 + t / 1e3)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._lock:
                self._counters["rejected_overload"] += 1
                self._inflight.pop(key, None)
            raise ServerOverloaded(
                f"request queue full ({self._queue.maxsize} pending); "
                f"retry later or raise max_queue") from None
        return fut

    def estimate(self, design: "Design", *,
                 timeout_ms: float | None = None) -> "Estimate":
        """Blocking estimate through the batcher (the advisor entry point).

        ``timeout_ms`` (or the server default) bounds the wait; expiry
        raises :class:`RequestTimeout`.  The result is bit-equal to
        ``self.session.estimate(design)``.
        """
        fut = self.submit(design, timeout_ms=timeout_ms)
        t = timeout_ms if timeout_ms is not None else (
            None if self.timeout_s is None else self.timeout_s * 1e3)
        try:
            return fut.result(timeout=None if t is None else t / 1e3)
        # pre-3.11 concurrent.futures.TimeoutError is not the builtin one
        except (TimeoutError, _FutureTimeout):
            raise RequestTimeout(
                f"no result within {t:.1f} ms (queue depth "
                f"{self._queue.qsize()})") from None

    def predict(self, hlo_text: str, cost: dict | None = None, *,
                gather_row_bytes: float = 512.0):
        """Cached TPU-model step prediction (``Session.predict``).

        Predictions are pure in (hlo_text, cost, hw), so they share the
        server's LRU under a distinct key prefix; the heavy HLO parse runs
        at most once per unique executable text.
        """
        key = config_hash({"hlo": hlo_text, "cost": cost,
                           "gather_row_bytes": gather_row_bytes},
                          salt="predict-" + self._salt)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        out = self.session.predict(hlo_text, cost,
                                   gather_row_bytes=gather_row_bytes)
        with self._lock:
            self._cache.put(key, out)
        return out

    def sweep(self, space=None, *, chunk_size: int | None = None,
              reducers=None, executor: str = "threads",
              workers: int | None = None, **axes):
        """Design-space sweep behind the serving front door.

        Same calling surface as :meth:`repro_torch.api.Session.sweep`
        (including ``executor="processes"`` for the coordinator/worker
        pool), plus the server's result cache: a grid space canonicalizes to
        its :class:`~repro_torch.core.stream.SweepPlan` JSON, so repeat
        queries for the same space under the same session context return
        the finished :class:`~repro_torch.api.SweepReport` without
        re-scoring, and identical
        sweeps *in flight* coalesce onto one run.  Custom ``reducers``
        (mutable instances) and ``Space.random`` spaces run uncached.
        """
        if self._closed:
            raise ServerClosed("server is closed")
        sp = self.session._as_space(space, axes)

        def run():
            return self.session.sweep(sp, chunk_size=chunk_size,
                                      reducers=reducers, workers=workers,
                                      executor=executor)

        if reducers is not None:
            return run()        # reducer instances carry uncanonical state
        try:
            plan = self.session.plan(sp, chunk_size=chunk_size)
        except TypeError:
            return run()        # non-grid space: no canonical plan to key on
        # Streaming and materialized reports answer different queries (held
        # rows vs the whole space), so the mode is part of the key even
        # though it never changes the numbers.
        streaming = (chunk_size is not None or sp.chunk_size is not None
                     or workers is not None or executor == "processes")
        key = config_hash({"plan": plan.to_json(), "streaming": streaming},
                          salt="sweep-" + self._salt)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
            shared = self._inflight.get(key)
            if shared is None:
                fut: Future = Future()
                self._inflight[key] = fut
        if shared is not None:
            with self._lock:
                self._counters["coalesced"] += 1
            return shared.result()
        try:
            report = run()
        except BaseException as exc:
            with self._lock:
                if self._inflight.get(key) is fut:
                    self._inflight.pop(key, None)
            fut.set_exception(exc)
            raise
        with self._lock:
            self._cache.put(key, report)
            if self._inflight.get(key) is fut:
                self._inflight.pop(key, None)
        fut.set_result(report)
        return report

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout_s: float | None = None) -> None:
        """Block until every queued request has been scored."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not self._queue.empty() or self._inflight:
            if deadline is not None and time.monotonic() > deadline:
                raise RequestTimeout(
                    f"drain incomplete after {timeout_s:.1f}s "
                    f"(queue depth {self._queue.qsize()})")
            time.sleep(0.5e-3)

    def close(self, *, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop accepting requests and shut the batcher down.

        ``drain=True`` (graceful) scores everything already queued first;
        ``drain=False`` fails pending futures with :class:`ServerClosed`.
        Idempotent; also runs on ``__exit__``.
        """
        if self._closed:
            return
        self._closed = True
        if not drain:
            # pull whatever is still queued and fail it
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not _SHUTDOWN:
                    self._fail(req, ServerClosed("server closed before "
                                                 "this request was scored"))
        self._queue.put(_SHUTDOWN)
        self._thread.join(timeout=timeout_s)
        with self._lock:
            pending = list(self._inflight.values())
            self._inflight.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(ServerClosed("server closed"))

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    @property
    def closed(self) -> bool:
        return self._closed

    # -- telemetry ----------------------------------------------------------

    def stats(self) -> dict:
        """Hit/miss/latency counters (one consistent snapshot).

        ``latency_ms`` summarizes the last ``latency_window`` completed
        requests (submit -> result, cache hits included): p50/p99/mean.
        """
        with self._lock:
            lat = sorted(self._latencies)
            counters = dict(self._counters)
            cache = self._cache.stats()
        n = len(lat)
        pct = lambda q: (lat[min(n - 1, int(q * (n - 1) + 0.999999))] * 1e3  # noqa: E731
                         if n else 0.0)
        served = max(1, counters["served"])
        return {
            **counters,
            "queue_depth": self._queue.qsize(),
            "inflight": len(self._inflight),
            "cache": cache,
            "cache_hit_rate": cache["hits"] / max(1, cache["hits"]
                                                  + cache["misses"]),
            "mean_batch": counters["batched_requests"] / max(
                1, counters["batches"]),
            "latency_ms": {
                "n": n,
                "p50": statistics.median(lat) * 1e3 if n else 0.0,
                "p99": pct(0.99),
                "mean": sum(lat) / n * 1e3 if n else 0.0,
            },
            "served_per_batch": counters["served"] / max(
                1, counters["batches"]) if counters["batches"] else 0.0,
            "error_rate": counters["errors"] / served,
        }

    # -- batcher ------------------------------------------------------------

    def _collect(self) -> "list[_Request] | None":
        """Block for the first request, then fill the batch.

        Everything already queued is drained immediately; only a *partial*
        batch then lingers up to ``max_wait_ms`` for stragglers, so a lone
        request never waits longer than the window and a hot queue never
        waits at all.  Returns ``None`` on shutdown (after requeueing the
        sentinel so the drain path still scores what it collected).
        """
        try:
            first = self._queue.get()
        except (OSError, ValueError):  # pragma: no cover — interpreter exit
            return None
        if first is _SHUTDOWN:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if nxt is _SHUTDOWN:
                self._queue.put(_SHUTDOWN)     # keep the signal for the loop
                break
            batch.append(nxt)
        return batch

    def _batcher(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            batch = self._collect()
            if batch is None:
                return
            now = time.monotonic()
            live: list[_Request] = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    self._fail(req, RequestTimeout(
                        "request expired in queue before scoring"))
                    with self._lock:
                        self._counters["expired"] += 1
                else:
                    live.append(req)
            if not live:
                continue
            try:
                results = self._score([r.design for r in live])
            except BaseException as exc:  # noqa: BLE001 — fail the batch, not the thread
                for req in live:
                    self._fail(req, exc)
                continue
            now = time.monotonic()
            with self._lock:
                self._counters["batches"] += 1
                self._counters["batched_requests"] += len(live)
                self._counters["max_batch_seen"] = max(
                    self._counters["max_batch_seen"], len(live))
                for req, est in zip(live, results):
                    self._cache.put(req.key, est)
                    self._inflight.pop(req.key, None)
                    self._latencies.append(now - req.t_enqueue)
                    self._counters["served"] += 1
            for req, est in zip(live, results):
                req.future.set_result(est)

    def _score(self, designs: "Sequence[Design]") -> "list[Estimate]":
        """One batched scoring pass (the only caller of the estimator):
        ``estimate_many`` on the session's device, unpadded."""
        return self.session.estimate_many(list(designs))

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _as_cached(est: "Estimate", design: "Design") -> "Estimate":
        return dataclasses.replace(est, design=design, cached=True)

    def _fail(self, req: _Request, exc: BaseException) -> None:
        with self._lock:
            self._counters["errors"] += 1
            cur = self._inflight.get(req.key)
            if cur is req.future:
                self._inflight.pop(req.key, None)
        if not req.future.done():
            req.future.set_exception(exc)
