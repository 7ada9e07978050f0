"""The port's serving layer (``Session.serve`` / ``Server``) on the CPU.

The reference's 24 serving tests (``tests/test_serve.py``) run against the
port's ``Server``: N threads of concurrent estimates are bit-equal to serial
``Session.estimate`` whatever batch each request lands in, plus padding,
cache hits, in-flight coalescing, timeout/overload/drain/close and the
batch-composition sweep.  Added here: served == serial == the reference's
``numpy-batch`` bit for bit on designs of 3-24 LSU groups per kernel
under shuffled batch compositions (the fixed-order segment sum that keeps
this true on the card too), ``pad_group_batch`` equal to the reference's,
and the session salt keyed on the device.
"""
import dataclasses
import itertools
import threading
import time

import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core import model_batch as ref_mb
from repro.core import serving as ref_serving
from repro_torch import Design, Session
from repro_torch.core import model_batch as mb
from repro_torch.core.cache import LruCache, config_hash
from repro_torch.core.lsu import LsuType
from repro_torch.core.serving import (
    RequestTimeout,
    Server,
    ServerClosed,
    ServerOverloaded,
    _next_pow2,
    _session_salt,
    pad_group_batch,
)

ALL_TYPES = [LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED,
             LsuType.BC_WRITE_ACK, LsuType.ATOMIC_PIPELINED]

BACKENDS = ["torch", "scalar"]


def cpu(**kw) -> Session:
    return Session(device="cpu", **kw)


def _combos():
    return itertools.cycle(
        (t, g, s, d) for t in ALL_TYPES for g in (1, 2, 3, 4)
        for s in (1, 4, 16) for d in (1, 3, 7))


def _pool(n: int, mod=Design) -> list:
    """``n`` distinct designs spanning every LSU type and stride (the
    reference's pool; ``mod`` picks which package builds them)."""
    ty = (lambda t: t) if mod is Design else \
        (lambda t: repro.LsuType(t.value))
    return [mod.microbench(ty(t), n_ga=g, simd=s, delta=d,
                           n_elems=1 << (12 + i % 4), name=f"pool-{i}")
            for i, (t, g, s, d) in zip(range(n), _combos())]


def _mixed_pool(n: int, mod=Design) -> list:
    """``n`` distinct designs of 3-24 LSU groups each, the LSU type cycling
    fastest (write-ACK designs carry ``n_ga + simd`` groups)."""
    ty = (lambda t: t) if mod is Design else \
        (lambda t: repro.LsuType(t.value))
    combos = itertools.cycle(
        (t, g, s, d) for g in (3, 4, 6, 8) for s in (4, 16) for d in (1, 3)
        for t in ALL_TYPES)
    return [mod.microbench(ty(t), n_ga=g, simd=s, delta=d,
                           n_elems=1 << (12 + i % 5), name=f"mixed-{i}")
            for i, (t, g, s, d) in zip(range(n), combos)]


def _eq(a, b) -> None:
    """Bit-equality of the numeric surface (not `design`/`cached` metadata)."""
    assert a.t_exe == b.t_exe
    assert a.t_ideal == b.t_ideal
    assert a.t_ovh == b.t_ovh
    assert a.bound_ratio == b.bound_ratio
    assert a.memory_bound == b.memory_bound
    assert a.total_bytes == b.total_bytes
    assert a.n_lsu == b.n_lsu


class TestHammer:
    """Concurrent == serial, bit for bit."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_concurrent_bit_equal_to_serial(self, backend):
        sess = cpu(backend=backend)
        designs = _pool(48)
        serial = {d.name: sess.estimate(d) for d in designs}
        results: dict[int, list] = {}
        errors: list[BaseException] = []

        def client(tid: int) -> None:
            rng = np.random.default_rng(tid)
            order = rng.permutation(len(designs))
            out = []
            try:
                for i in order:
                    out.append(srv.estimate(designs[i]))
            except BaseException as exc:  # noqa: BLE001 — surface in main thread
                errors.append(exc)
            results[tid] = out

        # cache off: every request goes through the batcher (coalescing is
        # still allowed — a coalesced future is a batcher-scored row too)
        with sess.serve(max_batch=16, max_wait_ms=0.5, cache_size=0) as srv:
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            stats = srv.stats()
        assert not errors
        n_results = 0
        for out in results.values():
            for est in out:
                _eq(est, serial[est.design.name])
                n_results += 1
        assert n_results == 8 * len(designs)
        assert stats["batches"] >= 1 and stats["error_rate"] == 0.0

    def test_result_carries_callers_design(self):
        """Coalesced or cached, `est.design` is the submitted object's name."""
        sess = cpu()
        d = Design.microbench(LsuType.BC_ALIGNED, n_ga=2, name="mine")
        with sess.serve() as srv:
            assert srv.estimate(d).design.name == "mine"
            assert srv.estimate(d).design.name == "mine"   # cached path


class TestDeterminism:
    """Per-design results are independent of which batch the design lands
    in, what its neighbours are, and where in the batch it sits."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_batch_composition_independence(self, backend, seed):
        sess = cpu(backend=backend)
        designs = _pool(24)
        serial = {d.name: sess.estimate(d) for d in designs}
        srv = sess.serve(max_batch=len(designs))
        try:
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(designs))
            cuts = np.sort(rng.choice(
                np.arange(1, len(designs)), size=5, replace=False))
            for chunk in np.split(order, cuts):
                if not len(chunk):
                    continue
                batch = [designs[i] for i in chunk]
                for d, est in zip(batch, srv._score(batch)):
                    _eq(est, serial[d.name])
        finally:
            srv.close()


class TestAgainstReference:
    """Served == serial == the reference's ``numpy-batch``, bit for bit."""

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_shuffled_batches_equal_reference(self, seed):
        designs = _mixed_pool(64)
        ref_designs = {d.name: d for d in _mixed_pool(64, repro.Design)}
        ref = repro.Session(backend="numpy-batch")
        want = {name: ref.estimate(d) for name, d in ref_designs.items()}
        # every design has >= 3 LSU groups, where a segment sum's order
        # shows (write-ACK designs up to 24)
        groups = [mb.GroupBatch.from_kernels(
            [list(d.lsus)], cpu().dram).kernel.size for d in designs]
        assert max(groups) >= 20 and min(groups) >= 3
        sess = cpu()
        rng = np.random.default_rng(seed)
        srv = sess.serve(max_batch=len(designs))
        try:
            order = rng.permutation(len(designs))
            cuts = np.sort(rng.choice(np.arange(1, len(designs)), size=7,
                                      replace=False))
            for chunk in np.split(order, cuts):
                batch = [designs[i] for i in chunk]
                for d, est in zip(batch, srv._score(batch)):
                    _eq(est, want[d.name])
                    _eq(est, sess.estimate(d))
        finally:
            srv.close()
        with sess.serve(max_batch=8, max_wait_ms=0.5, cache_size=0) as srv:
            futs = [srv.submit(designs[i]) for i in rng.permutation(64)]
            for f in futs:
                est = f.result(timeout=30)
                _eq(est, want[est.design.name])

    def test_segment_sum_is_bincount_order(self):
        """The fixed-order segment sum equals ``np.bincount`` for kernels in
        any interleaving, with rounding that a pairwise order would change."""
        rng = np.random.default_rng(5)
        kernel = rng.integers(0, 7, size=200)
        data = rng.standard_normal(200) * 10.0 ** rng.integers(-8, 8, 200)
        seg = mb._fixed_order_segments(torch.as_tensor(kernel), 9)
        got = seg(torch.as_tensor(data)).numpy()
        np.testing.assert_array_equal(
            got, np.bincount(kernel, weights=data, minlength=9))
        assert got[7] == 0.0 and got[8] == 0.0

    def test_no_index_add_on_the_estimate_path(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("index_add on the estimate path")

        monkeypatch.setattr(torch.Tensor, "index_add", boom)
        monkeypatch.setattr(torch.Tensor, "index_add_", boom)
        sess = cpu()
        with sess.serve() as srv:
            for d in _pool(6):
                _eq(srv.estimate(d), sess.estimate(d))


class TestPadding:
    """pad_group_batch: fixed shapes, bit-equal real rows."""

    def _batch(self, designs):
        sess = cpu()
        hw = [sess._hw_for(d) for d in designs]
        return mb.GroupBatch.from_kernels(
            [list(d.lsus) for d in designs],
            [h[0] for h in hw], [h[1] for h in hw],
            f=[d.f for d in designs])

    def test_padded_rows_bit_equal(self):
        designs = _pool(5)
        batch = self._batch(designs)
        m = len(np.asarray(batch.kernel))
        padded = pad_group_batch(batch, batch.n_kernels + 3, _next_pow2(m) * 2)
        ref = mb.estimate_batch(batch, device="cpu")
        got = mb.estimate_batch(padded, device="cpu")
        for fld in ("t_exe", "t_ideal", "t_ovh", "total_bytes"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, fld))[:batch.n_kernels],
                np.asarray(getattr(ref, fld)))

    def test_padded_batch_equals_reference_padding(self):
        """Same columns as the reference's ``pad_group_batch``, and the
        padded estimate's rows equal the reference's ``numpy-batch``."""
        designs = _pool(7)
        ref_designs = _pool(7, repro.Design)
        batch = self._batch(designs)
        rs = repro.Session()
        rhw = [rs._hw_for(d) for d in ref_designs]
        ref_batch = ref_mb.GroupBatch.from_kernels(
            [list(d.lsus) for d in ref_designs],
            [h[0] for h in rhw], [h[1] for h in rhw],
            f=[d.f for d in ref_designs])
        m = len(np.asarray(batch.kernel))
        got = pad_group_batch(batch, 12, _next_pow2(m) * 2)
        want = ref_serving.pad_group_batch(ref_batch, 12, _next_pow2(m) * 2)
        for f in dataclasses.fields(mb.GroupBatch):
            np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                          np.asarray(getattr(want, f.name)),
                                          f.name)
        est = mb.estimate_batch(got, device="cpu")
        ref_est = ref_mb.estimate_batch(want)
        for fld in ("t_exe", "t_ideal", "t_ovh", "bound_ratio",
                    "total_bytes", "n_lsu", "memory_bound"):
            np.testing.assert_array_equal(getattr(est, fld),
                                          getattr(ref_est, fld), fld)

    def test_exact_shape_is_identity(self):
        batch = self._batch(_pool(3))
        m = len(np.asarray(batch.kernel))
        assert pad_group_batch(batch, batch.n_kernels, m) is batch

    def test_oversized_batch_rejected(self):
        batch = self._batch(_pool(4))
        with pytest.raises(ValueError, match="exceeds"):
            pad_group_batch(batch, batch.n_kernels - 1, 1 << 10)

    def test_next_pow2(self):
        assert [_next_pow2(n) for n in (1, 2, 3, 64, 65)] == \
            [1, 2, 4, 64, 128]


class TestCache:
    def test_hit_is_equal_and_marked(self):
        sess = cpu()
        d = _pool(1)[0]
        with sess.serve() as srv:
            first = srv.estimate(d)
            second = srv.estimate(d)
            stats = srv.stats()
        assert first.cached is False
        assert second.cached is True
        _eq(second, first)
        _eq(first, sess.estimate(d))
        assert stats["cache"]["hits"] >= 1
        assert 0.0 < stats["cache_hit_rate"] <= 1.0

    def test_distinct_sessions_never_share_numbers(self):
        """The session salt keys hardware/calibration into the cache."""
        d = _pool(1)[0]
        a = cpu().serve()
        b = cpu().with_hardware(rt.hw.get("stratix10_ddr4_2666")).serve()
        try:
            ea, eb = a.estimate(d), b.estimate(d)
            assert ea.t_exe != eb.t_exe
            assert not eb.cached
        finally:
            a.close()
            b.close()

    def test_session_salt_keys_the_device(self):
        sess = cpu()
        other = dataclasses.replace(sess)
        object.__setattr__(other, "device", torch.device("cuda", 0))
        assert _session_salt(sess) != _session_salt(other)
        assert _session_salt(sess) == _session_salt(cpu())

    def test_lru_evicts_in_insertion_order(self):
        c = LruCache(2)
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1          # refresh a
        c.put("c", 3)                   # evicts b
        assert c.get("b") is None
        assert c.get("a") == 1 and c.get("c") == 3
        s = c.stats()
        assert s["size"] == 2 and s["hits"] == 3 and s["misses"] == 1

    def test_zero_capacity_disables_caching(self):
        c = LruCache(0)
        c.put("a", 1)
        assert c.get("a") is None and c.stats()["size"] == 0

    def test_config_hash_equals_reference(self):
        from repro.core.cache import config_hash as ref_hash

        for obj, salt in (({"a": [1, 2.5], "b": "x"}, ""),
                          ([3, None, True], "s"), ("plain", "serve")):
            assert config_hash(obj, salt=salt) == ref_hash(obj, salt=salt)

    def test_predict_memoizes(self):
        sess = cpu()
        calls = []
        real = sess.predict

        def counting_predict(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        object.__setattr__(sess, "predict", counting_predict)  # frozen dc
        hlo = ("HloModule m\n\n"
               "ENTRY e (p.0: f32[1024,1024]) -> f32[1024,1024] {\n"
               "  %p.0 = f32[1024,1024]{1,0} parameter(0)\n"
               "  ROOT %n = f32[1024,1024]{1,0} negate(%p.0)\n"
               "}\n")
        with sess.serve() as srv:
            a = srv.predict(hlo)
            b = srv.predict(hlo)
            c = srv.predict(hlo, gather_row_bytes=64.0)
        assert a is b                   # literally the cached object
        assert c is not a
        assert len(calls) == 2          # the parse ran once per key
        ref = repro.Session().predict(hlo)
        assert (a.t_memory, a.flops, a.hbm_bytes) == \
            (ref.t_memory, ref.flops, ref.hbm_bytes)


class TestCoalescing:
    def test_identical_inflight_designs_share_one_future(self):
        sess = cpu()
        d = _pool(1)[0]
        # long linger so all submits land while the first is still queued
        with sess.serve(max_batch=64, max_wait_ms=100.0, cache_size=0) as srv:
            futs = [srv.submit(d) for _ in range(16)]
            ests = [f.result(timeout=5) for f in futs]
            stats = srv.stats()
        assert len({id(f) for f in futs}) < 16
        assert stats["coalesced"] >= 1
        ref = sess.estimate(d)
        for est in ests:
            _eq(est, ref)


class TestTimeoutOverloadDrain:
    def test_blocking_estimate_times_out(self):
        sess = cpu()
        # batcher lingers 500 ms on the first request -> 20 ms budget expires
        with sess.serve(max_batch=8, max_wait_ms=500.0, cache_size=0) as srv:
            with pytest.raises(RequestTimeout):
                srv.estimate(_pool(1)[0], timeout_ms=20)

    def test_expired_request_fails_before_scoring(self):
        sess = cpu()
        designs = _pool(2)
        with sess.serve(max_batch=8, max_wait_ms=300.0, cache_size=0) as srv:
            ok = srv.submit(designs[0])                   # no deadline
            doomed = srv.submit(designs[1], timeout_ms=1)  # expires in queue
            assert ok.result(timeout=5).design.name == designs[0].name
            with pytest.raises(RequestTimeout):
                doomed.result(timeout=5)
            assert srv.stats()["expired"] == 1

    def test_overload_fast_fails(self):
        sess = cpu()
        designs = _pool(4)
        srv = sess.serve(max_batch=1, max_wait_ms=0.0, cache_size=0,
                         max_queue=1)
        release = threading.Event()
        real_score = srv._score

        def slow_score(batch):
            release.wait(timeout=10)
            return real_score(batch)

        srv._score = slow_score
        try:
            busy = srv.submit(designs[0])
            for _ in range(1000):                   # batcher picked [0] up
                if srv._queue.empty():
                    break
                time.sleep(1e-3)
            queued = srv.submit(designs[1])         # fills the 1-slot queue
            with pytest.raises(ServerOverloaded):
                srv.submit(designs[2])
            assert srv.stats()["rejected_overload"] == 1
            release.set()
            busy.result(timeout=5)
            queued.result(timeout=5)
            # the rejected key was cleaned up: a retry succeeds
            assert srv.estimate(designs[2]).design.name == designs[2].name
        finally:
            release.set()
            srv.close()

    def test_drain_completes_everything(self):
        sess = cpu()
        designs = _pool(20)
        srv = sess.serve(max_batch=4, max_wait_ms=5.0, cache_size=0)
        futs = [srv.submit(d) for d in designs]
        srv.drain(timeout_s=10)
        assert all(f.done() for f in futs)
        srv.close()
        assert srv.stats()["served"] == len(designs)


class TestLifecycle:
    def test_submit_after_close_raises(self):
        srv = cpu().serve()
        srv.close()
        assert srv.closed
        with pytest.raises(ServerClosed):
            srv.submit(_pool(1)[0])
        srv.close()                     # idempotent

    def test_graceful_close_scores_queued_work(self):
        sess = cpu()
        designs = _pool(10)
        srv = sess.serve(max_batch=4, max_wait_ms=50.0, cache_size=0)
        futs = [srv.submit(d) for d in designs]
        srv.close(drain=True)
        for d, f in zip(designs, futs):
            _eq(f.result(timeout=0), sess.estimate(d))

    def test_abrupt_close_fails_queued_work(self):
        sess = cpu()
        srv = sess.serve(max_batch=64, max_wait_ms=500.0, cache_size=0)
        futs = [srv.submit(d) for d in _pool(6)]
        srv.close(drain=False)
        failed = 0
        for f in futs:
            try:
                f.result(timeout=5)
            except ServerClosed:
                failed += 1
        assert failed >= 1              # first batch may already be in flight

    def test_context_manager_exception_skips_drain(self):
        with pytest.raises(RuntimeError, match="boom"):
            with cpu().serve(max_wait_ms=500.0, cache_size=0) as srv:
                srv.submit(_pool(1)[0])
                raise RuntimeError("boom")
        assert srv.closed

    def test_invalid_params_rejected(self):
        sess = cpu()
        for kw in ({"max_batch": 0}, {"max_wait_ms": -1.0},
                   {"max_queue": 0}, {"timeout_ms": 0}):
            with pytest.raises(ValueError):
                sess.serve(**kw)


class TestStatsAndSurface:
    def test_stats_shape(self):
        sess = cpu()
        with sess.serve() as srv:
            for d in _pool(8):
                srv.estimate(d)
            s = srv.stats()
        assert s["submitted"] == s["served"] == 8
        assert s["errors"] == 0 and s["error_rate"] == 0.0
        assert s["mean_batch"] >= 1.0
        lat = s["latency_ms"]
        assert lat["n"] == 8
        assert 0.0 < lat["p50"] <= lat["p99"]
        assert s["queue_depth"] == 0 and s["inflight"] == 0

    def test_public_surface(self):
        from repro_torch import api

        for name in ("Server", "ServerClosed", "ServerOverloaded",
                     "RequestTimeout"):
            assert name in api.__all__
            assert getattr(rt, name) is getattr(api, name)
        with cpu().serve() as srv:
            assert isinstance(srv, Server)
        assert rt.Estimate(
            t_exe=1.0, t_ideal=1.0, t_ovh=0.0, bound_ratio=1.0,
            memory_bound=True, total_bytes=1.0, n_lsu=1).cached is False
        assert [f.name for f in dataclasses.fields(rt.Estimate)] == \
            [f.name for f in dataclasses.fields(repro.Estimate)]

    def test_server_sweep_caches_the_report(self):
        sess = cpu()
        space = rt.Space.grid(n_ga=[1, 2, 4], simd=[1, 16])
        with sess.serve() as srv:
            a = srv.sweep(space)
            b = srv.sweep(space)
        assert a is b
        ref = repro.Session().sweep(repro.Space.grid(n_ga=[1, 2, 4],
                                                     simd=[1, 16]))
        np.testing.assert_array_equal(a.t_exe, ref.t_exe)

    def test_cuda_session_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session().serve()
