"""Coordinator/worker process pool for distributed streaming sweeps.

Port of ``repro.core.distributed``.  The streaming engine
(:mod:`repro_torch.core.stream`) made the chunk-aligned id interval the
natural work unit and every reducer mergeable, so distributing a sweep
needs no new math: the coordinator partitions ``[0, n)`` into chunk-aligned
*work units*, a ``spawn`` process pool folds each unit into fresh reducers
rebuilt from the picklable :class:`~repro_torch.core.stream.SweepPlan`,
and the coordinator merges the returned reducer states.  Every worker sees
exactly the chunks the single-process fold would (the one padded final
chunk included), so the merged result is bit-equal to the serial run.

Each worker rebuilds the evaluator from the plan and resolves the plan's
device itself: on a CUDA plan every worker opens its own CUDA context.
The pool always spawns — a forked child of a process that has initialized
CUDA cannot use the card.

Fault tolerance is re-issue based: a unit whose workers all died, or that
outlived ``straggler_timeout_s``, is handed to another worker; the first
returned state per unit wins and duplicates are dropped, so re-issue never
double-counts.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback

from repro_torch.core import stream as _stream

__all__ = ["run_distributed"]

_FAULT_ENV = "REPRO_TORCH_DIST_FAULT"


def _maybe_fault(uid: int) -> None:
    """Test hook: inject a one-shot worker fault for work unit ``uid``.

    ``REPRO_TORCH_DIST_FAULT="<uid>:<kind>:<marker-path>"`` makes the *first*
    worker to start that unit fail — ``kind="kill"`` hard-exits the
    process, ``kind="hang"`` sleeps past any sane straggler timeout.  The
    marker file records that the fault already fired so the re-issued
    attempt succeeds.  No-op unless the variable is set.
    """
    spec = os.environ.get(_FAULT_ENV)
    if not spec:
        return
    fuid, kind, marker = spec.split(":", 2)
    if int(fuid) != uid or os.path.exists(marker):
        return
    with open(marker, "w") as fh:
        fh.write(f"{kind} fired in pid {os.getpid()}\n")
    if kind == "kill":
        time.sleep(0.2)     # let the queue feeder flush the "start" message
        os._exit(17)
    if kind == "hang":
        time.sleep(60.0)


def _worker_main(plan, task_q, result_q) -> None:
    """Worker loop: build the range folder once, fold units until sentinel.

    The folder (:func:`repro_torch.core.stream.make_range_folder`) takes
    the device fold on the torch backend when the plan and reducers
    qualify, and the host ``plan.run_range`` pipeline otherwise — the same
    bit-equal dispatch ``Session.sweep`` makes in-process.

    Messages out: ``("start", uid, pid)`` when a unit begins (feeds the
    coordinator's straggler/death bookkeeping), ``("ok", uid, states)``
    with one ``state_dict()`` per reducer on success, ``("err", uid, tb)``
    on failure (``uid == -1`` if the evaluator itself failed to build).
    """
    try:
        fold_range = _stream.make_range_folder(plan)
    except BaseException:
        result_q.put(("err", -1, traceback.format_exc()))
        return
    while True:
        task = task_q.get()
        if task is None:
            return
        uid, lo, hi, reducer_states = task
        try:
            result_q.put(("start", uid, os.getpid()))
            _maybe_fault(uid)
            reducers = [cls.from_state(s) for cls, s in reducer_states]
            fold_range(lo, hi, reducers)
            result_q.put(("ok", uid, [r.state_dict() for r in reducers]))
        except BaseException:
            result_q.put(("err", uid, traceback.format_exc()))


def _units(n_chunks: int, chunk_size: int, n: int,
           unit_chunks: int) -> list[tuple[int, int, int]]:
    """Partition the chunk grid into ``(uid, lo, hi)`` work units."""
    units = []
    for uid, c0 in enumerate(range(0, n_chunks, unit_chunks)):
        lo = c0 * chunk_size
        hi = min((c0 + unit_chunks) * chunk_size, n)
        units.append((uid, lo, hi))
    return units


def run_distributed(plan, reducers, *, workers: int | None = None,
                    unit_chunks: int | None = None,
                    straggler_timeout_s: float = 30.0,
                    max_issues: int = 4,
                    poll_s: float = 0.05) -> "_stream.StreamOutcome":
    """Fold ``plan`` into ``reducers`` across a spawn-based process pool.

    The caller's ``reducers`` receive the merged result in place (mirroring
    ``run_stream``) and come back inside the returned
    :class:`~repro_torch.core.stream.StreamOutcome`.  ``unit_chunks`` sets the
    work-unit size in chunks (default: ~4 units per worker so stragglers
    cost a fraction of the sweep, never a full worker share).  A unit is
    re-issued when every worker that started it died, or when it has not
    completed ``straggler_timeout_s`` after a worker started it (a unit
    still queued is not late: a spawned worker may take seconds to import
    torch); a straggler's re-issue also spawns a worker in place of the
    busy one, within the respawn budget.  Each unit is issued at most
    ``max_issues`` times before the sweep fails.
    """
    n, chunk = plan.n, plan.chunk_size
    n_chunks = plan.n_chunks
    reducers = tuple(reducers)
    if n_chunks == 0:       # empty grid: nothing to distribute
        return _stream.StreamOutcome(reducers=reducers, n_points=n,
                                     n_chunks=0, chunk_size=chunk)
    if workers is None:
        workers = min(4, os.cpu_count() or 1)
    if workers < 1:
        raise ValueError("workers must be >= 1")
    if unit_chunks is None:
        unit_chunks = max(1, -(-n_chunks // (4 * workers)))
    units = _units(n_chunks, chunk, n, unit_chunks)
    workers = min(workers, len(units))

    # Workers rebuild each unit's reducers from these states so custom
    # Reducer subclasses keep their configuration (k, key, objectives)
    # without the coordinator knowing their constructor signatures.
    protos = [(type(r), r.fresh().state_dict()) for r in reducers]

    ctx = mp.get_context("spawn")
    task_q = ctx.Queue()
    result_q = ctx.Queue()

    def spawn() -> "mp.Process":
        p = ctx.Process(target=_worker_main, args=(plan, task_q, result_q),
                        daemon=True)
        p.start()
        return p

    pool = [spawn() for _ in range(workers)]
    done: dict[int, list] = {}              # uid -> reducer states (first wins)
    issues = {uid: 0 for uid, _, _ in units}
    starters: dict[int, set[int]] = {uid: set() for uid, _, _ in units}
    last_event = {uid: time.monotonic() for uid, _, _ in units}
    by_uid = {uid: (lo, hi) for uid, lo, hi in units}
    respawns_left = max_issues * workers
    all_dead: set[int] = set()              # every worker pid that ever died

    def issue(uid: int) -> None:
        lo, hi = by_uid[uid]
        issues[uid] += 1
        last_event[uid] = time.monotonic()
        # Forget prior starters: the unit is only "dead" again once a *new*
        # attempt starts and that worker dies too (prevents re-issuing every
        # poll tick against the same dead pids).
        starters[uid].clear()
        task_q.put((uid, lo, hi, protos))

    def shutdown() -> None:
        for _ in pool:
            task_q.put(None)
        for p in pool:
            p.join(timeout=2.0)
        for p in pool:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        task_q.cancel_join_thread()
        result_q.cancel_join_thread()

    try:
        for uid, _, _ in units:
            issue(uid)
        while len(done) < len(units):
            try:
                msg = result_q.get(timeout=poll_s)
            except queue.Empty:
                msg = None
            if msg is not None:
                kind, uid, payload = msg
                if kind == "start":
                    starters[uid].add(payload)
                    last_event[uid] = time.monotonic()
                elif kind == "ok":
                    done.setdefault(uid, payload)   # first result wins
                elif kind == "err":
                    raise RuntimeError(
                        f"distributed sweep worker failed on unit {uid}:\n"
                        f"{payload}")
                continue
            # No result this tick: sweep the pool for deaths and stragglers.
            dead = {p.pid for p in pool if not p.is_alive()}
            if dead:
                all_dead |= dead
                alive = [p for p in pool if p.is_alive()]
                for p in pool:
                    if not p.is_alive():
                        p.join()
                        if respawns_left > 0:
                            respawns_left -= 1
                            alive.append(spawn())
                pool = alive
                if not pool:
                    raise RuntimeError(
                        "distributed sweep: every worker died and the "
                        "respawn budget is exhausted")
            now = time.monotonic()
            for uid, _, _ in units:
                if uid in done:
                    continue
                died = bool(starters[uid]) and starters[uid] <= all_dead
                # a unit no worker has started yet is queued, not late:
                # spawned workers may take seconds to import torch
                stale = (bool(starters[uid])
                         and now - last_event[uid] > straggler_timeout_s)
                if died or stale:
                    if issues[uid] >= max_issues:
                        raise RuntimeError(
                            f"distributed sweep: work unit {uid} "
                            f"(ids [{by_uid[uid][0]}, {by_uid[uid][1]})) "
                            f"failed after {issues[uid]} issues")
                    if stale and not died and respawns_left > 0:
                        # the straggler's worker is still busy: add one in
                        # its place, so the re-issued unit has a taker
                        respawns_left -= 1
                        pool.append(spawn())
                    issue(uid)
    finally:
        shutdown()

    for uid in sorted(done):
        for base, state in zip(reducers, done[uid]):
            base.merge(type(base).from_state(state))
    return _stream.StreamOutcome(reducers=reducers, n_points=n,
                                 n_chunks=n_chunks, chunk_size=chunk)
