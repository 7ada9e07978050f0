"""Event-driven DRAM timing simulator — the validation oracle.

Port of ``repro.core.dramsim``: a sequential round-robin event loop in
plain Python on the host (an oracle, not a hot path).  Write-ACK addresses
come from ``np.random.default_rng(seed)``, so a :class:`SimResult` is
bit-equal to the reference's for the same seed.

The paper validates its closed-form model against a physical Stratix 10
board.  We have no board, so this module provides an *independent*
implementation of the memory system described in SII-B / Fig. 2: per-bank row
buffers, PRE/ACT row-miss latency, a shared data bus at ``bw_mem``, bank
interleaving at the controller granularity, and round-robin arbitration
between LSU streams.  The closed-form model (``core.model``) is cross-checked
against this simulator by property-based tests; agreement within the paper's
own error envelope (<~15 % for coalesced, <~28 % for ACK) is required.

Simplifications (shared with the paper's model): no refresh (~3.5 % effect,
SV-A1), fixed inter-command timing, single rank/channel (the devkit has one
DIMM), closed-page policy approximated by row-buffer state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.lsu import Lsu, LsuType
from repro_torch.core import model as _model
from repro_torch.core.model import _default_bsp


@dataclasses.dataclass
class Transaction:
    addr: int          # byte address
    nbytes: float      # transaction size
    is_write: bool
    serialized: bool = False    # atomic: next txn waits for this completion
    extra_latency: float = 0.0  # e.g. write-recovery round trip
    force_miss: bool = False    # closed-page semantics (atomics)


def _transactions_for_lsu(
    lsu: Lsu, dram: DramParams, bsp: BspParams, base_addr: int, rng: np.random.Generator
) -> Iterator[Transaction]:
    """Expand an LSU into the DRAM transaction stream its coalescer emits.

    * BC aligned: maximal ``2**burst_cnt * dq * bl`` transactions streaming a
      physical extent of ``useful * delta`` bytes (the coalescer always
      fetches whole bursts; a stride makes 1/delta of each useful).
    * BC non-aligned: the ``max_th`` / page triggers cap each assembled
      request at ``burst_size`` *useful* bytes, i.e. a physical window of
      ``burst_size * delta`` bytes per request.
    * Write-ACK: one min-burst per access at a data-dependent address inside
      the array footprint (``span_bytes``); writes pay the recovery time.
    * Atomic: strictly serialized read-modify-write with closed-page
      semantics (each command re-opens the row — the Eq. 10 behaviour).
    """
    if lsu.lsu_type is LsuType.ATOMIC_PIPELINED:
        for _ in range(lsu.ls_acc):
            yield Transaction(base_addr, dram.min_burst_bytes, False,
                              serialized=True, force_miss=True)
            # write recovery is charged at the forced row re-open in run()
            yield Transaction(base_addr, dram.min_burst_bytes, True,
                              serialized=True, force_miss=True)
        return

    if lsu.lsu_type is LsuType.BC_WRITE_ACK:
        span = lsu.span_bytes or max(dram.min_burst_bytes, lsu.total_bytes)
        n_blocks = max(1, span // dram.min_burst_bytes)
        blocks = rng.integers(0, n_blocks, size=lsu.ls_acc)
        for b in blocks:
            # write-recovery (t_WR) is paid on row transitions, not per
            # pipelined same-row write — handled in run() at miss time.
            yield Transaction(base_addr + int(b) * dram.min_burst_bytes,
                              dram.min_burst_bytes, lsu.is_write)
        return

    # Burst-coalesced streaming (aligned / cache / prefetch / non-aligned).
    bsz = _model.burst_size_bytes(lsu, dram, bsp)       # useful bytes/request
    if lsu.lsu_type in (LsuType.BC_ALIGNED, LsuType.BC_CACHE):
        # maximal transactions streaming the whole strided extent
        physical = int(bsz)
        n = max(1, math.ceil(lsu.total_bytes * lsu.delta / physical))
    else:
        # one assembled request per `bsz` useful bytes, spanning bsz*delta
        physical = max(dram.min_burst_bytes, int(round(bsz * lsu.delta)))
        n = max(1, math.ceil(lsu.total_bytes / bsz))
    for k in range(n):
        yield Transaction(base_addr + k * physical, physical, lsu.is_write)


@dataclasses.dataclass
class SimResult:
    t_total: float
    n_transactions: int
    n_row_misses: int

    @property
    def row_miss_rate(self) -> float:
        return self.n_row_misses / max(1, self.n_transactions)


class DramSimulator:
    """Round-robin arbiter + banked DRAM with a shared data bus."""

    def __init__(self, dram: DramParams, bsp: BspParams | None = None,
                 interleave_bytes: int = 1024, seed: int = 0):
        self.dram = dram
        self.bsp = bsp if bsp is not None else _default_bsp()
        self.interleave = interleave_bytes
        self.seed = seed

    def _bank_row(self, addr: int) -> tuple[int, int]:
        block = addr // self.interleave
        bank = block % self.dram.banks
        row = (block // self.dram.banks) // max(1, self.dram.row_bytes // self.interleave)
        return bank, row

    def run(self, lsus: Sequence[Lsu]) -> SimResult:
        dram, bsp = self.dram, self.bsp
        rng = np.random.default_rng(self.seed)
        # All LSU streams start block-aligned at congruent bases: large
        # contiguous allocations on the devkit start page-aligned, so
        # concurrent streams collide on banks (SII-B arbitration).
        streams = []
        drains = []   # write-buffer drain batch per stream (SII-B: the read
                      # and write arbiters are independent; buffered ACK
                      # writes drain in batches, restoring row locality)
        base = 0
        for lsu in lsus:
            if not lsu.lsu_type.is_global:
                continue
            txns = list(_transactions_for_lsu(lsu, dram, bsp, base, rng))
            if txns:
                streams.append(txns)
                drains.append(16 if (lsu.lsu_type is LsuType.BC_WRITE_ACK
                                     and lsu.is_write) else 1)
            base += 1 << 32  # far apart: distinct rows, congruent banks
        if not streams:
            return SimResult(0.0, 0, 0)

        open_row = [-1] * dram.banks
        bank_ready = [0.0] * dram.banks
        bus_free = 0.0
        ptr = [0] * len(streams)
        stream_ready = [0.0] * len(streams)
        n_txn = 0
        n_miss = 0
        done = 0
        i = -1
        budget = 0
        while done < len(streams):
            # round-robin arbitration; write-buffered streams drain in batches
            if budget <= 0 or ptr[i] >= len(streams[i]):
                i = (i + 1) % len(streams)
                budget = drains[i]
            if ptr[i] >= len(streams[i]):
                budget = 0
                continue
            budget -= 1
            txn = streams[i][ptr[i]]
            ptr[i] += 1
            if ptr[i] == len(streams[i]):
                done += 1
            bank, row = self._bank_row(txn.addr)
            arrival = stream_ready[i]
            act_done = max(bank_ready[bank], arrival)
            if txn.force_miss or open_row[bank] != row:
                act_done += dram.t_row
                if txn.is_write:
                    act_done += dram.t_wr   # write recovery before re-open
                open_row[bank] = row
                n_miss += 1
            start = max(bus_free, act_done)
            end = start + txn.nbytes / dram.bw_mem + txn.extra_latency
            bus_free = end
            bank_ready[bank] = end
            n_txn += 1
            if txn.serialized:
                stream_ready[i] = end
        return SimResult(bus_free, n_txn, n_miss)


def simulate(lsus: Sequence[Lsu], dram: DramParams,
             bsp: BspParams | None = None, seed: int = 0,
             interleave_bytes: int = 1024) -> SimResult:
    """One-shot simulation; ``interleave_bytes`` is the controller
    interleave granularity (``repro_torch.hw`` specs carry it as
    ``Hardware.dram.interleave_bytes``)."""
    return DramSimulator(dram, bsp, interleave_bytes=interleave_bytes,
                         seed=seed).run(lsus)
