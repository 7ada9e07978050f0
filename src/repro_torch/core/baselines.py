"""Reimplementations of the two state-of-the-art models the paper compares
against in Table V (port of ``repro.core.baselines``).

The original tools are not public (paper SIV: "their dynamic profiling tools
feeding the models are not publicly available"), so — like the paper's
authors, who "manually computed their estimations" — we reimplement the
*memory components* of each model as described in the respective papers and
in our paper's SV-C / SVI analysis:

* **Wang** [6] (HPCA'16): coarse-grain memory model.  Global accesses are
  charged at a fixed effective bandwidth calibrated once on the original
  evaluation board (Stratix V + DDR3-1600); LSU modifiers are not
  distinguished ("incomplete support of all LSU modifiers"), strides are
  folded into the coalesced stream, and the DRAM parameters (frequency, row
  misses) are not inputs — so the model cannot adapt when the BSP memory
  changes (the DDR4-2666 rows of Table V).  Data-dependent accesses fall
  outside the pipelined-coalesced assumption and are charged the full
  unpipelined DRAM round trip per access, which produces the 8049 % / 11279 %
  ACK signatures.

* **HLScope+** [7] (ICCAD'17): memory time = bytes / characterized bandwidth
  plus a board-characterized controller overhead ``Tco`` per DRAM burst
  (SV-C: "Tco = 2.5 ns for #lsu > 3, Tco = 0 ns in other cases").  The
  characterization is performed once per board at nominal frequency, so a
  different DRAM clock degrades accuracy; stride/data-dependence enter only
  through a fixed efficiency factor.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.fpga import DramParams
from repro_torch.core.lsu import Lsu, LsuType
from repro_torch.hw import DEFAULT_BOARD, get as _hw_get

# Wang [6] calibration constants (Stratix V devkit, DDR3-1600: 12.8 GB/s
# theoretical; ~85 % achievable in their microbenchmarks).
_WANG_BW = 12.8e9 * 0.85
# Unpipelined DRAM round trip charged per data-dependent access (CAS + row
# cycle + controller/PCIe-side queueing on their measurement path).
_WANG_RANDOM_LATENCY = 150e-9

# HLScope+ characterization (performed at DDR4-1866 nominal).
_HLSCOPE_BW = (_hw_get(DEFAULT_BOARD).dram_params().bw_mem
               * 0.92)                    # characterized stream bandwidth
_HLSCOPE_TCO_MANY_LSU = 2.5e-9            # SV-C: Tco=2.5ns for #lsu>3
_HLSCOPE_BURST_BYTES = 512                # their fixed burst granularity
_HLSCOPE_RANDOM_EFF = 0.5                 # efficiency knob for irregular LSUs


def wang_estimate(lsus: Sequence[Lsu], dram: DramParams) -> float:
    """Wang [6]: fixed-bandwidth coalesced model, latency-serial for
    data-dependent accesses.  ``dram`` is ignored by design — that is the
    model's documented weakness."""
    del dram
    t = 0.0
    for lsu in lsus:
        if not lsu.lsu_type.is_global:
            continue
        if lsu.lsu_type in (LsuType.BC_WRITE_ACK, LsuType.ATOMIC_PIPELINED):
            t += lsu.ls_acc * _WANG_RANDOM_LATENCY
        else:
            # stride collapses into the coalesced stream (useful bytes only)
            t += lsu.total_bytes / _WANG_BW
    return t


def hlscope_estimate(lsus: Sequence[Lsu], dram: DramParams) -> float:
    """HLScope+ [7]: characterized bandwidth + per-burst controller overhead.

    The characterization constants are tied to the board at DDR4-1866; the
    model reuses them verbatim at other DRAM frequencies (Table V, lower
    half).
    """
    del dram
    glob = [l for l in lsus if l.lsu_type.is_global]
    n_lsu = len(glob)
    tco = _HLSCOPE_TCO_MANY_LSU if n_lsu > 3 else 0.0
    t = 0.0
    for lsu in glob:
        eff = 1.0
        if lsu.lsu_type in (LsuType.BC_WRITE_ACK, LsuType.ATOMIC_PIPELINED,
                            LsuType.BC_NON_ALIGNED):
            eff = _HLSCOPE_RANDOM_EFF
        bytes_moved = lsu.total_bytes
        t += bytes_moved / (_HLSCOPE_BW * eff)
        t += (bytes_moved / _HLSCOPE_BURST_BYTES) * tco
    return t
