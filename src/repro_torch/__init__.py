"""repro_torch — the paper's analytical model of memory-bound HLS
applications, ported to PyTorch, with hand-written CUDA kernels for an
NVIDIA H100.

The JAX package ``repro`` stays beside it as the reference; this package
imports nothing from it (and no JAX) and keeps its own copy of what it
needs.  The public surface mirrors ``repro``'s for the paper's loop —
describe a design, score it with Eqs. 1-10, validate the model against
measured kernels:

    >>> import repro_torch as rt
    >>> sess = rt.Session()                         # the CUDA card
    >>> d = rt.Design.microbench(rt.LsuType.BC_ALIGNED, n_ga=4)
    >>> sess.estimate(d).t_exe
    >>> sess.sweep(rt.Space.grid(n_ga=[1, 2, 4], simd=[1, 16])).top_k(3)
    >>> sess.validate()                             # membench + decode kernels

``Session(device="cpu")`` runs the same pipeline on the CPU, with the
kernels' plain PyTorch versions in place of the CUDA kernels.
"""
from repro_torch import hw
from repro_torch.api import (
    BACKENDS,
    Design,
    Estimate,
    Report,
    Session,
    Space,
    SweepReport,
    ValidateReport,
)
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.lsu import Lsu, LsuType, make_global_access
from repro_torch.hw import ClockDomain, DramOrganization, Hardware, MemorySystem
from repro_torch.search import ResourceEnvelope

DDR4_1866 = hw.get("stratix10_ddr4_1866").dram_params()
DDR4_2666 = hw.get("stratix10_ddr4_2666").dram_params()
STRATIX10_BSP = hw.get("stratix10_ddr4_1866").bsp_params()

__all__ = [
    "Design", "Session", "Space", "Estimate", "Report", "SweepReport",
    "ValidateReport", "BACKENDS",
    "hw", "Hardware", "MemorySystem", "DramOrganization", "ClockDomain",
    "ResourceEnvelope",
    "Lsu", "LsuType", "make_global_access",
    "DramParams", "BspParams", "DDR4_1866", "DDR4_2666", "STRATIX10_BSP",
]
