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
    >>> sess.sweep(rt.Space.grid(n_ga=list(range(1, 101))).stream())
    >>> sess.optimize(rt.Space.grid(n_ga=list(range(1, 101))))
    >>> sess.validate()                             # the seven-kernel table
    >>> with sess.serve() as srv: srv.estimate(d)   # micro-batched + cached
    >>> sess.predict(hlo_text)                      # compiled HLO -> step time
    >>> from repro_torch.configs import get_config
    >>> sess.estimate_model(get_config("qwen2-7b"),     # a whole model step,
    ...                     phases=("prefill", "decode"))  # captured op by op

``Session(device="cpu")`` runs the same pipeline on the CPU, with the
kernels' plain PyTorch versions in place of the CUDA kernels.
"""
from repro_torch import hw
from repro_torch.api import (
    BACKENDS,
    DEFAULT_CHUNK,
    EXECUTORS,
    Design,
    Estimate,
    Report,
    RequestTimeout,
    RooflineReport,
    Server,
    ServerClosed,
    ServerOverloaded,
    Session,
    Space,
    SweepPlan,
    SweepReport,
    AutotuneReport,
    ValidateReport,
)
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.hbm import AccessClass, TpuParams
from repro_torch.core.lsu import Lsu, LsuType, make_global_access
from repro_torch.hw import ClockDomain, DramOrganization, Hardware, MemorySystem
from repro_torch.search import (
    Constraint,
    OptimizeReport,
    ResourceEnvelope,
    within,
)
# Whole-model estimation (Session.estimate_model / plan_model / sweep_model
# return these).
from repro_torch.workload import (
    ModelReport,
    ModelSweepPlan,
    ModelSweepReport,
    OpEstimate,
    OpRecord,
    PhaseReport,
)

DDR4_1866 = hw.get("stratix10_ddr4_1866").dram_params()
DDR4_2666 = hw.get("stratix10_ddr4_2666").dram_params()
STRATIX10_BSP = hw.get("stratix10_ddr4_1866").bsp_params()
DRAM_CONFIGS = {d.name: d for d in (DDR4_1866, DDR4_2666)}
#: The TPU-model chip parameters (a datasheet input of the HLO predictor,
#: not a measurement of the card the port runs on).
TPU_V5E = hw.get("tpu_v5e").tpu_params()

#: The API version of the reference package this port mirrors.
__version__ = "0.9.0"

__all__ = [
    "Design", "Session", "Space", "Estimate", "Report", "SweepPlan",
    "SweepReport", "AutotuneReport", "ValidateReport", "RooflineReport",
    "BACKENDS",
    "EXECUTORS", "DEFAULT_CHUNK", "ResourceEnvelope", "Constraint", "within",
    "OptimizeReport",
    "ModelReport", "PhaseReport", "OpEstimate", "OpRecord",
    "ModelSweepPlan", "ModelSweepReport",
    "Server", "ServerClosed", "ServerOverloaded", "RequestTimeout",
    "hw", "Hardware", "MemorySystem", "DramOrganization", "ClockDomain",
    "Lsu", "LsuType", "make_global_access",
    "DramParams", "BspParams", "DDR4_1866", "DDR4_2666", "DRAM_CONFIGS",
    "STRATIX10_BSP",
    "TpuParams", "TPU_V5E", "AccessClass",
    "__version__",
]
