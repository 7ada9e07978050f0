"""LSU taxonomy of the Intel FPGA SDK Global Memory Interconnect (paper Table I).

Each *global access* (GA) in the OpenCL source is translated by the HLS
compiler into one or several Load/Store Units.  The LSU type is decided by a
static analysis of the index expression:

=====================  ==========  =====  ======  =============================
LSU type               Pipelined   Burst  Atomic  index pattern
=====================  ==========  =====  ======  =============================
BC_ALIGNED             yes         yes    --      ``x[i]`` contiguous, page-aligned
BC_NON_ALIGNED         yes         yes    --      ``x[3*i+1]`` strided / offset
BC_WRITE_ACK           yes         yes    --      ``x[j]`` data-dependent index
BC_CACHE               yes         yes    --      repeated data-dependent index
PREFETCHING            --          yes    --      compiled as BC_ALIGNED (high-end)
CONSTANT_PIPELINED     yes         --     --      ``cn[i]`` constant cache (on-chip)
PIPELINED              yes         --     --      local-memory access (on-chip)
ATOMIC_PIPELINED       yes         --     yes     ``atomic_add(&x[0], 1)``
=====================  ==========  =====  ======  =============================

Only the GMI types (burst-coalesced family + atomic) touch DRAM and are
modelled; the on-chip types never reach the memory controller.
"""
from __future__ import annotations

import dataclasses
import enum


class LsuType(enum.Enum):
    BC_ALIGNED = "bc_aligned"
    BC_NON_ALIGNED = "bc_non_aligned"
    BC_WRITE_ACK = "bc_write_ack"
    BC_CACHE = "bc_cache"
    PREFETCHING = "prefetching"
    CONSTANT_PIPELINED = "constant_pipelined"
    PIPELINED = "pipelined"
    ATOMIC_PIPELINED = "atomic_pipelined"

    @property
    def is_global(self) -> bool:
        """True if this LSU issues DRAM traffic through the GMI."""
        return self in _GLOBAL_TYPES

    @property
    def is_burst(self) -> bool:
        return self in (
            LsuType.BC_ALIGNED,
            LsuType.BC_NON_ALIGNED,
            LsuType.BC_WRITE_ACK,
            LsuType.BC_CACHE,
            LsuType.PREFETCHING,
        )


_GLOBAL_TYPES = frozenset(
    {
        LsuType.BC_ALIGNED,
        LsuType.BC_NON_ALIGNED,
        LsuType.BC_WRITE_ACK,
        LsuType.BC_CACHE,
        LsuType.PREFETCHING,
        LsuType.ATOMIC_PIPELINED,
    }
)


@dataclasses.dataclass(frozen=True)
class Lsu:
    """One load/store unit, as read from the early compilation report.

    Attributes mirror paper Table II (``Report``/``Verilog``/``User`` rows):

    * ``lsu_type``  -- from the HTML report (``aocl -rtl``).
    * ``ls_width``  -- memory width of the LSU in bytes; SIMD vectorization by
      factor ``f`` widens the LSU: ``ls_width = f * elem_bytes`` (except
      WRITE_ACK/atomic, where the compiler instead replicates the LSU).
    * ``ls_acc``    -- number of accesses this LSU performs (dynamic count;
      user-supplied for dynamic loops, inferable otherwise).
    * ``ls_bytes``  -- bytes of a single access.
    * ``delta``     -- address stride of the access pattern (1 = contiguous).
    * ``is_write``  -- direction (read/write arbiters are independent).
    * ``val_constant`` -- atomic only: the summed value is loop-constant, so
      the compiler merges ``f`` atomic updates into one (Eq. 10 `/f` case).
    """

    lsu_type: LsuType
    ls_width: int
    ls_acc: int
    ls_bytes: int
    delta: int = 1
    is_write: bool = False
    val_constant: bool = False
    name: str = ""
    # Address footprint of the accessed array [bytes].  Only used by the
    # simulator oracle (row-locality of data-dependent accesses); defaults to
    # the streamed extent.
    span_bytes: int | None = None

    def __post_init__(self):
        if self.ls_width <= 0 or self.ls_bytes <= 0:
            raise ValueError(f"LSU {self.name}: widths must be positive")
        if self.ls_acc < 0:
            raise ValueError(f"LSU {self.name}: ls_acc must be >= 0")
        if self.delta < 1:
            raise ValueError(f"LSU {self.name}: delta (stride) must be >= 1")
        if self.lsu_type is LsuType.ATOMIC_PIPELINED and self.delta != 1:
            raise ValueError("atomic-pipelined LSUs always have stride 1")

    @property
    def total_bytes(self) -> int:
        """Useful bytes this LSU moves: ls_acc * ls_bytes."""
        return self.ls_acc * self.ls_bytes


def make_global_access(
    lsu_type: LsuType,
    *,
    n_elems: int,
    elem_bytes: int = 4,
    f: int = 1,
    delta: int = 1,
    is_write: bool = False,
    val_constant: bool = False,
    name: str = "",
) -> list[Lsu]:
    """Expand one source-level *global access* into its LSU list.

    Mirrors the compiler behaviour described in the paper:

    * burst-coalesced aligned / non-aligned: one LSU whose ``ls_width`` is
      widened by the vectorization factor ``f`` (SIMD * unroll) and that
      performs ``n_elems / f`` vector accesses;
    * burst-coalesced write-ACK: ``ls_width`` stays at ``elem_bytes``; the
      compiler instead instantiates ``f`` LSUs per GA (paper SV-A3: "the
      compiler generates so many LSU as the desired SIMD by each global
      access"), each covering ``n_elems / f`` scalar accesses;
    * atomic-pipelined: like write-ACK, width never grows; one LSU per GA
      (atomics serialize; ``f`` enters via Eq. 10 instead).
    """
    if n_elems % max(f, 1):
        raise ValueError("n_elems must be divisible by the vectorization factor")
    if lsu_type in (LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED, LsuType.PREFETCHING, LsuType.BC_CACHE):
        return [
            Lsu(
                lsu_type=LsuType.BC_ALIGNED if lsu_type is LsuType.PREFETCHING else lsu_type,
                ls_width=f * elem_bytes,
                ls_acc=n_elems // f,
                ls_bytes=f * elem_bytes,
                delta=delta,
                is_write=is_write,
                name=name,
            )
        ]
    if lsu_type is LsuType.BC_WRITE_ACK:
        return [
            Lsu(
                lsu_type=lsu_type,
                ls_width=elem_bytes,
                ls_acc=n_elems // f,
                ls_bytes=elem_bytes,
                delta=delta,
                is_write=is_write,
                name=f"{name}[{k}]" if name else "",
            )
            for k in range(f)
        ]
    if lsu_type is LsuType.ATOMIC_PIPELINED:
        return [
            Lsu(
                lsu_type=lsu_type,
                ls_width=elem_bytes,
                ls_acc=n_elems,
                ls_bytes=elem_bytes,
                delta=1,
                is_write=True,
                val_constant=val_constant,
                name=name,
            )
        ]
    raise ValueError(f"{lsu_type} is an on-chip LSU; it has no GMI traffic")
