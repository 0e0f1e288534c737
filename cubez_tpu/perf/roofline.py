"""Analytic per-kernel cost model — flop/byte constants for roofline checks.

Flop-per-point constants mirror the reference's in-kernel flop accounting
(jacobi/psor 18: cz_solver.f90:238-241,315-318; sor2sma 18 per full RB pair:
cz_solver.f90:438-441; calc_ax 13 / calc_rk 14: cz_blas.f90:607-610,686-689;
triad 2 / dot 2 / bicg_1 4 / bicg_2 4: cz_blas.f90:278,341,407,471,536;
MAF point kernels 66: cz_maf.f90:50-53; PCR: cz_solver.f90:523-530,694-701).

Byte counts model the *minimal* device-memory traffic of an ideally fused
sweep: each field touched once, one read or write each.  It is a lower
bound, not what runs: the XLA red-black step makes two masked full-field
passes (about 6 streams), and the red-black Triton kernel
(pallas_kernels/rbsweep.py) moves about 3 (the other color read, its own
color read and written, per color).  A %SoL against this model says how
far a sweep is from the floor.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops_per_pt: float
    streams: float  # HBM passes over the N^3 field (reads + writes)

    def flops(self, npts: int) -> float:
        return self.flops_per_pt * npts

    def bytes(self, npts: int, itemsize: int = 4) -> float:
        return self.streams * npts * itemsize


def pcr_flops_per_pt(n: int) -> float:
    """Full-plane PCR per line point (pcr, cz_solver.f90:694-701)."""
    pn = 1
    while (1 << pn) <= n:
        pn += 1
    return 6 + 14 * max(pn - 2, 0) + 74 * (2 ** max(pn - 2, 0)) / n + 6 + 6


# streams: the ideal (x read + x write [+ b read])
COSTS = {
    "jacobi": KernelCost(18, 3),
    "jacobi_b0": KernelCost(18, 2),
    "psor": KernelCost(18, 3),
    "sor2sma": KernelCost(18, 3),      # both colors fused: read x, b; write x
    "sor2sma_b0": KernelCost(18, 2),
    "jacobi_maf": KernelCost(66, 3),
    "psor_maf": KernelCost(66, 3),
    "sor2sma_maf": KernelCost(66, 3),
    "calc_ax": KernelCost(13, 3),
    "calc_rk": KernelCost(14, 4),
    "calc_ax_maf": KernelCost(63, 3),
    "calc_rk_maf": KernelCost(63, 4),
    "dot1": KernelCost(2, 1),
    "dot2": KernelCost(2, 2),
    "triad": KernelCost(2, 3),
    "bicg_1": KernelCost(4, 4),
    "bicg_2": KernelCost(4, 4),
}


def sweep_cost(name: str, shape, itemsize: int = 4, b_is_zero: bool = False):
    """(flops, bytes) for one sweep of ``name`` over grid ``shape``."""
    key = name
    if b_is_zero and f"{name}_b0" in COSTS:
        key = f"{name}_b0"
    if key not in COSTS and name.startswith("pcr"):
        # the reference's own PCR accounting per line point
        # (cz_solver.f90:694-701) over the K line length; a red-black
        # iteration solves each line once, like the line-Jacobi form.
        # Traffic stays read x + write x [+ read b].
        npts = math.prod(shape)
        per_pt = pcr_flops_per_pt(shape[0] - 2)
        streams = 2 if b_is_zero else 3
        return per_pt * npts, streams * npts * itemsize
    c = COSTS[key]
    npts = math.prod(shape)
    return c.flops(npts), c.bytes(npts, itemsize)
