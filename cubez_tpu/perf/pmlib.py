"""Performance monitor — the PMlib replacement.

The reference weaves PMlib through every solver: a label registry with
CALC/COMM types and exclusive flags (set_timing_label, cz_miscel.cpp:150-262),
TIMING_start/stop macros accumulating analytic flop counts (cz.h:506-539),
and a gathered report to stdout + profiling.txt (cz_Evaluate.cpp:506-544).

This module provides the same accounting model, adapted to the XLA execution
model: sections time *dispatched work* (the caller must block_until_ready
inside the section for honest numbers), flops/bytes are attached analytically
per kernel exactly like the reference's in-kernel flop accumulators
(cz_solver.f90:238-241 etc.), and the report adds a roofline column —
percent of the device's published HBM bandwidth (PEAKS below), the
meaningful absolute yardstick for these bandwidth-bound sweeps
(BASELINE.md).  The CPU has no peak, so the column stays empty there.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

CALC = "CALC"
COMM = "COMM"


@dataclasses.dataclass
class Section:
    label: str
    kind: str = CALC
    exclusive: bool = True
    calls: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds > 0 else 0.0


class PerfMonitor:
    """Label registry + section timers + report (PMlib's initialize /
    setProperties / start / stop / print pipeline, cz_miscel.cpp:142-263)."""

    def __init__(self, hbm_gbps: Optional[float] = None, peak_gflops: Optional[float] = None):
        self.sections: dict[str, Section] = {}
        self.order: list[str] = []
        self.hbm_gbps = hbm_gbps
        self.peak_gflops = peak_gflops

    def set_label(self, label: str, kind: str = CALC, exclusive: bool = True):
        if label not in self.sections:
            self.sections[label] = Section(label=label, kind=kind, exclusive=exclusive)
            self.order.append(label)
        return self.sections[label]

    @contextmanager
    def section(self, label: str, kind: str = CALC, flops: float = 0.0, bytes: float = 0.0):
        """Time a block; attach analytic flop/byte counts for the work done
        inside (the TIMING_start/stop pair, cz.h:506-539)."""
        s = self.set_label(label, kind)
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            dt = time.perf_counter() - t0
            s.calls += 1
            s.seconds += dt
            s.flops += flops
            s.bytes += bytes

    def add(self, label: str, seconds: float, kind: str = CALC, flops: float = 0.0,
            bytes: float = 0.0, calls: int = 1):
        """Record an externally-timed interval."""
        s = self.set_label(label, kind)
        s.calls += calls
        s.seconds += seconds
        s.flops += flops
        s.bytes += bytes

    # --- report ------------------------------------------------------------

    def report(self) -> str:
        """profiling.txt-style table (PM.print, cz_Evaluate.cpp:506-544)."""
        lines = []
        hdr = (
            f"{'Label':<28} {'type':<4} {'calls':>7} {'time[s]':>10} "
            f"{'GFLOPS':>9} {'GB/s':>8} {'%SoL':>6}"
        )
        lines.append(hdr)
        lines.append("-" * len(hdr))
        total = 0.0
        for label in self.order:
            s = self.sections[label]
            if s.calls == 0:
                continue
            sol = ""
            if self.hbm_gbps and s.bytes > 0 and s.seconds > 0:
                sol = f"{100.0 * s.gbps / self.hbm_gbps:6.1f}"
            elif self.peak_gflops and s.flops > 0 and s.seconds > 0:
                sol = f"{100.0 * s.gflops / self.peak_gflops:6.1f}"
            lines.append(
                f"{s.label:<28} {s.kind:<4} {s.calls:>7d} {s.seconds:>10.4f} "
                f"{s.gflops:>9.2f} {s.gbps:>8.1f} {sol:>6}"
            )
            if s.exclusive:
                total += s.seconds
        lines.append("-" * len(hdr))
        lines.append(f"{'total (exclusive)':<28} {'':<4} {'':>7} {total:>10.4f}")
        return "\n".join(lines)

    def write(self, path: str = "profiling.txt"):
        with open(path, "w") as f:
            f.write(self.report() + "\n")


# Published peaks per device_kind (dense rates, no sparsity).  Source:
# NVIDIA H100 Tensor Core GPU data sheet (SXM5, PCIe and NVL columns).  The
# rates assume the card's full power limit; a card set below it reaches
# less, so reports print the power limit beside any share of these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5, 700 W
        "hbm_gbps": 3350.0, "f32_tflops": 67.0, "f64_tflops": 34.0,
        "bf16_tflops": 989.0,
    },
    "NVIDIA H100 PCIe": {  # 80 GB HBM2e, 350 W
        "hbm_gbps": 2000.0, "f32_tflops": 51.0, "f64_tflops": 26.0,
        "bf16_tflops": 756.0,
    },
    "NVIDIA H100 NVL": {  # 94 GB HBM3, 400 W
        "hbm_gbps": 3900.0, "f32_tflops": 60.0, "f64_tflops": 30.0,
        "bf16_tflops": 835.0,
    },
}


def device_peaks(device=None) -> Optional[dict]:
    """Published peaks of ``device`` (default: jax device 0) from PEAKS,
    keyed by its device_kind.  None on the CPU, which has no peak to
    divide by; an accelerator missing from the table raises KeyError
    (no default: a wrong peak makes every share wrong)."""
    import jax

    d = jax.devices()[0] if device is None else device
    if d.platform == "cpu":
        return None
    kind = str(getattr(d, "device_kind", d.platform))
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; add it to "
            "cubez_tpu/perf/pmlib.py:PEAKS with its source"
        )
    return PEAKS[kind]
