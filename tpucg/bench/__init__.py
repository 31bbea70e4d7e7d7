"""Benchmark harness: three-phase timing and roofline analysis."""

from tpucg.bench.timing import (
    DEVICE_PEAKS,
    BenchReport,
    has_peaks,
    hbm_peak_bytes_per_s,
    time_fn,
    time_matvec_loop,
    time_solve_chain,
)

__all__ = [
    "BenchReport",
    "DEVICE_PEAKS",
    "has_peaks",
    "time_fn",
    "time_matvec_loop",
    "time_solve_chain",
    "hbm_peak_bytes_per_s",
]
