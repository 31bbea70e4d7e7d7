"""Kernel backend resolution.

Every operator runs on XLA: no Pallas kernel is left (PERF.md records the
DIA kernel that was written for the GPU and removed because the solve was
no faster with it). ``kernel="pallas"`` is refused rather than silently
served by something else.
"""

from __future__ import annotations


def resolve_backend(kernel: str = "auto") -> str:
    """Map CGConfig.kernel to the backend: ``"xla"`` for ``"auto"`` and
    ``"xla"``; a ValueError for ``"pallas"`` (no operator has a Pallas
    kernel) and for anything else."""
    if kernel in ("auto", "xla"):
        return "xla"
    if kernel == "pallas":
        raise ValueError(
            "kernel='pallas': no operator has a Pallas kernel; use "
            "kernel='xla' or 'auto'"
        )
    raise ValueError(f"unknown kernel backend {kernel!r}")
