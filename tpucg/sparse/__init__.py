"""Sparse matrix formats (host-side containers + device forms)."""

from tpucg.sparse.formats import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    DIAMatrix,
    EllMatrix,
    csr_to_bsr,
    csr_to_dia,
    csr_to_ell,
)
from tpucg.sparse.well import WellMatrix, csr_to_well

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "EllMatrix",
    "BSRMatrix",
    "DIAMatrix",
    "csr_to_ell",
    "csr_to_bsr",
    "csr_to_dia",
    "WellMatrix",
    "csr_to_well",
]
