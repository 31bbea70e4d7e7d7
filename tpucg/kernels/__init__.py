"""Compute kernels.

These replace the reference's L1 C loops (``serialConjugate.c:109-177``):
``matVec`` -> XLA's dot at HIGHEST precision, ``vecVec`` -> an exact dot,
``scalarVec``/``vecAdd``/``vecSub`` -> one jnp update that XLA fuses into a
single pass. Sparse products live in ``spmv`` (ELL, DIA, BSR) and
``gather_spmv`` (WELL).
"""

from tpucg.kernels.dispatch import resolve_backend
from tpucg.kernels.matvec import matvec_xla
from tpucg.kernels.blas1 import dot_xla, fused_update
from tpucg.kernels.spmv import (
    bsr_ell_spmv,
    dia_spmv,
    ell_spmv,
)

__all__ = [
    "resolve_backend",
    "matvec_xla",
    "dot_xla",
    "fused_update",
    "ell_spmv",
    "bsr_ell_spmv",
    "dia_spmv",
]
