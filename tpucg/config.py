"""Runtime configuration for CG solves.

The reference hard-codes every knob at compile time (``#define ROWS/COLS/EPSILON``,
``serialConjugate.c:28-31``) and requires recompilation to change problem size.
tpucg replaces that with one runtime config object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from tpucg.kernels.dispatch import resolve_backend


@dataclasses.dataclass(frozen=True)
class CGConfig:
    """Configuration for a conjugate-gradient solve.

    Attributes:
      tol: absolute residual-2-norm stopping tolerance. The reference contract is
        ``sqrt(r.r) < EPSILON`` with ``EPSILON = 1e-6`` (``serialConjugate.c:28,235``),
        checked after the x/r update and before the p update.
      maxiter: iteration cap. ``None`` means n (the reference caps at ROWS,
        ``serialConjugate.c:213``).
      dtype: compute dtype. The reference is float32 throughout (``float`` /
        ``MPI_FLOAT``); float64 is supported as an extension (requires
        ``jax.config.update('jax_enable_x64', True)``).
      strategy: communication strategy for sharded solves —
        ``"allgather"`` rebuilds the full direction vector each iteration
        (reference collective arm, ``parallel_cg.c:290-291``);
        ``"overlap"`` keeps p block-sharded and streams blocks around a
        collective-permute ring overlapped with local matvec (the collective
        replacement for the reference's p2p arm, ``point-to-point_cg.c:364-394``).
      kernel: compute-kernel backend — ``"auto"`` and ``"xla"`` run XLA;
        ``"pallas"`` is refused (no operator has a Pallas kernel; see
        ``kernels.dispatch``).
      safe_alpha: guard the ``alpha = rsold / (p . Ap)`` division against a zero
        denominator (exact initial guess). The reference would produce NaN here;
        tpucg treats it as converged instead (SURVEY.md §3.5 mandates failing
        loudly / robustly rather than replicating reference bugs).
      precondition: ``"none"`` (the reference's unpreconditioned CG),
        ``"jacobi"`` (z = r / diag(A); cuts iterations on badly
        diagonally-scaled systems at one extra O(n) multiply per lap),
        ``"block_jacobi"`` (z = blockdiag(A)^-1 r with ``pc_block_size``
        blocks, inverted once at setup and applied as ONE batched
        (bs, bs) block GEMV per lap — a batched-GEMM strong
        preconditioner; also absorbs within-block coupling, e.g. bands
        and per-node DOF blocks; dense/DIA/Poisson operators), or
        ``"poly"`` (truncated-Neumann polynomial of degree ``poly_degree`` —
        ``poly_degree - 1`` extra matvecs per lap, no triangular solves).
        The stopping test stays on the true residual in every case.
      poly_degree: polynomial degree for ``precondition="poly"`` (>= 1).
      pc_block_size: diagonal-block size for
        ``precondition="block_jacobi"`` (>= 2; setup inverts
        ceil(n/bs) bs x bs blocks once).
      method: ``"cg"`` (the reference recurrence), ``"pipelined"``
        (Ghysels-Vanroose communication-hiding CG: ONE fused scalar reduction
        per lap, overlappable with the matvec — an extension for
        latency-bound distributed solves; see solver.cg.pipelined_cg_loop),
        ``"ca"`` (communication-AVOIDING s-step CG: ONE fused Gram
        reduction per ``s_step`` laps at ~2x matvec cost — the far end of
        the latency/bandwidth trade; see solver.cg.ca_cg_loop), or
        ``"chebyshev"`` (Chebyshev iteration: ZERO reductions per lap —
        every scalar comes from a spectral-interval recurrence — with
        reductions only at ``check_every``-lap chunk boundaries; the
        terminal point of the reduction-cadence spectrum. Needs more
        iterations than CG
        (no minimization, rate fixed by the interval estimate) — it wins
        only where reduction latency dominates the lap; see
        solver.cg.chebyshev_loop).
      s_step: block size s for ``method="ca"`` (>= 1; 3-4 is the usual
        f32 sweet spot — monomial-basis conditioning grows with s).
      check_every: laps between exact residual checks for
        ``method="chebyshev"`` (>= 1). Convergence is only observed at
        checks, so reported iteration counts round up to a multiple of
        ``check_every``.
    """

    tol: float = 1.0e-6
    maxiter: Optional[int] = None
    dtype: jnp.dtype = jnp.float32
    strategy: str = "allgather"
    kernel: str = "auto"
    safe_alpha: bool = True
    precondition: str = "none"
    poly_degree: int = 3
    pc_block_size: int = 64
    method: str = "cg"
    s_step: int = 3
    check_every: int = 8

    def __post_init__(self):
        if self.strategy not in ("allgather", "overlap"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.method not in ("cg", "pipelined", "ca", "chebyshev"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.s_step < 1:
            raise ValueError("s_step must be >= 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.method == "ca" and self.precondition != "none":
            raise ValueError(
                "method='ca' supports precondition='none' (a preconditioned "
                "CA basis needs split M^-1-weighted towers; use "
                "method='pipelined' for preconditioned latency hiding)"
            )
        resolve_backend(self.kernel)
        if self.precondition not in (
            "none", "jacobi", "block_jacobi", "poly"
        ):
            raise ValueError(f"unknown preconditioner {self.precondition!r}")
        if self.poly_degree < 1:
            raise ValueError("poly_degree must be >= 1")
        if self.pc_block_size < 2:
            raise ValueError("pc_block_size must be >= 2")
        if self.tol <= 0:
            raise ValueError("tol must be positive")
        if jnp.dtype(self.dtype) not in (jnp.float32, jnp.float64):
            # bf16 is a STORAGE dtype (DenseOperator.create(dtype=bfloat16)),
            # not a solve dtype: the residual test needs f32+ vectors.
            raise ValueError(
                f"solve dtype must be float32/float64, got {self.dtype}"
            )
