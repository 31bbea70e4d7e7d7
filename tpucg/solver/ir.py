"""Mixed-precision iterative refinement: bf16-speed solves, f32-true results.

``DenseOperator.create(dtype=bfloat16)`` halves the GEMV's HBM traffic but
solves the bf16-ROUNDED system — its solution differs from the f32 system's
by O(eps_bf16 * kappa). Iterative refinement removes that caveat the
classical way (Wilkinson; the standard mixed-precision HPC recipe):

    repeat:  r = b - A_f32 x        # true residual, full precision
             solve A_bf16 d ~= r    # inner CG on the cheap operator
             x <- x + d

Each refinement contracts the error by ~eps_bf16 * kappa, so a handful of
rounds reach the f32 stopping contract (``sqrt(r.r) < tol`` on the TRUE
f32 residual) while ~all the matvec bandwidth is spent at bf16 rates. The
whole refinement loop is ONE jitted while_loop (inner CG nested inside), so
there are no host round-trips between rounds.

Extension beyond the reference (f32-only). Memory cost: both precisions of A
are resident (1.5x the f32 footprint).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpucg.config import CGConfig
from tpucg.kernels.blas1 import dot_xla, fused_update
from tpucg.solver.cg import CGResult, cg_loop, dataclasses_replace
from tpucg.solver.operators import DenseOperator


class _IRState(NamedTuple):
    j: jax.Array        # refinement rounds completed
    x: jax.Array
    r: jax.Array        # true residual b - A_f32 x (carried: one op32 matvec
    rr: jax.Array       # per round, not two)
    inner_total: jax.Array
    done: jax.Array
    stalled: jax.Array  # refinement stopped contracting: f32 floor reached


def ir_loop(mv16, mv32, dot, update, b, x0, *, tol, inner_rtol,
            inner_maxiter, max_refine):
    """Generic refinement loop over execution-model closures: serial jnp
    closures here; psum-reducing shard_map closures in ``sharded_cg_solve_ir``
    (the same abstraction seam as ``cg_loop``)."""
    tol2 = jnp.float32(tol) ** 2

    def true_rr(x):
        r = b - mv32(x)
        return r, dot(r, r)

    r0, rr0 = true_rr(x0)
    state = _IRState(
        j=jnp.int32(0), x=x0, r=r0, rr=rr0, inner_total=jnp.int32(0),
        done=rr0 < tol2, stalled=jnp.zeros((), jnp.bool_),
    )

    def cond(s: _IRState):
        return jnp.logical_and(
            s.j < max_refine,
            jnp.logical_not(jnp.logical_or(s.done, s.stalled)),
        )

    def body(s: _IRState):
        nrm = jnp.sqrt(s.rr) + jnp.float32(1e-30)
        # Inner solve on the normalized residual: the static inner tolerance
        # becomes a RELATIVE tolerance, so one executable serves every round.
        inner = cg_loop(
            mv16, dot, update,
            s.r / nrm, jnp.zeros_like(s.r),
            tol=inner_rtol, maxiter=inner_maxiter,
        )
        x_new = s.x + nrm * inner.x
        r_new, rr_new = true_rr(x_new)  # the round's ONE op32 matvec
        # A refinement round should contract ||r||^2 by >> 4x; anything less
        # means the f32 true-residual evaluation floor has been reached —
        # stop (and keep the better iterate) rather than burn more rounds.
        stalled = rr_new > 0.25 * s.rr
        better = rr_new < s.rr
        return _IRState(
            j=s.j + 1,
            x=jnp.where(better, x_new, s.x),
            r=jnp.where(better, r_new, s.r),
            rr=jnp.where(better, rr_new, s.rr),
            inner_total=s.inner_total + inner.k,
            done=jnp.minimum(rr_new, s.rr) < tol2,
            stalled=stalled,
        )

    return jax.lax.while_loop(cond, body, state)


@functools.partial(
    jax.jit,
    static_argnames=(
        "tol", "inner_rtol", "inner_maxiter", "max_refine",
    ),
)
def _ir_jit(op16, op32, b, x0, tol, inner_rtol, inner_maxiter, max_refine):
    s = ir_loop(
        op16.matvec, op32.matvec, dot_xla, fused_update, b, x0,
        tol=tol, inner_rtol=inner_rtol, inner_maxiter=inner_maxiter,
        max_refine=max_refine,
    )
    return CGResult(
        x=s.x,
        iterations=s.inner_total,
        residual_norm=jnp.sqrt(s.rr),
        converged=s.done,
    )


def cg_solve_ir(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    *,
    inner_rtol: float = 3.0e-2,
    inner_maxiter: Optional[int] = None,
    max_refine: int = 6,
    **overrides,
) -> CGResult:
    """Solve A x = b to the f32 contract with bf16-rate inner solves.

    ``A`` is a dense host array (both bf16 and f32 device copies are built).
    ``iterations`` in the result counts TOTAL inner CG laps across
    refinement rounds; ``residual_norm``/``converged`` report the TRUE f32
    residual, i.e. the same contract as ``cg_solve``.
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg" or config.precondition != "none":
        raise ValueError(
            "cg_solve_ir supports method='cg', precondition='none'"
        )
    if jnp.dtype(config.dtype) != jnp.float32:
        raise ValueError(
            "cg_solve_ir is the f32-contract mixed-precision path; for f64 "
            "use cg_solve(dtype=float64)"
        )
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    op16 = DenseOperator.create(A, dtype=jnp.bfloat16)
    op32 = DenseOperator.create(A, dtype=jnp.float32)
    npad = op32.padded_n
    if op16.padded_n != npad:
        raise AssertionError("precision variants padded differently")
    b = jnp.asarray(b, jnp.float32)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    x0 = (
        jnp.zeros(n, jnp.float32)
        if x0 is None
        else jnp.asarray(x0, jnp.float32)
    )
    if npad != n:
        b = jnp.pad(b, (0, npad - n))
        x0 = jnp.pad(x0, (0, npad - n))
    # config.maxiter caps the INNER solves (the analog of the reference's
    # per-solve ROWS cap); an explicit inner_maxiter overrides it.
    if inner_maxiter is not None:
        inner_cap = inner_maxiter
    elif config.maxiter is not None:
        inner_cap = config.maxiter
    else:
        inner_cap = n
    res = _ir_jit(
        op16, op32, b, x0,
        float(config.tol), float(inner_rtol), int(inner_cap),
        int(max_refine),
    )
    if npad != n:
        res = res._replace(x=res.x[:n])
    return res


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tol", "inner_rtol", "inner_maxiter", "max_refine", "axis",
        "strategy",
    ),
)
def _sharded_ir_jit(
    A16, A32, b, x0, *, mesh, tol, inner_rtol, inner_maxiter, max_refine,
    axis, strategy,
):
    from jax.sharding import PartitionSpec as P

    from tpucg.solver.sharded import _make_matvec, _make_reductions

    num = mesh.devices.size

    def run(A16_blk, A32_blk, b_blk, x_blk):
        mv16 = _make_matvec(A16_blk, strategy, num, axis)
        mv32 = _make_matvec(A32_blk, strategy, num, axis)
        dot, _, update = _make_reductions(axis)
        s = ir_loop(
            mv16, mv32, dot, update, b_blk, x_blk,
            tol=tol, inner_rtol=inner_rtol, inner_maxiter=inner_maxiter,
            max_refine=max_refine,
        )
        return s.x, s.inner_total, jnp.sqrt(s.rr), s.done

    return jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis), P(), P(), P()),
    )(A16, A32, b, x0)


def sharded_cg_solve_ir(
    A,
    b,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    inner_rtol: float = 3.0e-2,
    inner_maxiter: Optional[int] = None,
    max_refine: int = 6,
    **overrides,
) -> CGResult:
    """Distributed mixed-precision iterative refinement: both precision
    copies of A row-block-sharded, bf16-rate inner CG laps with psum
    reductions, f32 true-residual refinement — same contract as
    ``cg_solve_ir``, same decomposition as ``sharded_cg_solve``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpucg.comm.mesh import make_mesh
    from tpucg.io.partitioner import RowPartition, pad_identity_tail
    from tpucg.solver.sharded import ROW_ALIGN

    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg" or config.precondition != "none":
        raise ValueError(
            "sharded_cg_solve_ir supports method='cg', precondition='none'"
        )
    if mesh is None:
        mesh = make_mesh()
    if mesh.devices.ndim != 1:
        raise ValueError("sharded_cg_solve_ir runs on 1-D meshes")
    axis = mesh.axis_names[0]
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    part = RowPartition(
        n=n, num_shards=mesh.devices.size, align=ROW_ALIGN
    )
    npad = part.n_padded
    Ap = pad_identity_tail(A, npad)
    import ml_dtypes

    shard2 = NamedSharding(mesh, P(axis, None))
    shard1 = NamedSharding(mesh, P(axis))
    A16 = jax.device_put(Ap.astype(ml_dtypes.bfloat16), shard2)
    A32 = jax.device_put(Ap, shard2)
    bp = np.zeros(npad, np.float32)
    bp[:n] = np.asarray(b, np.float32)
    x0p = np.zeros(npad, np.float32)
    if x0 is not None:
        x0p[:n] = np.asarray(x0, np.float32)
    if inner_maxiter is not None:
        inner_cap = inner_maxiter
    elif config.maxiter is not None:
        inner_cap = config.maxiter
    else:
        inner_cap = n
    x, k, rn, done = _sharded_ir_jit(
        A16, A32,
        jax.device_put(bp, shard1),
        jax.device_put(x0p, shard1),
        mesh=mesh,
        tol=float(config.tol),
        inner_rtol=float(inner_rtol),
        inner_maxiter=int(inner_cap),
        max_refine=int(max_refine),
        axis=axis,
        strategy=config.strategy,
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=k, residual_norm=rn, converged=done)
