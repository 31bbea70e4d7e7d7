"""Distributed CG over a device mesh.

This is a collective-based re-design of the reference's two parallel programs
(SURVEY.md §2.3-2.4). The decomposition is the same 1-D row-block striping
("row-wise block-striped decomposition", report §5.2; ``MPI_Scatter`` of A at
``parallel_cg.c:112-115``) — A sharded ``P('rows', None)``, b/x/r/p sharded
``P('rows')`` — but the communication is XLA collectives (NCCL over NVLink
on GPUs):

- scalar reductions (rsold / p.Ap / beta): ``lax.psum`` inside shard_map,
  replacing the three ``MPI_Allreduce`` calls per iteration
  (``parallel_cg.c:287,294,313``);
- strategy "allgather": rebuild the full direction vector each iteration via
  ``lax.all_gather`` then one local (rows/P, n) GEMV — semantically the
  collective arm (``MPI_Allgather``, ``parallel_cg.c:290-292``);
- strategy "overlap": p stays block-sharded; the local GEMV is split into P
  column-block partial products while a ``lax.ppermute`` ring rotates p blocks
  between neighbors, overlapping each transfer with the concurrent partial
  matvec. This is the hand-rolled send/recv arm of ``point-to-point_cg.c``
  rebuilt as a ring collective (compute/comm overlap instead of
  sequential rank-0 gather+bcast).

Unlike the reference, x is block-sharded too — ``parallel_cg.c:299-303``
redundantly updates the full replicated x on every rank (SURVEY.md §3.2 quirk);
here every vector op is O(n/P) per device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpucg.comm.mesh import ROWS_AXIS, make_mesh
from tpucg.config import CGConfig
from tpucg.io.partitioner import RowPartition, pad_identity_tail, pad_system
from tpucg.kernels.blas1 import dot_xla
from tpucg.kernels.matvec import matvec_xla
from tpucg.kernels.spmv import bsr_ell_spmv, ell_spmv
from tpucg.solver.cg import (
    TRUE_CHECK_EVERY as _TRUE_CHECK,
    CGResult,
    _run_chebyshev,
    ca_cg_loop,
    cg_loop,
    dataclasses_replace,
    make_block_precond,
    make_poly_precond,
    pipelined_cg_loop,
)


# Per-shard row alignment of the dense decompositions.
ROW_ALIGN = 8


def pc_align(base: int, config) -> int:
    """Partition alignment including the block-Jacobi block size: padding
    each shard to a multiple of ``pc_block_size`` (identity tail blocks are
    exact unit diagonals) lifts the reference's ROWS %% P == 0 restriction
    class (``parallel_cg.c:86-90``) from the preconditioner too."""
    import math

    if config.precondition != "block_jacobi":
        return base
    return math.lcm(base, int(config.pc_block_size))


def _make_reductions(axes):
    """The psum-backed scalar closures every decomposition shares: ``dot``
    (vecVec + MPI_Allreduce, ``parallel_cg.c:286-287``), ``dot2`` (the
    pipelined method's single fused two-scalar reduction), and the classic
    ``update``. ``axes`` is the mesh axis (or tuple of axes) to reduce over.
    """

    def dot(u, v):
        return jax.lax.psum(dot_xla(u, v), axes)

    def dots(pairs):
        # ALL of a lap's scalars in ONE fused psum — the pipelined method's
        # point: a single (k,)-vector allreduce, overlappable with the matvec.
        part = jnp.stack([dot_xla(u, v) for u, v in pairs])
        tot = jax.lax.psum(part, axes)
        return tuple(tot[i] for i in range(len(pairs)))

    def update(x, r, p, ap, alpha):
        xn = x + alpha * p
        rn = r - alpha * ap
        return xn, rn, dot(rn, rn)

    return dot, dots, update


def _run_pipelined(mv, dot, dots, b_blk, x_blk, tol, maxiter, safe_alpha,
                   precond=None):
    """Pipelined loop + the honest convergence epilogue (the loop tests one
    lap late; on a cap exit recompute the true r.r for reporting).
    Preconditioned runs get periodic residual replacement (see
    ``solver.cg.PIPE_REPLACE_EVERY`` — the replacement matvecs ride the
    same sharded closure, adding zero reductions)."""
    from tpucg.solver.cg import PIPE_REPLACE_EVERY

    s = pipelined_cg_loop(
        mv, dots, b_blk, x_blk,
        tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
        replace_every=None if precond is None else PIPE_REPLACE_EVERY,
    )
    rr = jnp.where(s.done, s.rslast, dot(s.r, s.r))
    done = jnp.logical_or(s.done, rr < jnp.asarray(tol, rr.dtype) ** 2)
    return s.x, s.k, jnp.sqrt(rr), done


def _run_ca(mv, dot, b_blk, x_blk, axes, *, s_step, tol, maxiter,
            safe_alpha, interval=None):
    """Distributed CA (s-step) CG: the basis towers ride the block-local
    matvec closure (so each of the 2s-1 basis matvecs pays only ITS
    communication — allgather or ring), and the block's Gram matrix is ONE
    fused (2s+1)^2 psum (plus the exact block-end verification dot) per s
    laps — versus 2-3 scalar psums per lap for classic CG. See
    ``tpucg.solver.cg.ca_cg_loop``. ``interval`` (a cached (lam_lo,
    lam_hi)) skips the power-method setup — and with it the setup's OWN
    matvec communication."""

    def gram(V):
        return jax.lax.psum(
            jnp.matmul(V.T, V, precision=jax.lax.Precision.HIGHEST), axes
        )

    st = ca_cg_loop(
        mv, dot, gram, b_blk, x_blk,
        s=s_step, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
        interval=interval,
    )
    return st.x, st.k, jnp.sqrt(st.rslast), st.done


def _interval_static(interval, config):
    """Validate and staticize a cached spectral interval for the sharded
    jits (a host-known (lam_lo, lam_hi) pair — e.g. the first two values of
    ``tpucg.spectral_interval`` — closed over as compile-time constants;
    one compile per cached interval, the reuse regime it exists for)."""
    if interval is None:
        return None
    if config.method not in ("ca", "chebyshev"):
        raise ValueError(
            "interval=(lam_lo, lam_hi) applies to method='ca'/'chebyshev' "
            f"(got method={config.method!r})"
        )
    return (float(interval[0]), float(interval[1]))


def _ring_perm(num: int) -> list:
    """ppermute pairs: device j receives the block held by j+1 (mod P), i.e.
    blocks flow one step down the ring each lap."""
    return [((j + 1) % num, j) for j in range(num)]


def _make_matvec(A_blk, strategy: str, num_shards: int, axis: str):
    block_rows = A_blk.shape[0]

    if strategy == "allgather":

        def mv(p_blk):
            p_full = jax.lax.all_gather(p_blk, axis, tiled=True)
            return matvec_xla(A_blk, p_full)

        return mv

    def mv(p_blk):
        # Ring matvec: at step s this device multiplies its A column-block
        # (my + s) mod P with the p block currently in hand, while the next p
        # block is already in flight on the ring. Statically unrolled
        # (num_shards is a mesh constant) so XLA's scheduler can overlap each
        # ppermute with the concurrent partial GEMV.
        my = jax.lax.axis_index(axis)
        y = jnp.zeros((block_rows,), jnp.float32)
        p_cur = p_blk
        for s in range(num_shards):
            idx = jax.lax.rem(my + s, num_shards)
            col0 = (idx * block_rows).astype(jnp.int32)
            A_cols = jax.lax.dynamic_slice(
                A_blk, (jnp.int32(0), col0), (block_rows, block_rows)
            )
            p_next = (
                jax.lax.ppermute(p_cur, axis, _ring_perm(num_shards))
                if s < num_shards - 1
                else p_cur
            )
            y = y + matvec_xla(A_cols, p_cur)
            p_cur = p_next
        return y

    return mv


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "strategy", "tol", "maxiter", "safe_alpha", "axis",
        "precondition", "method", "poly_degree", "record", "s_step",
        "check_every", "pc_block_size", "interval",
    ),
)
def _sharded_cg_jit(
    A, b, x0, *, mesh, strategy, tol, maxiter, safe_alpha, axis,
    precondition="none", method="cg", poly_degree=0, record=False, s_step=3,
    check_every=8, pc_block_size=64, interval=None,
):
    num = mesh.devices.size

    def solve(A_blk, b_blk, x_blk):
        mv = _make_matvec(A_blk, strategy, num, axis)

        precond = None
        if precondition == "jacobi":
            minv = _jacobi_minv_blk(A_blk, axis)
            precond = lambda r: minv * r
        if precondition == "block_jacobi":
            # Block Jacobi is perfectly shard-local under row-block
            # sharding (the wrapper enforces bs | block_rows): gather this
            # shard's diagonal blocks, invert once (the shared
            # solver.cg.invert_blocks guards), and apply as one LOCAL
            # batched block GEMV per lap — zero extra collectives.
            from tpucg.solver.cg import invert_blocks, make_block_precond

            blocks = _local_diag_blocks(A_blk, axis, pc_block_size)
            precond = make_block_precond(
                invert_blocks(blocks), A_blk.shape[0]
            )

        dot, dots, update = _make_reductions(axis)
        if precondition == "poly":
            precond = make_poly_precond(mv, dot, b_blk, poly_degree)
        if method == "pipelined":
            # ONE fused psum per lap, overlappable with q = A w.
            x, k, rn, done = _run_pipelined(
                mv, dot, dots, b_blk, x_blk, tol, maxiter, safe_alpha,
                precond=precond,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)
        if method == "ca":
            # ONE fused Gram psum (+ verification dot) per s_step laps.
            x, k, rn, done = _run_ca(
                mv, dot, b_blk, x_blk, axis,
                s_step=s_step, tol=tol, maxiter=maxiter,
                safe_alpha=safe_alpha, interval=interval,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)
        if method == "chebyshev":
            # ZERO psums per lap (matvec comm only); one exact-residual
            # psum per check_every laps.
            x, k, rn, done = _run_chebyshev(
                mv, dot, b_blk, x_blk,
                tol=tol, maxiter=maxiter, check_every=check_every,
                precond=precond, interval=interval,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)

        s = cg_loop(
            mv, dot, update, b_blk, x_blk,
            tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
            hist_len=maxiter if record else None,
        )
        hist = s.hist if record else jnp.zeros((1,), jnp.float32)
        return s.x, s.k, jnp.sqrt(s.rslast), s.done, hist

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        # The ||r|| history entries are psum-derived scalars -> replicated.
        out_specs=(P(axis), P(), P(), P(), P()),
    )(A, b, x0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "safe_alpha", "axis"),
)
def _sharded_multi_jit(A, B, X0, *, mesh, tol, maxiter, safe_alpha, axis):
    """Row-sharded multi-RHS CG: k recurrences in lockstep under vmap INSIDE
    shard_map. The per-lane all_gathers batch into one collective of the
    (n/P, k) block and the per-lane GEMVs into one A_blk @ P_full GEMM per
    lap — A streams once for ALL k systems AND stays row-sharded."""

    def solve(A_blk, B_blk, X_blk):
        def one(b_blk, x_blk):
            def mv(p_blk):
                p_full = jax.lax.all_gather(p_blk, axis, tiled=True)
                from tpucg.kernels.matvec import matvec_xla

                return matvec_xla(A_blk, p_full)

            dot, _, update = _make_reductions(axis)
            s = cg_loop(
                mv, dot, update, b_blk, x_blk,
                tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            )
            return s.x, s.k, jnp.sqrt(s.rslast), s.done

        return jax.vmap(one, in_axes=1, out_axes=(1, 0, 0, 0))(B_blk, X_blk)

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(), P(), P()),
    )(A, B, X0)


def sharded_cg_solve_multi(
    A,
    B,
    X0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B for k right-hand sides with A row-block-sharded.

    The distributed composition of ``cg_solve_multi`` (the reference solves
    one RHS per program run): per lap ONE batched all_gather rebuilds the
    (n, k) direction block and one (n/P, n) x (n, k) GEMM applies A to all
    lanes — the k-fold bandwidth amortization survives sharding. Lanes
    converge independently. Result fields are batched like
    ``cg_solve_multi``: x is (n, k); iterations/residual_norm/converged are
    (k,).

    Sparse/stencil operators (Poisson/DIA/ELL/BSR forms) take the operator
    decompositions of ``sharded_operator_cg_solve`` with the k lanes
    vmapped inside shard_map (one batched halo ppermute / all_gather per
    lap; the XLA matvec arms, which batch cleanly, are used).
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg" or config.precondition != "none":
        raise ValueError(
            "sharded_cg_solve_multi supports method='cg', "
            "precondition='none'"
        )
    if mesh is None:
        mesh = make_mesh()
    if mesh.devices.ndim == 2:
        if isinstance(A, _operator_types()):
            raise ValueError(
                "sparse operators take the 1-D operator decompositions; "
                "the 2-D SUMMA arm is dense"
            )
        return _sharded2d_multi(A, B, X0, mesh, config)
    if mesh.devices.ndim != 1:
        raise ValueError("sharded_cg_solve_multi runs on 1-D/2-D meshes")
    if isinstance(A, _operator_types()):
        return _sharded_operator_multi(A, B, X0, mesh, config)
    axis = mesh.axis_names[0]
    num = mesh.devices.size
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    B = np.asarray(B, np.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    X0 = (
        np.zeros((n, k), np.float32)
        if X0 is None
        else np.asarray(X0, np.float32)
    )
    part = RowPartition(n=n, num_shards=num,
                        align=pc_align(ROW_ALIGN, config))
    npad = part.n_padded
    Ap = pad_identity_tail(A, npad)
    Bp = np.zeros((npad, k), np.float32)
    Bp[:n] = B
    X0p = np.zeros((npad, k), np.float32)
    X0p[:n] = X0
    shard2 = NamedSharding(mesh, P(axis, None))
    maxiter = config.maxiter if config.maxiter is not None else n
    x, kk, rn, done = _sharded_multi_jit(
        jax.device_put(Ap, shard2),
        jax.device_put(Bp, shard2),
        jax.device_put(X0p, shard2),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        safe_alpha=bool(config.safe_alpha),
        axis=axis,
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=kk, residual_norm=rn, converged=done)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tol", "maxiter", "axis", "precondition", "poly_degree",
        "pc_block_size",
    ),
)
def _sharded_block_jit(
    A, B, X0, *, mesh, tol, maxiter, axis, precondition="none",
    poly_degree=0, pc_block_size=64,
):
    """Row-sharded TRUE block CG in BCGrQ form (``solver.cg.block_cg_loop``):
    the (n, k) matvec GEMM all_gathers ONE direction block per lap; the
    S^T A S Gram and the CholeskyQR2 thin-QR passes are three (k, k) psums
    per lap; all k x k algebra runs on replicated scalars.

    Preconditioning mirrors the serial ``_cg_block_pjit`` dispatch:
    Jacobi is matrix-free symmetric equilibration (shard-local row scale,
    with the column scale riding the existing all_gather — zero extra
    collectives); poly runs the flexible M^-1-inner-product
    ``block_pcg_loop`` whose pc is shard-local given the sharded mv."""
    from tpucg.kernels.matvec import matvec_xla
    from tpucg.solver.cg import (
        block_cg_loop, block_pcg_loop, dot_xla, lambda_max_estimate,
    )

    def solve(A_blk, B_blk, X_blk):
        def mv(P_blk):
            p_full = jax.lax.all_gather(P_blk, axis, tiled=True)
            return matvec_xla(A_blk, p_full)

        def gram(U_blk, V_blk):
            return jax.lax.psum(
                jnp.matmul(
                    U_blk.T, V_blk, precision=jax.lax.Precision.HIGHEST
                ),
                axis,
            )

        if precondition == "jacobi":
            sc_blk = jnp.sqrt(_jacobi_minv_blk(A_blk, axis))
            # A_hat = D^-1/2 A D^-1/2: the column scale is applied BEFORE
            # the gather (scale-then-gather == gather-then-scale, one
            # local multiply), the row scale after the local GEMM.
            mv_hat = lambda Y_blk: sc_blk[:, None] * mv(
                sc_blk[:, None] * Y_blk
            )
            k, Y, rr, done = block_cg_loop(
                mv_hat, gram, sc_blk[:, None] * B_blk,
                X_blk / sc_blk[:, None], tol=tol, maxiter=maxiter,
            )
            return sc_blk[:, None] * Y, k, jnp.sqrt(rr), done
        if precondition == "block_jacobi":
            # BLOCKWISE equilibration, shard-local exactly like the
            # single-vector arm (bs | block_rows enforced by the wrapper):
            # M^-1/2 applied before the gather and after the local GEMM —
            # valid because blockdiag(M)^-1/2 is block-diagonal on the
            # same shard-aligned blocks. The eigh/floor guards live in
            # the shared solver.cg.sqrt_pair_blocks.
            from tpucg.solver.cg import make_block_apply, sqrt_pair_blocks

            block_rows = A_blk.shape[0]
            isq, sq = sqrt_pair_blocks(
                _local_diag_blocks(A_blk, axis, pc_block_size)
            )
            sapp = make_block_apply(isq, block_rows)
            sqapp = make_block_apply(sq, block_rows)
            mv_hat = lambda Y_blk: sapp(mv(sapp(Y_blk)))
            k, Y, rr, done = block_cg_loop(
                mv_hat, gram, sapp(B_blk), sqapp(X_blk),
                tol=tol, maxiter=maxiter,
            )
            return sapp(Y), k, jnp.sqrt(rr), done
        if precondition == "poly":
            dot = lambda u, v: jax.lax.psum(dot_xla(u, v), axis)
            lam = lambda_max_estimate(
                lambda p: mv(p[:, None])[:, 0], dot, B_blk[:, 0]
            )
            w = jnp.asarray(0.95, B_blk.dtype) / lam

            def pc(R_blk):
                Z = w * R_blk
                for _ in range(poly_degree - 1):
                    Z = Z + w * R_blk - w * mv(Z)
                return Z

            k, X, rr, done = block_pcg_loop(
                mv, gram, pc, B_blk, X_blk, tol=tol, maxiter=maxiter
            )
            return X, k, jnp.sqrt(rr), done
        k, X, rr, done = block_cg_loop(
            mv, gram, B_blk, X_blk, tol=tol, maxiter=maxiter
        )
        return X, k, jnp.sqrt(rr), done

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(), P(), P()),
    )(A, B, X0)


def sharded_cg_solve_block(
    A,
    B,
    X0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """Distributed TRUE block CG: A row-block-sharded, the k right-hand
    sides sharing one block-Krylov space (``cg_solve_block``'s distributed
    composition; contrast ``sharded_cg_solve_multi``, whose k lanes search
    independently). Result fields and the preconditioning contract (the
    M^-1/2-weighted residual norm for ``"jacobi"``/``"poly"``) as
    ``cg_solve_block``.

    Sparse/stencil operators (Poisson/DIA/ELL/BSR forms) take the operator
    decompositions of ``sharded_operator_cg_solve`` with the (blk, k)
    matvec batched over the k lanes (one collective per lap);
    ``precondition`` in {'none', 'jacobi', 'poly'}."""
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg" or config.precondition not in (
        "none", "jacobi", "block_jacobi", "poly"
    ):
        raise ValueError(
            "sharded_cg_solve_block supports method='cg' with "
            "precondition 'none', 'jacobi', 'block_jacobi', or 'poly'"
        )
    if mesh is None:
        mesh = make_mesh()
    if mesh.devices.ndim == 2:
        if isinstance(A, _operator_types()):
            raise ValueError(
                "sparse operators take the 1-D operator decompositions; "
                "the 2-D SUMMA arm is dense"
            )
        return _sharded2d_block(A, B, X0, mesh, config)
    if mesh.devices.ndim != 1:
        raise ValueError("sharded_cg_solve_block runs on 1-D/2-D meshes")
    if isinstance(A, _operator_types()):
        return _sharded_operator_block(A, B, X0, mesh, config)
    axis = mesh.axis_names[0]
    num = mesh.devices.size
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    B = np.asarray(B, np.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    from tpucg.solver.cg import BLOCK_CG_MAX_K

    if k > BLOCK_CG_MAX_K:
        raise ValueError(
            f"block CG supports k <= {BLOCK_CG_MAX_K} right-hand sides "
            f"(got {k}); use sharded_cg_solve_multi for wide batches"
        )
    X0 = (
        np.zeros((n, k), np.float32)
        if X0 is None
        else np.asarray(X0, np.float32)
    )
    part = RowPartition(n=n, num_shards=num,
                        align=pc_align(ROW_ALIGN, config))
    npad = part.n_padded
    Ap = pad_identity_tail(A, npad)
    Bp = np.zeros((npad, k), np.float32)
    Bp[:n] = B
    X0p = np.zeros((npad, k), np.float32)
    X0p[:n] = X0
    shard2 = NamedSharding(mesh, P(axis, None))
    maxiter = config.maxiter if config.maxiter is not None else n
    assert (npad // num) % max(int(config.pc_block_size), 1) == 0 or \
        config.precondition != "block_jacobi"  # guaranteed by pc_align
    x, kk, rn, done = _sharded_block_jit(
        jax.device_put(Ap, shard2),
        jax.device_put(Bp, shard2),
        jax.device_put(X0p, shard2),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        axis=axis,
        precondition=config.precondition,
        poly_degree=int(config.poly_degree),
        pc_block_size=int(config.pc_block_size),
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=kk, residual_norm=rn, converged=done)


# --- Segmented (checkpointable) sharded execution -------------------------
# The CG state is the carried tuple (k, x, r, p, rsold, rslast, done);
# exposing init / run-one-segment as separate shard_map programs lets a host
# driver pull the sharded state at segment boundaries, write it to disk, and
# resume bit-identically (tpucg.solver.checkpoint.sharded_cg_solve_checkpointed).


def _state_specs(axis):
    vec, rep = P(axis), P()
    return (rep, vec, vec, vec, rep, rep, rep)  # (k, x, r, p, rsold, rslast, done)


def _local_diag_blocks(A_blk, axis, bs):
    """This shard's (block_rows/bs, bs, bs) diagonal blocks of A: slice
    the shard's diagonal square (each shard's diagonal entries live in
    its own column block, like ``_jacobi_minv_blk``) and gather the
    bs-blocks (the caller's wrapper enforces bs | block_rows)."""
    block_rows = A_blk.shape[0]
    my = jax.lax.axis_index(axis)
    sq = jax.lax.dynamic_slice(
        A_blk,
        (jnp.int32(0), (my * block_rows).astype(jnp.int32)),
        (block_rows, block_rows),
    ).astype(jnp.float32)
    ridx = jnp.arange(block_rows).reshape(block_rows // bs, bs)
    return sq[ridx[:, :, None], ridx[:, None, :]]


def _jacobi_minv_blk(A_blk, axis):
    """Each shard's diagonal entries live in its own column block (see
    _sharded_cg_jit)."""
    block_rows = A_blk.shape[0]
    my = jax.lax.axis_index(axis)
    col0 = (my * block_rows).astype(jnp.int32)
    d = jnp.diagonal(jax.lax.dynamic_slice(
        A_blk, (jnp.int32(0), col0), (block_rows, block_rows)
    )).astype(jnp.float32)  # upcast before inverting (A may be bf16 storage)
    return jnp.where(d != 0, 1.0 / d, 1.0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "strategy", "tol", "axis", "precondition",
    ),
)
def _sharded_init_jit(
    A, b, x0, *, mesh, strategy, tol, axis, precondition="none"
):
    num = mesh.devices.size

    def init(A_blk, b_blk, x_blk):
        mv = _make_matvec(A_blk, strategy, num, axis)
        dot, _, _ = _make_reductions(axis)
        precond = None
        if precondition == "jacobi":
            minv = _jacobi_minv_blk(A_blk, axis)
            precond = lambda r: minv * r
        from tpucg.solver.cg import init_state

        s = init_state(mv, dot, b_blk, x_blk, tol, precond=precond)
        return s.k, s.x, s.r, s.p, s.rsold, s.rslast, s.done

    return jax.shard_map(
        init,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=_state_specs(axis),
    )(A, b, x0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "strategy", "tol", "safe_alpha", "axis",
        "precondition",
    ),
)
def _sharded_segment_jit(
    A, state, k_target, *, mesh, strategy, tol, safe_alpha, axis,
    precondition="none",
):
    """Advance the sharded CG state to cumulative iteration ``k_target`` (a
    TRACED scalar, so every segment reuses one executable)."""
    num = mesh.devices.size

    def seg(A_blk, k, x_blk, r_blk, p_blk, rsold, rslast, done, kt):
        from tpucg.solver.cg import _State

        mv = _make_matvec(A_blk, strategy, num, axis)
        dot, _, update = _make_reductions(axis)
        precond = None
        if precondition == "jacobi":
            minv = _jacobi_minv_blk(A_blk, axis)
            precond = lambda r: minv * r
        st = _State(k=k, x=x_blk, r=r_blk, p=p_blk, rsold=rsold,
                    rslast=rslast, done=done)
        s = cg_loop(
            mv, dot, update, None, None,
            tol=tol, maxiter=kt, safe_alpha=safe_alpha, state=st,
            precond=precond,
        )
        return s.k, s.x, s.r, s.p, s.rsold, s.rslast, s.done

    return jax.shard_map(
        seg,
        mesh=mesh,
        in_specs=(P(axis, None),) + _state_specs(axis) + (P(),),
        out_specs=_state_specs(axis),
    )(A, *state, k_target)


@functools.partial(
    jax.jit, static_argnames=("mesh", "strategy", "axis")
)
def _sharded_matvec_jit(A, v, *, mesh, strategy, axis):
    """One distributed matvec (used by the checkpoint identity signature)."""
    num = mesh.devices.size

    def f(A_blk, v_blk):
        mv = _make_matvec(A_blk, strategy, num, axis)
        return mv(v_blk)

    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=P(axis),
    )(A, v)


def _segment_precond(precondition, minv_blk, acinv_rep, mv, dot, like_blk,
                     axis, tl_agg, tl_omega, tl_sd, tl_sa):
    """Preconditioner closure shared by the checkpointed init/segment jits
    ('none' | 'jacobi' | 'two_level'). The two-level branch rebuilds the
    sharded cycle from the same deterministic pieces every segment
    (lambda_max_estimate seeds from an iota), so resume is bit-identical."""
    if precondition == "jacobi":
        return lambda r: minv_blk * r
    if precondition == "two_level":
        from tpucg.solver.twolevel import make_two_level_precond_sharded

        return make_two_level_precond_sharded(
            mv, dot, like_blk, acinv_rep, minv_blk, tl_agg, tl_omega,
            axis, smooth_degree=tl_sd, smooth_alpha=tl_sa,
        )
    return None


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tol", "axis", "kind", "m", "m_padded", "offsets",
        "precondition", "tl_agg", "tl_omega", "tl_sd", "tl_sa",
    ),
)
def _sharded_operator_init_jit(
    op_arrays, b, x0, minv, acinv, *, mesh, tol, axis, kind, m, m_padded,
    offsets, precondition="none", tl_agg=0, tl_omega=0.7, tl_sd=1,
    tl_sa=4.0,
):
    num = mesh.devices.size

    def init(op_blk, b_blk, x_blk, minv_blk, acinv_rep):
        from tpucg.solver.cg import init_state

        mv = _operator_matvec(
            kind, op_blk, axis, num, m, m_padded, offsets
        )
        dot, _, _ = _make_reductions(axis)
        precond = _segment_precond(
            precondition, minv_blk, acinv_rep, mv, dot, b_blk, axis,
            tl_agg, tl_omega, tl_sd, tl_sa,
        )
        s = init_state(mv, dot, b_blk, x_blk, tol, precond=precond)
        return s.k, s.x, s.r, s.p, s.rsold, s.rslast, s.done

    return jax.shard_map(
        init,
        mesh=mesh,
        in_specs=(_operator_specs(kind, axis), P(axis), P(axis), P(axis),
                  P(None, None)),
        out_specs=_state_specs(axis),
    )(op_arrays, b, x0, minv, acinv)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tol", "safe_alpha", "axis", "kind", "m", "m_padded",
        "offsets", "precondition", "tl_agg", "tl_omega", "tl_sd",
        "tl_sa",
    ),
)
def _sharded_operator_segment_jit(
    op_arrays, state, k_target, minv, acinv, b=None, *, mesh, tol,
    safe_alpha, axis, kind, m, m_padded, offsets,
    precondition="none", tl_agg=0, tl_omega=0.7, tl_sd=1, tl_sa=4.0,
    stag_carry=None,
):
    num = mesh.devices.size
    if b is None:
        b = jnp.zeros_like(state[1])
    if stag_carry is None:
        # Replicated stagnation bookkeeping (cg_loop's stag_carry): must
        # thread ACROSS segment calls or a floor-bound two_level solve
        # grinds to maxiter instead of stagnation-stopping (same bug the
        # serial segment driver had — see solver.checkpoint).
        stag_carry = (jnp.asarray(np.inf, jnp.float32),
                      jnp.zeros((), jnp.bool_))

    def seg(op_blk, k, x_blk, r_blk, p_blk, rsold, rslast, done, kt,
            minv_blk, acinv_rep, b_blk, stag_rr, stag_flag):
        from tpucg.solver.cg import _State

        mv = _operator_matvec(
            kind, op_blk, axis, num, m, m_padded, offsets
        )
        dot, _, update = _make_reductions(axis)
        precond = _segment_precond(
            precondition, minv_blk, acinv_rep, mv, dot, x_blk, axis,
            tl_agg, tl_omega, tl_sd, tl_sa,
        )
        st = _State(k=k, x=x_blk, r=r_blk, p=p_blk, rsold=rsold,
                    rslast=rslast, done=done)
        s, (rr_c, st_c) = cg_loop(
            mv, dot, update, b_blk, None,
            tol=tol, maxiter=kt, safe_alpha=safe_alpha, state=st,
            precond=precond,
            check_true_every=(
                _TRUE_CHECK if precondition == "two_level" else None
            ),
            stag_carry=(stag_rr, stag_flag), return_stag=True,
        )
        return s.k, s.x, s.r, s.p, s.rsold, s.rslast, s.done, rr_c, st_c

    return jax.shard_map(
        seg,
        mesh=mesh,
        in_specs=(
            (_operator_specs(kind, axis),) + _state_specs(axis)
            + (P(), P(axis), P(None, None), P(axis), P(), P())
        ),
        out_specs=_state_specs(axis) + (P(), P()),
    )(op_arrays, *state, k_target, minv, acinv, b, *stag_carry)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "kind", "m", "m_padded", "offsets",
    ),
)
def _sharded_operator_matvec_jit(
    op_arrays, v, *, mesh, axis, kind, m, m_padded, offsets
):
    num = mesh.devices.size

    def f(op_blk, v_blk):
        mv = _operator_matvec(
            kind, op_blk, axis, num, m, m_padded, offsets
        )
        return mv(v_blk)

    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(_operator_specs(kind, axis), P(axis)),
        out_specs=P(axis),
    )(op_arrays, v)


def _operator_specs(kind, axis):
    if kind == "poisson":
        return P(axis)
    if kind == "dia":
        return P(None, axis)
    if kind == "bsr":
        return (P(axis, None, None, None), P(axis, None))
    if kind == "well":
        # (vals, lidx, gidl, wrow, sgb), each stacked along a leading
        # shard axis (see sparse.well.csr_to_well_sharded).
        return (P(axis, None, None), P(axis, None, None),
                P(axis, None, None), P(axis, None), P(axis, None))
    return (P(axis, None), P(axis, None))


def _matvec_2d(A_blk, r_ax: str, c_ax: str):
    """SUMMA-style 2-D GEMV closure: all_gather the direction chunk within
    mesh columns, local partial GEMV, psum_scatter within mesh rows —
    O(n/C + n/R) comm per lap (see ``_sharded2d_cg_jit``)."""

    def mv(p_blk):
        p_cols = jax.lax.all_gather(p_blk, r_ax, tiled=True)  # (n/C,)
        partial = matvec_xla(A_blk, p_cols)      # (n/R,)
        return jax.lax.psum_scatter(
            partial, c_ax, scatter_dimension=0, tiled=True
        )  # (n/(R*C),)

    return mv


def _state_specs_2d(r_ax, c_ax):
    vec, rep = P((r_ax, c_ax),), P()
    return (rep, vec, vec, vec, rep, rep, rep)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "precondition"),
)
def _sharded2d_init_jit(
    A, b, x0, minv, *, mesh, tol, precondition="none"
):
    r_ax, c_ax = mesh.axis_names

    def init(A_blk, b_blk, x_blk, minv_blk):
        from tpucg.solver.cg import init_state

        mv = _matvec_2d(A_blk, r_ax, c_ax)
        dot, _, _ = _make_reductions((r_ax, c_ax))
        precond = (
            (lambda r: minv_blk * r) if precondition == "jacobi" else None
        )
        s = init_state(mv, dot, b_blk, x_blk, tol, precond=precond)
        return s.k, s.x, s.r, s.p, s.rsold, s.rslast, s.done

    vec = P((r_ax, c_ax),)
    return jax.shard_map(
        init,
        mesh=mesh,
        in_specs=(P(r_ax, c_ax), vec, vec, vec),
        out_specs=_state_specs_2d(r_ax, c_ax),
    )(A, b, x0, minv)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "safe_alpha", "precondition"),
)
def _sharded2d_segment_jit(
    A, state, k_target, minv, *, mesh, tol, safe_alpha,
    precondition="none",
):
    r_ax, c_ax = mesh.axis_names

    def seg(A_blk, k, x_blk, r_blk, p_blk, rsold, rslast, done, kt,
            minv_blk):
        from tpucg.solver.cg import _State

        mv = _matvec_2d(A_blk, r_ax, c_ax)
        dot, _, update = _make_reductions((r_ax, c_ax))
        precond = (
            (lambda r: minv_blk * r) if precondition == "jacobi" else None
        )
        st = _State(k=k, x=x_blk, r=r_blk, p=p_blk, rsold=rsold,
                    rslast=rslast, done=done)
        s = cg_loop(
            mv, dot, update, None, None,
            tol=tol, maxiter=kt, safe_alpha=safe_alpha, state=st,
            precond=precond,
        )
        return s.k, s.x, s.r, s.p, s.rsold, s.rslast, s.done

    vec = P((r_ax, c_ax),)
    return jax.shard_map(
        seg,
        mesh=mesh,
        in_specs=(
            (P(r_ax, c_ax),) + _state_specs_2d(r_ax, c_ax) + (P(), vec)
        ),
        out_specs=_state_specs_2d(r_ax, c_ax),
    )(A, *state, k_target, minv)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded2d_matvec_jit(A, v, *, mesh):
    r_ax, c_ax = mesh.axis_names

    def f(A_blk, v_blk):
        return _matvec_2d(A_blk, r_ax, c_ax)(v_blk)

    vec = P((r_ax, c_ax),)
    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(r_ax, c_ax), vec),
        out_specs=vec,
    )(A, v)


def _colperm_2d(npad: int, R: int, C: int) -> np.ndarray:
    """Column permutation aligning A's storage with the 2-D gather order.

    Vectors are sharded P(('rows','cols')): device (i, j) holds the
    contiguous chunk k = i*C + j. ``all_gather`` over 'rows' on device (i, j)
    concatenates chunks (0..R-1, j) in i-order, so A's local column block must
    contain exactly those chunks' columns in that order: global column
    position j*(npad/C) + i*(npad/(R*C)) + t maps to column (i*C+j)*chunk + t.
    A pure storage-layout permutation — vectors, b, and the solution all stay
    in natural order.
    """
    cs = npad // (R * C)
    perm = np.empty(npad, dtype=np.int64)
    pos = 0
    for j in range(C):
        for i in range(R):
            k = i * C + j
            perm[pos:pos + cs] = np.arange(k * cs, (k + 1) * cs)
            pos += cs
    return perm


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tol", "maxiter", "safe_alpha", "method",
        "precondition", "poly_degree", "record", "s_step", "check_every",
    ),
)
def _sharded2d_cg_jit(
    A, b, x0, minv, *, mesh, tol, maxiter, safe_alpha, method="cg",
    precondition="none", poly_degree=0, record=False, s_step=3,
    check_every=8,
):
    """2-D block decomposition (SUMMA-style GEMV) — beyond the reference
    (which only row-stripes, SURVEY.md §2.4): A sharded P('rows','cols'),
    vectors fully sharded over both axes. Per lap the direction vector is
    all-gathered only within mesh columns (n/C data over R devices) and the
    partial GEMV results reduce-scattered within mesh rows (n/R over C) —
    O(n/C + n/R) comm instead of the 1-D allgather's O(n)."""
    r_ax, c_ax = mesh.axis_names

    def solve(A_blk, b_blk, x_blk, minv_blk):
        mv = _matvec_2d(A_blk, r_ax, c_ax)
        dot, dots, update = _make_reductions((r_ax, c_ax))

        precond = None
        if precondition == "jacobi":
            # The diagonal is computed on the host (distribute step) and
            # sharded exactly like the vectors, so the preconditioner is a
            # local elementwise multiply.
            precond = lambda r: minv_blk * r
        elif precondition == "poly":
            precond = make_poly_precond(mv, dot, b_blk, poly_degree)

        if method == "pipelined":
            x, k, rn, done = _run_pipelined(
                mv, dot, dots, b_blk, x_blk, tol, maxiter, safe_alpha,
                precond=precond,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)
        if method == "ca":
            x, k, rn, done = _run_ca(
                mv, dot, b_blk, x_blk, (r_ax, c_ax),
                s_step=s_step, tol=tol, maxiter=maxiter,
                safe_alpha=safe_alpha,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)
        if method == "chebyshev":
            x, k, rn, done = _run_chebyshev(
                mv, dot, b_blk, x_blk,
                tol=tol, maxiter=maxiter, check_every=check_every,
                precond=precond,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)

        s = cg_loop(
            mv, dot, update, b_blk, x_blk,
            tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
            hist_len=maxiter if record else None,
        )
        hist = s.hist if record else jnp.zeros((1,), jnp.float32)
        return s.x, s.k, jnp.sqrt(s.rslast), s.done, hist

    vec = P((r_ax, c_ax),)
    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(r_ax, c_ax), vec, vec, vec),
        out_specs=(vec, P(), P(), P(), P()),
    )(A, b, x0, minv)


def distribute_system_2d(
    A: np.ndarray,
    b: np.ndarray,
    x0: Optional[np.ndarray],
    mesh: Mesh,
    align: int = 1,
    storage_dtype=np.float32,
):
    """Pad, column-permute, and place (A, b, x0) block-sharded on a 2-D mesh
    (see ``_colperm_2d``). Returns (A2, b, x0, n_padded).
    ``storage_dtype=bfloat16`` halves each block's HBM bytes (the local
    partial GEMV upcasts/accumulates in f32, same as the 1-D path)."""
    R, C = mesh.devices.shape
    n = A.shape[0]
    base = int(np.lcm.reduce([R * C, R * align, C * align]))
    npad = ((n + base - 1) // base) * base
    part = RowPartition(n=n, num_shards=1, align=npad)  # pad to npad exactly
    Ap, bp, x0p = pad_system(A, b, x0, part)
    A2 = Ap[:, _colperm_2d(npad, R, C)]
    if jnp.dtype(storage_dtype) == jnp.bfloat16:
        import ml_dtypes

        A2 = A2.astype(ml_dtypes.bfloat16)  # host cast: ships 2 B/elt
    r_ax, c_ax = mesh.axis_names
    return (
        jax.device_put(A2, NamedSharding(mesh, P(r_ax, c_ax))),
        jax.device_put(bp, NamedSharding(mesh, P((r_ax, c_ax),))),
        jax.device_put(x0p, NamedSharding(mesh, P((r_ax, c_ax),))),
        npad,
    )


def _poisson_halo_matvec(m: int, m_padded: int, axis: str, num: int):
    """Slab-decomposed 3-D 7-point Laplacian with ppermute halo exchange.

    Device d owns x-planes [d*mp, (d+1)*mp) of the m^3 grid (mp =
    m_padded/P; when m % P != 0 the grid is plane-padded to m_padded and the
    pad planes act as a decoupled identity block — the sparse analog of the
    dense identity-tail padding, lifting the reference's ``ROWS % P == 0``
    restriction instead of inheriting it, SURVEY.md §7 hard part c). Each
    lap it needs one boundary plane from each neighbor; the two ``ppermute``
    halo transfers are dataflow-independent of the in-slab y/z stencil work,
    so XLA can overlap the transfer with local compute — the BASELINE.json
    north star ("halo segments exchanged via collective-permute overlapped with
    local matVec"), replacing the reference's replicate-everything allgather
    (``parallel_cg.c:290-291``). Unpaired edge devices receive zeros from
    ppermute — exactly the Dirichlet boundary condition.
    """
    mp = m_padded // num
    down = [(j, j + 1) for j in range(num - 1)]  # d sends its last plane to d+1
    up = [(j + 1, j) for j in range(num - 1)]    # d sends its first plane to d-1

    def mv(u_flat):
        u_raw = u_flat.reshape(mp, m, m)
        if m_padded != m:
            # Zero the pad planes on input (making the operator exactly
            # block-diag(A_poisson, I) for ANY vector) and restore them as
            # identity on output; plane ownership is static per device.
            d = jax.lax.axis_index(axis)
            plane = d * mp + jnp.arange(mp)
            mask = (plane < m).astype(u_raw.dtype)[:, None, None]
            u = u_raw * mask
        else:
            u = u_raw
        halo_lo = jax.lax.ppermute(u[-1:], axis, down)  # plane (d*mp - 1)
        halo_hi = jax.lax.ppermute(u[:1], axis, up)     # plane ((d+1)*mp)

        def finish(y):
            if m_padded != m:
                y = jnp.where(mask > 0, y, u_raw)
            return y.reshape(-1)

        # In-slab y/z stencil (independent of the halos -> overlaps them),
        # then the x-direction via the extended slab.
        y = 6.0 * u
        zeros = jnp.zeros_like(u[:, :1])
        y = y - jnp.concatenate([u[:, 1:], zeros], axis=1)
        y = y - jnp.concatenate([zeros, u[:, :-1]], axis=1)
        zeros = jnp.zeros_like(u[:, :, :1])
        y = y - jnp.concatenate([u[:, :, 1:], zeros], axis=2)
        y = y - jnp.concatenate([zeros, u[:, :, :-1]], axis=2)
        u_ext = jnp.concatenate([halo_lo, u, halo_hi], axis=0)  # (mp+2, m, m)
        y = y - u_ext[2:] - u_ext[:-2]
        return finish(y)

    return mv


def _dia_halo_matvec(offsets: tuple, axis: str, num: int):
    """Row-block-sharded banded (DIA) SpMV with ppermute halo exchange.

    Each device owns a contiguous block of rows plus the (ndiag, blk)
    diagonal slab for them; per lap it needs only the band-reach window
    from each neighbor — O(band) elements over the ring vs the all_gather's
    O(n). The sparse-general analog of the Poisson slab halo, valid for any
    banded matrix whose reach fits within one block.
    """
    from tpucg.kernels.spmv import dia_halo_width, dia_spmv_halo

    pad = dia_halo_width(offsets)
    down = [(j, j + 1) for j in range(num - 1)]
    up = [(j + 1, j) for j in range(num - 1)]

    def mv(data_blk, x_blk):
        halo_lo = jax.lax.ppermute(x_blk[-pad:], axis, down)
        halo_hi = jax.lax.ppermute(x_blk[:pad], axis, up)
        return dia_spmv_halo(data_blk, offsets, x_blk, halo_lo, halo_hi)

    return mv


def _ell_allgather_matvec(values_blk, indices_blk, axis: str):
    """Row-sharded ELL SpMV: gather the full direction vector, multiply the
    local rows (global column indices stay valid). The sparse analog of the
    reference's collective arm."""

    def mv(x_blk):
        x_full = jax.lax.all_gather(x_blk, axis, tiled=True)
        return ell_spmv(values_blk, indices_blk, x_full)

    return mv


def _operator_matvec(kind, op_blk, axis, num, m, m_padded, offsets):
    """Per-shard matvec closure for the operator decompositions — shared by
    the solve, init, segment, and probe jits."""
    if kind == "poisson":
        return _poisson_halo_matvec(m, m_padded, axis, num)
    if kind == "dia":
        dia_mv = _dia_halo_matvec(offsets, axis, num)
        return lambda v: dia_mv(op_blk, v)
    if kind == "well":
        # Row-block sharded WELL: vals/lidx/gidl/wrow/sgb arrive with a
        # leading stack dim of 1 (P(axis, None, ...)); x is all_gathered
        # (windows address GLOBAL columns). Statics ride the shared slots:
        # m = rows per shard, offsets = (bg, nsg) — DIA's band offsets are
        # meaningless for WELL, so the tuple slot is reused.
        from tpucg.kernels.gather_spmv import LANE as _WL
        from tpucg.kernels.gather_spmv import well_spmv_xla

        vals, lidx, gidl, wrow, sgb = (a[0] for a in op_blk)
        bg, nsg = offsets

        def mv(x_blk):
            x_full = jax.lax.all_gather(x_blk, axis, tiled=True)
            y2 = well_spmv_xla(vals, lidx, gidl, wrow, sgb,
                               x_full.reshape(-1, _WL), bg=bg, nsg=nsg)
            return y2.reshape(-1)[:m]

        return mv
    if kind == "bsr":
        values_blk, indices_blk = op_blk

        def mv(v_blk):
            v_full = jax.lax.all_gather(v_blk, axis, tiled=True)
            return bsr_ell_spmv(values_blk, indices_blk, v_full)

        return mv
    values_blk, indices_blk = op_blk
    return _ell_allgather_matvec(values_blk, indices_blk, axis)


def _operator_matvec_batched(kind, op_blk, axis, num, m, m_padded, offsets):
    """(blk, k) -> (blk, k) batched per-shard matvec for the multi-RHS and
    block decompositions: the single-vector XLA closure vmapped over the
    RHS axis — the shift-and-add / stencil / gather arms batch into clean
    (blk, k) ops and the collectives into ONE (halo, k) ppermute /
    (blk, k) all_gather per lap."""
    return jax.vmap(
        _operator_matvec(kind, op_blk, axis, num, m, m_padded, offsets),
        in_axes=1, out_axes=1,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tol", "maxiter", "safe_alpha", "axis", "method", "kind", "m",
        "m_padded", "precondition", "poly_degree", "offsets", "record",
        "s_step", "check_every", "interval", "tl_agg", "tl_omega",
        "tl_sd", "tl_sa",
    ),
)
def _sharded_operator_cg_jit(
    op_arrays, b, x0, minv, acinv, tl_obj=None, *, mesh, tol, maxiter,
    safe_alpha, axis, method="cg", kind="ell", m=None, m_padded=None,
    precondition="none", poly_degree=0, offsets=None,
    record=False, s_step=3, check_every=8, interval=None, tl_agg=0,
    tl_omega=0.7, tl_sd=1, tl_sa=4.0,
):
    num = mesh.devices.size
    # The multilevel hierarchy (TwoLevel with inner levels) enters the
    # shard_map as flattened replicated leaves — shard_map cannot close
    # over tracers, and the nested operator pytree has mixed ranks, so
    # per-leaf all-None specs are built mechanically.
    tl_leaves, tl_def = jax.tree_util.tree_flatten(tl_obj)
    tl_specs = tuple(
        P(*([None] * getattr(l, "ndim", 0))) for l in tl_leaves
    )

    def solve(op_blk, b_blk, x_blk, minv_blk, acinv_rep, *tl_ls):
        tl = jax.tree_util.tree_unflatten(tl_def, tl_ls)
        mv = _operator_matvec(
            kind, op_blk, axis, num, m, m_padded, offsets
        )
        dot, dots, update = _make_reductions(axis)
        precond = None
        if precondition == "jacobi":
            precond = lambda r: minv_blk * r
        elif precondition == "block_jacobi":
            # Shard-local batched block-GEMV: the block grid restarts at
            # every shard boundary (see _diag_blocks_sharded), so no
            # communication per apply.
            precond = make_block_precond(minv_blk, b_blk.shape[0])
        elif precondition == "poly":
            precond = make_poly_precond(mv, dot, b_blk, poly_degree)
        elif precondition == "two_level":
            # minv carries the sharded 1/diag; acinv the replicated
            # coarse inverse (see solver.twolevel); tl the full object
            # when the hierarchy is multilevel.
            from tpucg.solver.twolevel import (
                make_two_level_precond_sharded,
            )

            precond = make_two_level_precond_sharded(
                mv, dot, b_blk, acinv_rep, minv_blk, tl_agg, tl_omega,
                axis, smooth_degree=tl_sd, smooth_alpha=tl_sa, tl=tl,
            )
        if method == "pipelined":
            x, k, rn, done = _run_pipelined(
                mv, dot, dots, b_blk, x_blk, tol, maxiter, safe_alpha,
                precond=precond,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)
        if method == "ca":
            x, k, rn, done = _run_ca(
                mv, dot, b_blk, x_blk, axis,
                s_step=s_step, tol=tol, maxiter=maxiter,
                safe_alpha=safe_alpha, interval=interval,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)
        if method == "chebyshev":
            x, k, rn, done = _run_chebyshev(
                mv, dot, b_blk, x_blk,
                tol=tol, maxiter=maxiter, check_every=check_every,
                precond=precond, interval=interval,
            )
            return x, k, rn, done, jnp.zeros((1,), jnp.float32)

        s = cg_loop(
            mv, dot, update, b_blk, x_blk,
            tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
            hist_len=maxiter if record else None,
            # True-residual stopping for the strong-preconditioner path
            # (solver.cg.TRUE_CHECK_EVERY — collective-safe: the check
            # matvec/psum run unconditionally at segment boundaries).
            check_true_every=(
                _TRUE_CHECK if precondition == "two_level" else None
            ),
        )
        hist = s.hist if record else jnp.zeros((1,), jnp.float32)
        conv = s.rslast < jnp.asarray(tol, s.rslast.dtype) ** 2
        return s.x, s.k, jnp.sqrt(s.rslast), conv, hist

    vec = P(axis)
    minv_spec = (
        P(axis, None, None) if precondition == "block_jacobi" else vec
    )
    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(_operator_specs(kind, axis), vec, vec, minv_spec,
                  P(None, None)) + tl_specs,
        out_specs=(vec, P(), P(), P(), P()),
    )(op_arrays, b, x0, minv, acinv, *tl_leaves)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "safe_alpha", "axis", "kind",
                     "m", "m_padded", "offsets"),
)
def _sharded_operator_multi_jit(
    op_arrays, B, X0, *, mesh, tol, maxiter, safe_alpha, axis, kind,
    m=None, m_padded=None, offsets=None,
):
    """Operator-sharded multi-RHS CG: k lockstep recurrences vmapped over
    the RHS axis INSIDE shard_map — the per-lane halo ppermutes /
    all_gathers batch into ONE (halo, k) / (blk, k) collective per lap and
    the stencil / shift-and-add arms into (blk, k) elementwise ops."""
    num = mesh.devices.size

    def solve(op_blk, B_blk, X_blk):
        mv1 = _operator_matvec(
            kind, op_blk, axis, num, m, m_padded, offsets
        )

        def one(b_blk, x_blk):
            dot, _, update = _make_reductions(axis)
            s = cg_loop(
                mv1, dot, update, b_blk, x_blk,
                tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            )
            return s.x, s.k, jnp.sqrt(s.rslast), s.done

        if kind == "well":
            outs = [one(B_blk[:, j], X_blk[:, j])
                    for j in range(B_blk.shape[1])]
            return (jnp.stack([o[0] for o in outs], axis=1),
                    jnp.stack([o[1] for o in outs]),
                    jnp.stack([o[2] for o in outs]),
                    jnp.stack([o[3] for o in outs]))
        return jax.vmap(one, in_axes=1, out_axes=(1, 0, 0, 0))(B_blk, X_blk)

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(_operator_specs(kind, axis), P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(), P(), P()),
    )(op_arrays, B, X0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "axis", "precondition",
                     "poly_degree", "kind", "m", "m_padded", "offsets"),
)
def _sharded_operator_block_jit(
    op_arrays, B, X0, minv, *, mesh, tol, maxiter, axis,
    precondition="none", poly_degree=0, kind="ell", m=None, m_padded=None,
    offsets=None,
):
    """Operator-sharded TRUE block CG (BCGrQ): the (blk, k) matvec is the
    batched operator closure (one collective per lap), the Gram/thin-QR
    algebra the same three (k, k) psums as the dense arm. Jacobi is
    matrix-free symmetric equilibration with the prepared 1/diag shard
    (sqrt applied on both sides of the batched matvec); poly the flexible
    M^-1-inner-product ``block_pcg_loop``."""
    from tpucg.solver.cg import (
        block_cg_loop, block_pcg_loop, dot_xla, lambda_max_estimate,
    )

    num = mesh.devices.size

    def solve(op_blk, B_blk, X_blk, minv_blk):
        mv = _operator_matvec_batched(
            kind, op_blk, axis, num, m, m_padded, offsets
        )

        def gram(U_blk, V_blk):
            return jax.lax.psum(
                jnp.matmul(
                    U_blk.T, V_blk, precision=jax.lax.Precision.HIGHEST
                ),
                axis,
            )

        if precondition == "jacobi":
            sc_blk = jnp.sqrt(minv_blk)
            mv_hat = lambda Y_blk: sc_blk[:, None] * mv(
                sc_blk[:, None] * Y_blk
            )
            k, Y, rr, done = block_cg_loop(
                mv_hat, gram, sc_blk[:, None] * B_blk,
                X_blk / sc_blk[:, None], tol=tol, maxiter=maxiter,
            )
            return sc_blk[:, None] * Y, k, jnp.sqrt(rr), done
        if precondition == "poly":
            dot = lambda u, v: jax.lax.psum(dot_xla(u, v), axis)
            lam = lambda_max_estimate(
                lambda p: mv(p[:, None])[:, 0], dot, B_blk[:, 0]
            )
            w = jnp.asarray(0.95, B_blk.dtype) / lam

            def pc(R_blk):
                Z = w * R_blk
                for _ in range(poly_degree - 1):
                    Z = Z + w * R_blk - w * mv(Z)
                return Z

            k, X, rr, done = block_pcg_loop(
                mv, gram, pc, B_blk, X_blk, tol=tol, maxiter=maxiter
            )
            return X, k, jnp.sqrt(rr), done
        k, X, rr, done = block_cg_loop(
            mv, gram, B_blk, X_blk, tol=tol, maxiter=maxiter
        )
        return X, k, jnp.sqrt(rr), done

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(_operator_specs(kind, axis), P(axis, None), P(axis, None),
                  P(axis)),
        out_specs=(P(axis, None), P(), P(), P()),
    )(op_arrays, B, X0, minv)


def _matvec_2d_batched(A_blk, r_ax: str, c_ax: str):
    """(blk, k) -> (blk, k) SUMMA matvec: ONE (n/C, k) all_gather, one
    local (n/R, n/C) x (n/C, k) GEMM, one (n/R, k) psum_scatter — the k
    lanes amortize A's stream exactly like the 1-D multi path."""

    def mv(X_blk):
        X_cols = jax.lax.all_gather(X_blk, r_ax, tiled=True)
        partial = jnp.matmul(
            A_blk.astype(jnp.float32), X_cols,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jax.lax.psum_scatter(
            partial, c_ax, scatter_dimension=0, tiled=True
        )

    return mv


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "safe_alpha"),
)
def _sharded2d_multi_jit(A, B, X0, *, mesh, tol, maxiter, safe_alpha):
    """2-D SUMMA multi-RHS CG: k lockstep recurrences sharing one batched
    SUMMA matvec per lap (the scalars vmap; the collectives batch)."""
    r_ax, c_ax = mesh.axis_names
    axes = (r_ax, c_ax)

    def solve(A_blk, B_blk, X_blk):
        mvb = _matvec_2d_batched(A_blk, r_ax, c_ax)

        def dot(u, v):
            return jax.lax.psum(dot_xla(u, v), axes)

        def one(b_blk, x_blk, mv1):
            def update(x, r, p, ap, alpha):
                x2 = x + alpha * p
                r2 = r - alpha * ap
                return x2, r2, jax.lax.psum(dot_xla(r2, r2), axes)

            s = cg_loop(
                mv1, dot, update, b_blk, x_blk,
                tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            )
            return s.x, s.k, jnp.sqrt(s.rslast), s.done

        # vmap over lanes; the per-lane matvec re-expands to the batched
        # closure under vmap (one collective for all lanes).
        return jax.vmap(
            lambda b_, x_: one(b_, x_, lambda v: mvb(v[:, None])[:, 0]),
            in_axes=1, out_axes=(1, 0, 0, 0),
        )(B_blk, X_blk)

    vec2 = P((r_ax, c_ax), None)
    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(r_ax, c_ax), vec2, vec2),
        out_specs=(vec2, P(), P(), P()),
    )(A, B, X0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "precondition", "poly_degree"),
)
def _sharded2d_block_jit(A, B, X0, minv, *, mesh, tol, maxiter,
                         precondition="none", poly_degree=0):
    """2-D SUMMA TRUE block CG (BCGrQ): the (blk, k) matvec is one batched
    SUMMA pass; the Gram/thin-QR (k, k) algebra psums over BOTH axes.
    Jacobi is matrix-free symmetric equilibration with the flat-sharded
    1/diag (the diagonal scale commutes with the column permutation —
    scaling x pre-gather IS scaling A's matching columns)."""
    from tpucg.solver.cg import (
        block_cg_loop, block_pcg_loop, dot_xla as _dx, lambda_max_estimate,
    )

    r_ax, c_ax = mesh.axis_names
    axes = (r_ax, c_ax)

    def solve(A_blk, B_blk, X_blk, minv_blk):
        mv = _matvec_2d_batched(A_blk, r_ax, c_ax)

        def gram(U_blk, V_blk):
            return jax.lax.psum(
                jnp.matmul(
                    U_blk.T, V_blk, precision=jax.lax.Precision.HIGHEST
                ),
                axes,
            )

        if precondition == "jacobi":
            sc_blk = jnp.sqrt(minv_blk)
            mv_hat = lambda Y_blk: sc_blk[:, None] * mv(
                sc_blk[:, None] * Y_blk
            )
            k, Y, rr, done = block_cg_loop(
                mv_hat, gram, sc_blk[:, None] * B_blk,
                X_blk / sc_blk[:, None], tol=tol, maxiter=maxiter,
            )
            return sc_blk[:, None] * Y, k, jnp.sqrt(rr), done
        if precondition == "poly":
            dot = lambda u, v: jax.lax.psum(_dx(u, v), axes)
            lam = lambda_max_estimate(
                lambda p: mv(p[:, None])[:, 0], dot, B_blk[:, 0]
            )
            w = jnp.asarray(0.95, B_blk.dtype) / lam

            def pc(R_blk):
                Z = w * R_blk
                for _ in range(poly_degree - 1):
                    Z = Z + w * R_blk - w * mv(Z)
                return Z

            k, X, rr, done = block_pcg_loop(
                mv, gram, pc, B_blk, X_blk, tol=tol, maxiter=maxiter
            )
            return X, k, jnp.sqrt(rr), done
        k, X, rr, done = block_cg_loop(
            mv, gram, B_blk, X_blk, tol=tol, maxiter=maxiter
        )
        return X, k, jnp.sqrt(rr), done

    vec2 = P((r_ax, c_ax), None)
    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(r_ax, c_ax), vec2, vec2, P((r_ax, c_ax),)),
        out_specs=(vec2, P(), P(), P()),
    )(A, B, X0, minv)


def _sharded2d_multi(A, B, X0, mesh, config) -> CGResult:
    """2-D arm of :func:`sharded_cg_solve_multi`."""
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    B = np.asarray(B, np.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    align = 1
    r_ax, c_ax = mesh.axis_names
    Ad, _, _, npad = distribute_system_2d(
        A, np.zeros(n, np.float32), None, mesh, align=align
    )
    Bp = np.zeros((npad, k), np.float32)
    Bp[:n] = B
    X0p = np.zeros((npad, k), np.float32)
    if X0 is not None:
        X0p[:n] = np.asarray(X0, np.float32)
    shard = NamedSharding(mesh, P((r_ax, c_ax), None))
    maxiter = config.maxiter if config.maxiter is not None else n
    x, kk, rn, done = _sharded2d_multi_jit(
        Ad,
        jax.device_put(Bp, shard),
        jax.device_put(X0p, shard),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        safe_alpha=bool(config.safe_alpha),
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=kk, residual_norm=rn, converged=done)


def _sharded2d_block(A, B, X0, mesh, config) -> CGResult:
    """2-D arm of :func:`sharded_cg_solve_block`."""
    if config.precondition not in ("none", "jacobi", "poly"):
        raise ValueError(
            "2-D block CG supports precondition in {'none', 'jacobi', "
            "'poly'} (block Jacobi is 1-D-only: the 2-D decomposition "
            "stores column-permuted blocks)"
        )
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    B = np.asarray(B, np.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    from tpucg.solver.cg import BLOCK_CG_MAX_K

    if k > BLOCK_CG_MAX_K:
        raise ValueError(
            f"block CG supports k <= {BLOCK_CG_MAX_K} right-hand sides "
            f"(got {k}); use sharded_cg_solve_multi for wide batches"
        )
    r_ax, c_ax = mesh.axis_names
    Ad, _, _, npad = distribute_system_2d(
        A, np.zeros(n, np.float32), None, mesh,
        align=1,
    )
    d = np.ones(npad, np.float32)
    d[:n] = np.diag(A).astype(np.float32)
    minv = np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)
    Bp = np.zeros((npad, k), np.float32)
    Bp[:n] = B
    X0p = np.zeros((npad, k), np.float32)
    if X0 is not None:
        X0p[:n] = np.asarray(X0, np.float32)
    shard = NamedSharding(mesh, P((r_ax, c_ax), None))
    maxiter = config.maxiter if config.maxiter is not None else n
    x, kk, rn, done = _sharded2d_block_jit(
        Ad,
        jax.device_put(Bp, shard),
        jax.device_put(X0p, shard),
        jax.device_put(minv, NamedSharding(mesh, P((r_ax, c_ax),))),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        precondition=config.precondition,
        poly_degree=int(config.poly_degree),
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=kk, residual_norm=rn, converged=done)


def _operator_types():
    from tpucg.solver.operators import (
        BsrOperator,
        DiaOperator,
        EllOperator,
        PoissonOperator,
    )
    from tpucg.sparse.formats import BSRMatrix, CSRMatrix, DIAMatrix, EllMatrix

    return (PoissonOperator, EllOperator, EllMatrix, DIAMatrix, DiaOperator,
            BSRMatrix, BsrOperator, CSRMatrix)


def _pad_rhs_block(B, X0, n, npad):
    B = np.asarray(B, np.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    Bp = np.zeros((npad, k), np.float32)
    Bp[:n] = B
    X0p = np.zeros((npad, k), np.float32)
    if X0 is not None:
        X0p[:n] = np.asarray(X0, np.float32)
    return Bp, X0p, k


def _sharded_operator_multi(op, B, X0, mesh, config) -> CGResult:
    """Operator (sparse/stencil) arm of :func:`sharded_cg_solve_multi`."""
    axis = mesh.axis_names[0]
    op_arrays, statics, n, npad, _ = _prepare_sharded_operator(
        op, mesh, config
    )
    Bp, X0p, k = _pad_rhs_block(B, X0, n, npad)
    shard2 = NamedSharding(mesh, P(axis, None))
    maxiter = config.maxiter if config.maxiter is not None else n
    x, kk, rn, done = _sharded_operator_multi_jit(
        op_arrays,
        jax.device_put(Bp, shard2),
        jax.device_put(X0p, shard2),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        safe_alpha=bool(config.safe_alpha),
        axis=axis,
        **statics,
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=kk, residual_norm=rn, converged=done)


def _sharded_operator_block(op, B, X0, mesh, config) -> CGResult:
    """Operator (sparse/stencil) arm of :func:`sharded_cg_solve_block`."""
    if config.precondition not in ("none", "jacobi", "poly"):
        raise ValueError(
            "block CG on sharded sparse operators supports precondition "
            "in {'none', 'jacobi', 'poly'} (block Jacobi on sharded "
            "sparse operators is unimplemented, matching "
            "sharded_operator_cg_solve)"
        )
    axis = mesh.axis_names[0]
    # _prepare_sharded_operator builds minv only for jacobi; the block jit
    # still takes the array (ones are inert for the other preconditioners).
    op_arrays, statics, n, npad, minv_host = _prepare_sharded_operator(
        op, mesh, config
    )
    Bp, X0p, k = _pad_rhs_block(B, X0, n, npad)
    from tpucg.solver.cg import BLOCK_CG_MAX_K

    if k > BLOCK_CG_MAX_K:
        raise ValueError(
            f"block CG supports k <= {BLOCK_CG_MAX_K} right-hand sides "
            f"(got {k}); use sharded_cg_solve_multi for wide batches"
        )
    minv = (
        minv_host if minv_host is not None else np.ones(npad, np.float32)
    )
    shard1 = NamedSharding(mesh, P(axis))
    shard2 = NamedSharding(mesh, P(axis, None))
    maxiter = config.maxiter if config.maxiter is not None else n
    x, kk, rn, done = _sharded_operator_block_jit(
        op_arrays,
        jax.device_put(Bp, shard2),
        jax.device_put(X0p, shard2),
        jax.device_put(jnp.asarray(minv), shard1),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        axis=axis,
        precondition=config.precondition,
        poly_degree=int(config.poly_degree),
        **statics,
    )
    if npad != n:
        x = x[:n]
    return CGResult(x=x, iterations=kk, residual_norm=rn, converged=done)


def _dia_canonical(op) -> Tuple[np.ndarray, tuple, int]:
    """Host-side canonical (ndiag, n) DIA data + offsets from a DIAMatrix or
    DiaOperator."""
    from tpucg.solver.operators import DiaOperator
    from tpucg.sparse.formats import DIAMatrix

    if isinstance(op, DIAMatrix):
        return np.asarray(op.data, np.float32), tuple(
            int(o) for o in op.offsets
        ), op.shape[0]
    assert isinstance(op, DiaOperator)
    return np.asarray(op.data).astype(np.float32, copy=False), op.offsets, \
        op.n


def sharded_operator_cg_solve(
    op,
    b=None,
    x0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    record_residuals: bool = False,
    storage_dtype=np.float32,
    interval=None,
    two_level=None,
    **overrides,
) -> CGResult:
    """Distributed CG on a sparse/stencil operator over a 1-D mesh.

    - ``PoissonOperator``: slab decomposition with overlapped ppermute halo
      exchange; any m (plane-padded to a P multiple, the pad planes forming
      a decoupled identity block);
    - ``EllOperator`` / ``EllMatrix``: row-block sharded values/indices +
      all_gather of the direction vector (rows identity-padded to P);
    - ``DIAMatrix`` / ``DiaOperator``: row-block sharded diagonal slabs
      with a ppermute BAND-halo exchange — O(band) comm per lap instead of
      O(n);
    - ``BSRMatrix`` / ``BsrOperator``: block-row sharded dense tiles +
      all_gather (block rows identity-padded to P).

    All decompositions accept any size (the reference hard-requires
    ``ROWS % P == 0``, ``parallel_cg.c:86-90``; tpucg pads instead).
    ``storage_dtype=bfloat16`` (DIA only) halves the per-shard slab bytes
    (f32 accumulation; same extension as the dense solver's bf16 storage).

    ``precondition='block_jacobi'`` (Poisson / DIA / CSRMatrix-WELL): the
    block grid restarts at every shard boundary so no block crosses a
    shard — the per-lap apply is one shard-local batched block-GEMV, zero
    communication; ``pc_block_size`` need not divide rows-per-shard
    (virtual grid-tail rows take identity).

    ``two_level`` (a :func:`tpucg.build_two_level` result; method "cg" or
    "pipelined", ``precondition="none"``): distributed two-level PCG —
    shard-local
    restrict/prolong (contiguous aggregates never cross a shard), one
    (nc,)-length all_gather of the coarse residual per apply, the coarse
    inverse replicated. Build it with ``npad`` equal to the SHARDED
    padding (the error message states the required value — e.g.
    round_up(n, 128 * P) for the CSR/WELL decomposition) and an
    ``agg_size`` dividing rows-per-shard.
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if record_residuals and config.method != "cg":
        raise ValueError("record_residuals requires method='cg'")
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    op_arrays, statics, n, npad, minv_host = _prepare_sharded_operator(
        op, mesh, config, storage_dtype=storage_dtype
    )
    if config.precondition == "block_jacobi" and minv_host is None:
        raise ValueError(
            "precondition='block_jacobi' on sharded operators is "
            "implemented for Poisson/DIA/WELL (shard-local diagonal "
            "blocks); ELL/BSR support 'none', 'jacobi', or 'poly'"
        )
    precondition = config.precondition
    tl_agg, tl_omega, tl_sd, tl_sa = 0, 0.7, 1, 4.0
    acinv_host = np.zeros((1, 1), np.float32)
    tl_pass = None
    if two_level is not None:
        if config.method not in ("cg", "pipelined") \
                or config.precondition != "none":
            # On a real pod the latency-bound regime wants the strong
            # preconditioner AND the latency-hiding method together:
            # pipelined PCG keeps its single fused scalar psum per lap
            # (the cycle's own collective is the (nc,)-length coarse
            # all_gather, dataflow-independent of the lap's scalars).
            raise ValueError(
                "two_level runs as THE preconditioner of a method='cg' or "
                f"'pipelined' solve (got method={config.method!r}, "
                f"precondition={config.precondition!r})"
            )
        if two_level.npad != npad:
            raise ValueError(
                f"two_level was built for padded size {two_level.npad}, "
                f"the sharded decomposition pads to {npad} — rebuild with "
                f"build_two_level(csr, agg_size={two_level.agg}, "
                f"npad={npad})"
            )
        num = mesh.devices.size
        if (npad // num) % two_level.agg:
            raise ValueError(
                f"agg_size={two_level.agg} must divide rows-per-shard "
                f"({npad // num}) so aggregates stay shard-local"
            )
        precondition = "two_level"
        tl_agg, tl_omega = two_level.agg, two_level.omega
        tl_sd, tl_sa = two_level.smooth_degree, two_level.smooth_alpha
        minv_host = np.asarray(two_level.dinv)  # sharded like jacobi's
        acinv_host = np.asarray(two_level.acinv)
        if two_level.inner is not None:
            # Multilevel: ship the hierarchy itself (replicated leaves);
            # the top-level dinv already travels SHARDED as minv, so a
            # dummy replaces it in the shipped object.
            import dataclasses as _dc

            tl_pass = _dc.replace(two_level, dinv=jnp.zeros((1,),
                                                           jnp.float32))
    shard1 = NamedSharding(mesh, P(axis))

    if isinstance(op, WellShardedSystem):
        # Pre-sharded system: b/x0 default to the loader's placed vectors
        # (a host b would be fine too — it is O(n), not the ceiling).
        if b is None:
            b = op.b
        if x0 is None and op.x0 is not None:
            x0 = op.x0
    if b is None:
        raise ValueError(
            "b is required (only a WellShardedSystem carries its own)"
        )
    presharded_vecs = isinstance(b, jax.Array) and b.shape == (npad,)
    if presharded_vecs:
        bp, x0p = b, (x0 if x0 is not None else jnp.zeros_like(b))
    else:
        b = np.asarray(b, np.float32)
        if b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got {b.shape}")
        bp = np.zeros(npad, np.float32)
        bp[:n] = b
        x0p = np.zeros(npad, np.float32)
        if x0 is not None:
            x0p[:n] = np.asarray(x0, np.float32)
    if config.precondition == "block_jacobi":
        # One-time batched block inversion (ridge + symmetrization in
        # invert_blocks), then placed block-sharded: ceil(blk/bs) blocks
        # per shard, so the per-lap apply is shard-local.
        from tpucg.solver.cg import invert_blocks

        minv_dev = jax.device_put(
            invert_blocks(jnp.asarray(minv_host)),
            NamedSharding(mesh, P(axis, None, None)),
        )
    else:
        minv = (
            minv_host if minv_host is not None else np.ones(npad, np.float32)
        )
        minv_dev = jax.device_put(jnp.asarray(minv), shard1)
    maxiter = config.maxiter if config.maxiter is not None else n
    if not presharded_vecs:
        bp = jax.device_put(jnp.asarray(bp), shard1)
        x0p = jax.device_put(jnp.asarray(x0p), shard1)
    x, k, rnorm, done, hist = _sharded_operator_cg_jit(
        op_arrays,
        bp,
        x0p,
        minv_dev,
        jax.device_put(jnp.asarray(acinv_host),
                       NamedSharding(mesh, P(None, None))),
        tl_pass,
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        safe_alpha=bool(config.safe_alpha),
        axis=axis,
        method=config.method,
        precondition=precondition,
        poly_degree=(
            config.poly_degree if config.precondition == "poly" else 0
        ),
        record=record_residuals,
        s_step=int(config.s_step),
        check_every=int(config.check_every),
        interval=_interval_static(interval, config),
        tl_agg=int(tl_agg),
        tl_omega=float(tl_omega),
        tl_sd=int(tl_sd),
        tl_sa=float(tl_sa),
        **statics,
    )
    if npad != n:
        x = x[:n]
    return CGResult(
        x=x, iterations=k, residual_norm=rnorm, converged=done,
        residual_history=hist if record_residuals else None,
    )


def _diag_blocks_sharded(offsets, data, num: int, bs: int) -> np.ndarray:
    """Shard-aligned diagonal blocks from DIA storage (numpy, host setup).

    The per-shard analog of ``operators._blocks_from_diag_data``: the
    ``bs``-block grid restarts at every shard boundary (``npad/num`` rows
    per shard) so no block crosses a shard and the distributed apply is
    one shard-local batched block-GEMV. Virtual grid-tail rows (``bs`` not
    dividing rows-per-shard) take identity — the apply pads the local
    vector with zeros there, and identity rows pass them through.
    Returns raw (num * ceil(blk/bs), bs, bs) blocks (invert separately).
    """
    ndiag, npad = data.shape
    blk = npad // num
    assert blk * num == npad
    nbl = -(-blk // bs)
    D = np.zeros((ndiag, num, nbl * bs), np.float32)
    D[:, :, :blk] = np.asarray(data, np.float32).reshape(ndiag, num, blk)
    blocks = np.zeros((num, nbl, bs, bs), np.float32)
    for d, off in enumerate(int(o) for o in offsets):
        if abs(off) >= bs:
            continue  # never lands inside a bs-block
        rs = np.arange(max(0, -off), bs - max(0, off))
        blocks[:, :, rs, rs + off] = D[d].reshape(num, nbl, bs)[..., rs]
    if nbl * bs != blk:
        # Zero any cross-shard band entries the slice carried into the
        # tail, then identity the virtual rows (same tail contract as
        # _blocks_from_diag_data).
        tail = np.arange(nbl * bs).reshape(nbl, bs) >= blk
        cut = tail[None, :, :, None] | tail[None, :, None, :]
        blocks = np.where(cut, 0.0, blocks)
        blocks += np.eye(bs, dtype=np.float32)[None, None] * tail[None, :, :, None]
    return blocks.reshape(num * nbl, bs, bs)


def _poisson_dia_rows(m: int, npad: int):
    """DIA-form rows of the PADDED slab-decomposed 3-D 7-point Laplacian
    (pad planes identity, exactly the operator ``_poisson_halo_matvec``
    applies) — block-Jacobi setup input for ``_diag_blocks_sharded``."""
    N = m ** 3
    i = np.arange(npad)
    offsets = [0]
    rows = [np.where(i < N, 6.0, 1.0).astype(np.float32)]
    for off, ok_fwd in (
        (1, (i % m) != m - 1),
        (m, ((i // m) % m) != m - 1),
        (m * m, (i // (m * m)) != m - 1),
    ):
        fwd = np.where(ok_fwd & (i + off < N) & (i < N), -1.0, 0.0)
        bwd = np.zeros(npad, np.float32)
        bwd[off:] = fwd[:-off]
        offsets += [off, -off]
        rows += [fwd.astype(np.float32), bwd]
    return offsets, np.stack(rows)


def _prepare_sharded_operator(op, mesh: Mesh, config: CGConfig,
                              storage_dtype=np.float32):
    """Pad, pack, and place a sparse/stencil operator for the 1-D mesh.

    Returns (op_arrays, statics, n, npad, minv_host) where ``statics`` are
    the kind-specific static kwargs of the operator jits (kind, m, m_padded,
    offsets) — shared by the solve and checkpoint drivers.
    ``storage_dtype=bfloat16`` (DIA and WELL) ships and streams the
    diagonal slab (WELL: the packed values) in bfloat16 — half the
    per-shard bytes, f32 accumulation.
    """
    from tpucg.solver.operators import (
        BsrOperator,
        DiaOperator,
        EllOperator,
        PoissonOperator,
    )
    from tpucg.sparse.formats import BSRMatrix, DIAMatrix, EllMatrix

    from tpucg.sparse.formats import CSRMatrix

    axis = mesh.axis_names[0]
    num = mesh.devices.size
    shard1 = NamedSharding(mesh, P(axis))
    shard2 = NamedSharding(mesh, P(axis, None))

    m_static = m_padded = None
    offsets_static = None
    minv_host = None  # host diagonal^-1 (padded); ones fallback by caller

    if isinstance(op, WellShardedSystem):
        # Host-sharded pre-packed WELL (load_well_system_sharded): the
        # arrays are already global device arrays — no host ever held the
        # full matrix, so there is nothing to pack or place here.
        if jnp.dtype(storage_dtype) != jnp.float32:
            raise ValueError(
                "storage_dtype=bfloat16 is not supported on pre-sharded "
                "WELL systems yet (cast at pack time instead)"
            )
        if config.precondition == "block_jacobi":
            raise ValueError(
                "precondition='block_jacobi' needs the source CSR; "
                "pre-sharded WELL systems support 'none'/'jacobi'/"
                "two_level"
            )
        if op.op_arrays[0].shape[0] != num:
            raise ValueError(
                f"system was packed for {op.op_arrays[0].shape[0]} "
                f"shards, mesh has {num}"
            )
        minv_host = (
            (1.0 / op.diag).astype(np.float32)
            if config.precondition == "jacobi" else None
        )
        return op.op_arrays, dict(op.statics), op.n, op.npad, minv_host

    if isinstance(op, PoissonOperator):
        kind = "poisson"
        n = op.n
        m_static = op.m
        m_padded = ((op.m + num - 1) // num) * num
        npad = m_padded * op.m * op.m
        op_arrays = jax.device_put(
            jnp.zeros((num,), jnp.float32), shard1  # placeholder, unused
        )
        if config.precondition == "jacobi":
            minv_host = np.ones(npad, np.float32)
            minv_host[:n] = 1.0 / 6.0
        elif config.precondition == "block_jacobi":
            minv_host = _diag_blocks_sharded(
                *_poisson_dia_rows(op.m, npad), num,
                int(config.pc_block_size),
            )
    elif isinstance(op, (EllOperator, EllMatrix)):
        kind = "ell"
        values = np.asarray(op.values, np.float32)
        indices = np.asarray(op.indices, np.int32)
        n = values.shape[0]
        npad = ((n + num - 1) // num) * num
        if npad != n:
            L = values.shape[1]
            vp = np.zeros((npad, L), np.float32)
            ip = np.zeros((npad, L), np.int32)
            vp[:n], ip[:n] = values, indices
            vp[n:, 0] = 1.0                       # identity pad rows
            ip[n:, 0] = np.arange(n, npad)
            values, indices = vp, ip
        op_arrays = (
            jax.device_put(jnp.asarray(values), shard2),
            jax.device_put(jnp.asarray(indices), shard2),
        )
        if config.precondition == "jacobi":
            rows = np.arange(npad)[:, None]
            d = np.where(indices == rows, values, 0.0).sum(axis=1)
            minv_host = np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)
    elif isinstance(op, (DIAMatrix, DiaOperator)):
        kind = "dia"
        data, offsets_static, n = _dia_canonical(op)
        if 0 not in offsets_static:
            raise ValueError(
                "sharded DIA needs a main diagonal to place identity padding"
            )
        # Shards of a multiple of 128 rows: the band reach of small systems
        # then fits inside one shard's block (the halo covers one neighbour).
        align = num * 128
        npad = -(-n // align) * align
        if npad != data.shape[1]:
            padded = np.zeros((data.shape[0], npad), np.float32)
            padded[:, : data.shape[1]] = data
            padded[offsets_static.index(0), data.shape[1]:] = 1.0
            data = padded
        blk = npad // num
        maxo = max(abs(o) for o in offsets_static)
        if maxo > blk:
            raise ValueError(
                f"band reach {maxo} exceeds the per-shard block {blk}; "
                "use fewer devices (halo exchange covers one neighbor)"
            )
        if jnp.dtype(storage_dtype) == jnp.bfloat16:
            import ml_dtypes

            # Host cast: 2 B/elt shipped.
            data_dev = data.astype(ml_dtypes.bfloat16)
        elif jnp.dtype(storage_dtype) == jnp.float32:
            data_dev = data
        else:
            raise ValueError(
                f"storage_dtype must be float32 or bfloat16, "
                f"got {storage_dtype}"
            )
        op_arrays = jax.device_put(
            jnp.asarray(data_dev), NamedSharding(mesh, P(None, axis))
        )
        if config.precondition == "jacobi":
            d = data[offsets_static.index(0)]
            minv_host = np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)
        elif config.precondition == "block_jacobi":
            minv_host = _diag_blocks_sharded(
                offsets_static, data, num, int(config.pc_block_size)
            )
    elif isinstance(op, (BSRMatrix, BsrOperator)):
        kind = "bsr"
        if isinstance(op, BSRMatrix):
            dev_op = BsrOperator.from_bsr(op)
        else:
            dev_op = op
        values = np.asarray(dev_op.values, np.float32)  # (nbr, L, bs, bs)
        indices = np.asarray(dev_op.indices, np.int32)
        nbr, L, bs, _ = values.shape
        n = dev_op.n
        nbr_pad = ((nbr + num - 1) // num) * num
        npad = nbr_pad * bs
        if nbr_pad != nbr:
            vp = np.zeros((nbr_pad, L, bs, bs), np.float32)
            ip = np.zeros((nbr_pad, L), np.int32)
            vp[:nbr], ip[:nbr] = values, indices
            eye = np.eye(bs, dtype=np.float32)
            vp[nbr:, 0] = eye                     # identity pad blocks
            ip[nbr:, 0] = np.arange(nbr, nbr_pad)
            values, indices = vp, ip
        op_arrays = (
            jax.device_put(
                jnp.asarray(values),
                NamedSharding(mesh, P(axis, None, None, None)),
            ),
            jax.device_put(jnp.asarray(indices), shard2),
        )
        if config.precondition == "jacobi":
            rows = np.arange(nbr_pad)[:, None]
            on_diag = (indices == rows)[..., None]
            diag_b = np.where(
                on_diag,
                np.diagonal(values, axis1=2, axis2=3),
                0.0,
            ).sum(axis=1)
            d = diag_b.reshape(npad)
            minv_host = np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)
    elif isinstance(op, CSRMatrix):
        # Genuinely irregular sparsity: row-block sharded WELL (windowed
        # gather-ELL) — each shard packs its rows against GLOBAL columns
        # and the matvec all_gathers x (see sparse.well.csr_to_well_sharded
        # and kernels.gather_spmv). Statics ride the shared slots:
        # m = rows per shard, offsets = (bg, nsg).
        from tpucg.sparse.well import csr_to_well_sharded

        kind = "well"
        n = op.shape[0]
        stacked, st = csr_to_well_sharded(op, num)
        npad = st["npad"]
        m_static = st["rps"]
        offsets_static = (st["bg"], st["nsg"])
        if jnp.dtype(storage_dtype) == jnp.bfloat16:
            import ml_dtypes

            stacked["vals"] = stacked["vals"].astype(ml_dtypes.bfloat16)
        specs = _operator_specs(kind, axis)
        op_arrays = tuple(
            jax.device_put(jnp.asarray(stacked[name]),
                           NamedSharding(mesh, spec))
            for name, spec in zip(("vals", "lidx", "gidl", "wrow", "sgb"),
                                  specs)
        )
        if config.precondition == "jacobi":
            coo = op.to_coo()
            on_d = coo.row == coo.col
            dv = np.zeros(n, np.float64)
            np.add.at(dv, coo.row[on_d], coo.data[on_d].astype(np.float64))
            d = np.ones(npad, np.float32)
            d[:n] = np.where(dv != 0, dv, 1.0).astype(np.float32)
            minv_host = (1.0 / d).astype(np.float32)
        elif config.precondition == "block_jacobi":
            from tpucg.sparse.formats import csr_diagonal_blocks

            minv_host = csr_diagonal_blocks(
                op, int(config.pc_block_size), npad=npad, shards=num
            )
    else:
        raise TypeError(
            "sharded_operator_cg_solve supports Poisson/Ell/DIA/BSR "
            "operators and CSRMatrix (irregular -> sharded WELL), got "
            f"{type(op).__name__}"
        )

    if jnp.dtype(storage_dtype) != jnp.float32 and kind not in ("dia",
                                                                 "well"):
        raise ValueError(
            "storage_dtype=bfloat16 is supported for DIA and WELL "
            "operators (the stencil is matrix-free; ELL/BSR index arrays "
            f"dominate their footprint), got kind={kind!r}"
        )
    statics = dict(
        kind=kind, m=m_static, m_padded=m_padded, offsets=offsets_static,
    )
    return op_arrays, statics, n, npad, minv_host


def distribute_system(
    A: np.ndarray,
    b: np.ndarray,
    x0: Optional[np.ndarray],
    mesh: Mesh,
    part: RowPartition,
    axis: str = ROWS_AXIS,
    storage_dtype=np.float32,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pad and place (A, b, x0) row-block-sharded on the mesh.

    This is the reference's "data distribution" phase (``MPI_Bcast`` +
    ``MPI_Scatter``, ``parallel_cg.c:111-115``) as sharded device_put; timed
    separately by the bench harness to mirror its three-phase report.
    ``storage_dtype=bfloat16`` halves A's per-shard HBM footprint and
    streaming traffic (f32 accumulation in the matvec, f32 vectors — the
    same storage-dtype extension as ``DenseOperator.create``).
    """
    Ap, bp, x0p = pad_system(A, b, x0, part)
    if jnp.dtype(storage_dtype) == jnp.bfloat16:
        import ml_dtypes

        Ap = Ap.astype(ml_dtypes.bfloat16)  # host cast: ships 2 B/elt
    shard2d = NamedSharding(mesh, P(axis, None))
    shard1d = NamedSharding(mesh, P(axis))
    return (
        jax.device_put(Ap, shard2d),
        jax.device_put(bp, shard1d),
        jax.device_put(x0p, shard1d),
    )


def load_system_sharded(
    matrix_path: str,
    rhs_path: str,
    x0_path: Optional[str] = None,
    mesh: Optional[Mesh] = None,
    kernel: str = "auto",
):
    """Host-sharded loading: place (A, b, x0) row-block-sharded on the mesh
    with each shard's host callback parsing ONLY its own rows of the matrix
    file (``tpucg.io.textio.load_matrix_rows`` + the native range parser).

    The reference's rank 0 fscanf-s the entire matrix before scattering
    (``parallel_cg.c:100-108``) — its scalability ceiling (SURVEY.md §7 hard
    part d). Here no host ever materializes all of A: under multi-process
    JAX, ``jax.make_array_from_callback`` only invokes the callback for
    locally-addressable shards. Returns (A, b, x0, n) — pre-padded device
    arrays accepted directly by ``sharded_cg_solve(..., n=n)`` (same
    mesh/kernel), plus the logical system size.
    """
    from tpucg.io.textio import load_matrix_rows, load_vector

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    num = mesh.devices.size
    b_host = load_vector(rhs_path)
    n = int(b_host.size)
    align = ROW_ALIGN
    part = RowPartition(n=n, num_shards=num, align=align)
    npad = part.n_padded

    def a_shard(index):
        rows = index[0]
        r0 = rows.start or 0
        r1 = rows.stop if rows.stop is not None else npad
        block = np.zeros((r1 - r0, npad), np.float32)
        ur1 = min(r1, n)
        if ur1 > r0:
            block[: ur1 - r0, :n] = load_matrix_rows(matrix_path, r0, ur1, n)
        for i in range(max(r0, n), r1):  # identity pad tail
            block[i - r0, i] = 1.0
        return block

    A = jax.make_array_from_callback(
        (npad, npad), NamedSharding(mesh, P(axis, None)), a_shard
    )
    bp = np.zeros(npad, np.float32)
    bp[:n] = b_host
    x0p = np.zeros(npad, np.float32)
    if x0_path is not None:
        x0p[:n] = load_vector(x0_path, n=n)
    shard1 = NamedSharding(mesh, P(axis))
    return (
        A,
        jax.device_put(bp, shard1),
        jax.device_put(x0p, shard1),
        n,
    )


def _sum_across_processes(arr: np.ndarray) -> np.ndarray:
    """Elementwise sum of a small host array over all JAX processes
    (identity when single-process). Deterministic: the stacked per-process
    contributions are summed in process order on every host, so every
    process computes the bit-identical result (the distributed two-level
    build relies on this for its replicated f64 inverse)."""
    if jax.process_count() == 1:
        return arr
    from jax.experimental import multihost_utils

    stacked = np.asarray(
        multihost_utils.process_allgather(np.ascontiguousarray(arr))
    )
    return stacked.reshape((jax.process_count(),) + arr.shape).sum(axis=0)


def _max_across_processes(arr: np.ndarray) -> np.ndarray:
    if jax.process_count() == 1:
        return arr
    from jax.experimental import multihost_utils

    stacked = np.asarray(
        multihost_utils.process_allgather(np.ascontiguousarray(arr))
    )
    return stacked.reshape((jax.process_count(),) + arr.shape).max(axis=0)


class WellShardedSystem(NamedTuple):
    """A host-sharded irregular system: per-shard WELL packs already placed
    on the mesh (no host ever held the full matrix), ready for
    ``sharded_operator_cg_solve`` / ``build_two_level`` composition."""

    op_arrays: tuple          # global jax Arrays, leading shard axis
    statics: dict             # kind/m/m_padded/offsets jit statics
    n: int
    npad: int
    b: jax.Array              # (npad,) row-sharded
    x0: jax.Array             # (npad,) row-sharded
    diag: np.ndarray          # (npad,) f32 operator diagonal (host, summed)
    bytes_read: int           # matrix bytes THIS process fetched
    two_level: Optional[object] = None   # TwoLevel when two_level_agg set


def load_well_system_sharded(
    matrix_path: str,
    rhs_path: Optional[str] = None,
    x0_path: Optional[str] = None,
    mesh: Optional[Mesh] = None,
    groups_per_super: int = 64,
    two_level_agg: Optional[int] = None,
    smooth_degree: int = 1,
) -> WellShardedSystem:
    """Host-sharded loading for the IRREGULAR path: each process reads ONLY
    its shards' rows of an indexed MatrixMarket file
    (``tpucg.io.mmio.load_matrix_market_rows`` byte-range reads — run
    ``expand_matrix_market`` / ``tpucg convert`` once to index a foreign
    file) and packs them per-shard into WELL
    (``sparse.well.local_rows_to_well_shard``) against global columns.

    This removes the reference's rank-0 ceiling
    (``parallel_cg.c:100-108``) from the flagship sparse path: round 4's
    ``csr_to_well_sharded`` still parsed and packed the WHOLE matrix on
    every host. Per-process matrix bytes-read ~ 1/P of the file
    (``bytes_read``, asserted by tests/test_multiprocess.py).

    Cross-process agreement (two tiny collectives, multi-process only):
    shard 0's adaptive stream-block pick governs every shard, and packs
    are zero-padded to the mesh-wide max sublane count.

    ``rhs_path``: ``.npy`` (memmap — byte-range reads) or MatrixMarket
    array; every process holds the O(n) vector (the ceiling being removed
    is the O(nnz) matrix). Returns a :class:`WellShardedSystem`.
    """
    from tpucg.io.mmio import load_matrix_market, load_matrix_market_rows
    from tpucg.io.mmio import mm_index_path
    from tpucg.sparse.well import LANE, local_rows_to_well_shard, pad_well_shard

    if mesh is None:
        mesh = make_mesh()
    if mesh.devices.ndim != 1:
        raise ValueError("load_well_system_sharded takes a 1-D mesh")
    axis = mesh.axis_names[0]
    num = mesh.devices.size
    with np.load(mm_index_path(matrix_path)) as z:
        n, ncol = int(z["nrow"]), int(z["ncol"])
    if n != ncol:
        raise ValueError(f"matrix is {n}x{ncol}, CG needs square SPD")
    rps = -(-n // (num * LANE)) * LANE
    npad = num * rps

    my_proc = jax.process_index()
    local_shards = [
        s for s in range(num)
        if mesh.devices[s].process_index == my_proc
    ]
    parts = {}       # shard -> local COO (local rows, global cols)
    bytes_read = 0
    for s in local_shards:
        r0, r1 = s * rps, min(n, (s + 1) * rps)
        if r1 > r0:
            coo, _, br = load_matrix_market_rows(matrix_path, r0, r1)
            bytes_read += br
        else:   # shard entirely in the identity tail
            from tpucg.sparse.formats import COOMatrix

            coo = COOMatrix(
                row=np.empty(0, np.int64), col=np.empty(0, np.int64),
                data=np.empty(0, np.float32), shape=(rps, npad),
            )
        parts[s] = coo

    # Phase 1: shard 0's owner picks BS adaptively; everyone else follows.
    bs_local = 0
    w0 = None
    if 0 in parts:
        w0 = local_rows_to_well_shard(
            parts[0], 0, rps, npad, n, None,
            groups_per_super=groups_per_super,
        )
        bs_local = w0.block_sublanes
    BS = int(_max_across_processes(np.asarray([bs_local], np.int64))[0])
    assert BS > 0, "shard 0 must be owned by some process"

    wells = {}
    for s, coo in parts.items():
        if s == 0 and w0 is not None:
            wells[s] = w0
        else:
            wells[s] = local_rows_to_well_shard(
                coo, s, rps, npad, n, BS,
                groups_per_super=groups_per_super,
            )
    # Phase 2: mesh-wide max sublane count -> uniform stacked shapes.
    ns_local = np.zeros(num, np.int64)
    for s, w in wells.items():
        ns_local[s] = w.n_sublanes
    NS = int(_max_across_processes(ns_local).max())
    NB = NS // BS
    nsg = next(iter(wells.values())).n_supergroups
    packed = {s: pad_well_shard(w, NS) for s, w in wells.items()}

    from tpucg.sparse.well import CHUNK

    shapes = dict(
        vals=((num, NS, LANE), np.float32),
        lidx=((num, NS, LANE), np.int8),
        gidl=((num, NB, BS), np.int32),
        wrow=((num, NS // CHUNK), np.int32),
        sgb=((num, NB), np.int32),
    )
    specs = _operator_specs("well", axis)
    names = ("vals", "lidx", "gidl", "wrow", "sgb")

    def make(name, spec):
        shape, dtype = shapes[name]

        def cb(index):
            s = index[0].start or 0
            return packed[s][name][None].astype(dtype)

        return jax.make_array_from_callback(
            shape, NamedSharding(mesh, spec), cb
        )

    op_arrays = tuple(make(nm, sp) for nm, sp in zip(names, specs))

    # Operator diagonal (jacobi / two-level dinv), assembled from local
    # rows then process-summed — O(npad) floats, not the O(nnz) ceiling.
    diag_part = np.zeros(npad, np.float64)
    for s, coo in parts.items():
        on_d = (coo.row + s * rps) == coo.col
        np.add.at(diag_part, coo.col[on_d],
                  coo.data[on_d].astype(np.float64))
    diag = _sum_across_processes(diag_part)
    diag[n:npad] = 1.0
    diag = np.where(diag != 0, diag, 1.0).astype(np.float32)

    def load_vec(path):
        if path is None:
            return np.zeros(npad, np.float32)
        if path.endswith(".npy"):
            v = np.load(path, mmap_mode="r")
            v = np.asarray(v, np.float32).ravel()
        else:
            v = load_matrix_market(path)
            v = np.asarray(v, np.float32).ravel()
        if v.size != n:
            raise ValueError(f"{path!r}: expected {n} values, got {v.size}")
        return np.pad(v, (0, npad - n))

    shard1 = NamedSharding(mesh, P(axis))
    bd = jax.device_put(load_vec(rhs_path), shard1)
    x0d = jax.device_put(load_vec(x0_path), shard1)
    statics = dict(
        kind="well", m=rps, m_padded=None,
        offsets=(int(groups_per_super), int(nsg)),
    )
    tl = None
    if two_level_agg is not None:
        # Distributed Galerkin assembly from the same local parts — the
        # coarse build never sees the full matrix either (VERDICT r4 #2).
        from tpucg.solver.twolevel import build_two_level_from_parts

        if (npad // num) % int(two_level_agg):
            raise ValueError(
                f"two_level_agg={two_level_agg} must divide "
                f"rows-per-shard ({npad // num})"
            )
        tl = build_two_level_from_parts(
            [(s * rps, coo) for s, coo in parts.items()],
            n=n, npad=npad, agg_size=int(two_level_agg),
            smooth_degree=smooth_degree, diag=diag,
        )
    return WellShardedSystem(
        op_arrays=op_arrays, statics=statics, n=n, npad=npad,
        b=bd, x0=x0d, diag=diag, bytes_read=int(bytes_read),
        two_level=tl,
    )


def sharded_cg_solve(
    A,
    b,
    x0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    n: Optional[int] = None,
    record_residuals: bool = False,
    storage_dtype=np.float32,
    interval=None,
    **overrides,
) -> CGResult:
    """Solve A x = b with A row-block-sharded across the mesh.

    Accepts host (NumPy) arrays — they are padded so every shard has equal
    static shape (lifting the reference's ``ROWS % P == 0`` restriction,
    ``parallel_cg.c:86-90``) and distributed; or pre-sharded device arrays of
    already-padded shape (then padding/placement are skipped; pass ``n`` to
    trim the solution back to the logical size, e.g. after
    ``load_system_sharded``). ``record_residuals=True`` returns the
    per-iteration ||r|| trace exactly like the serial ``cg_solve`` (the
    entries are the psum-reduced global scalars).
    ``storage_dtype=bfloat16`` stores A's shards in bfloat16 (f32
    accumulation and vectors — the distributed analog of
    ``DenseOperator.create(dtype=bfloat16)``; the solve then satisfies the
    contract on the bf16-rounded system, so scale ``tol`` accordingly).
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if record_residuals and config.method != "cg":
        raise ValueError("record_residuals requires method='cg'")
    if mesh is None:
        mesh = make_mesh()
    if jnp.dtype(storage_dtype) not in (jnp.float32, jnp.bfloat16):
        raise ValueError(
            f"storage_dtype must be float32 or bfloat16, got {storage_dtype}"
        )
    if mesh.devices.ndim == 2:
        if n is not None:
            raise ValueError("n override is for pre-padded 1-D inputs")
        if interval is not None:
            raise ValueError(
                "interval caching is implemented for the 1-D decompositions "
                "(the 2-D SUMMA arm re-estimates per solve)"
            )
        if config.precondition == "block_jacobi":
            raise ValueError(
                "precondition='block_jacobi' is supported on 1-D meshes "
                "(the 2-D decomposition stores column-permuted blocks)"
            )
        return _sharded2d_solve(
            A, b, x0, mesh, config, record_residuals,
            storage_dtype=storage_dtype,
        )
    axis = mesh.axis_names[0]
    num = mesh.devices.size

    A = np.asarray(A) if not isinstance(A, jax.Array) else A
    n_logical = n
    n = A.shape[0] if n_logical is None else n_logical
    align = pc_align(ROW_ALIGN, config)
    part = RowPartition(n=n, num_shards=num, align=align)
    if isinstance(A, jax.Array) and A.shape[0] == part.n_padded:
        if jnp.dtype(A.dtype) != jnp.dtype(storage_dtype):
            # The cast happens at distribution; a pre-sharded array must
            # already carry the requested storage dtype or the parameter
            # would be silently ignored.
            raise ValueError(
                f"pre-sharded A has dtype {A.dtype} but "
                f"storage_dtype={jnp.dtype(storage_dtype).name}; cast A "
                "before placement (or drop the storage_dtype argument)"
            )
        Ad, bd, x0d = (
            A,
            jnp.asarray(b, jnp.float32),
            (
                jnp.zeros(part.n_padded, jnp.float32)
                if x0 is None
                else jnp.asarray(x0, jnp.float32)
            ),
        )
    else:
        Ad, bd, x0d = distribute_system(
            np.asarray(A, np.float32),
            np.asarray(b, np.float32),
            None if x0 is None else np.asarray(x0, np.float32),
            mesh,
            part,
            axis,
            storage_dtype=storage_dtype,
        )
    if (
        config.precondition == "block_jacobi"
        and (part.n_padded // num) % config.pc_block_size != 0
    ):
        # Only reachable with a PRE-SHARDED A whose padding predates the
        # pc_block_size alignment — repad/redistribute in that case.
        raise ValueError(
            f"pre-sharded A's padding is incompatible with pc_block_size="
            f"{config.pc_block_size} (shard block {part.n_padded // num} "
            "rows); redistribute without pre-sharding"
        )
    maxiter = config.maxiter if config.maxiter is not None else n
    x, k, rnorm, done, hist = _sharded_cg_jit(
        Ad, bd, x0d,
        mesh=mesh,
        strategy=config.strategy,
        tol=float(config.tol),
        maxiter=int(maxiter),
        safe_alpha=bool(config.safe_alpha),
        axis=axis,
        precondition=config.precondition,
        method=config.method,
        poly_degree=(
            config.poly_degree if config.precondition == "poly" else 0
        ),
        record=record_residuals,
        s_step=int(config.s_step),
        check_every=int(config.check_every),
        pc_block_size=int(config.pc_block_size),
        interval=_interval_static(interval, config),
    )
    if part.n_padded != n:
        x = x[:n]
    return CGResult(
        x=x, iterations=k, residual_norm=rnorm, converged=done,
        residual_history=hist if record_residuals else None,
    )


def _prepare_sharded2d(A, b, x0, mesh, config,
                       storage_dtype=np.float32):
    """Distribute (A, b, x0) and the Jacobi minv onto a 2-D mesh — shared by
    the plain and checkpointed 2-D solvers (padding/permutation and
    preconditioner construction must never diverge between them).
    Returns (Ad, bd, x0d, minvd, npad)."""
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    align = 1
    Ad, bd, x0d, npad = distribute_system_2d(
        A,
        np.asarray(b, np.float32),
        None if x0 is None else np.asarray(x0, np.float32),
        mesh,
        align=align,
        storage_dtype=storage_dtype,
    )
    # Jacobi diagonal computed on the host from the UN-permuted matrix
    # (identity pad tail -> 1.0), sharded like the vectors.
    if config.precondition == "jacobi":
        d = np.ones(npad, np.float32)
        d[:n] = np.diag(A).astype(np.float32)
        minv_host = np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)
    else:
        minv_host = np.ones(npad, np.float32)
    r_ax, c_ax = mesh.axis_names
    minvd = jax.device_put(
        minv_host, NamedSharding(mesh, P((r_ax, c_ax),))
    )
    return Ad, bd, x0d, minvd, npad


def _sharded2d_solve(
    A, b, x0, mesh, config, record_residuals=False,
    storage_dtype=np.float32,
) -> CGResult:
    n = np.asarray(A).shape[0]
    Ad, bd, x0d, minv, npad = _prepare_sharded2d(
        A, b, x0, mesh, config, storage_dtype=storage_dtype
    )
    maxiter = config.maxiter if config.maxiter is not None else n
    x, k, rnorm, done, hist = _sharded2d_cg_jit(
        Ad, bd, x0d, minv,
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        safe_alpha=bool(config.safe_alpha),
        method=config.method,
        precondition=config.precondition,
        poly_degree=(
            config.poly_degree if config.precondition == "poly" else 0
        ),
        record=record_residuals,
        s_step=int(config.s_step),
        check_every=int(config.check_every),
    )
    if npad != n:
        x = x[:n]
    return CGResult(
        x=x, iterations=k, residual_norm=rnorm, converged=done,
        residual_history=hist if record_residuals else None,
    )
