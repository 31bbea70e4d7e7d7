"""MINRES — symmetric INDEFINITE systems (extension beyond the reference).

The reference (and ``cg_solve``) requires SPD: CG's ``alpha = r.r / p.Ap``
divides by a quadratic form that an indefinite matrix can make zero or
negative, silently breaking the recurrence (the reference would emit NaNs,
``serialConjugate.c:219-220``). MINRES (Paige & Saunders 1975) minimizes
||b - A x|| over the same Krylov space using a Lanczos three-term
recurrence + Givens QR, and requires only symmetry.

Shape: identical to CG's — one matvec, one optional preconditioner
apply, two dots, and a handful of axpy-scale vector ops per lap, all inside
one jitted ``lax.while_loop`` with static shapes; the Givens scalars live in
registers. Works with any ``LinearOperator`` (dense GEMV, DIA,
stencil, WELL, ...).

Preconditioning (SPD M only — MINRES runs Lanczos on the symmetrically
preconditioned operator, so M must define an inner product): ``jacobi``
uses 1/|diag(A)| and ``block_jacobi`` the SPD-ized inverse |B|^-1 of each
diagonal block (eigenvalue absolute values) — plain inverses of an
indefinite matrix's diagonal (blocks) need not be positive.

Stopping contract: the Lanczos/Givens recurrence carries ``phibar``
(= ||r_k|| exactly in exact arithmetic; the ||r_k||_{M^-1} norm when
preconditioned), which in f32 can drift optimistic. The loop therefore uses
phibar only as a TRIGGER: when phibar < tol the lap CONFIRMS against the
true residual ``||b - A x_k||`` (one extra matvec, paid only on triggered
laps) and keeps iterating if the confirmation fails — the same
true-residual contract as ``cg_solve``, with ``converged`` recomputed
honestly at the end (like ``pipelined_cg``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from tpucg.config import CGConfig
from tpucg.kernels.blas1 import dot_xla
from tpucg.solver.cg import CGResult, make_block_precond
from tpucg.solver.operators import as_operator


class _MinresState(NamedTuple):
    k: jax.Array
    x: jax.Array
    r1: jax.Array      # Lanczos history vector (unpreconditioned)
    r2: jax.Array
    y: jax.Array       # M^-1 r2 (== r2 unpreconditioned)
    oldb: jax.Array    # beta_{j-1}
    beta: jax.Array    # beta_j
    dbar: jax.Array
    epsln: jax.Array
    phibar: jax.Array  # residual-norm estimate (M^-1 norm if preconditioned)
    cs: jax.Array
    sn: jax.Array
    w: jax.Array       # solution-update direction history
    w2: jax.Array
    done: jax.Array


def minres_loop(
    matvec: Callable,
    dot: Callable,
    b: jax.Array,
    x0: jax.Array,
    *,
    tol,
    maxiter,
    psolve: Optional[Callable] = None,
) -> _MinresState:
    """Generic (optionally preconditioned) MINRES while_loop.

    ``matvec``/``dot`` abstract the execution model exactly like
    ``cg_loop``'s: serial closures, or psum-reducing closures under
    shard_map (``sharded_minres_solve``). ``psolve``, if given, applies an
    SPD M^-1 (same shape contract as the CG preconditioner closures).
    """
    f32 = b.dtype
    tolv = jnp.asarray(tol, f32)

    r1 = b - matvec(x0)
    y = r1 if psolve is None else psolve(r1)
    # dot(r1, y) = ||r1||_{M^-1}^2 >= 0 for SPD M (clamp guards f32 noise).
    beta1 = jnp.sqrt(jnp.maximum(dot(r1, y), 0.0))
    zero = jnp.zeros_like(b)
    nil = jnp.zeros((), f32)
    s0 = _MinresState(
        k=jnp.int32(0), x=x0, r1=r1, r2=r1, y=y,
        oldb=nil, beta=beta1, dbar=nil, epsln=nil, phibar=beta1,
        cs=-jnp.ones((), f32), sn=nil, w=zero, w2=zero,
        done=beta1 < tolv,
    )

    def cond(s):
        return jnp.logical_and(s.k < maxiter, jnp.logical_not(s.done))

    def body(s):
        safe_beta = jnp.where(s.beta > 0, s.beta, jnp.ones_like(s.beta))
        v = s.y / safe_beta
        av = matvec(v)
        # Lanczos three-term recurrence on the preconditioned operator,
        # carried on the UNpreconditioned vectors r1/r2 (Paige-Saunders).
        safe_oldb = jnp.where(s.oldb > 0, s.oldb, jnp.ones_like(s.oldb))
        av = av - jnp.where(s.k > 0, s.beta / safe_oldb, 0.0) * s.r1
        alfa = dot(v, av)
        av = av - (alfa / safe_beta) * s.r2
        r1n, r2n = s.r2, av
        yn = r2n if psolve is None else psolve(r2n)
        beta = jnp.sqrt(jnp.maximum(dot(r2n, yn), 0.0))

        # Previous Givens rotation, then the next one.
        oldeps = s.epsln
        delta = s.cs * s.dbar + s.sn * alfa
        gbar = s.sn * s.dbar - s.cs * alfa
        epsln = s.sn * beta
        dbar = -s.cs * beta
        gamma = jnp.sqrt(gbar * gbar + beta * beta)
        gamma = jnp.where(gamma > 0, gamma, jnp.ones_like(gamma))
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * s.phibar
        phibar = sn * s.phibar

        w_new = (v - oldeps * s.w2 - delta * s.w) / gamma
        x = s.x + phi * w_new

        # phibar < tol only TRIGGERS the stop; a true-residual recompute
        # confirms it (both branches trace; only the taken one runs).
        def confirm(_):
            r = b - matvec(x)
            return dot(r, r) < tolv * tolv

        done = jax.lax.cond(
            phibar < tolv, confirm, lambda _: jnp.bool_(False), None
        )
        return _MinresState(
            k=s.k + 1, x=x, r1=r1n, r2=r2n, y=yn,
            oldb=s.beta, beta=beta, dbar=dbar, epsln=epsln,
            phibar=phibar, cs=cs, sn=sn, w=w_new, w2=s.w, done=done,
        )

    return jax.lax.while_loop(cond, body, s0)


def abs_inv_blocks(blocks: jax.Array, ridge: float = 1e-6) -> jax.Array:
    """SPD-ized inverse of a (nb, bs, bs) batch of symmetric blocks:
    |B|^-1 = Q |lambda|^-1 Q^T via batched eigh. For MINRES the
    preconditioner must be SPD even when A (hence its diagonal blocks)
    is indefinite; |B|^-1 matches B^-1 where B is definite and flips the
    negative directions. Near-zero eigenvalues are floored at
    ``ridge`` x max|lambda| (setup-only cost; f32 accuracy here affects
    preconditioner quality, not solve correctness)."""
    sym = 0.5 * (blocks + jnp.transpose(blocks, (0, 2, 1)))
    lam, q = jnp.linalg.eigh(sym)
    a = jnp.abs(lam)
    floor = ridge * jnp.max(a, axis=1, keepdims=True)
    a = jnp.maximum(a, jnp.maximum(floor, 1e-30))
    minv = jnp.einsum("qij,qj,qkj->qik", q, 1.0 / a, q,
                      precision=jax.lax.Precision.HIGHEST)
    return 0.5 * (minv + jnp.transpose(minv, (0, 2, 1)))


def _make_minres_psolve(minv, npad: int) -> Optional[Callable]:
    """CG-convention preconditioner closure from a 1-D (point) or 3-D
    (block) minv array; None passes through."""
    if minv is None:
        return None
    if minv.ndim == 3:
        return make_block_precond(minv, npad)
    return lambda r: minv * r


@functools.partial(
    jax.jit, static_argnames=("tol", "maxiter")
)
def _minres_jit(op, b, x0, minv, tol, maxiter):
    matvec, dot = op.matvec, dot_xla
    psolve = _make_minres_psolve(minv, b.shape[0])
    s = minres_loop(matvec, dot, b, x0, tol=tol, maxiter=maxiter,
                    psolve=psolve)
    # Honest reporting: recompute the true residual once (the loop's
    # trigger+confirm already tested it on the stopping lap).
    r = b - matvec(s.x)
    rr = dot(r, r)
    tolv = jnp.asarray(tol, b.dtype)
    return CGResult(
        x=s.x, iterations=s.k, residual_norm=jnp.sqrt(rr),
        converged=rr < tolv * tolv,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "strategy", "tol", "maxiter",
                     "axis", "precondition", "pc_block_size"),
)
def _sharded_minres_jit(A, b, x0, *, mesh, strategy, tol, maxiter,
                        axis, precondition="none", pc_block_size=32):
    from jax.sharding import PartitionSpec as P

    from tpucg.solver.sharded import (
        _jacobi_minv_blk,
        _local_diag_blocks,
        _make_matvec,
        _make_reductions,
    )

    num = mesh.devices.size
    tolv = jnp.asarray(tol, jnp.float32)

    def solve(A_blk, b_blk, x_blk):
        mv = _make_matvec(A_blk, strategy, num, axis)
        dot, _, _ = _make_reductions(axis)
        psolve = None
        if precondition == "jacobi":
            # abs(1/d) = 1/|d| (SPD M even for indefinite diagonals).
            minv = jnp.abs(_jacobi_minv_blk(A_blk, axis))
            psolve = lambda r: minv * r
        elif precondition == "block_jacobi":
            blocks = _local_diag_blocks(A_blk, axis, pc_block_size)
            minv = abs_inv_blocks(blocks)
            psolve = make_block_precond(minv, b_blk.shape[0])
        s = minres_loop(mv, dot, b_blk, x_blk, tol=tol, maxiter=maxiter,
                        psolve=psolve)
        r = b_blk - mv(s.x)
        rr = dot(r, r)
        return s.x, s.k, jnp.sqrt(rr), rr < tolv * tolv

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis), P(), P(), P()),
    )(A, b, x0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "precondition"),
)
def _sharded2d_minres_jit(A, b, x0, minv, *, mesh, tol, maxiter,
                          precondition="none"):
    """MINRES over the 2-D SUMMA decomposition: the same all_gather +
    partial-GEMV + psum_scatter matvec as 2-D CG, with the Lanczos dots
    psummed over BOTH mesh axes."""
    from jax.sharding import PartitionSpec as P

    from tpucg.solver.sharded import _matvec_2d

    r_ax, c_ax = mesh.axis_names
    tolv = jnp.asarray(tol, jnp.float32)

    def solve(A_blk, b_blk, x_blk, minv_blk):
        mv = _matvec_2d(A_blk, r_ax, c_ax)
        dot = lambda u, v: jax.lax.psum(dot_xla(u, v), (r_ax, c_ax))
        psolve = None
        if precondition == "jacobi":
            am = jnp.abs(minv_blk)  # 1/|d|: SPD M for indefinite diagonals
            psolve = lambda r: am * r
        s = minres_loop(mv, dot, b_blk, x_blk, tol=tol, maxiter=maxiter,
                        psolve=psolve)
        r = b_blk - mv(s.x)
        rr = dot(r, r)
        return s.x, s.k, jnp.sqrt(rr), rr < tolv * tolv

    vec = P((r_ax, c_ax),)
    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(r_ax, c_ax), vec, vec, vec),
        out_specs=(vec, P(), P(), P()),
    )(A, b, x0, minv)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "maxiter", "axis", "kind", "m",
                     "m_padded", "precondition", "offsets"),
)
def _sharded_operator_minres_jit(
    op_arrays, b, x0, minv, *, mesh, tol, maxiter, axis, kind, m=None,
    m_padded=None, precondition="none", offsets=None,
):
    """MINRES over a sharded sparse/stencil operator — the same per-shard
    matvec closures as ``_sharded_operator_cg_jit`` (Poisson slab halo, DIA
    band halo, ELL/BSR allgather) driving :func:`minres_loop` with psum
    reductions."""
    from jax.sharding import PartitionSpec as P

    from tpucg.solver.sharded import (
        _make_reductions,
        _operator_matvec,
        _operator_specs,
    )

    num = mesh.devices.size
    tolv = jnp.asarray(tol, jnp.float32)

    def solve(op_blk, b_blk, x_blk, minv_blk):
        mv = _operator_matvec(
            kind, op_blk, axis, num, m, m_padded, offsets
        )
        dot, _, _ = _make_reductions(axis)
        psolve = (
            (lambda r: minv_blk * r) if precondition == "jacobi" else None
        )
        s = minres_loop(mv, dot, b_blk, x_blk, tol=tol, maxiter=maxiter,
                        psolve=psolve)
        r = b_blk - mv(s.x)
        rr = dot(r, r)
        return s.x, s.k, jnp.sqrt(rr), rr < tolv * tolv

    vec = P(axis)
    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(_operator_specs(kind, axis), vec, vec, vec),
        out_specs=(vec, P(), P(), P()),
    )(op_arrays, b, x0, minv)


def _sharded_operator_minres(op, b, x0, mesh, config) -> CGResult:
    """Operator (sparse/stencil) arm of :func:`sharded_minres_solve`."""
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from tpucg.solver.sharded import _prepare_sharded_operator

    if config.precondition == "block_jacobi":
        raise ValueError(
            "sharded MINRES on sparse operators supports precondition "
            "'none' or 'jacobi' (block Jacobi on sharded sparse operators "
            "is unimplemented, matching sharded_operator_cg_solve)"
        )
    axis = mesh.axis_names[0]
    op_arrays, statics, n, npad, minv_host = _prepare_sharded_operator(
        op, mesh, config
    )
    shard1 = NamedSharding(mesh, P(axis))
    b = np.asarray(b, np.float32)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    bp = np.zeros(npad, np.float32)
    bp[:n] = b
    x0p = np.zeros(npad, np.float32)
    if x0 is not None:
        x0p[:n] = np.asarray(x0, np.float32)
    # MINRES needs SPD M: 1/|d| (the prepared minv is 1/d).
    minv = (
        np.abs(minv_host) if minv_host is not None
        else np.ones(npad, np.float32)
    )
    maxiter = config.maxiter if config.maxiter is not None else n
    x, k, rn, done = _sharded_operator_minres_jit(
        op_arrays,
        jax.device_put(jnp.asarray(bp), shard1),
        jax.device_put(jnp.asarray(x0p), shard1),
        jax.device_put(jnp.asarray(minv), shard1),
        mesh=mesh,
        tol=float(config.tol),
        maxiter=int(maxiter),
        axis=axis,
        precondition=config.precondition,
        **statics,
    )
    res = CGResult(x=x, iterations=k, residual_norm=rn, converged=done)
    if npad != n:
        res = res._replace(x=res.x[:n])
    return res


def sharded_minres_solve(
    A,
    b,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """MINRES with A row-block-sharded across the mesh — the distributed
    composition of :func:`minres_solve` (same allgather/overlap strategy
    arms, psum scalar reductions, and jacobi/block_jacobi preconditioner
    options as ``sharded_cg_solve``; block-Jacobi blocks are extracted
    per shard and SPD-ized with :func:`abs_inv_blocks`).

    Sparse/stencil operators (``PoissonOperator``, ``DIAMatrix`` /
    ``DiaOperator``, ``EllMatrix`` / ``EllOperator``, ``BSRMatrix`` /
    ``BsrOperator``) take the operator decompositions of
    ``sharded_operator_cg_solve`` — slab / band-halo ppermute exchange or
    row-sharded allgather — with ``precondition`` in {'none', 'jacobi'}
    (M = 1/|diag|)."""
    import numpy as np
    from dataclasses import replace as dataclasses_replace

    from tpucg.comm.mesh import make_mesh
    from tpucg.io.partitioner import RowPartition
    from tpucg.solver.sharded import distribute_system, ROW_ALIGN

    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg":
        raise ValueError("sharded_minres_solve has no method variants")
    if config.precondition not in ("none", "jacobi", "block_jacobi"):
        raise ValueError(
            "sharded_minres_solve supports precondition in "
            "{'none', 'jacobi', 'block_jacobi'} (M must be SPD)"
        )
    if mesh is None:
        mesh = make_mesh()
    from tpucg.solver.sharded import _operator_types

    if mesh.devices.ndim == 2:
        # 2-D SUMMA arm (dense host arrays; jacobi = 1/|d|).
        from tpucg.solver.sharded import _prepare_sharded2d

        if isinstance(A, _operator_types()):
            raise ValueError(
                "sparse operators take the 1-D operator decompositions; "
                "the 2-D SUMMA arm is dense"
            )
        if config.precondition == "block_jacobi":
            raise ValueError(
                "precondition='block_jacobi' is supported on 1-D meshes "
                "(the 2-D decomposition stores column-permuted blocks)"
            )
        A = np.asarray(A, np.float32)
        n = A.shape[0]
        Ad, bd, x0d, minvd, npad = _prepare_sharded2d(
            A, b, x0, mesh, config
        )
        maxiter = config.maxiter if config.maxiter is not None else n
        x, k, rn, done = _sharded2d_minres_jit(
            Ad, bd, x0d, minvd, mesh=mesh,
            tol=float(config.tol), maxiter=int(maxiter),
            precondition=config.precondition,
        )
        res = CGResult(x=x, iterations=k, residual_norm=rn, converged=done)
        if npad != n:
            res = res._replace(x=res.x[:n])
        return res
    if mesh.devices.ndim != 1:
        raise ValueError("MINRES is supported on 1-D and 2-D meshes")
    if isinstance(A, _operator_types()):
        return _sharded_operator_minres(A, b, x0, mesh, config)
    axis = mesh.axis_names[0]
    A = np.asarray(A, np.float32)
    n = A.shape[0]
    part = RowPartition(n=n, num_shards=mesh.devices.size,
                        align=ROW_ALIGN)
    if config.precondition == "block_jacobi":
        block_rows = part.n_padded // mesh.devices.size
        if block_rows % int(config.pc_block_size):
            raise ValueError(
                f"pc_block_size={config.pc_block_size} must divide each "
                f"shard's block ({block_rows} rows)"
            )
    Ad, bd, x0d = distribute_system(
        A, np.asarray(b, np.float32),
        None if x0 is None else np.asarray(x0, np.float32),
        mesh, part, axis,
    )
    maxiter = config.maxiter if config.maxiter is not None else n
    x, k, rn, done = _sharded_minres_jit(
        Ad, bd, x0d, mesh=mesh, strategy=config.strategy,
        tol=float(config.tol), maxiter=int(maxiter), axis=axis,
        precondition=config.precondition,
        pc_block_size=int(config.pc_block_size),
    )
    res = CGResult(x=x, iterations=k, residual_norm=rn, converged=done)
    if part.n_padded != n:
        res = res._replace(x=res.x[:n])
    return res


def minres_solve(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """Solve the symmetric (possibly INDEFINITE) system A x = b by MINRES.

    Same calling convention and true-residual stopping contract as
    ``cg_solve`` (absolute ``||b - A x|| < tol`` confirmed in-loop,
    <= maxiter laps, float32), but only symmetry — not positive-
    definiteness — is required. On SPD systems it matches CG's solution
    (CG remains slightly cheaper per lap).

    ``precondition``: "none", "jacobi" (M = |diag(A)|), or "block_jacobi"
    (M = blockdiag |B_i|, ``pc_block_size`` rows per block, SPD-ized via
    :func:`abs_inv_blocks`). MINRES requires SPD M, hence the absolute
    values. Accepts any ``LinearOperator`` (DIA/stencil/WELL/dense...);
    block_jacobi needs the operator to expose ``diagonal_blocks``.
    """
    from dataclasses import replace as dataclasses_replace

    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg":
        raise ValueError("minres_solve has no method variants")
    if config.precondition not in ("none", "jacobi", "block_jacobi"):
        raise ValueError(
            "minres_solve supports precondition in {'none', 'jacobi', "
            "'block_jacobi'} (MINRES needs an SPD M; poly preconditioners "
            "of indefinite operators are not SPD)"
        )
    if jnp.dtype(config.dtype) != jnp.float32:
        raise ValueError("minres_solve is float32-only")
    op = as_operator(A)
    n, npad = op.n, op.padded_n
    b = jnp.asarray(b, jnp.float32)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    x0 = jnp.zeros(n, jnp.float32) if x0 is None else jnp.asarray(
        x0, jnp.float32)
    if npad != n:
        b = jnp.pad(b, (0, npad - n))
        x0 = jnp.pad(x0, (0, npad - n))
    minv = None
    if config.precondition == "jacobi":
        d = jnp.abs(op.diagonal())
        minv = jnp.where(d > 0, 1.0 / jnp.maximum(d, 1e-30), 1.0).astype(
            jnp.float32)
    elif config.precondition == "block_jacobi":
        bs = int(config.pc_block_size)
        minv = abs_inv_blocks(op.diagonal_blocks(bs))
    maxiter = config.maxiter if config.maxiter is not None else n
    res = _minres_jit(op, b, x0, minv, float(config.tol), int(maxiter))
    if npad != n:
        res = res._replace(x=res.x[:n])
    return res
