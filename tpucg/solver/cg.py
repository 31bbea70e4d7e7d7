"""The CG iteration as a jit-compiled ``lax.while_loop``.

Contract (reference ``serialConjugate.c:180-259``; SURVEY.md §3.5):

- float32 recurrence: r = p = b - A x0; rsold = r.r; then per iteration
  alpha = rsold / (p.Ap); x += alpha p; r -= alpha Ap; beta = r.r;
  STOP if sqrt(beta) < tol (checked after the x/r update, BEFORE the p
  update — on convergence p and rsold are left un-updated);
  else p = r + (beta/rsold) p; rsold = beta. At most n iterations
  (``serialConjugate.c:213``).

The whole loop is one XLA computation: no host round-trip per iteration (the
reference pays an MPI allreduce + host-side sqrt test every lap; here the
convergence test is a traced predicate inside the while_loop).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpucg.config import CGConfig
from tpucg.kernels.blas1 import dot_xla, fused_update
from tpucg.solver.operators import LinearOperator, as_operator


class CGResult(NamedTuple):
    """Solve outcome. ``iterations`` counts matvec loop laps, matching the
    reference's loop variable (2 for the shipped 2x2 system, 4 for the 4x4)."""

    x: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array
    converged: jax.Array
    # ||r|| after each iteration (entry 0 = initial residual), NaN beyond the
    # converged lap; only populated by record_residuals=True solves.
    residual_history: Optional[jax.Array] = None


class _State(NamedTuple):
    k: jax.Array
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rsold: jax.Array
    rslast: jax.Array  # most recent r.r (tracked for reporting)
    done: jax.Array
    # Optional (maxiter+1,) per-iteration ||r|| trace; None disables (the
    # pytree structure is fixed per trace, so None costs nothing). The
    # reference's only equivalent was the commented-out printer() dump
    # (serialConjugate.c:252).
    hist: Optional[jax.Array] = None


def lambda_max_estimate(matvec: Callable, dot: Callable, like: jax.Array,
                        power_iters: int = 12,
                        absolute: bool = False) -> jax.Array:
    """Fixed-iteration power-method estimate of lambda_max(A), built from the
    same matvec/dot closures as the solve so it works unchanged under every
    decomposition (the distributed matvec and psum dots just come along).
    Used by the polynomial preconditioner (Neumann-series convergence needs
    w*lambda_max < 1) and by the CA-CG basis scaling (monomial columns
    ~lambda_max^s would overflow f32 unscaled)."""

    def power_body(_, v):
        y = matvec(v)
        return y * jax.lax.rsqrt(dot(y, y) + jnp.asarray(1e-30, y.dtype))

    # Seed with a fixed generic oscillation, NOT anything derived from the
    # rhs: rhs-based seeds can vanish (b = -1 made b+1 exactly zero ->
    # lam = 0 -> downstream inf/NaN) or live in the identity-tail pad
    # subspace and estimate lam ~ 1 instead of lambda_max(A).
    nloc = like.shape[0]
    v0 = jnp.cos(
        jnp.arange(nloc, dtype=like.dtype) * jnp.asarray(0.7, like.dtype)
    ) + jnp.asarray(0.1, like.dtype)
    # + 0*like changes nothing numerically but marks v0 as device-varying
    # under shard_map's VMA tracking (the iota seed alone is unvarying, while
    # the loop body's matvec output is varying — a carry-type mismatch).
    v0 = v0 + jnp.zeros_like(like)
    v = jax.lax.fori_loop(0, power_iters, power_body, v0)
    lam = dot(v, matvec(v)) / (dot(v, v) + jnp.asarray(1e-30, like.dtype))
    if absolute:
        # Spectral-RADIUS estimate: for an indefinite operator (e.g. the
        # CA basis's shifted A - mu I, whose spectrum is <= 0) the dominant
        # Rayleigh quotient is signed; its magnitude is what scales.
        lam = jnp.abs(lam)
    return jnp.maximum(lam, jnp.asarray(1e-30, like.dtype))


def spectral_interval_estimate(matvec: Callable, dot: Callable,
                               like: jax.Array,
                               power_iters: int = 16):
    """Two-sided power-method spectrum bounds of an SPD operator:
    ``lam_hi`` from a direct power iteration, ``lam_lo`` from one on the
    REFLECTED operator lam_hi*I - A (whose dominant eigenvalue is
    lam_hi - lam_min). Shared by CA-CG's basis interval, the Chebyshev
    iteration, and the public ``tpucg.spectral_interval``; both
    estimates ride the same matvec/dot closures, so they work unchanged
    under every decomposition. NOTE both are finite-iteration estimates:
    lam_hi is typically an UNDERestimate and lam_lo an OVERestimate —
    consumers must pad (each caller documents its pads and guards)."""
    lam_hi = lambda_max_estimate(matvec, dot, like, power_iters)
    refl = lambda_max_estimate(
        lambda v: lam_hi * v - matvec(v), dot, like, power_iters,
        absolute=True,
    )
    lam_lo = jnp.clip(lam_hi - refl, 0.0, lam_hi)
    return lam_lo, lam_hi


def make_poly_precond(matvec: Callable, dot: Callable, b: jax.Array,
                      degree: int, power_iters: int = 12) -> Callable:
    """Truncated-Neumann polynomial preconditioner: M^-1 = w * sum_{i<d} (I - wA)^i.

    SPD for any degree when 0 < w*lambda_max < 1, so w is set from a
    fixed-iteration power-method estimate of lambda_max (see
    ``lambda_max_estimate``). Each preconditioner application costs
    ``degree - 1`` extra matvecs per lap — matvecs and collectives only, no
    triangular solves — and typically cuts iteration counts
    ~2-3x on stencil-conditioned systems (an extension; the reference is
    unpreconditioned).
    """
    if degree < 1:
        raise ValueError("poly degree must be >= 1")
    lam = lambda_max_estimate(matvec, dot, b, power_iters)
    w = jnp.asarray(0.95, b.dtype) / lam  # safety margin keeps w*lam < 1

    def precond(r):
        z = w * r
        for _ in range(degree - 1):
            z = z + w * r - w * matvec(z)
        return z

    return precond


def block_jacobi_minv(op, bs: int) -> jax.Array:
    """One-time setup of the block-Jacobi preconditioner: the
    (nb, bs, bs) batch of INVERTED diagonal blocks of A, symmetrized.
    Where point Jacobi undoes diagonal scaling only, block Jacobi also
    absorbs within-block coupling (tridiagonal bands, per-node DOF
    blocks) — and its per-lap apply is ONE batched (bs, bs) x (bs,)
    GEMM (contrast incomplete factorizations, whose triangular solves
    serialize).

    The inverse is computed ONCE by ``jnp.linalg.inv`` (plus a tiny
    trace-relative ridge): preconditioner quality, not the f32 solve
    contract, depends on it — PCG needs M fixed and SPD, not exact, and
    the stopping test stays on the true residual — so XLA's
    uncontrolled-precision LU is acceptable here where it is not in the
    solve path. Symmetrizing restores the exact-arithmetic symmetry of
    an SPD inverse that LU roundoff breaks."""
    return invert_blocks(op.diagonal_blocks(bs))


def invert_blocks(blocks: jax.Array) -> jax.Array:
    """``block_jacobi_minv`` on an already-extracted (nb, bs, bs) batch —
    the single home of the ridge/symmetrization guards, shared by the
    serial (operator) and sharded (shard-local blocks) paths."""
    f32 = blocks.dtype
    bs = blocks.shape[1]
    tr = jnp.trace(blocks, axis1=1, axis2=2) / bs  # (nb,)
    ridge = jnp.asarray(1e-6, f32) * tr + jnp.asarray(1e-30, f32)
    eye = jnp.eye(bs, dtype=f32)
    minv = jnp.linalg.inv(blocks + ridge[:, None, None] * eye[None])
    return 0.5 * (minv + jnp.transpose(minv, (0, 2, 1)))


def block_jacobi_sqrt_pair(op, bs: int):
    """Setup for BLOCKWISE symmetric equilibration: the (nb, bs, bs)
    batches M^-1/2 and M^1/2 of the block-diagonal M = blockdiag(A),
    from ONE batched ``eigh`` (eigenvalues floored relative to each
    block's largest, so a singular tail block cannot NaN the rsqrt).
    Same precision rationale as ``block_jacobi_minv``: this runs once at
    setup and only preconditioner quality depends on it. Used by the
    block-CG arm, where equilibration is the f32-stable way to
    precondition (see ``_cg_block_pjit``)."""
    return sqrt_pair_blocks(op.diagonal_blocks(bs))


def sqrt_pair_blocks(blocks: jax.Array):
    """``block_jacobi_sqrt_pair`` on an already-extracted (nb, bs, bs)
    batch — the single home of the eigenvalue floor, shared by the
    serial (operator) and sharded (shard-local blocks) paths."""
    f32 = blocks.dtype
    w, V = jnp.linalg.eigh(blocks)
    w = jnp.maximum(
        w,
        jnp.maximum(
            jnp.asarray(1e-12, f32) * w[:, -1:],
            jnp.asarray(1e-30, f32),
        ),
    )
    mm = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    isq = mm("qij,qj,qkj->qik", V, jax.lax.rsqrt(w), V)
    sq = mm("qij,qj,qkj->qik", V, jnp.sqrt(w), V)
    sym = lambda T: 0.5 * (T + jnp.transpose(T, (0, 2, 1)))
    return sym(isq), sym(sq)


def make_block_apply(S: jax.Array, npad: int) -> Callable:
    """Apply a block-diagonal matrix (the (nb, bs, bs) batch ``S``) to an
    (npad, k) column block: one batched (bs, bs) x (bs, k) GEMM. The
    2-D-block sibling of ``make_block_precond`` (which serves 1-D
    vectors); identity pad blocks make the row tail pass through."""
    nb, bs, _ = S.shape

    def apply(Y):
        Yp = (
            jnp.pad(Y, ((0, nb * bs - npad), (0, 0)))
            if nb * bs != npad
            else Y
        )
        Z = jnp.einsum(
            "qij,qjc->qic", S, Yp.reshape(nb, bs, -1),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(nb * bs, -1)
        return Z[:npad] if nb * bs != npad else Z

    return apply


def make_block_precond(minv: jax.Array, npad: int) -> Callable:
    """z = M^-1 r for the block-Jacobi ``minv`` (nb, bs, bs): one batched
    block GEMV per application (``precision=HIGHEST`` — it IS a matmul on
    the solve path). Pads r when bs does not divide the vector length
    (the pad blocks are identity, so the pad coordinates pass through)."""
    nb, bs, _ = minv.shape

    def precond(r):
        rp = jnp.pad(r, (0, nb * bs - npad)) if nb * bs != npad else r
        z = jnp.einsum(
            "qij,qj->qi", minv, rp.reshape(nb, bs),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(-1)
        return z[:npad] if nb * bs != npad else z

    return precond


def init_state(matvec: Callable, dot: Callable, b: jax.Array,
               x0: jax.Array, tol: float,
               precond: Optional[Callable] = None,
               hist_len: Optional[int] = None) -> _State:
    """CG initialization: r = p = b - A x0; rsold = r.r
    (reference ``serialConjugate.c:208-212``).

    With a ``precond`` closure (z = M^-1 r) this is PCG initialization
    instead: p = z0, and ``rsold`` carries r.z (the direction scalar) while
    ``rslast`` carries r.r (the stopping scalar — the contract's
    ``sqrt(r.r) < tol`` test is always on the TRUE residual).
    """
    r0 = b - matvec(x0)
    tol2 = jnp.asarray(tol, r0.dtype) ** 2
    rr0 = dot(r0, r0)
    # The reference would divide 0/0 on an exact initial guess
    # (``serialConjugate.c:219-220``); we flag it converged at k=0 instead.
    done0 = rr0 < tol2
    if precond is None:
        p0, rs0 = r0, rr0
    else:
        p0 = precond(r0)
        rs0 = dot(r0, p0)
    hist = None
    if hist_len is not None:
        hist = jnp.full((hist_len + 1,), jnp.nan, r0.dtype)
        hist = hist.at[0].set(jnp.sqrt(rr0))
    return _State(
        k=jnp.int32(0), x=x0, r=r0, p=p0, rsold=rs0, rslast=rr0, done=done0,
        hist=hist,
    )


def cg_loop(
    matvec: Callable,
    dot: Callable,
    update: Callable,
    b: jax.Array,
    x0: jax.Array,
    *,
    tol: float,
    maxiter,
    safe_alpha: bool = True,
    state: Optional[_State] = None,
    precond: Optional[Callable] = None,
    hist_len: Optional[int] = None,
    replace_every: Optional[int] = None,
    replace_fn: Optional[Callable] = None,
    check_true_every: Optional[int] = None,
    stag_carry=None,
    return_stag: bool = False,
) -> _State:
    """Generic CG while_loop. ``matvec``/``dot``/``update`` abstract the
    execution model: serial closures here; psum-reducing closures under
    shard_map in ``tpucg.solver.sharded`` (where ``dot`` carries the
    MPI_Allreduce role of ``parallel_cg.c:287-313``).

    ``state`` resumes a previous run (checkpoint/resume — the CG state is just
    (k, x, r, p, rsold); see ``tpucg.solver.checkpoint``). ``maxiter`` bounds
    the *cumulative* iteration count k and may be a traced scalar (so a
    segmented driver can extend it without recompiling).

    ``precond`` (z = M^-1 r, e.g. Jacobi) switches the recurrence to
    preconditioned CG — an extension beyond the reference (which is
    unpreconditioned only), with the same stopping contract on the true
    residual: ``sqrt(r.r) < tol`` after the x/r update, before the p update.

    ``replace_every`` (requires ``b``; round 5): Van der Vorst/Sleijpen
    residual replacement — every that-many laps the recurrence residual is
    re-anchored to the TRUE residual (r <- b - A x, rsold <- (r, M^-1 r);
    p kept). The deflation x two-level composition needs it: the
    projection re-injects the stored basis's f32 matvec error every lap
    and the recurrence walks away from the true residual near the
    composed floor (RESULTS.md deflation caveat); replacement lowers that
    attainable floor by following the true residual again. Costs one
    matvec + one preconditioner apply per replacement lap.
    ``replace_fn(x, r_true) -> (x, r)`` customizes the re-anchoring — the
    DEFLATED recurrence must re-apply its Galerkin correction here
    (plainly replacing r re-injects span(W) components the projected
    search directions can never remove; measured DIVERGENT at FEM n=30k).

    ``check_true_every`` (requires ``b``; round 5): make the STOPPING test
    the TRUE residual, evaluated every that-many laps (one extra matvec +
    dot per check) — the reference's actual contract
    (``serialConjugate.c:28,235``; in the reference's double precision the
    recurrence r IS the true r, in f32 at high condition it is NOT:
    measured at FEM n=300k the recurrence converged 2000x BELOW the true
    residual on strong-preconditioner solves, while warm deflated
    recurrences sat ABOVE a true residual that had already met tol). The
    per-lap recurrence test is disabled; laps quantize to the check
    cadence; ``rslast`` carries the latest TRUE r.r so reported residuals
    are honest. The checks run UNCONDITIONALLY at segment boundaries
    (collective-safe — see pipelined_cg_loop's deadlock note). Mutually
    exclusive with ``replace_every``.

    ``stag_carry``/``return_stag`` (round 5): the stagnation exit's
    bookkeeping — (previous boundary true r.r, previous stagnant flag) —
    lives OUTSIDE ``state``; a segmented driver that calls cg_loop per
    segment must thread it across calls or the two-consecutive-windows
    rule never accumulates and a floor-bound solve grinds to maxiter
    instead of stagnation-stopping (found by the round-5 smoke run:
    the plain FEM n=30k two_level solve stopped honestly at 112 laps
    while the checkpointed run burned all 512). Pass ``return_stag=True``
    to get ``(state, (prev_rr, prev_stag))`` back and feed it to the next
    segment's ``stag_carry``. Ignored when ``check_true_every`` is None
    (the carry is returned unchanged).
    """
    if state is None:
        state = init_state(
            matvec, dot, b, x0, tol, precond=precond, hist_len=hist_len
        )
    if check_true_every:
        assert b is not None and not replace_every
        # disable the per-lap recurrence test: done fires only from the
        # true-residual checks at segment boundaries below.
        tol2 = jnp.asarray(-1.0, state.r.dtype)
    else:
        tol2 = jnp.asarray(tol, state.r.dtype) ** 2
    true_tol2 = jnp.asarray(tol, state.r.dtype) ** 2

    def cond(s: _State):
        return jnp.logical_and(s.k < maxiter, jnp.logical_not(s.done))

    # Breakdown guards, ONLY in check_true mode: (p, Ap) and (r, M^-1 r)
    # are positive for SPD A/M in exact arithmetic but cross zero in f32
    # once a solve grinds PAST its attainable floor (reachable only when
    # check_true_every keeps iterating honestly there) — an unguarded
    # recurrence then NaNs within a few hundred laps (measured, FEM +
    # two-level). The guards must NOT apply to legacy recurrence-tested
    # paths: bf16 inner solves (solver/ir.py) legitimately measure
    # pap <= 0 from rounding mid-convergence, and zeroing those steps was
    # measured to DIVERGE iterative refinement — the historical
    # negative-alpha step is what works there.
    guard = bool(check_true_every)

    def body(s: _State):
        ap = matvec(s.p)
        pap = dot(s.p, ap)
        if safe_alpha:
            ok_a = (pap > 0) if guard else (pap != 0)
            alpha = jnp.where(ok_a, s.rsold / pap, jnp.zeros_like(pap))
        else:
            alpha = s.rsold / pap
        x, r, rr = update(s.x, s.r, s.p, ap, alpha)
        done = rr < tol2
        if precond is None:
            z, rs_new = r, rr
        else:
            z = precond(r)
            rs_new = dot(r, z)
        if guard:
            healthy = rs_new > 0
            beta = jnp.where(healthy, rs_new / s.rsold,
                             jnp.zeros_like(rs_new))
            p = jnp.where(done, s.p, z + beta * s.p)
            rsold = jnp.where(
                done, s.rsold,
                jnp.where(healthy, rs_new,
                          jnp.asarray(np.finfo(np.float32).tiny,
                                      rs_new.dtype)),
            )
        else:
            p = jnp.where(done, s.p, z + (rs_new / s.rsold) * s.p)
            rsold = jnp.where(done, s.rsold, rs_new)
        hist = (
            None if s.hist is None
            else s.hist.at[s.k + 1].set(jnp.sqrt(rr))
        )
        ns = _State(
            k=s.k + 1, x=x, r=r, p=p, rsold=rsold, rslast=rr, done=done,
            hist=hist,
        )
        if replace_every:
            assert b is not None, "replace_every needs b"
            # SERIAL-ONLY: this refresh sits inside lax.cond; a SHARDED
            # matvec/dot here (collectives under a conditional) is an
            # SPMD deadlock hazard — see pipelined_cg_loop's segmented
            # restructure if a distributed caller ever needs this.

            def refresh(s2: _State) -> _State:
                r_true = b - matvec(s2.x)
                if replace_fn is None:
                    x_n, r_n = s2.x, r_true
                else:
                    x_n, r_n = replace_fn(s2.x, r_true)
                z_t = r_n if precond is None else precond(r_n)
                return s2._replace(x=x_n, r=r_n, rsold=dot(r_n, z_t))

            do = jnp.logical_and(
                ns.k % jnp.int32(replace_every) == 0,
                jnp.logical_not(ns.done),
            )
            ns = jax.lax.cond(do, refresh, lambda s2: s2, ns)
        return ns

    if not check_true_every:
        st = jax.lax.while_loop(cond, body, state)
        if return_stag:
            return st, (
                stag_carry
                if stag_carry is not None
                else (jnp.asarray(np.inf, state.r.dtype),
                      jnp.zeros((), jnp.bool_))
            )
        return st

    R = jnp.int32(check_true_every)

    def inner_cond(s: _State):
        return jnp.logical_and(cond(s), s.k % R != 0)

    def outer_cond(carry):
        s, _, _ = carry
        return cond(s)

    def outer_body(carry):
        s, prev_rr, prev_stag = carry
        s = body(s)                                    # leave the boundary
        s = jax.lax.while_loop(inner_cond, body, s)    # to next boundary
        rec_rr = s.rslast           # the RECURRENCE r.r at this boundary
        r_t = b - matvec(s.x)
        rr_t = dot(r_t, r_t)
        done_t = rr_t < true_tol2
        # Stagnation exit: past the f32 attainable floor the true residual
        # stops improving while the RECURRENCE runs away (measured: p
        # overflows to inf within ~1k post-floor laps). Two guards keep
        # this from killing live solves: (a) TWO consecutive sub-0.5%
        # windows (CG 2-norms are not monotone — a single plateau can be
        # a mid-convergence shoulder), and (b) recurrence/truth
        # DECOUPLING (rr_true >> rr_recurrence): during the initial
        # residual-growth transient the recurrence still TRACKS the true
        # residual, only at the floor has it collapsed far below it.
        # (done, NOT converged: callers decide from rslast = true r.r.)
        stag = jnp.logical_and(
            rr_t > 0.995 * prev_rr, rr_t > 100.0 * rec_rr
        )
        # Checks take EFFECT only at k % R == 0 boundaries (elementwise
        # select — the matvec/dot above stay unconditional, collective-
        # safe): a segmented driver whose k_target lands mid-window then
        # follows the bit-identical trajectory of an unsegmented run.
        at_b = s.k % R == 0
        s = s._replace(
            done=jnp.logical_or(
                s.done,
                jnp.logical_and(
                    at_b,
                    jnp.logical_or(done_t,
                                   jnp.logical_and(stag, prev_stag)),
                ),
            ),
            rslast=jnp.where(at_b, rr_t, s.rslast),
        )
        return (
            s,
            jnp.where(at_b, rr_t, prev_rr),
            jnp.where(at_b, stag, prev_stag),
        )

    if stag_carry is not None:
        init_rr = jnp.asarray(stag_carry[0], state.r.dtype)
        init_stag = jnp.asarray(stag_carry[1], jnp.bool_)
    else:
        init_rr = jnp.asarray(np.inf, state.r.dtype)
        init_stag = jnp.zeros((), jnp.bool_)
    st, prev_rr, prev_stag = jax.lax.while_loop(
        outer_cond, outer_body, (state, init_rr, init_stag)
    )
    if return_stag:
        return st, (prev_rr, prev_stag)
    return st


# Residual-replacement cadence for PRECONDITIONED pipelined CG (laps
# between recomputing the recurrence vectors from their definitions).
# The r/w recurrences drift as ||M^-1|| grows — measured catastrophic on
# FEM mesh Laplacians for both Jacobi and two-level (true residual 0.2-0.5
# while the recurrence reported 1e-5-1e-3) — so every preconditioned
# pipelined solve replaces; together with the measured (p, s) pair in the
# fused reduction (see pipelined_cg_loop's body) this anchors the
# reported residual to the true one. The remaining f32 ATTAINABLE floor
# scales with the operator's condition number (~kappa * 1e-7 ||b||,
# measured: FEM P1 n=2k ~3e-4 ||b||, n=30k ~3e-2 ||b||; geometric-graph
# kappa~1e2 systems reach 1e-5 ||b|| with exact lap parity) — cadence
# sweeps {5, 10, 25} do not move it; it is the method's known f32
# penalty, and classic PCG remains the accuracy path on ill-conditioned
# systems.
PIPE_REPLACE_EVERY = 25

# True-residual stopping cadence for STRONG-preconditioner classic PCG
# (two-level / deflated composition — see cg_loop's check_true_every).
# At high condition the f32 recurrence decouples from the true residual
# in BOTH directions (measured at FEM n=300k: the cold two-level solve's
# recurrence converged 2000x below truth; warm deflated recurrences sat
# above a truth that had already met tol), so these paths test the TRUE
# residual every 16 laps — the reference's actual contract
# (serialConjugate.c:28,235) — at one extra matvec+dot per check (~6%).
TRUE_CHECK_EVERY = 16


class _PipeState(NamedTuple):
    k: jax.Array
    x: jax.Array
    r: jax.Array
    w: jax.Array       # A M^-1 r (recurrence-maintained)
    p: jax.Array
    s: jax.Array       # A p
    z: jax.Array       # A M^-1 s
    gamma: jax.Array   # r.u of the previous lap (u = M^-1 r; = r.r when M=I)
    alpha: jax.Array
    rslast: jax.Array
    done: jax.Array
    u: Optional[jax.Array] = None  # M^-1 r (preconditioned variant only)
    q: Optional[jax.Array] = None  # M^-1 s (preconditioned variant only)


def pipelined_cg_loop(
    matvec: Callable,
    dots: Callable,
    b: jax.Array,
    x0: jax.Array,
    *,
    tol: float,
    maxiter,
    safe_alpha: bool = True,
    precond: Optional[Callable] = None,
    replace_every: Optional[int] = None,
) -> _PipeState:
    """Pipelined (communication-hiding) CG/PCG — Ghysels & Vanroose 2014.

    Mathematically the same Krylov iterates as classic (P)CG, but ALL scalar
    reductions per lap are FUSED into one: ``dots(pairs)`` reduces a list of
    dot-product pairs in a single psum. That reduction is
    dataflow-independent of the lap's matvec (and preconditioner apply) — so
    on a real mesh XLA can overlap the collective's latency with the
    GEMV. The price is extra recurrence-maintained vectors (w, s, z — plus
    u, q when preconditioned) of memory traffic per lap, and slightly earlier
    f32 rounding drift — worth it when the psum latency, not bandwidth,
    bounds the iteration (strong-scaled small n/P). Extension beyond the
    reference (its two MPI_Allreduce calls per lap are the analogous cost,
    ``parallel_cg.c:294,313``).

    ``replace_every``: periodic residual replacement (Cools & Vanroose
    2017) — every that-many laps the recurrence-maintained vectors are
    recomputed from their definitions (r = b - Ax, u = M^-1 r, w = A u,
    s = A p, q = M^-1 s, z = A q). The drift of the r/w recurrences scales
    with ||M^-1|| — harmless for Jacobi, CATASTROPHIC for a strong cycle
    like two-level (measured: the recurrence residual reports 1e-5 while
    the true residual sits at 2e-1 on FEM n=2k) — so the two_level
    composition always sets it. Replacement laps cost 3 matvecs + 2
    preconditioner applies but add NO reductions, preserving the
    one-fused-psum-per-lap property.

    Stopping contract: same quantity as classic CG (``sqrt(r.r) < tol`` on
    the TRUE residual), evaluated at the top of the next lap; ``k`` counts
    completed x-updates, so iteration counts match the classic loop.
    """
    r0 = b - matvec(x0)
    tol2 = jnp.asarray(tol, r0.dtype) ** 2
    u0 = None if precond is None else precond(r0)
    w0 = matvec(r0 if precond is None else u0)
    zeros = jnp.zeros_like(r0)
    one = jnp.ones((), r0.dtype)
    state = _PipeState(
        k=jnp.int32(0), x=x0, r=r0, w=w0, p=zeros, s=zeros, z=zeros,
        gamma=one, alpha=one, rslast=one,
        done=jnp.zeros((), jnp.bool_),
        u=u0, q=None if precond is None else zeros,
    )

    def cond(st: _PipeState):
        return jnp.logical_and(st.k < maxiter, jnp.logical_not(st.done))

    def body(st: _PipeState):
        # The (p, s) pair measures the conjugation term DIRECTLY instead
        # of through the classic recursive proxy gamma/alpha (Ghysels'
        # denom = delta - beta*gamma/alpha): the recursion's scalar drift
        # compounds with ||M^-1|| and measured-floors the attainable
        # residual at 1e-2 ||b|| on FEM n=30k under two-level — the
        # measured pair rides the SAME fused reduction (one more scalar
        # in the psum, zero extra latency) and restores the floor to the
        # replacement-bounded level. Identity: gamma_i/alpha_{i-1} =
        # beta_i * (p, s)_{i-1}, so denom_i = delta_i - beta_i^2 (p,s)_{i-1}.
        if precond is None:
            gamma, delta, ps = dots(
                [(st.r, st.r), (st.w, st.r), (st.p, st.s)]
            )
            rr = gamma
        else:
            gamma, delta, rr, ps = dots(
                [(st.r, st.u), (st.w, st.u), (st.r, st.r), (st.p, st.s)]
            )
        done = rr < tol2
        # Independent of the fused reduction: overlaps the psum.
        m = st.w if precond is None else precond(st.w)
        nv = matvec(m)
        # Breakdown-safe scalars: gamma = (r, M^-1 r) and denom = (p, A p)
        # are positive for SPD in exact arithmetic, but at the f32
        # attainable floor the measured values cross zero — a negative
        # beta/alpha then walks the iterate AWAY (measured: 5e-2 ||b||,
        # then NaN, after a few thousand post-floor laps). On a gamma
        # breakdown restart the direction (beta = 0 -> p = u, steepest
        # descent); on a denom breakdown freeze the step (alpha = 0). The
        # solve then grinds in place to the cap — the honest behavior.
        first = st.k == 0
        restart = jnp.logical_or(first, gamma <= 0)
        beta = jnp.where(restart, jnp.zeros_like(gamma), gamma / st.gamma)
        denom = delta - beta * beta * ps
        if safe_alpha:
            alpha = jnp.where(denom > 0, gamma / denom, jnp.zeros_like(gamma))
        else:
            alpha = gamma / denom
        ubase = st.r if precond is None else st.u
        p = ubase + beta * st.p
        s = st.w + beta * st.s
        z = nv + beta * st.z
        x = st.x + alpha * p
        r = st.r - alpha * s
        w = st.w - alpha * z
        keep = lambda new, old: jnp.where(done, old, new)
        if precond is None:
            u = q = None
        else:
            q = m + beta * st.q
            u = st.u - alpha * q
            u, q = keep(u, st.u), keep(q, st.q)
        return _PipeState(
            k=jnp.where(done, st.k, st.k + 1),
            x=keep(x, st.x), r=keep(r, st.r), w=keep(w, st.w),
            p=keep(p, st.p), s=keep(s, st.s), z=keep(z, st.z),
            gamma=keep(gamma, st.gamma), alpha=keep(alpha, st.alpha),
            rslast=rr, done=done, u=u, q=q,
        )

    if not replace_every:
        return jax.lax.while_loop(cond, body, state)

    # Residual replacement, SEGMENTED: an outer loop runs replace_every
    # laps (inner while_loop), then refreshes the recurrence vectors
    # UNCONDITIONALLY with an elementwise keep-guard. The refresh must
    # NOT live inside a lax.cond: the sharded matvec carries collectives
    # (all_gather/ppermute), and collectives under a conditional are an
    # SPMD deadlock hazard (measured: the full CPU-mesh suite hung in
    # the sharded pipelined+two_level test; standalone runs passed).
    R = jnp.int32(replace_every)

    def inner_cond(st: _PipeState):
        return jnp.logical_and(cond(st), st.k % R != 0)

    def refresh(s2: _PipeState) -> _PipeState:
        rr_ = b - matvec(s2.x)
        u_ = None if precond is None else precond(rr_)
        w_ = matvec(rr_ if precond is None else u_)
        s_ = matvec(s2.p)
        q_ = None if precond is None else precond(s_)
        z_ = matvec(s_ if precond is None else q_)
        keep_ = lambda new, old: jnp.where(s2.done, old, new)
        return s2._replace(
            r=keep_(rr_, s2.r), w=keep_(w_, s2.w), s=keep_(s_, s2.s),
            z=keep_(z_, s2.z),
            u=None if u_ is None else keep_(u_, s2.u),
            q=None if q_ is None else keep_(q_, s2.q),
        )

    def outer_body(st: _PipeState):
        st = body(st)                                   # leave the k%R==0 point
        st = jax.lax.while_loop(inner_cond, body, st)   # run to next boundary
        return refresh(st)

    return jax.lax.while_loop(cond, outer_body, state)


def ca_cg_loop(
    matvec: Callable,
    dot: Callable,
    gram: Callable,
    b: jax.Array,
    x0: jax.Array,
    *,
    s: int,
    tol: float,
    maxiter,
    safe_alpha: bool = True,
    power_iters: int = 12,
    interval=None,
) -> _State:
    """Communication-avoiding (s-step) CG — Chronopoulos & Gear 1989;
    Carson, Knight & Demmel 2013 (monomial-basis CA-KSMs); Hoemmen 2010.

    Completes tpucg's communication-strategy spectrum, the collective
    extension of the reference's collective-vs-p2p thesis (its two arms
    differ only in HOW each lap's 3 blocking reductions travel,
    ``parallel_cg.c:287-313``): classic CG pays 2-3 scalar psums per lap,
    pipelined CG fuses them into 1, CA-CG amortizes to **one fused Gram
    reduction per s laps**. Per outer step it builds a Krylov basis
    V = [q_0(A)p, ..., q_s(A)p, q_0(A)r, ..., q_{s-1}(A)r] ((2s+1)
    columns; tall-skinny (n, 2s+1) products — GEMMs where
    classic CG has bandwidth-bound BLAS-1), takes G = V^T V in ONE
    reduction, then advances s CG iterations entirely in (2s+1)-coordinate
    space: every alpha/beta is a tiny quadratic form in G, replicated on
    all devices with zero communication.

    Basis polynomials: CHEBYSHEV on an estimated spectral interval [a, b]
    (the standard CA-KSM basis — Hoemmen 2010 §7; Carson 2015 §5). b ~
    lambda_max(A) by power method; a ~ b - rho(b I - A) by a second power
    method on the reflected operator (both from the same matvec/dot
    closures, so they ride every decomposition). Columns follow the
    three-term recurrence v_{i+1} = 2 t(A) v_i - v_{i-1} with
    t(A) = (A - c I)/h, c = (a+b)/2, h = (b-a)/2 (padded 5%), giving a
    TRIDIAGONAL change-of-basis B with |T_i| <= 1 on the interval — column
    norms stay O(||v_0||) in f32. The interval estimates affect only basis
    CONDITIONING, never correctness: B is exact for the recurrence at any
    [a, b]. Basis choice is what makes f32 CA-CG work at all: measured
    here, a plain monomial basis (A/theta)^i p collapses for CLUSTERED
    spectra (the reference's diag-dominant family has A ~ n I, so every
    power of p is nearly p: s=3 turned a 5-iteration solve into 235), and
    a single-shift Newton basis ((A - mu I)/gamma)^i p fixes the cluster
    but collapses on the SPREAD Poisson spectrum at s=3 (monomial-on-an-
    interval conditioning); Chebyshev handles both (s<=4 matches classic
    iteration counts on goldens, diag-dominant, and Poisson).

    Costs (documented trade-off, benchmarked in the A/B ledger): 2s-1
    matvecs per s iterations (~2x matvec traffic at large s) — a WIN when
    reduction latency bounds the lap (strong-scaled small n/P on a real
    mesh), a LOSS when the matvec's bandwidth does.

    Numerics (f32): the Gram quadratic forms carry an ABSOLUTE error floor
    ~eps * ||G|| * ||hat||^2 — far above tol^2 = 1e-12 near convergence —
    so the inner convergence test (same contract point: after the x/r
    update, before the p update) is only TENTATIVE. Every block ends with
    an EXACT ``dot(r, r)`` on the reconstructed full-space residual (the
    block's second and last reduction): it confirms or refutes a tentative
    stop, refreshes ``rsold`` so Gram-form drift cannot accumulate across
    blocks, and detects convergence the noisy Gram forms cannot resolve. A
    refuted block restarts the search direction at p = r (the classic safe
    CG restart) — near the Gram noise floor the method degrades gracefully
    toward verified steepest-descent steps instead of reporting a false
    convergence. ``rslast`` carries the exact block-end r.r.

    ``matvec``/``dot``/``gram`` abstract the execution model: serial
    closures, or block-local closures under shard_map where ``gram`` is
    psum(V_blk^T V_blk) and ``dot`` is psum-reducing.

    ``interval=(lam_lo, lam_hi)`` (scalars, traced or python) supplies the
    basis interval directly and SKIPS the 2 x ``power_iters``-matvec
    power-method setup — the reusable-artifact path for repeated solves on
    one operator (get it once from ``tpucg.spectral_interval``). The
    interval affects only basis CONDITIONING, never correctness (the
    change-of-basis B is exact at any [a, b]), so a cached estimate from an
    earlier solve is safe to reuse as long as the operator is unchanged.
    """
    if s < 1:
        raise ValueError("ca s-step count must be >= 1")
    m = 2 * s + 1  # p-tower degrees 0..s, r-tower degrees 0..s-1
    f32 = b.dtype
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    # Change-of-basis structure (Chebyshev three-term recurrence), per
    # tower of local index i with c = (a+b)/2, h = (b-a)/2:
    #   A v_0 = h v_1 + c v_0                       (v_1 = t(A) v_0)
    #   A v_i = (h/2) v_{i+1} + c v_i + (h/2) v_{i-1}   for 0 < i < top
    # The top column of each tower is never multiplied by B: p_hat_j has
    # p-degree <= j <= s-1 and r-degree <= j-1 <= s-2, so B raises degrees
    # to at most (s, s-1) — exactly the basis. Those columns stay zero.
    # S1 carries the first-step raise (coeff h), S2 the interior raise and
    # lower entries (coeff h/2), D the diagonal c mask.
    S1 = np.zeros((m, m), np.float32)
    S2 = np.zeros((m, m), np.float32)
    D = np.zeros((m, m), np.float32)
    for base, depth in ((0, s + 1), (s + 1, s)):  # p tower, r tower
        if depth >= 2:
            S1[base + 1, base] = 1.0
            D[base, base] = 1.0
        for i in range(1, depth - 1):
            S2[base + i + 1, base + i] = 1.0
            S2[base + i - 1, base + i] = 1.0
            D[base + i, base + i] = 1.0
    S1, S2, D = jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(D)

    if interval is None:
        lam_lo, lam_hi = spectral_interval_estimate(
            matvec, dot, b, power_iters
        )
    else:
        lam_lo = jnp.asarray(interval[0], f32)
        lam_hi = jnp.asarray(interval[1], f32)
    # 5% pad absorbs power-method under/over-shoot (eigenvalues slightly
    # outside the interval only grow T_i mildly); the width floor guards
    # the exactly-scalar operator A = const*I (h = 0 would NaN — any tiny
    # h just rescales coordinates).
    pad = 0.05 * (lam_hi - lam_lo)
    aa = jnp.maximum(lam_lo - pad, 0.0)
    bb = lam_hi + pad
    c = 0.5 * (aa + bb)
    h = jnp.maximum(0.5 * (bb - aa), jnp.asarray(1e-20, f32) * lam_hi)
    inv_h = 1.0 / h

    r0 = b - matvec(x0)
    tol2 = jnp.asarray(tol, f32) ** 2
    rr0 = dot(r0, r0)
    state = _State(
        k=jnp.int32(0), x=x0, r=r0, p=r0, rsold=rr0, rslast=rr0,
        done=rr0 < tol2,
    )

    e = np.eye(m, dtype=np.float32)
    ep, er = jnp.asarray(e[0]), jnp.asarray(e[s + 1])

    def cond(st: _State):
        return jnp.logical_and(st.k < maxiter, jnp.logical_not(st.done))

    def tower(v0, depth):
        # Chebyshev three-term column build: depth-1 matvecs, no reductions.
        cols = [v0]
        if depth >= 2:
            cols.append((matvec(v0) - c * v0) * inv_h)
        for _ in range(2, depth):
            v = cols[-1]
            t_v = (matvec(v) - c * v) * inv_h
            cols.append(2.0 * t_v - cols[-2])
        return cols

    def body(st: _State):
        # --- Basis build: 2s-1 matvecs, NO reductions -----------------
        V = jnp.stack(
            tower(st.p, s + 1) + tower(st.r, s), axis=1
        )  # (n_local, 2s+1)
        # --- The block's FIRST reduction ------------------------------
        G = gram(V)  # (2s+1, 2s+1), replicated
        B = h * S1 + (0.5 * h) * S2 + c * D
        rsold = st.rsold  # exact (refreshed by the previous block's dot)
        k = st.k
        tentative = jnp.zeros((), jnp.bool_)
        p_hat, r_hat, x_hat = ep, er, jnp.zeros((m,), f32)
        # --- s iterations in coordinate space (statically unrolled) ---
        for _ in range(s):
            active = jnp.logical_and(
                jnp.logical_not(tentative), k < maxiter
            )
            Bp = mm(B, p_hat)
            pap = mm(p_hat, mm(G, Bp))
            if safe_alpha:
                alpha = jnp.where(
                    pap != 0, rsold / pap, jnp.zeros_like(pap)
                )
            else:
                alpha = rsold / pap
            x_new = x_hat + alpha * p_hat
            r_new = r_hat - alpha * Bp
            # Gram quadratic form of an ~converged residual can round
            # fractionally negative.
            rr = jnp.maximum(mm(r_new, mm(G, r_new)), 0.0)
            conv = rr < tol2
            x_hat = jnp.where(active, x_new, x_hat)
            r_hat = jnp.where(active, r_new, r_hat)
            k = k + active.astype(jnp.int32)
            # Contract point: (tentatively) converged laps leave p/rsold
            # un-updated.
            upd = jnp.logical_and(active, jnp.logical_not(conv))
            p_hat = jnp.where(upd, r_new + (rr / rsold) * p_hat, p_hat)
            rsold = jnp.where(upd, rr, rsold)
            tentative = jnp.logical_or(
                tentative, jnp.logical_and(active, conv)
            )
        # --- Reconstruct exact full-space state (linear combos) -------
        x = st.x + mm(V, x_hat)
        r = mm(V, r_hat)
        p = mm(V, p_hat)
        # --- The block's SECOND reduction: exact verification ---------
        rr_true = dot(r, r)
        done = rr_true < tol2
        # A refuted tentative stop means the Gram noise floor fired below
        # tol; restart the direction at p = r (safe CG restart) so the
        # stale, un-updated p cannot stall later blocks.
        refuted = jnp.logical_and(tentative, jnp.logical_not(done))
        p = jnp.where(refuted, r, p)
        rsold = jnp.where(done, rsold, rr_true)
        return _State(
            k=k, x=x, r=r, p=p, rsold=rsold, rslast=rr_true, done=done,
        )

    return jax.lax.while_loop(cond, body, state)


def chebyshev_loop(
    matvec: Callable,
    dot: Callable,
    b: jax.Array,
    x0: jax.Array,
    *,
    tol: float,
    maxiter,
    check_every: int = 8,
    power_iters: int = 16,
    precond: Optional[Callable] = None,
    interval=None,
) -> _State:
    """Chebyshev iteration (Saad, *Iterative Methods*, alg. 12.1) — the
    terminal point of tpucg's reduction-cadence spectrum: classic CG pays
    2-3 scalar psums per lap, pipelined 1, CA-CG 2 per s laps — Chebyshev
    pays **ZERO reductions per lap**. Every alpha/beta analogue comes from
    a scalar recurrence on an estimated spectral interval [a, bnd], so a
    distributed lap is matvec communication ONLY (allgather/ring); the
    only reductions are two dots per ``check_every``-lap chunk boundary
    (the recurrence-residual stopping test and the true-residual anchor -
    fusable into one psum if ever latency-critical) plus the setup-time
    power-method interval estimate (reusing ``lambda_max_estimate``; same
    two-sided construction as ``ca_cg_loop``). Convergence is observed at
    chunk boundaries, so reported iteration counts round up to a multiple
    of ``check_every``.

    Stopping is a recurrence-residual test CONFIRMED against the true
    residual (the CA loop's confirm/refute pattern): a tentative stop
    whose b - A x still exceeds tol is refuted — r re-anchors to ground
    truth and the solve continues — unless the true residual has stopped
    improving since the last refute, which is the f32 true-residual floor
    (O(eps * ||A|| * ||x||), measurably ABOVE an absolute tol at large n);
    there the solve accepts, exactly as classic CG (whose contract
    quantity is the recurrence residual, ``serialConjugate.c:235``) does
    implicitly.

    The price (documented; benchmarked in the A/B ledger): no
    minimization - the rate is fixed by sqrt(a/bnd) with NO CG
    superlinearity, and a WRONG interval (spectrum outside [a, bnd])
    diverges instead of merely slowing. The defenses: asymmetric interval
    pads (bnd up 10%; a down 25% - the reflected power method
    systematically OVERestimates lambda_min, the dangerous direction),
    and a two-tier chunk guard - on a stalled check, re-anchor r to the
    true residual (residual replacement, van der Vorst & Ye) and restart
    the direction; on a >1.5x divergence, additionally widen the interval
    (a halves; bnd grows 25%) -
    so a bad estimate degrades toward a safe, wider-interval iteration
    rather than diverging.

    With ``precond`` (z = M^-1 r; Jacobi or the Neumann polynomial — both
    reduction-free per application) this is preconditioned Chebyshev on
    M^-1 A: the interval is estimated on the preconditioned operator and
    laps stay reduction-free.

    ``interval=(lam_lo, lam_hi)`` supplies the spectrum bounds directly
    and skips the power-method setup (see ``ca_cg_loop``); with a
    ``precond`` the supplied interval must bound the PRECONDITIONED
    operator M^-1 A. A wrong interval degrades toward the widened-interval
    guard below rather than correctness (the chunk guard re-anchors and
    widens), but costs rate — cache intervals per (operator, M) pair.
    """
    f32 = b.dtype
    tol2 = jnp.asarray(tol, f32) ** 2
    pmv = matvec if precond is None else (lambda v: precond(matvec(v)))

    if interval is None:
        lam_lo, lam_hi = spectral_interval_estimate(pmv, dot, b, power_iters)
    else:
        lam_lo = jnp.asarray(interval[0], f32)
        lam_hi = jnp.asarray(interval[1], f32)
    bnd0 = 1.10 * lam_hi
    a0 = jnp.maximum(0.75 * lam_lo, jnp.asarray(1e-8, f32) * lam_hi)

    def scalars(a, bnd):
        theta = 0.5 * (bnd + a)
        # Width floor guards A = const*I (delta = 0 would NaN sigma1; any
        # tiny delta just makes rho ~ 0 and the lap a Richardson step).
        delta = jnp.maximum(0.5 * (bnd - a), jnp.asarray(1e-20, f32) * bnd)
        return theta, delta, theta / delta

    r0 = b - matvec(x0)
    rr0 = dot(r0, r0)
    theta0, _, sigma0 = scalars(a0, bnd0)
    z0 = r0 if precond is None else precond(r0)
    state = (
        jnp.int32(0), rr0 < tol2, x0, r0, z0 / theta0, 1.0 / sigma0,
        a0, bnd0, rr0, jnp.asarray(jnp.inf, f32),
    )

    def cond(s):
        k, done = s[0], s[1]
        return jnp.logical_and(k < maxiter, jnp.logical_not(done))

    def body(s):
        k, done, x, r, d, rho, a, bnd, rr_prev, refute_rr = s
        theta, delta, sigma1 = scalars(a, bnd)

        def lap(_, t):
            k, x, r, d, rho = t
            active = k < maxiter
            xn = x + d
            rn = r - matvec(d)
            zn = rn if precond is None else precond(rn)
            rho_n = 1.0 / (2.0 * sigma1 - rho)
            dn = rho_n * rho * d + (2.0 * rho_n / delta) * zn
            x = jnp.where(active, xn, x)
            r = jnp.where(active, rn, r)
            d = jnp.where(active, dn, d)
            rho = jnp.where(active, rho_n, rho)
            return (k + active.astype(jnp.int32), x, r, d, rho)

        k, x, r, d, rho = jax.lax.fori_loop(
            0, check_every, lap, (k, x, r, d, rho)
        )
        # Stopping test on the RECURRENCE residual — the reference's (and
        # classic CG's) contract quantity (``serialConjugate.c:235`` tests
        # the incrementally-updated r). An f32 TRUE residual b - A x
        # carries an O(eps * ||A|| * ||x||) floor that an absolute tol can
        # sit BELOW (measured: ~5e-6 floor vs tol 1e-6 at n=4096 on the
        # reference generator family) — testing ground truth there would
        # spin to the cap on solves classic CG finishes; the recurrence
        # residual, like CG's, grinds below the floor.
        rr = dot(r, r)
        r_true = b - matvec(x)
        rr_true = dot(r_true, r_true)
        # Confirm/refute at a tentative stop (same pattern as ca_cg_loop's
        # exact block-end verification): a long Chebyshev trajectory drifts
        # the recurrence r off b - A x (measured 3.3e-6 true residual on a
        # recurrence-converged 1e-6 golden), so a recurrence stop is only
        # CONFIRMED when the true residual also clears tol. A refuted stop
        # re-anchors r to the true residual and continues — UNLESS the true
        # residual has made no progress (>= 90%) since the last refute:
        # that is the f32 true-residual floor, O(eps * ||A|| * ||x||),
        # which can sit ABOVE an absolute tol (measured ~5e-6 vs tol 1e-6
        # at n=4096 on the reference generator family); accept there, as
        # classic CG (whose contract quantity is the recurrence residual,
        # ``serialConjugate.c:235``) does implicitly.
        tentative = rr < tol2
        confirmed = jnp.logical_and(tentative, rr_true < tol2)
        # 0.81 = (0.9)^2: refute_rr carries SQUARED norms, and the
        # documented '>= 90% progress' contract (matching
        # block_cg_loop's boundary) is on residual NORMS.
        floor_hit = jnp.logical_and(tentative,
                                    rr_true >= 0.81 * refute_rr)
        done = jnp.logical_or(confirmed, floor_hit)
        refuted = jnp.logical_and(tentative, jnp.logical_not(done))
        # Two-tier chunk guard for non-tentative chunks:
        # - STALL (rr failed to decrease): re-anchor r to the TRUE
        #   residual (residual replacement, van der Vorst & Ye) and
        #   restart the direction recurrence at d = z/theta.
        # - DIVERGENCE (rr grew > 1.5x): the interval misses spectrum —
        #   additionally widen it (a halves; bnd grows 25% — measured on
        #   Poisson m=8: a 16-iter power method UNDERestimates lambda_max
        #   by 13%, the escaped top mode grows a steady ~2.4x/chunk, and a
        #   laxer 4x threshold with a timid 5% bnd bump never catches up;
        #   OVERshooting bnd only costs rate where UNDERshooting diverges).
        #   A mere stall must NOT widen: near the floor rr stalls chunk
        #   after chunk, and halving `a` each time would destroy the rate
        #   on a solve that only needs to grind.
        stall = jnp.logical_and(jnp.logical_not(tentative), rr >= rr_prev)
        div = jnp.logical_and(jnp.logical_not(tentative), rr > 1.5 * rr_prev)
        a = jnp.where(div, 0.5 * a, a)
        bnd = jnp.where(div, 1.25 * bnd, bnd)
        reanchor = jnp.logical_or(stall, refuted)
        r = jnp.where(reanchor, r_true, r)
        theta_r, _, sigma_r = scalars(a, bnd)
        z = r if precond is None else precond(r)
        d = jnp.where(reanchor, z / theta_r, d)
        rho = jnp.where(reanchor, 1.0 / sigma_r, rho)
        rr_prev = jnp.where(reanchor, rr_true, rr)
        refute_rr = jnp.where(refuted, rr_true, refute_rr)
        return (k, done, x, r, d, rho, a, bnd, rr_prev, refute_rr)

    k, done, x, r, d, rho, a, bnd, rr, _refute = jax.lax.while_loop(
        cond, body, state
    )
    return _State(k=k, x=x, r=r, p=d, rsold=rr, rslast=rr, done=done)


def _run_chebyshev(matvec, dot, b, x0, *, tol, maxiter, check_every,
                   precond=None, interval=None):
    """Chebyshev loop -> the (x, k, rnorm, done) result tuple shared by the
    serial and sharded drivers."""
    st = chebyshev_loop(
        matvec, dot, b, x0,
        tol=tol, maxiter=maxiter, check_every=check_every, precond=precond,
        interval=interval,
    )
    return st.x, st.k, jnp.sqrt(st.rslast), st.done


# The hand-rolled k x k algebra unrolls O(k^2) traced ops per lap; keep
# block widths where that stays trivially cheap (use cg_solve_multi for
# wide batches of unrelated systems).
BLOCK_CG_MAX_K = 32


def _chol_lower(G, k: int):
    """Hand-rolled k x k Cholesky (k static and small). The point vs
    ``jnp.linalg.cholesky``: every multiply here is an elementwise op or an
    explicit ``precision=HIGHEST`` dot, so nothing can run at reduced
    precision (TF32 on the GPU — the repo's f32 invariant; XLA's blocked
    Cholesky/TriangularSolve lowerings expose no precision control).
    Diagonal is floored so a ridged-but-rounded Gram can never NaN the
    sqrt."""
    f32 = G.dtype
    L = jnp.zeros_like(G)
    for j in range(k):
        s = G[j, j]
        if j:
            s = s - jnp.dot(L[j, :j], L[j, :j],
                            precision=jax.lax.Precision.HIGHEST)
        ljj = jnp.sqrt(jnp.maximum(s, jnp.asarray(1e-30, f32)))
        L = L.at[j, j].set(ljj)
        if j + 1 < k:
            col = G[j + 1:, j]
            if j:
                col = col - jnp.matmul(
                    L[j + 1:, :j], L[j, :j],
                    precision=jax.lax.Precision.HIGHEST,
                )
            L = L.at[j + 1:, j].set(col / ljj)
    return L


def _tri_solve_lower(L, M, k: int):
    """Solve L Z = M (L (k, k) lower-triangular, M (k, m)) by explicit
    forward substitution — k static rows of HIGHEST-precision GEMVs, for
    the same precision reason as ``_chol_lower`` (the (k, n) solve is
    exactly the matmul shape XLA would otherwise run at default
    precision)."""
    rows = []
    for i in range(k):
        acc = M[i]
        if i:
            acc = acc - jnp.matmul(
                L[i, :i], jnp.stack(rows),
                precision=jax.lax.Precision.HIGHEST,
            )
        rows.append(acc / L[i, i])
    return jnp.stack(rows)


def _spd_inv(T, eyek, k: int):
    """Inverse of a (ridged) k x k SPD matrix via the hand-rolled Cholesky
    and substitutions: T^-1 = L^-T L^-1, all HIGHEST-precision."""
    L = _chol_lower(T, k)
    Linv = _tri_solve_lower(L, eyek, k)
    return jnp.matmul(Linv.T, Linv, precision=jax.lax.Precision.HIGHEST)


def _cholqr(gram, Y, eyek, ridge):
    """Column-equilibrated Cholesky QR of the (n_loc, k) block ``Y`` via the
    ``gram`` closure (ONE reduction): Y = Q R with Q orthonormal. The
    equilibration (scale columns to unit norm before the Cholesky) is what
    makes the f32 Gram factorizable when column norms span orders of
    magnitude — the raw Gram's round-off exceeds any trace-relative ridge
    there. A ~zero column (converged residual — or an exactly-zero RHS)
    gets a guarded scale whose SQUARE still survives f32 (floors 1e-15
    relative / 1e-18 absolute: a 1e-30-relative floor squared to 1e-60
    underflowed ``jnp.outer`` to 0 and NaN-poisoned the whole solve) and a
    ~zero R entry: noise directions the triangular factor kills."""
    f32 = Y.dtype
    k = eyek.shape[0]
    G = gram(Y, Y)
    G = 0.5 * (G + G.T)
    d = jnp.sqrt(jnp.clip(jnp.diagonal(G), 0.0, None))
    d = jnp.maximum(
        d,
        jnp.maximum(
            jnp.asarray(1e-15, f32) * jnp.max(d), jnp.asarray(1e-18, f32)
        ),
    )
    Gn = G / jnp.outer(d, d) + jnp.asarray(ridge, f32) * eyek
    L = _chol_lower(Gn, k)
    Qt = _tri_solve_lower(L, (Y / d[None, :]).T, k)
    return Qt.T, L.T * d[None, :]


def _cholqr2(gram, Y, eyek, ridge=1e-6):
    """CholeskyQR2 (two passes): the second pass restores orthonormality to
    O(eps) after the equilibrated-but-ridged first pass — the standard
    distributed thin-QR (2 reductions total, each a (k, k) psum under
    shard_map; no Householder sequentialism)."""
    Q1, R1 = _cholqr(gram, Y, eyek, ridge)
    Q2, R2 = _cholqr(gram, Q1, eyek, ridge)
    return Q2, jnp.matmul(R2, R1, precision=jax.lax.Precision.HIGHEST)


def _cholqr_pc(gram, pc, Y, Z, eyek, ridge):
    """M^-1-inner-product Cholesky QR of the residual-side block ``Y``
    (``Z = pc(Y) = M^-1 Y``, supplied so callers can reuse one they
    already have): returns ``(U, V, Rfac)`` with Y = V Rfac,
    V M^-1-orthonormal (V^T M^-1 V = I), and U = M^-1 V REDERIVED by a
    fresh ``pc`` application — never by transforming Z. The M^-1-Gram
    needs no M: Y^T M^-1 Y = Z^T Y (``gram(Z, Y)``, one reduction).

    Why rederive instead of applying the triangular transform to both
    sides (which is exact-arithmetic-equivalent and saves the pc call):
    near-rank-deficient blocks make the ridged triangular solve amplify
    by ~1/sqrt(ridge) per pass, and a TRANSFORMED companion drifts from
    M^-1 V by that factor times f32 roundoff (measured ||U - M^-1 V||
    ~ 9 after two passes on a converging block) — the pair Gram then
    stops being PSD and the recurrence NaNs. A fresh pc keeps the pair
    consistent BY CONSTRUCTION, so every Gram is an honest inner product
    of stored vectors and the self-correcting property of the
    unpreconditioned ``_cholqr`` carries over.

    Guards: same column equilibration and zero-column floors as
    ``_cholqr``, plus — because diag(Z^T Y) is a sum of SIGNED f32
    products, unlike the always->= 0 diag(Y^T Y) — the normalized Gram
    is clipped to its exact-arithmetic range (off-diagonals in [-1, 1]
    by Cauchy-Schwarz) and its diagonal pinned at 1."""
    f32 = Y.dtype
    k = eyek.shape[0]
    G = gram(Z, Y)
    G = 0.5 * (G + G.T)
    d = jnp.sqrt(jnp.clip(jnp.diagonal(G), 0.0, None))
    d = jnp.maximum(
        d,
        jnp.maximum(
            jnp.asarray(1e-15, f32) * jnp.max(d), jnp.asarray(1e-18, f32)
        ),
    )
    Gn = jnp.clip(G / jnp.outer(d, d), -1.0, 1.0)
    Gn = Gn - jnp.diag(jnp.diagonal(Gn)) \
        + (1.0 + jnp.asarray(ridge, f32)) * eyek
    L = _chol_lower(Gn, k)
    Vt = _tri_solve_lower(L, (Y / d[None, :]).T, k)
    V = Vt.T
    return pc(V), V, L.T * d[None, :]


def _cholqr2_pc(gram, pc, Y, Z, eyek, ridge=1e-6):
    """Two-pass M^-1-inner-product CholeskyQR (the ``_cholqr2`` of the
    preconditioned world): the second pass re-orthonormalizes V1 to
    O(eps). 2 Gram reductions (both (k, k) psums under shard_map) and
    2 preconditioner applications; pass 2 reuses pass 1's fresh U1 as
    its Z side."""
    U1, V1, R1 = _cholqr_pc(gram, pc, Y, Z, eyek, ridge)
    U2, V2, R2 = _cholqr_pc(gram, pc, V1, U1, eyek, ridge)
    return U2, V2, jnp.matmul(R2, R1, precision=jax.lax.Precision.HIGHEST)


def block_pcg_loop(
    mv: Callable,
    gram: Callable,
    pc: Callable,
    B: jax.Array,
    X0: jax.Array,
    *,
    tol: float,
    maxiter,
    ridge: float = 1e-6,
):
    """Preconditioned TRUE block CG: ``block_cg_loop``'s BCGrQ recurrence
    run on the split-preconditioned system M^-1/2 A M^-1/2 — WITHOUT ever
    forming M^1/2 or M^-1/2. Everything lives in the original variables:
    the hat-space residual block factors as R_hat = M^-1/2 V C with V
    M^-1-ORTHONORMAL (the hat residual's orthonormal factor, pulled back
    to the residual side); the loop carries V, and every M^-1-side block
    it needs is produced by a FRESH ``pc`` application (see
    ``_cholqr_pc`` for why transforming one instead diverges). Cost:
    one operator GEMM and three M^-1 applications per lap on (n, k)
    blocks (one on A S alpha, two inside the CholeskyQR2), plus one
    GEMM + three M^-1 per confirm/refute boundary.

    Hat-space identities that make each lap cheap in original variables:
    S_hat^T A_hat S_hat = S^T (A S) (a plain Gram of the operator GEMM),
    X update X += S (alpha C), and the next residual-side block is
    MW = V - (A S) alpha with M^-1 side W = pc(MW).

    Stopping contract: the recurrence's C-norm test is on the hat
    residual ||M^-1/2 r||, so tentative stops, the returned
    ``residual_norm``, and ``converged`` are all in the M^-1/2-WEIGHTED
    norm — the natural PCG norm (for Jacobi this is ||D^-1/2 r||,
    identical to the dense equilibrated path's contract). Confirm/refute
    boundaries recompute it exactly: rr_hat = diag((M^-1 R_t)^T R_t)
    with R_t = B - A X the true residual.

    ``mv``/``gram``/``pc`` abstract the execution model exactly as in
    ``block_cg_loop``; ``pc`` maps an (n_loc, k) block to M^-1 times it
    (elementwise for Jacobi; operator polynomials for poly — both
    shard-local given a sharded ``mv``).
    """
    f32 = B.dtype
    krhs = B.shape[1]
    tol2 = jnp.asarray(tol, f32) ** 2
    eyek = jnp.eye(krhs, dtype=f32)
    mmk = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    R0 = B - mv(X0)
    U0, V0, C0 = _cholqr2_pc(gram, pc, R0, pc(R0), eyek, ridge)
    # The M^-1 side U is NOT carried: every consumer rederives it fresh
    # from the residual side (S is seeded from the QR's U and then self-
    # propagates), so threading it through the loop would be a dead
    # (n, k) buffer.
    state = (
        jnp.int32(0),            # laps
        jnp.bool_(False),        # done (set at confirm/floor boundaries)
        X0, V0, C0, U0,          # X, V (M^-1-orthonormal factor), C, S
        jnp.asarray(jnp.inf, f32),   # worst hat-rr at the last refute
        jnp.full((krhs,), jnp.inf, f32),  # latest exact per-column hat-rr
    )

    def outer_cond(s):
        k, done = s[0], s[1]
        return jnp.logical_and(k < maxiter, jnp.logical_not(done))

    def inner_cond(t):
        k, X, V, C, S = t
        rn2 = jnp.sum(C * C, axis=0)  # per-column hat ||r||^2, replicated
        return jnp.logical_and(k < maxiter,
                               jnp.logical_not(jnp.all(rn2 < tol2)))

    def inner_body(t):
        k, X, V, C, S = t
        AS = mv(S)
        T = gram(S, AS)
        T = 0.5 * (T + T.T)
        delta = jnp.asarray(ridge, f32) * (jnp.trace(T) / krhs) \
            + jnp.asarray(1e-30, f32)
        alpha = _spd_inv(T + delta * eyek, eyek, krhs)
        X = X + mmk(S, mmk(alpha, C))
        MW = V - mmk(AS, alpha)
        Un, Vn, rho = _cholqr2_pc(gram, pc, MW, pc(MW), eyek, ridge)
        C = mmk(rho, C)
        S = Un + mmk(S, rho.T)
        return (k + 1, X, Vn, C, S)

    def outer_body(s):
        k, done, X, V, C, S, refute_rr, rr = s
        k, X, V, C, S = jax.lax.while_loop(
            inner_cond, inner_body, (k, X, V, C, S)
        )
        # Boundary (tentative stop or cap): exact hat-norm true residual.
        # diag(Z^T R) is a signed f32 sum — clip roundoff-negatives so the
        # verdict (and the reported sqrt) stay well-defined at convergence.
        Rt = B - mv(X)
        Zt = pc(Rt)
        rr = jnp.clip(jnp.diagonal(gram(Zt, Rt)), 0.0, None)
        worst = jnp.max(rr)
        confirmed = jnp.all(rr < tol2)
        floor_hit = worst >= jnp.asarray(0.81, f32) * refute_rr  # (0.9)^2
        done = jnp.logical_or(confirmed,
                              jnp.logical_or(floor_hit, k >= maxiter))
        # Refute: re-anchor the recurrence on ground truth and continue.
        Ur, Vr, Cr = _cholqr2_pc(gram, pc, Rt, Zt, eyek, ridge)
        reanchor = jnp.logical_not(done)
        V = jnp.where(reanchor, Vr, V)
        C = jnp.where(reanchor, Cr, C)
        S = jnp.where(reanchor, Ur, S)
        refute_rr = jnp.where(reanchor, worst, refute_rr)
        return (k, done, X, V, C, S, refute_rr, rr)

    k, done, X, V, C, S, refute_rr, rr = jax.lax.while_loop(
        outer_cond, outer_body, state
    )
    return k, X, rr, rr < tol2


def block_cg_loop(
    mv: Callable,
    gram: Callable,
    B: jax.Array,
    X0: jax.Array,
    *,
    tol: float,
    maxiter,
    ridge: float = 1e-6,
):
    """TRUE block CG, in the numerically stable BCGrQ form (Dubrulle 2001,
    "Retooling the method of block conjugate gradients"): the k right-hand
    sides share ONE block-Krylov search space instead of running k
    independent recurrences in lockstep (``cg_solve_multi``'s vmap), so
    related systems converge in FEWER laps — the block deflates k
    eigendirections per lap (measured here: 1-D Laplacian n=256, k=8
    random RHS — 37 block laps vs 256 single-vector CG laps in f32).

    Why rQ: the plain O'Leary recurrence is UNSTABLE in f32 — measured on
    the same Laplacian, it loses block conjugacy and needs 300+ laps (no
    better than single CG), and any Gram ridge large enough to survive
    rank collapse poisons conjugacy further (ridge 1e-6 took the exact
    arithmetic's 32 laps to 332 even in f64). BCGrQ keeps the residual
    block ORTHONORMAL (thin QR each lap; the triangular factor C carries
    the residual magnitudes, so per-column stopping norms are the column
    norms of the replicated (k, k) C — no extra reduction), which bounds
    every Gram's conditioning by the search block's, not the residuals'.

    Shape: per lap one (n, k) operator GEMM, one (k, k) Gram psum for
    S^T A S, and a CholeskyQR2 thin QR (2 Gram psums) — GEMMs plus
    replicated k x k scalar algebra, no per-column BLAS-1, 3 fused
    reductions per lap under sharding.

    Stopping (the same confirm/refute pattern as ``ca_cg_loop`` and
    ``chebyshev_loop``): the recurrence's C-norm test is TENTATIVE; at a
    tentative stop the loop computes the exact true residual B - A X
    (one matvec + one Gram) and either CONFIRMS (all columns under tol),
    REFUTES (re-anchor: re-QR the true residual and continue), or accepts
    at the f32 true-residual floor (no >=10% progress since the last
    refute). ``converged`` is the per-column exact-true-residual verdict.

    ``mv``/``gram`` abstract the execution model: serial closures, or
    block-local closures under shard_map with ``gram`` psum-reducing.
    """
    f32 = B.dtype
    krhs = B.shape[1]
    tol2 = jnp.asarray(tol, f32) ** 2
    eyek = jnp.eye(krhs, dtype=f32)
    mmk = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    Q0, C0 = _cholqr2(gram, B - mv(X0), eyek, ridge)
    state = (
        jnp.int32(0),            # laps
        jnp.bool_(False),        # done (set at confirm/floor boundaries)
        X0, Q0, C0, Q0,          # X, Q, C, S
        jnp.asarray(jnp.inf, f32),   # worst true rr at the last refute
        jnp.full((krhs,), jnp.inf, f32),  # latest exact per-column rr
    )

    def outer_cond(s):
        k, done = s[0], s[1]
        return jnp.logical_and(k < maxiter, jnp.logical_not(done))

    def inner_cond(t):
        k, X, Q, C, S = t
        rn2 = jnp.sum(C * C, axis=0)  # per-column ||r||^2, replicated
        return jnp.logical_and(k < maxiter,
                               jnp.logical_not(jnp.all(rn2 < tol2)))

    def inner_body(t):
        k, X, Q, C, S = t
        AS = mv(S)
        T = gram(S, AS)
        T = 0.5 * (T + T.T)
        delta = jnp.asarray(ridge, f32) * (jnp.trace(T) / krhs) \
            + jnp.asarray(1e-30, f32)
        alpha = _spd_inv(T + delta * eyek, eyek, krhs)
        X = X + mmk(S, mmk(alpha, C))
        Qn, rho = _cholqr2(gram, Q - mmk(AS, alpha), eyek, ridge)
        C = mmk(rho, C)
        S = Qn + mmk(S, rho.T)
        return (k + 1, X, Qn, C, S)

    def outer_body(s):
        k, done, X, Q, C, S, refute_rr, rr = s
        k, X, Q, C, S = jax.lax.while_loop(
            inner_cond, inner_body, (k, X, Q, C, S)
        )
        # Boundary (tentative stop or cap): exact true residual.
        Rt = B - mv(X)
        rr = jnp.diagonal(gram(Rt, Rt))
        worst = jnp.max(rr)
        confirmed = jnp.all(rr < tol2)
        floor_hit = worst >= jnp.asarray(0.81, f32) * refute_rr  # (0.9)^2
        done = jnp.logical_or(confirmed,
                              jnp.logical_or(floor_hit, k >= maxiter))
        # Refute: re-anchor the recurrence on ground truth and continue.
        Qr, Cr = _cholqr2(gram, Rt, eyek, ridge)
        reanchor = jnp.logical_not(done)
        Q = jnp.where(reanchor, Qr, Q)
        C = jnp.where(reanchor, Cr, C)
        S = jnp.where(reanchor, Qr, S)
        refute_rr = jnp.where(reanchor, worst, refute_rr)
        return (k, done, X, Q, C, S, refute_rr, rr)

    k, done, X, Q, C, S, refute_rr, rr = jax.lax.while_loop(
        outer_cond, outer_body, state
    )
    return k, X, rr, rr < tol2


@functools.partial(
    jax.jit,
    static_argnames=(
        "tol", "maxiter", "safe_alpha", "method", "record",
        "poly_degree", "s_step", "check_every",
    ),
)
def _cg_jit(op, b, x0, minv, tol, maxiter, safe_alpha,
            method="cg", record=False, poly_degree=0, s_step=3,
            check_every=8, interval=None, two_level=None):
    matvec = op.matvec
    dot = dot_xla
    if two_level is not None:
        from tpucg.solver.twolevel import make_two_level_precond

        precond = make_two_level_precond(two_level, matvec, dot, b)
    elif poly_degree:
        precond = make_poly_precond(matvec, dot, b, poly_degree)
    elif minv is not None:
        # 1-D minv = point Jacobi (elementwise); 3-D = block Jacobi
        # (batched inverted diagonal blocks, one block GEMV per apply).
        precond = (
            make_block_precond(minv, b.shape[0])
            if minv.ndim == 3
            else (lambda r: minv * r)
        )
    else:
        precond = None
    if method == "pipelined":
        dots = lambda pairs: tuple(dot_xla(u, v) for u, v in pairs)
        s = pipelined_cg_loop(
            matvec, dots, b, x0,
            tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            precond=precond,
            replace_every=None if precond is None else PIPE_REPLACE_EVERY,
        )
        # The pipelined loop tests convergence one lap late; if it exited on
        # the iteration cap, recompute the final r.r for honest reporting.
        rr = jnp.where(s.done, s.rslast, dot(s.r, s.r))
        return CGResult(
            x=s.x,
            iterations=s.k,
            residual_norm=jnp.sqrt(rr),
            converged=jnp.logical_or(s.done, rr < jnp.asarray(tol, rr.dtype) ** 2),
        )
    if method == "ca":
        if precond is not None:
            raise ValueError("method='ca' supports precondition='none'")
        gram = lambda V: jnp.matmul(
            V.T, V, precision=jax.lax.Precision.HIGHEST
        )
        st = ca_cg_loop(
            matvec, dot, gram, b, x0,
            s=s_step, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            interval=interval,
        )
        # rslast carries the exact (verified) block-end r.r.
        return CGResult(
            x=st.x,
            iterations=st.k,
            residual_norm=jnp.sqrt(st.rslast),
            converged=st.done,
        )
    if method == "chebyshev":
        x, k, rn, done = _run_chebyshev(
            matvec, dot, b, x0,
            tol=tol, maxiter=maxiter, check_every=check_every,
            precond=precond, interval=interval,
        )
        return CGResult(x=x, iterations=k, residual_norm=rn, converged=done)
    s = cg_loop(
        matvec, dot, fused_update, b, x0,
        tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
        hist_len=maxiter if record else None,
        check_true_every=(
            TRUE_CHECK_EVERY if two_level is not None else None
        ),
    )
    return CGResult(
        x=s.x,
        iterations=s.k,
        residual_norm=jnp.sqrt(s.rslast),
        # rslast carries the TRUE r.r under check_true_every (where done
        # may also fire on stagnation); identical to s.done otherwise.
        converged=s.rslast < jnp.asarray(tol, s.rslast.dtype) ** 2,
        residual_history=s.hist,
    )


class _MultiState(NamedTuple):
    k: jax.Array     # scalar lap counter (loop bound)
    its: jax.Array   # (k,) per-column iteration counts
    X: jax.Array
    R: jax.Array
    P: jax.Array
    rsold: jax.Array
    rslast: jax.Array
    done: jax.Array


def _dot_cols(U: jax.Array, V: jax.Array) -> jax.Array:
    """Columnwise dots, (npad, k) x (npad, k) -> (k,), at HIGHEST precision
    (never TF32 — same contract as ``dot_xla``)."""
    return jnp.einsum(
        "nk,nk->k", U, V, precision=jax.lax.Precision.HIGHEST
    )


def multi_cg_loop(
    mvm: Callable,
    B: jax.Array,
    X0: jax.Array,
    *,
    tol: float,
    maxiter,
    safe_alpha: bool = True,
    precond: Optional[Callable] = None,
) -> _MultiState:
    """Matrix-form lockstep (P)CG: k independent recurrences advanced by
    ONE batched matvec ``mvm(X) = A @ X`` per lap.

    Per-column iterates are EXACTLY ``cg_loop``'s (same update order, same
    stopping test on the true residual after the x/r update, same done-lane
    freezing the batched while_loop provides under vmap — here explicit
    ``where`` masks with alpha = 0 on frozen columns). The point of the
    matrix form is the operator: ``vmap(op.matvec)`` re-streams a sparse
    operator's packed data once per lane, while a native ``matvec_multi``
    (e.g. ``WellOperator.matvec_multi``) streams it once for all k —
    the SpMM the serving workload wants. The loop runs until every column
    converges (or ``maxiter``); ``its`` reports per-column lap counts,
    matching the vmapped path's per-lane ``k``.
    """
    R0 = B - mvm(X0)
    tol2 = jnp.asarray(tol, R0.dtype) ** 2
    rr0 = _dot_cols(R0, R0)
    done0 = rr0 < tol2
    if precond is None:
        P0, rs0 = R0, rr0
    else:
        P0 = precond(R0)
        rs0 = _dot_cols(R0, P0)
    k0 = B.shape[1]
    state = _MultiState(
        k=jnp.int32(0), its=jnp.zeros((k0,), jnp.int32),
        X=X0, R=R0, P=P0, rsold=rs0, rslast=rr0, done=done0,
    )

    def cond(s: _MultiState):
        return jnp.logical_and(
            s.k < maxiter, jnp.logical_not(jnp.all(s.done))
        )

    def body(s: _MultiState):
        AP = mvm(s.P)
        pap = _dot_cols(s.P, AP)
        if safe_alpha:
            alpha = jnp.where(pap != 0, s.rsold / pap, jnp.zeros_like(pap))
        else:
            alpha = s.rsold / pap
        # Frozen columns take alpha = 0: X/R bit-identical to the vmapped
        # while_loop's per-lane freeze.
        alpha = jnp.where(s.done, jnp.zeros_like(alpha), alpha)
        X = s.X + alpha * s.P
        R = s.R - alpha * AP
        rr = jnp.where(s.done, s.rslast, _dot_cols(R, R))
        done = jnp.logical_or(s.done, rr < tol2)
        if precond is None:
            Z, rs_new = R, rr
        else:
            Z = precond(R)
            rs_new = _dot_cols(R, Z)
        P = jnp.where(done, s.P, Z + (rs_new / s.rsold) * s.P)
        rsold = jnp.where(done, s.rsold, rs_new)
        its = s.its + jnp.logical_not(s.done).astype(jnp.int32)
        return _MultiState(
            k=s.k + 1, its=its, X=X, R=R, P=P, rsold=rsold, rslast=rr,
            done=done,
        )

    return jax.lax.while_loop(cond, body, state)


@functools.partial(
    jax.jit, static_argnames=("tol", "maxiter", "safe_alpha", "poly_degree")
)
def _cg_multi_jit(op, B, X0, minv, tol, maxiter, safe_alpha, poly_degree=0):
    mvm = getattr(op, "matvec_multi", None)
    if mvm is not None and poly_degree == 0:
        # Operators with a native SpMM (WELL today): the matrix-form
        # lockstep loop streams the packed matrix ONCE per lap for all k
        # columns instead of once per vmapped lane.
        if minv is None:
            precond = None
        elif minv.ndim == 3:
            precond = jax.vmap(
                make_block_precond(minv, B.shape[0]), in_axes=1, out_axes=1
            )
        else:
            precond = lambda Rm: minv[:, None] * Rm
        s = multi_cg_loop(
            mvm, B, X0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            precond=precond,
        )
        return CGResult(
            x=s.X, iterations=s.its, residual_norm=jnp.sqrt(s.rslast),
            converged=s.done,
        )

    def one(b, x0):
        def update(x, r, p, ap, alpha):
            xn = x + alpha * p
            rn = r - alpha * ap
            return xn, rn, dot_xla(rn, rn)

        if poly_degree:
            precond = make_poly_precond(op.matvec, dot_xla, b, poly_degree)
        elif minv is not None:
            # 3-D minv = block Jacobi; the per-lane block GEMVs batch
            # under the enclosing vmap like the matvec does.
            precond = (
                make_block_precond(minv, b.shape[0])
                if minv.ndim == 3
                else (lambda r: minv * r)
            )
        else:
            precond = None
        s = cg_loop(
            op.matvec, dot_xla, update, b, x0,
            tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
        )
        return s.x, s.k, jnp.sqrt(s.rslast), s.done

    # vmap over RHS columns: the per-lane GEMVs batch into one A @ P GEMM per
    # lap, so A streams from HBM ONCE for all k systems — the bandwidth-bound
    # solve amortizes k-fold. Lanes converge independently (each carries its
    # own alpha/beta/done); the fused while_loop runs until all lanes finish.
    x, k, rn, done = jax.vmap(one, in_axes=1, out_axes=(1, 0, 0, 0))(B, X0)
    return CGResult(x=x, iterations=k, residual_norm=rn, converged=done)


@functools.partial(
    jax.jit, static_argnames=("tol", "maxiter", "safe_alpha", "poly_degree")
)
def _cg_batch_jit(A, b, x0, minv, tol, maxiter, safe_alpha, poly_degree=0):
    def one(Ai, bi, x0i, minvi):
        matvec = lambda v: jnp.dot(
            Ai, v, precision=jax.lax.Precision.HIGHEST
        )

        def update(x, r, p, ap, alpha):
            xn = x + alpha * p
            rn = r - alpha * ap
            return xn, rn, dot_xla(rn, rn)

        if poly_degree:
            precond = make_poly_precond(matvec, dot_xla, bi, poly_degree)
        else:
            precond = None if minvi is None else (lambda r: minvi * r)
        s = cg_loop(
            matvec, dot_xla, update, bi, x0i,
            tol=tol, maxiter=maxiter, safe_alpha=safe_alpha, precond=precond,
        )
        return s.x, s.k, jnp.sqrt(s.rslast), s.done

    # vmap over whole SYSTEMS: per-lane GEMVs batch into one (B,n,n)x(B,n)
    # batched GEMM per lap, and JAX's while_loop batching rule
    # select-masks each lane's carry on its own cond — converged systems
    # freeze while the rest keep iterating (same mechanism _cg_multi_jit
    # relies on for RHS lanes).
    if minv is None:
        x, k, rn, done = jax.vmap(
            lambda Ai, bi, x0i: one(Ai, bi, x0i, None)
        )(A, b, x0)
    else:
        x, k, rn, done = jax.vmap(one)(A, b, x0, minv)
    return CGResult(x=x, iterations=k, residual_norm=rn, converged=done)


def cg_solve_batch(
    A,
    b,
    X0=None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """Solve a BATCH of independent SPD systems A[i] x[i] = b[i].

    An extension beyond the reference (one system per process run) for
    throughput/serving workloads: ``A`` is (B, n, n), ``b``/``X0`` (B, n).
    One vmapped while_loop whose per-lap matvecs batch into one batched
    GEMM. Result fields are batched:
    ``x`` is (B, n); ``iterations``/``residual_norm``/``converged`` (B,).
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg":
        raise ValueError("cg_solve_batch supports method='cg' only")
    A = jnp.asarray(A, jnp.float32)
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {A.shape}")
    B_, n = A.shape[0], A.shape[1]
    b = jnp.asarray(b, jnp.float32)
    if b.shape != (B_, n):
        raise ValueError(f"b must be ({B_}, {n}), got {b.shape}")
    X0 = (
        jnp.zeros((B_, n), jnp.float32)
        if X0 is None
        else jnp.asarray(X0, jnp.float32)
    )
    if X0.shape != (B_, n):
        raise ValueError(f"X0 must be ({B_}, {n}), got {X0.shape}")
    maxiter = config.maxiter if config.maxiter is not None else n
    if config.precondition == "block_jacobi":
        raise ValueError(
            "cg_solve_batch supports precondition 'none', 'jacobi', or "
            "'poly' (per-system block inverses are unimplemented)"
        )
    minv = None
    if config.precondition == "jacobi":
        d = jnp.diagonal(A, axis1=1, axis2=2)
        minv = jnp.where(d != 0, 1.0 / d, 1.0).astype(jnp.float32)
    return _cg_batch_jit(
        A, b, X0, minv, float(config.tol), int(maxiter),
        bool(config.safe_alpha),
        config.poly_degree if config.precondition == "poly" else 0,
    )


@functools.partial(
    jax.jit,
    static_argnames=("offsets", "tol", "maxiter", "safe_alpha",
                     "precondition"),
)
def _cg_batch_dia_jit(data, offsets, b, X0, tol, maxiter, safe_alpha,
                      precondition):
    """vmapped while_loop over the batch with the shift-and-add SpMV per
    system."""
    from tpucg.kernels.spmv import dia_spmv

    def one(data_i, b_i, x0_i):
        mv = lambda v: dia_spmv(data_i, offsets, v)
        precond = None
        if precondition == "jacobi":
            d = data_i[offsets.index(0)].astype(jnp.float32)
            minv = jnp.where(d != 0, 1.0 / d, 1.0)
            precond = lambda r: minv * r
        s = cg_loop(mv, dot_xla, fused_update, b_i, x0_i,
                    tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                    precond=precond)
        return s.x, s.k, s.rslast, s.done

    x, k, rr, done = jax.vmap(one)(data, b, X0)
    return CGResult(
        x=x, iterations=k, residual_norm=jnp.sqrt(rr), converged=done,
    )


def cg_solve_batch_banded(
    data,
    offsets,
    b,
    X0=None,
    config: Optional[CGConfig] = None,
    storage_dtype=jnp.float32,
    **overrides,
) -> CGResult:
    """Solve a BATCH of independent BANDED SPD systems A[i] x[i] = b[i].

    The banded counterpart of :func:`cg_solve_batch` — the serving shape
    of implicit PDE time stepping (many small tridiagonal/banded batteries
    sharing one discretization): ``data`` is (B, ndiag, n) canonical DIA
    values (``data[i, d, j] = A_i[j, j + offsets[d]]``), ``offsets`` one
    static tuple shared by the batch, ``b``/``X0`` (B, n). One vmapped
    while_loop over the shift-and-add SpMV. ``precondition`` in
    {'none', 'jacobi'}; ``storage_dtype=bfloat16`` halves the slab stream
    (f32 accumulate). Result fields are batched like ``cg_solve_batch``.
    """
    import numpy as np

    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg":
        raise ValueError("cg_solve_batch_banded supports method='cg' only")
    if config.precondition not in ("none", "jacobi"):
        raise ValueError(
            "cg_solve_batch_banded supports precondition 'none' or "
            "'jacobi'"
        )
    if jnp.dtype(storage_dtype) not in (jnp.float32, jnp.bfloat16):
        raise ValueError(
            f"storage_dtype must be float32 or bfloat16, got {storage_dtype}"
        )
    data = np.asarray(data, np.float32)
    if data.ndim != 3:
        raise ValueError(f"data must be (B, ndiag, n), got {data.shape}")
    offsets = tuple(int(o) for o in offsets)
    B_, ndiag, n = data.shape
    if ndiag != len(offsets):
        raise ValueError(
            f"data has {ndiag} diagonals, offsets has {len(offsets)}"
        )
    b = jnp.asarray(b, jnp.float32)
    if b.shape != (B_, n):
        raise ValueError(f"b must be ({B_}, {n}), got {b.shape}")
    X0 = (
        jnp.zeros((B_, n), jnp.float32)
        if X0 is None
        else jnp.asarray(X0, jnp.float32)
    )
    if jnp.dtype(storage_dtype) == jnp.bfloat16:
        import ml_dtypes

        data = data.astype(ml_dtypes.bfloat16)
    maxiter = config.maxiter if config.maxiter is not None else n
    return _cg_batch_dia_jit(
        jnp.asarray(data), offsets, b, X0, float(config.tol),
        int(maxiter), bool(config.safe_alpha), config.precondition,
    )


@functools.partial(jax.jit, static_argnames=("power_iters",))
def _interval_jit(op, like, power_iters):
    return spectral_interval_estimate(
        op.matvec, dot_xla, like, power_iters
    )


def spectral_interval(A, power_iters: int = 16):
    """Estimate an SPD operator's spectrum bounds: returns
    ``(lam_lo, lam_hi, kappa)`` as floats from the two-sided power method
    (``spectral_interval_estimate``). The bounds are what the CA-CG basis
    and the Chebyshev iteration derive their scalars from — useful for
    picking ``method``/``s_step``/``check_every`` and for diagnosing
    f32 residual floors (O(eps * kappa) relative). Estimates, not bounds
    proper: lam_hi is typically slightly UNDER, lam_lo slightly OVER.
    """
    op = as_operator(A)
    like = jnp.zeros((op.padded_n,), jnp.float32)
    lam_lo, lam_hi = _interval_jit(op, like, int(power_iters))
    lam_lo_f, lam_hi_f = float(lam_lo), float(lam_hi)
    # NB an identity-padded operator's tail block contributes eigenvalue
    # 1.0, which can widen the reported interval — the same spectrum the
    # in-solver estimates see, so the numbers stay decision-relevant.
    return lam_lo_f, lam_hi_f, lam_hi_f / max(lam_lo_f, 1e-30)


def cg_solve_multi(
    A,
    B,
    X0=None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B for k right-hand sides simultaneously (B is (n, k)).

    An extension beyond the reference (one RHS per program run): the k CG
    recurrences advance in lockstep under ``vmap``, turning the per-lap GEMV
    into a GEMM that reads A once for all k systems. Operators exposing a
    native batched apply (``matvec_multi`` — WELL) take the matrix-form
    ``multi_cg_loop`` instead, same per-column iterates. Fields of the
    result are batched: ``x`` is (n, k);
    ``iterations``/``residual_norm``/``converged`` are (k,).
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg":
        raise ValueError("cg_solve_multi supports method='cg' only")
    op = as_operator(A)
    n, npad = op.n, op.padded_n
    B = jnp.asarray(B, jnp.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    X0 = (
        jnp.zeros((n, k), jnp.float32)
        if X0 is None
        else jnp.asarray(X0, jnp.float32)
    )
    if X0.shape != (n, k):
        raise ValueError(f"X0 must have shape ({n}, {k}), got {X0.shape}")
    if npad != n:
        B = jnp.pad(B, ((0, npad - n), (0, 0)))
        X0 = jnp.pad(X0, ((0, npad - n), (0, 0)))
    minv = None
    if config.precondition == "jacobi":
        d = op.diagonal()
        minv = jnp.where(d != 0, 1.0 / d, 1.0).astype(jnp.float32)
    elif config.precondition == "block_jacobi":
        minv = block_jacobi_minv(op, int(config.pc_block_size))
    maxiter = config.maxiter if config.maxiter is not None else n
    res = _cg_multi_jit(
        op, B, X0, minv, float(config.tol), int(maxiter),
        bool(config.safe_alpha),
        config.poly_degree if config.precondition == "poly" else 0,
    )
    if npad != n:
        res = res._replace(x=res.x[:n])
    return res


@functools.partial(
    jax.jit, static_argnames=("tol", "maxiter", "poly_degree")
)
def _cg_block_pjit(op, B, X0, minv, tol, maxiter, poly_degree=0):
    """Preconditioned block CG on any operator.

    Jacobi (``minv`` = 1/diag, padded length): MATRIX-FREE symmetric
    equilibration — wrap the operator as D^-1/2 A D^-1/2 with two
    elementwise row scalings around the matvec (XLA fuses them into the
    GEMM) and run the plain, f32-proven ``block_cg_loop`` on the scaled
    system. Exactly the dense equilibration shortcut's iterates, for
    operators whose scaled matrix can't be materialized. This is
    deliberately NOT ``block_pcg_loop``: with a badly scaled M the
    flexible recurrence's attainable f32 accuracy measured ~15x worse
    than equilibration (the post-convergence junk-direction laps walk X
    away in ORIGINAL variables, where the error is M^1/2-amplified),
    while equilibration computes every quantity in the well-scaled hat
    space.

    Block Jacobi (``minv`` = the (M^-1/2, M^1/2) pair from
    ``block_jacobi_sqrt_pair``): the SAME equilibration strategy
    blockwise — M^-1/2 exists explicitly for a block-diagonal M (one
    batched eigh at setup), so the hat operator is two batched block
    GEMMs around the matvec and the plain loop runs unchanged.

    Poly (``poly_degree`` > 0): the flexible M^-1-inner-product
    ``block_pcg_loop`` — a Neumann-polynomial M has no elementwise
    square root to equilibrate with, and (unlike a raw Jacobi D) is
    spectrally well-conditioned by construction, which keeps the
    flexible recurrence at its f32 floor (measured: exact parity with
    single-vector poly PCG on Poisson)."""
    # Native SpMM when the operator has one (WELL): one matrix
    # stream per lap for all k columns; vmap re-streams per lane.
    mv = getattr(op, "matvec_multi", None) or jax.vmap(
        op.matvec, in_axes=1, out_axes=1
    )
    gram = lambda U, V: jnp.matmul(
        U.T, V, precision=jax.lax.Precision.HIGHEST
    )
    if poly_degree:
        lam = lambda_max_estimate(op.matvec, dot_xla, B[:, 0])
        w = jnp.asarray(0.95, B.dtype) / lam

        def pc(R):
            Z = w * R
            for _ in range(poly_degree - 1):
                Z = Z + w * R - w * mv(Z)
            return Z

        k, X, rr, done = block_pcg_loop(
            mv, gram, pc, B, X0, tol=tol, maxiter=maxiter
        )
        return CGResult(
            x=X, iterations=k, residual_norm=jnp.sqrt(rr), converged=done
        )
    if isinstance(minv, tuple):
        isq, sq = minv
        npad = B.shape[0]
        sapp = make_block_apply(isq, npad)
        sqapp = make_block_apply(sq, npad)
        mv_hat = lambda Y: sapp(mv(sapp(Y)))
        k, Y, rr, done = block_cg_loop(
            mv_hat, gram, sapp(B), sqapp(X0), tol=tol, maxiter=maxiter
        )
        return CGResult(
            x=sapp(Y), iterations=k, residual_norm=jnp.sqrt(rr),
            converged=done,
        )
    sc = jnp.sqrt(minv)
    mv_hat = lambda Y: sc[:, None] * mv(sc[:, None] * Y)
    k, Y, rr, done = block_cg_loop(
        mv_hat, gram, sc[:, None] * B, X0 / sc[:, None],
        tol=tol, maxiter=maxiter,
    )
    return CGResult(
        x=sc[:, None] * Y, iterations=k, residual_norm=jnp.sqrt(rr),
        converged=done,
    )


@functools.partial(jax.jit, static_argnames=("tol", "maxiter"))
def _cg_block_jit(op, B, X0, tol, maxiter):
    # Native SpMM when the operator has one (WELL): one matrix
    # stream per lap for all k columns; vmap re-streams per lane.
    mv = getattr(op, "matvec_multi", None) or jax.vmap(
        op.matvec, in_axes=1, out_axes=1
    )
    gram = lambda U, V: jnp.matmul(
        U.T, V, precision=jax.lax.Precision.HIGHEST
    )
    k, X, rr, done = block_cg_loop(
        mv, gram, B, X0, tol=tol, maxiter=maxiter
    )
    return CGResult(
        x=X, iterations=k, residual_norm=jnp.sqrt(rr), converged=done
    )


def cg_solve_block(
    A,
    B,
    X0=None,
    config: Optional[CGConfig] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B with a TRUE block-Krylov method (O'Leary block CG).

    Where ``cg_solve_multi`` runs k INDEPENDENT recurrences in lockstep
    (same GEMM amortization, separate search spaces), block CG couples
    them: all k columns search one shared block-Krylov space, so related
    right-hand sides converge in fewer laps (the block deflates k
    eigendirections per lap — measured 37 vs 256 laps on a 1-D Laplacian
    with k=8). Runs in the f32-stable BCGrQ form (orthonormal residual
    block; see ``block_cg_loop``) on any operator (dense, stencil,
    sparse) via a vmapped matvec — per lap one (n, k) operator GEMM, one
    thin QR, and replicated k x k algebra.

    Result fields: ``x`` is (n, k); ``iterations`` is the SHARED lap
    count (all columns advance together); ``residual_norm``/``converged``
    are per-column (k,), reported from the EXACT true residual at the
    final confirm/refute boundary.

    Preconditioning on any operator: ``"jacobi"`` and ``"block_jacobi"``
    run as exact symmetric equilibration (elementwise scales /
    per-block M^(+-1/2) pairs from one batched eigh — the f32-stable
    form; dense-f32 Jacobi takes the materialized shortcut), ``"poly"``
    runs the flexible M-inner-product BCGrQ form (``block_pcg_loop``).
    Either way the residual contract — stopping,
    ``residual_norm``, ``converged`` — is on the M^-1/2-WEIGHTED
    residual (the natural PCG norm; ``||D^-1/2 (B - A X)||`` per column
    for Jacobi), which on a badly scaled diagonal can sit far from the
    unweighted ``||B - A X||``.
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    if config.method != "cg" or config.precondition not in (
        "none", "jacobi", "block_jacobi", "poly"
    ):
        raise ValueError(
            "cg_solve_block supports method='cg' with precondition "
            "'none', 'jacobi', 'block_jacobi', or 'poly'"
        )
    from tpucg.solver.operators import DenseOperator

    op = as_operator(A)
    scale = None
    flexible = config.precondition in ("poly", "block_jacobi")
    if config.precondition == "jacobi":
        if isinstance(op, DenseOperator) and op.A.dtype == jnp.float32:
            # Dense-f32 Jacobi block CG = EXACT symmetric equilibration:
            # solve (D^-1/2 A D^-1/2) Y = D^-1/2 B, X = D^-1/2 Y — the same
            # iterates as Jacobi-PCG, at zero per-lap cost (the scaled
            # matrix is materialized once). The stopping test is then on
            # the D^-1/2-weighted residual — the same M^-1/2-weighted
            # contract as the flexible path below.
            d = op.diagonal()
            scale = jnp.where(d > 0, jax.lax.rsqrt(d), jnp.ones_like(d))
            op = DenseOperator(
                A=scale[:, None] * op.A * scale[None, :], n=op.n
            )
        else:
            # Sparse / matrix-free / bf16-storage: the M-inner-product
            # BCGrQ loop, preconditioner applied blockwise per lap.
            flexible = True
    n, npad = op.n, op.padded_n
    B = jnp.asarray(B, jnp.float32)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    if k > BLOCK_CG_MAX_K:
        raise ValueError(
            f"block CG supports k <= {BLOCK_CG_MAX_K} right-hand sides "
            f"(got {k}): the full-precision k x k algebra unrolls O(k^2) "
            "traced ops per lap — use cg_solve_multi for wide batches"
        )
    X0 = (
        jnp.zeros((n, k), jnp.float32)
        if X0 is None
        else jnp.asarray(X0, jnp.float32)
    )
    if X0.shape != (n, k):
        raise ValueError(f"X0 must have shape ({n}, {k}), got {X0.shape}")
    if npad != n:
        B = jnp.pad(B, ((0, npad - n), (0, 0)))
        X0 = jnp.pad(X0, ((0, npad - n), (0, 0)))
    if scale is not None:
        B = scale[:, None] * B
        X0 = X0 / scale[:, None]
    maxiter = config.maxiter if config.maxiter is not None else n
    if flexible:
        if config.precondition == "jacobi":
            d = op.diagonal().astype(jnp.float32)
            minv = jnp.where(d > 0, 1.0 / d, jnp.ones_like(d))
            res = _cg_block_pjit(
                op, B, X0, minv, float(config.tol), int(maxiter)
            )
        elif config.precondition == "block_jacobi":
            res = _cg_block_pjit(
                op, B, X0,
                block_jacobi_sqrt_pair(op, int(config.pc_block_size)),
                float(config.tol), int(maxiter),
            )
        else:
            res = _cg_block_pjit(
                op, B, X0, None, float(config.tol), int(maxiter),
                poly_degree=int(config.poly_degree),
            )
    else:
        res = _cg_block_jit(op, B, X0, float(config.tol), int(maxiter))
    if scale is not None:
        res = res._replace(x=scale[:, None] * res.x)
    if npad != n:
        res = res._replace(x=res.x[:n])
    return res


def cg_solve(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    record_residuals: bool = False,
    interval=None,
    two_level=None,
    **overrides,
) -> CGResult:
    """Solve the SPD system A x = b on the current device.

    ``A`` may be a dense array, a ``CSRMatrix``/``EllMatrix``, or any
    ``LinearOperator``. Equivalent to running ``serialConjugate.c`` (same
    recurrence, tolerance, and iteration cap), jitted end-to-end.
    ``record_residuals=True`` additionally returns the per-iteration ||r||
    trace in ``result.residual_history``.

    ``interval=(lam_lo, lam_hi)`` (methods "ca"/"chebyshev" only) supplies
    cached spectrum bounds — e.g. the first two values of
    ``tpucg.spectral_interval(A)`` — and skips the per-solve power-method
    setup whose 2 x 12-16 matvecs otherwise dominate short solves
    (RESULTS.md cadence table). For preconditioned Chebyshev the bounds
    must be for M^-1 A.

    ``two_level`` (a prebuilt :func:`tpucg.build_two_level` result; method
    "cg" or "pipelined", ``precondition="none"``) runs
    two-level-preconditioned (pipelined) CG — the
    coarse-space correction that cuts FEM-class lap counts where
    point/block Jacobi cannot (see ``tpucg.solver.twolevel``). It must
    have been built with ``npad`` equal to the operator's ``padded_n``.
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    dtype = jnp.dtype(config.dtype)
    if dtype == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "dtype=float64 requires jax.config.update('jax_enable_x64', True) "
            "(the reference contract is float32; f64 is a tpucg extension)"
        )
    op = as_operator(A, dtype=dtype)
    n = op.n
    npad = op.padded_n
    b = jnp.asarray(b, dtype=dtype)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    x0 = (
        jnp.zeros(n, dtype)
        if x0 is None
        else jnp.asarray(x0, dtype=dtype)
    )
    if npad != n:
        # Identity-tail padding (see tpucg.io.partitioner): pad coordinates
        # start at the exact solution 0 and stay there.
        b = jnp.pad(b, (0, npad - n))
        x0 = jnp.pad(x0, (0, npad - n))
    maxiter = config.maxiter if config.maxiter is not None else n
    minv = None
    if config.precondition == "jacobi":
        d = op.diagonal()
        minv = jnp.where(d != 0, 1.0 / d, 1.0).astype(dtype)
    elif config.precondition == "block_jacobi":
        minv = block_jacobi_minv(op, int(config.pc_block_size)).astype(dtype)
    if record_residuals and config.method != "cg":
        raise ValueError("record_residuals requires method='cg'")
    if interval is not None:
        if config.method not in ("ca", "chebyshev"):
            raise ValueError(
                "interval=(lam_lo, lam_hi) applies to method='ca'/"
                f"'chebyshev' (got method={config.method!r})"
            )
        interval = jnp.asarray(
            [float(interval[0]), float(interval[1])], dtype
        )
    if two_level is not None:
        if config.method not in ("cg", "pipelined") \
                or config.precondition != "none":
            # The cycle is a FIXED SPD linear operator (solver/twolevel.py),
            # so it composes with any fixed-preconditioner Krylov method:
            # classic PCG and pipelined PCG (whose recurrence already takes
            # a precond and keeps its one-fused-psum-per-lap property — the
            # cycle's own collective is a tiny (nc,) all_gather, not a
            # blocking scalar reduction). CA/chebyshev take interval=.
            raise ValueError(
                "two_level runs as THE preconditioner of a method='cg' or "
                f"'pipelined' solve (got method={config.method!r}, "
                f"precondition={config.precondition!r})"
            )
        if dtype != jnp.float32:
            raise ValueError("two_level preconditioning is float32-only")
        if two_level.npad != npad:
            raise ValueError(
                f"two_level was built for padded size {two_level.npad}, "
                f"operator has {npad} — rebuild with "
                f"build_two_level(csr, npad={npad})"
            )
    res = _cg_jit(
        op, b, x0, minv, float(config.tol), int(maxiter),
        bool(config.safe_alpha), config.method, bool(record_residuals),
        config.poly_degree if config.precondition == "poly" else 0,
        int(config.s_step), int(config.check_every), interval, two_level,
    )
    if npad != n:
        res = res._replace(x=res.x[:n])
    return res


def dataclasses_replace(config: CGConfig, **overrides) -> CGConfig:
    import dataclasses

    return dataclasses.replace(config, **overrides)
