"""Two-level (AMG-lite) preconditioner — the iteration-count answer for
FEM-class irregular systems.

The reference is unpreconditioned CG (``serialConjugate.c:180-259``); tpucg's
point/block-Jacobi and Neumann-poly preconditioners bound the per-lap cost
but not the LAP COUNT on mesh Laplacians: the FEM P1 n=300k solve takes
~1700 jacobi laps and n=1M ~2250 (PERF.md) — iteration count, not
bandwidth, is the cost to cut. What CG lacks there is the LOW-frequency
end of the spectrum; a coarse-space correction supplies exactly that.

Gather-free construction (contrast classic AMG, whose C/F splitting,
triangular smoothers, and per-level sparse hierarchies are gather/scatter
machines XLA cannot tile):

- **Aggregates are fixed-size CONTIGUOUS index blocks** (``agg_size`` rows
  each). After a locality-restoring ordering (mesh numbering or ``--rcm``),
  consecutive rows are spatially adjacent, so contiguous blocks are honest
  spatial aggregates — and the transfer operators vanish into layout:
  restriction is ``r.reshape(nc, agg).sum(axis=1)`` (one reduction),
  prolongation a broadcast — ZERO gathers, zero stored P.
- **The Galerkin coarse operator Ac = P^T A P** is assembled host-side from
  the CSR coordinates in one ``np.add.at`` pass (entries pool by
  (row//agg, col//agg)) and INVERTED ONCE in f64; the per-lap coarse solve
  is then a single dense (nc, nc) GEMV, no sparse triangular
  solves anywhere.
- **Smoothing is damped Jacobi** (w D^-1, w = omega / lambda_max(D^-1 A),
  the estimate riding the same matvec/dot closures as the solve, so the
  whole preconditioner works unchanged under every decomposition).

Per application (the symmetric V(1,1) cycle below): 2 operator matvecs,
2 Jacobi scalings, one (nc,) reshape-sum + (nc, nc) GEMV + broadcast.
The cycle

    z1 = S r                    (pre-smooth,  S = w D^-1)
    z2 = z1 + P Ac^-1 P^T (r - A z1)
    z  = z2 + S (r - A z2)      (post-smooth)

composes to B = 2S - SAS + (I - SA) C (I - AS) with C = P Ac^-1 P^T —
symmetric by construction and SPD whenever w * lambda_max(D^-1 A) < 2
(guaranteed by the omega < 1 default against the power-method estimate),
so plain PCG applies with the true-residual stopping contract unchanged.

Measured effect (tests / RESULTS.md): the coarse space removes the smooth
modes CG crawls on — FEM P1 lap counts drop ~5-10x vs point Jacobi at ~3x
the per-lap cost, a net win precisely on the systems whose iteration count
is the bottleneck (VERDICT round-3 item 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpucg.io.partitioner import round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TwoLevel:
    """A prebuilt two-level (or recursive MULTILEVEL) preconditioner
    (device arrays + static layout).

    acinv (nc, nc) f32 — dense inverse of the Galerkin coarse matrix
                         P^T A P (f64 inverse at setup, symmetrized) —
                         the coarse SOLVE when ``inner`` is None;
    dinv  (npad,) f32  — 1/diag(A) over the padded rows (identity tail -> 1);
    agg                — rows per aggregate (contiguous);
    npad               — padded system size this was built for (must match
                         the operator's ``padded_n``);
    omega              — Jacobi damping relative to the lambda_max(D^-1 A)
                         estimate (w = omega / lam; omega < 1 keeps the
                         cycle SPD even under estimate error).

    Multilevel (round 5 — lifts the (n/agg)^2 replicated-inverse ceiling,
    VERDICT r4 #3): when ``inner`` is not None, the coarse solve is ONE
    recursive V(1,1) cycle on the SPARSE coarse operator ``coarse_op``
    (a device operator over the padded coarse size) with ``inner`` as its
    (possibly again recursive) preconditioner build — coarse memory then
    scales with nnz/agg instead of (n/agg)^2. The cycle stays a fixed
    linear SPD operator at every depth (an SPD approximate coarse solve
    keeps B SPD), so plain/pipelined PCG semantics are unchanged.
    """

    acinv: jax.Array
    dinv: jax.Array
    agg: int = dataclasses.field(metadata=dict(static=True))
    npad: int = dataclasses.field(metadata=dict(static=True))
    omega: float = dataclasses.field(
        default=0.7, metadata=dict(static=True)
    )
    # Smoother degree: 1 = one damped-Jacobi step (w = omega / lam_est);
    # ell >= 2 = an ell-step CHEBYSHEV smoother on the upper spectrum
    # [lam/alpha, 1.5 lam] of D^-1 A (the classic AMG smoother upgrade:
    # a fixed polynomial p(D^-1 A) D^-1 — still symmetric, still
    # reduction-free, ell matvecs per application). More per-lap matvecs,
    # fewer laps; measured crossovers live in RESULTS.md.
    smooth_degree: int = dataclasses.field(
        default=1, metadata=dict(static=True)
    )
    smooth_alpha: float = dataclasses.field(
        default=4.0, metadata=dict(static=True)
    )
    coarse_op: object = dataclasses.field(default=None)
    inner: object = dataclasses.field(default=None)
    # Inner-cycle iterations of the recursive coarse solve (sum_{j<k}
    # (I - B Ac)^j B — symmetric for every k, SPD while the inner cycle
    # is convergent). 2 recovers most of the exact-inverse lap count at
    # negligible cost (the coarse level is tiny); measured: FEM n=6k
    # agg=16 dense-inverse 75 laps, 1 cycle 116, 2 cycles ~85.
    coarse_cycles: int = dataclasses.field(
        default=2, metadata=dict(static=True)
    )

    @property
    def nc(self) -> int:
        # ceil(npad / agg) — NOT acinv.shape[0]: the multilevel form
        # carries a (1, 1) dummy acinv.
        return -(-int(self.npad) // int(self.agg))

    @property
    def levels(self) -> int:
        return 1 + (0 if self.inner is None else self.inner.levels)


def build_two_level(
    csr,
    agg_size: int = 64,
    omega: float = 0.7,
    npad: Optional[int] = None,
    ridge: float = 0.0,
    smooth_degree: int = 1,
    smooth_alpha: float = 4.0,
    coarse_max: Optional[int] = None,
) -> TwoLevel:
    """Build a :class:`TwoLevel` preconditioner from a square SPD CSR.

    Host-side, setup-only (one COO pass + one f64 dense inverse of the
    (nc, nc) coarse matrix, nc = ceil(npad / agg_size)); keep nc in the
    low thousands — agg_size 64-256 for n ~ 10^5-10^6. ``npad`` defaults
    to ``round_up(n, 128)`` (the WELL/DIA operator padding); pass the
    operator's ``padded_n`` explicitly if it differs. Rows [n, npad) are
    the partitioner's identity tail and contribute identity to their
    aggregates, so the coarse matrix stays SPD with no empty rows.

    ``ridge`` adds a trace-relative diagonal term before inversion — zero
    by default (the Galerkin coarse of an SPD fine matrix is SPD; the knob
    exists for near-singular shifted systems).

    ``coarse_max`` (round 5): when set and nc = ceil(npad/agg) exceeds it,
    the coarse matrix is assembled SPARSE (aggregate-pair key pooling, no
    dense (nc, nc) anywhere) and the build recurses — the returned cycle
    solves the coarse level with one V(1,1) cycle on a device sparse
    operator instead of a dense inverse, until the deepest level fits
    ``coarse_max`` and gets the exact f64 inverse. This lifts the
    (n/agg)^2 replicated-inverse memory ceiling (n=10M at agg=256 would
    need a 6 GB inverse; the multilevel hierarchy needs megabytes).
    """
    n, ncols = csr.shape
    if n != ncols:
        raise ValueError(f"two-level needs a square matrix, got {csr.shape}")
    agg = int(agg_size)
    if agg < 2:
        raise ValueError(f"agg_size must be >= 2, got {agg_size}")
    if npad is None:
        npad = round_up(n, 128)
    if npad < n:
        raise ValueError(f"npad {npad} < n {n}")
    nc = -(-npad // agg)

    coo = csr.to_coo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    vals = coo.data.astype(np.float64)

    on_d = rows == cols
    dv = np.zeros(n, np.float64)
    np.add.at(dv, rows[on_d], vals[on_d])
    d = np.ones(npad, np.float32)
    d[:n] = np.where(dv != 0, dv, 1.0).astype(np.float32)
    dinv = (1.0 / d).astype(np.float32)
    if smooth_degree < 1:
        raise ValueError(f"smooth_degree must be >= 1, got {smooth_degree}")

    # Galerkin coarse matrix: entries pool by aggregate pair; identity tail
    # rows [n, npad) add 1 to their aggregate's diagonal (blockdiag(A, I)
    # exactly). Rows [npad, nc*agg) are PHANTOM — restrict zero-pads them
    # (`make_two_level_precond.restrict`), so they contribute nothing to
    # the true Galerkin matrix and must not inflate the last diagonal
    # (every aggregate still holds real rows: (nc-1)*agg < npad).
    # The recursion floor is 2*LANE = 256: coarse operators pad to LANE
    # (128) rows, so a smaller coarse_max could CYCLE (nc -> padded 128
    # -> ratio agg -> back up — measured as a 968-frame RecursionError).
    # Anything <= 256 rows is a trivially cheap dense inverse anyway.
    cm_eff = None if coarse_max is None else max(int(coarse_max), 256)
    if cm_eff is not None and nc > cm_eff:
        # SPARSE assembly + recursion: never materialize (nc, nc) dense.
        keys = (rows // agg) * nc + (cols // agg)
        tailagg = np.arange(n, npad, dtype=np.int64) // agg
        keys = np.concatenate([keys, tailagg * nc + tailagg])
        kvals = np.concatenate([vals, np.ones(tailagg.size, np.float64)])
        uk, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros(uk.size, np.float64)
        np.add.at(acc, inv, kvals)
        if ridge:
            cdiag = (uk // nc) == (uk % nc)
            acc[cdiag] += ridge * (acc[cdiag].sum() / nc)
        from tpucg.sparse.formats import COOMatrix

        csr_c = COOMatrix(
            row=(uk // nc), col=(uk % nc),
            data=acc.astype(np.float32), shape=(nc, nc),
        ).to_csr()
        from tpucg.solver.operators import best_sparse_operator

        cop = best_sparse_operator(csr_c)
        # Inner aggregation ratio sized so the NEXT level lands at
        # coarse_max: reusing the (aggressive) top-level agg makes a weak
        # inner hierarchy — measured at FEM n=100k/agg=64/
        # coarse_max=256: inner agg=64 cost 357 outer laps vs the dense
        # inverse's 128; the ratio-sized inner agg (8 here) restores
        # near-parity. Deepest level is then an exact f64 inverse of at
        # most (coarse_max, coarse_max).
        agg_in = max(2, -(-nc // cm_eff))
        inner = build_two_level(
            csr_c, agg_size=agg_in, omega=omega, npad=cop.padded_n,
            ridge=ridge, smooth_degree=smooth_degree,
            smooth_alpha=smooth_alpha, coarse_max=cm_eff,
        )
        return TwoLevel(
            acinv=jnp.zeros((1, 1), jnp.float32), dinv=jnp.asarray(dinv),
            agg=agg, npad=int(npad), omega=float(omega),
            smooth_degree=int(smooth_degree),
            smooth_alpha=float(smooth_alpha),
            coarse_op=cop, inner=inner,
        )

    Ac = np.zeros((nc, nc), np.float64)
    np.add.at(Ac, (rows // agg, cols // agg), vals)
    tail_counts = np.bincount(
        np.arange(n, npad, dtype=np.int64) // agg, minlength=nc
    )
    idx = np.arange(nc)
    Ac[idx, idx] += tail_counts
    Ac = 0.5 * (Ac + Ac.T)
    if ridge:
        Ac[idx, idx] += ridge * (np.trace(Ac) / nc)
    acinv = np.linalg.inv(Ac)
    acinv = (0.5 * (acinv + acinv.T)).astype(np.float32)

    return TwoLevel(
        acinv=jnp.asarray(acinv), dinv=jnp.asarray(dinv),
        agg=agg, npad=int(npad), omega=float(omega),
        smooth_degree=int(smooth_degree), smooth_alpha=float(smooth_alpha),
    )


def build_two_level_from_parts(
    parts,
    n: int,
    npad: int,
    agg_size: int,
    omega: float = 0.7,
    ridge: float = 0.0,
    smooth_degree: int = 1,
    smooth_alpha: float = 4.0,
    diag=None,
) -> TwoLevel:
    """Distributed Galerkin assembly for host-sharded loading: each process
    contributes the partial coarse matrix of its LOCAL rows, one tiny
    (nc, nc) process-sum completes Ac, and every process computes the
    bit-identical f64 inverse (the per-process contributions are summed
    in process order). Replaces :func:`build_two_level`'s full-CSR
    ``np.add.at`` pass — the last place the flagship irregular path
    materialized the whole matrix per host (VERDICT r4 #2).

    ``parts``: list of ``(global_row_offset, COOMatrix)`` with local row
    numbering and GLOBAL columns (``load_matrix_market_rows`` output).
    ``diag``: the already-summed (npad,) operator diagonal if the caller
    has it (``WellShardedSystem.diag``); assembled from the parts + one
    more process-sum otherwise.
    """
    from tpucg.solver.sharded import _sum_across_processes

    agg = int(agg_size)
    if agg < 2:
        raise ValueError(f"agg_size must be >= 2, got {agg_size}")
    if npad % agg:
        raise ValueError(
            f"sharded two-level needs agg_size | npad ({agg} vs {npad})"
        )
    nc = npad // agg
    Ac_part = np.zeros((nc, nc), np.float64)
    need_diag = diag is None
    diag_part = np.zeros(npad, np.float64) if need_diag else None
    for row0, coo in parts:
        grows = coo.row.astype(np.int64) + int(row0)
        gcols = coo.col.astype(np.int64)
        vals = coo.data.astype(np.float64)
        np.add.at(Ac_part, (grows // agg, gcols // agg), vals)
        if need_diag:
            on_d = grows == gcols
            np.add.at(diag_part, grows[on_d], vals[on_d])
    Ac = _sum_across_processes(Ac_part)
    idx = np.arange(nc)
    # identity-tail rows [n, npad): added ONCE after the sum (every
    # process knows the range; it is not any process's data).
    tail_counts = np.bincount(
        np.arange(n, npad, dtype=np.int64) // agg, minlength=nc
    )
    Ac[idx, idx] += tail_counts
    Ac = 0.5 * (Ac + Ac.T)
    if ridge:
        Ac[idx, idx] += ridge * (np.trace(Ac) / nc)
    acinv = np.linalg.inv(Ac)
    acinv = (0.5 * (acinv + acinv.T)).astype(np.float32)
    if need_diag:
        d64 = _sum_across_processes(diag_part)
        d64[n:npad] = 1.0
        d = np.where(d64 != 0, d64, 1.0).astype(np.float32)
    else:
        d = np.asarray(diag, np.float32)
        if d.shape != (npad,):
            raise ValueError(f"diag must have shape ({npad},), got {d.shape}")
    if smooth_degree < 1:
        raise ValueError(f"smooth_degree must be >= 1, got {smooth_degree}")
    return TwoLevel(
        acinv=jnp.asarray(acinv), dinv=jnp.asarray(1.0 / d),
        agg=agg, npad=int(npad), omega=float(omega),
        smooth_degree=int(smooth_degree), smooth_alpha=float(smooth_alpha),
    )


def _make_smoother(matvec, dinv, lam, omega, degree: int, alpha: float):
    """The cycle's symmetric smoother S (z ~ smooth-solve of A z = r):

    degree 1: one damped-Jacobi step, S = (omega / lam) D^-1;
    degree l >= 2: the l-step CHEBYSHEV smoother on the upper interval
      [lam / alpha, 1.5 lam] of D^-1 A — the fixed polynomial
      S = p(D^-1 A) D^-1 (symmetric; SPD because the Chebyshev error
      polynomial q = 1 - lam p(lam) stays in (0, 1) BELOW the interval —
      q(0) = 1 exactly — and in [-1/T_l(s1), 1/T_l(s1)] on it; the pad
      guards the power-method's underestimate, the direction where q
      ESCAPES and the cycle turns amplifying. Round 5 measured a 1.39x
      underestimate on a flat-spectrum geometric graph — the old 1.1 pad
      silently made the cheb cycle DIVERGENT there, hidden until the
      true-residual stopping landed — hence 1.5, plus the deeper power
      method in the precond builders). l - 1 matvecs per application;
      same scalars as ``chebyshev_loop``'s lap recurrence.
    """
    f32 = jnp.float32
    if degree == 1:
        w = jnp.asarray(omega, f32) / lam

        def smooth(r):
            return (w * dinv) * r

        return smooth

    a = lam / jnp.asarray(alpha, f32)
    b = jnp.asarray(1.5, f32) * lam
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    def smooth(r):
        d = (dinv * r) / theta
        z = d
        rho = 1.0 / sigma1
        for _ in range(degree - 1):
            rr = r - matvec(z)
            rho_n = 1.0 / (2.0 * sigma1 - rho)
            d = rho_n * rho * d + (2.0 * rho_n / delta) * (dinv * rr)
            z = z + d
            rho = rho_n
        return z

    return smooth


def _coarse_solve_fn(tl: TwoLevel, dot: Callable) -> Callable:
    """The coarse-level solve rc -> e of one cycle: the exact dense
    inverse at the deepest level, ONE recursive V(1,1) cycle on the
    sparse coarse operator otherwise (still a fixed linear SPD operator,
    so outer PCG semantics are untouched). ``dot`` must be a LOCAL dot
    (sharded callers pass dot_xla, not the psum closure — the coarse
    hierarchy is replicated per device)."""
    _HI = jax.lax.Precision.HIGHEST
    if tl.inner is None:
        return lambda rc: jnp.matmul(tl.acinv, rc, precision=_HI)
    cop = tl.coarse_op
    nc = tl.nc

    def solve(rc):
        rcp = (
            jnp.pad(rc, (0, cop.padded_n - nc))
            if cop.padded_n != nc else rc
        )
        B = make_two_level_precond(tl.inner, cop.matvec, dot, rcp)
        e = B(rcp)
        for _ in range(int(tl.coarse_cycles) - 1):
            e = e + B(rcp - cop.matvec(e))
        return e[:nc] if cop.padded_n != nc else e

    return solve


def make_two_level_precond(
    tl: TwoLevel, matvec: Callable, dot: Callable, like: jax.Array
) -> Callable:
    """The serial z = B r closure (the symmetric V(1,1) cycle above), built
    from the same matvec/dot closures as the solve — trace-time cost is one
    power-method lambda_max(D^-1 A) estimate (12 matvecs, once per jit)
    per level of the hierarchy."""
    from tpucg.solver.cg import lambda_max_estimate

    # 24 power iterations: 12 underestimated lambda_max by 1.39x on a
    # flat-spectrum geometric graph (round 5) — inside the Chebyshev
    # smoother's safety pad only with the deeper estimate. Trace-time
    # cost only.
    lam = lambda_max_estimate(
        lambda v: tl.dinv * matvec(v), dot, like, power_iters=24
    )
    S = _make_smoother(matvec, tl.dinv, lam, tl.omega, tl.smooth_degree,
                       tl.smooth_alpha)
    nc, agg, npad = tl.nc, tl.agg, tl.npad
    npc = nc * agg
    coarse_solve = _coarse_solve_fn(tl, dot)

    def restrict(v):
        vp = jnp.pad(v, (0, npc - npad)) if npc != npad else v
        return jnp.sum(vp.reshape(nc, agg), axis=1)

    def prolong(u):
        z = jnp.broadcast_to(u[:, None], (nc, agg)).reshape(-1)
        return z[:npad] if npc != npad else z

    def precond(r):
        z = S(r)
        e = coarse_solve(restrict(r - matvec(z)))
        z = z + prolong(e)
        return z + S(r - matvec(z))

    return precond


def make_two_level_precond_sharded(
    matvec, dot, b_blk, acinv, dinv_blk, agg: int, omega: float, axis,
    smooth_degree: int = 1, smooth_alpha: float = 4.0, tl=None,
):
    """The row-block-sharded z = B r closure: shard-LOCAL restrict /
    prolong (contiguous aggregates never cross a shard — the caller
    enforces agg | rows-per-shard), ONE (nc,)-length ``all_gather`` of the
    coarse residual per coarse solve (nc is in the low thousands — a
    rounding error beside the matvec's own collective), the (nc, nc)
    inverse REPLICATED, plus the cycle's two sharded matvecs. ``matvec``/
    ``dot`` are the same per-shard closures the solve uses, so this rides
    every 1-D operator decomposition (WELL all-gather, DIA band-halo,
    Poisson slab) unchanged."""
    from tpucg.solver.cg import lambda_max_estimate

    lam = lambda_max_estimate(
        lambda v: dinv_blk * matvec(v), dot, b_blk, power_iters=24
    )
    S = _make_smoother(matvec, dinv_blk, lam, omega, smooth_degree,
                       smooth_alpha)
    ncl = dinv_blk.shape[0] // agg  # local coarse entries per shard
    _HI = jax.lax.Precision.HIGHEST
    if tl is not None and tl.inner is not None:
        # Multilevel: after the (nc,)-all_gather the whole coarse
        # HIERARCHY runs replicated per device — its dots must be LOCAL
        # (dot_xla), not the psum closure (the vectors are replicated,
        # a psum would multiply by P).
        from tpucg.kernels.blas1 import dot_xla

        coarse_solve = _coarse_solve_fn(tl, dot_xla)
    else:
        coarse_solve = lambda rc: jnp.matmul(acinv, rc, precision=_HI)

    def coarse(r_blk):
        rc_loc = jnp.sum(r_blk.reshape(ncl, agg), axis=1)
        rc = jax.lax.all_gather(rc_loc, axis, tiled=True)  # (nc,)
        e = coarse_solve(rc)
        my = jax.lax.axis_index(axis)
        e_loc = jax.lax.dynamic_slice(e, (my * ncl,), (ncl,))
        return jnp.broadcast_to(e_loc[:, None], (ncl, agg)).reshape(-1)

    def precond(r_blk):
        z = S(r_blk)
        z = z + coarse(r_blk - matvec(z))
        return z + S(r_blk - matvec(z))

    return precond
