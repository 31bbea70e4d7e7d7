#!/usr/bin/env python
"""End-to-end check that tpucg's solvers run on the GPU.

    python chip_smoke.py           # every phase below, on one card
    python chip_smoke.py --multi   # the sharded solvers on four cards

Every phase drives a public entry point at a size a user of a CG library
would call real, and compares the result with the repo's plain reference.
Any failed check raises, so the script exits non-zero; nothing is caught
and hidden. The script exits non-zero, printing no result, when JAX finds
no GPU. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Tolerances, and why each holds:

- goldens: the reference's 2x2 and 4x4 systems converge in exactly 2 and 4
  laps at tol 1e-6 and x matches the exact solution to 1e-6. Both hold in
  float32 only if every f32 contraction runs at full precision: TF32
  products (about three decimal digits) stall the 4x4 short of 1e-6.
- dense: against ``oracle_cg`` in float64 on the same matrix. The
  generator's systems are diagonally dominant (kappa ~ 2), so f32 and f64
  CG take the same laps up to one; x agrees to 1e-4 relative (f32 rounding
  of the residual test at tol 1e-6). bf16 storage rounds A by ~4e-3
  relative per entry, which moves x by ~kappa * 4e-3 / sqrt(n): 1e-2.
- Poisson and DIA: CG is asked for tol = 1e-5 ||b|| and the true residual
  ||b - A x||, in float64 on the host from scipy's CSR of
  ``poisson3d_csr``, must be at most tol. The f32 gap between the
  recurrence and the true residual (~eps ||A|| ||x||, about 1% of tol
  here) is not hidden by asking for less. The DIA matvec matches scipy's
  to 1e-6 relative (f32 sums of seven terms of size <= 6 ||x||).
- irregular (FEM P1, n=1M, WELL): the WELL matvec matches scipy's CSR to
  1e-6 relative (f32 sums of ~18 terms; the scatter-add's order does not
  matter at that level). The reference is a plain Jacobi CG in float64 on
  the device (a segment-sum CSR matvec, no tpucg code), asked for
  FEM_REF_RTOL; its true residual must meet FEM_RTOL = 1e-3. Rounding its
  x* to float32 gives the true residual rho: no float32 solve can be held
  below it. CG's float32 x updates add rounding that walks like sqrt(laps)
  (true residual / (rho sqrt(laps)) measured 0.94 at n=100k and 0.84 at
  300k on the CPU, 0.62-1.09 at 1M on the H100; PERF.md). Both float32 arms solve to FEM_RTOL (jacobi on
  its recurrence, two-level on the true residual with a stagnation exit)
  and must end before maxiter with x within FEM_XTOL of x* (relative
  2-norm; read 1.4e-5 to 3.6e-5 on the CPU at 20k-300k, 6.7e-6 and 2.3e-5
  at 1M on the H100) and a true residual at most
  FEM_RTOL + FEM_FLOOR_FACTOR rho sqrt(laps). That residual limit is loose
  at 1M by nature (rho sqrt(laps) ~ 0.6 for jacobi); the x check is the
  one that catches a wrong answer. A stagnation stop
  (converged False before maxiter) is printed, not hidden.
- batch: each system against its own float64 ``oracle_cg``, as dense.
- sharded (--multi): each result spans 4 distinct devices, takes the
  one-card solve's laps up to LAP_SLACK (sums run in another order) and
  meets the same reference check as its one-card phase. The row-sharded
  WELL matvec matches the one-card product and scipy's to 1e-6.
Sums on the GPU run in another order than on the host, and XLA's
scatter-add (the WELL SpMV) uses atomics whose rounding changes from run to
run, so nothing here is compared bit for bit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

GOLDEN_TOL = 1e-6
DENSE_XTOL = {"float32": 1e-4, "bfloat16": 1e-2}
POISSON_RTOL = 1e-5
MATVEC_TOL = 1e-6
FEM_RTOL = 1e-3
FEM_REF_RTOL = 1e-7
FEM_REF_MAXITER = 100_000
FEM_XTOL = 2e-4
FEM_FLOOR_FACTOR = 1.5
LAP_SLACK = 1


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_label() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown card"


def _rel(x, ref) -> float:
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


def _scipy_csr(csr):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.asarray(csr.data, np.float64), csr.indices, csr.indptr),
        shape=csr.shape,
    )


def _true_rel_residual(A64, x, b) -> float:
    b = np.asarray(b, np.float64)
    r = b - A64 @ np.asarray(x, np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _timed(fn):
    """Run ``fn`` twice: (second result, first-call seconds incl. compile,
    second-call seconds, first result)."""
    import jax

    t0 = time.perf_counter()
    first = jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, t1 - t0, time.perf_counter() - t1, first


def phase_goldens() -> dict:
    import tpucg
    from tpucg.cli import main as cli_main
    from tpucg.io.golden import GOLDEN_2X2, GOLDEN_4X4

    check(cli_main(["selftest"]) == 0, "tpucg selftest failed")
    laps, err, walls = [], 0.0, []
    for g in (GOLDEN_2X2, GOLDEN_4X4):
        r, t_first, t_warm, _ = _timed(
            lambda: tpucg.cg_solve(g["A"], g["b"], g["x0"], tol=GOLDEN_TOL)
        )
        walls.append((t_first, t_warm))
        k = int(r.iterations)
        e = float(np.abs(np.asarray(r.x, np.float64) - g["x_star"]).max())
        check(k == int(g["iters"]),
              f"golden {len(g['b'])}x{len(g['b'])}: {k} laps, want "
              f"{int(g['iters'])}")
        check(e <= GOLDEN_TOL, f"golden x error {e:.2e} > {GOLDEN_TOL}")
        laps.append(k)
        err = max(err, e)
    return dict(phase="goldens", size="2x2, 4x4", laps=laps,
                err=f"max |x - x*| {err:.2e} (<= {GOLDEN_TOL})",
                first_s=sum(w[0] for w in walls),
                warm_s=sum(w[1] for w in walls))


def phase_dense(n: int, storage: str = "float32") -> dict:
    import tpucg
    from tpucg.solver.operators import DenseOperator
    from tpucg.solver.oracle import oracle_cg

    A, b, x0 = tpucg.generate_spd_system(n, seed=0)
    x_ref, k_ref, _ = oracle_cg(A, b, x0, dtype=np.float64)
    op = DenseOperator.create(A, dtype=storage)
    res, t_first, t_warm, _ = _timed(lambda: tpucg.cg_solve(op, b, x0))
    k = int(res.iterations)
    e = _rel(res.x, x_ref)
    check(bool(res.converged), f"dense {storage} n={n} did not converge")
    check(abs(k - k_ref) <= 1, f"dense {storage}: {k} laps, oracle {k_ref}")
    check(e <= DENSE_XTOL[storage],
          f"dense {storage}: x rel err {e:.2e} > {DENSE_XTOL[storage]}")
    return dict(phase=f"dense {storage}", size=f"n={n}", laps=k,
                err=f"x rel err {e:.2e} vs f64 oracle ({k_ref} laps)",
                first_s=t_first, warm_s=t_warm)


def _poisson_rhs(m: int):
    """b = A x_true for a seeded random x_true: an O(1)-scaled right-hand
    side whose solution is known."""
    from tpucg.io.generator import poisson3d_csr

    csr = poisson3d_csr(m)
    A64 = _scipy_csr(csr)
    x_true = np.random.default_rng(0).standard_normal(m ** 3)
    b = (A64 @ x_true).astype(np.float32)
    return csr, A64, b


def phase_poisson(m: int) -> dict:
    import tpucg
    from tpucg.solver.operators import PoissonOperator

    _, A64, b = _poisson_rhs(m)
    tol = POISSON_RTOL * float(np.linalg.norm(b))
    op = PoissonOperator(m=m)
    res, t_first, t_warm, _ = _timed(
        lambda: tpucg.cg_solve(op, b, tol=tol, maxiter=4 * m ** 2)
    )
    rel = _true_rel_residual(A64, res.x, b)
    check(bool(res.converged), f"Poisson m={m} did not converge")
    check(rel <= POISSON_RTOL, f"Poisson true rel residual {rel:.2e}")
    return dict(phase="poisson", size=f"m={m} n={m ** 3}",
                laps=int(res.iterations),
                err=f"true rel residual {rel:.2e} (<= {POISSON_RTOL})",
                first_s=t_first, warm_s=t_warm)


def phase_dia(m: int) -> dict:
    import jax.numpy as jnp

    import tpucg
    from tpucg.solver.operators import DiaOperator

    csr, A64, b = _poisson_rhs(m)
    op = tpucg.best_sparse_operator(csr)
    check(isinstance(op, DiaOperator),
          f"best_sparse_operator chose {type(op).__name__}, want DIA")
    xv = np.random.default_rng(1).standard_normal(m ** 3).astype(np.float32)
    y = np.asarray(op.matvec(jnp.asarray(xv)))
    y_ref = A64 @ xv.astype(np.float64)
    e_mv = _rel(y, y_ref)
    check(e_mv <= MATVEC_TOL, f"DIA matvec rel err {e_mv:.2e}")
    tol = POISSON_RTOL * float(np.linalg.norm(b))
    res, t_first, t_warm, _ = _timed(
        lambda: tpucg.cg_solve(op, b, tol=tol, maxiter=4 * m ** 2)
    )
    rel = _true_rel_residual(A64, res.x, b)
    check(bool(res.converged), f"DIA m={m} did not converge")
    check(rel <= POISSON_RTOL, f"DIA true rel residual {rel:.2e}")
    return dict(phase="dia", size=f"m={m} n={m ** 3} ndiag={op.ndiag}",
                laps=int(res.iterations),
                err=f"matvec rel err {e_mv:.2e}; true rel residual "
                    f"{rel:.2e} (<= {POISSON_RTOL})",
                first_s=t_first, warm_s=t_warm)


def _f64_jacobi_cg(csr, b, rtol: float, maxiter: int):
    """Jacobi-preconditioned CG in float64 on the device, with a segment-sum
    CSR matvec: the plain reference for the FEM phases, sharing no code with
    tpucg. Stops when ||r|| <= rtol ||b||. Returns (x, laps) on the host."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = csr.shape[0]
    rows_h = np.repeat(np.arange(n, dtype=np.int32), np.diff(csr.indptr))
    cols_h = np.asarray(csr.indices, np.int32)
    vals_h = np.asarray(csr.data, np.float64)
    diag = np.zeros(n)
    on = rows_h == cols_h
    np.add.at(diag, rows_h[on], vals_h[on])
    b64 = np.asarray(b, np.float64)
    tol2 = float(rtol * np.linalg.norm(b64)) ** 2
    with jax.enable_x64(True):
        rows, cols = jnp.asarray(rows_h), jnp.asarray(cols_h)
        vals, dinv = jnp.asarray(vals_h), jnp.asarray(1.0 / diag)

        def mv(v):
            return jax.ops.segment_sum(vals * v[cols], rows, num_segments=n,
                                       indices_are_sorted=True)

        def body(s):
            x, r, p, rz, k, _ = s
            q = mv(p)
            a = rz / jnp.vdot(p, q)
            x, r = x + a * p, r - a * q
            z = dinv * r
            rz_new = jnp.vdot(r, z)
            return x, r, z + (rz_new / rz) * p, rz_new, k + 1, jnp.vdot(r, r)

        @jax.jit
        def solve(bb):
            z = dinv * bb
            init = (jnp.zeros_like(bb), bb, z, jnp.vdot(bb, z), 0,
                    jnp.vdot(bb, bb))
            s = lax.while_loop(lambda s: (s[5] > tol2) & (s[4] < maxiter),
                               body, init)
            return s[0], s[4]

        x, k = jax.block_until_ready(solve(jnp.asarray(b64)))
        return np.asarray(x), int(k)


def _fem_reference(A, A64, b) -> dict:
    """x* from the float64 reference, its true residual, and rho: the true
    relative residual of x* rounded to float32."""
    t0 = time.perf_counter()
    x_ref, k = _f64_jacobi_cg(A, b, FEM_REF_RTOL, FEM_REF_MAXITER)
    wall = time.perf_counter() - t0
    rel = _true_rel_residual(A64, x_ref, b)
    check(k < FEM_REF_MAXITER, "FEM f64 reference ran to maxiter")
    check(rel <= FEM_RTOL, f"FEM f64 reference: true rel residual {rel:.2e}")
    rho = _true_rel_residual(A64, x_ref.astype(np.float32), b)
    return dict(x=x_ref, laps=k, rel=rel, rho=rho, wall=wall)


def _check_fem(name: str, x, k: int, A64, b, ref: dict) -> str:
    """The FEM checks against the float64 reference; returns their text."""
    x = np.asarray(x, np.float64)
    check(bool(np.all(np.isfinite(x))), f"{name}: non-finite x")
    err = float(np.linalg.norm(x - ref["x"]) / np.linalg.norm(ref["x"]))
    rel = _true_rel_residual(A64, x, b)
    limit = FEM_RTOL + FEM_FLOOR_FACTOR * ref["rho"] * np.sqrt(k)
    check(err <= FEM_XTOL, f"{name}: x rel err {err:.2e} vs f64 > {FEM_XTOL}")
    check(rel <= limit, f"{name}: true rel residual {rel:.2e} > {limit:.2e}")
    return (f"x rel err {err:.2e} vs f64 reference (<= {FEM_XTOL}); true "
            f"rel residual {rel:.2e} (<= {limit:.2e} = tol + "
            f"{FEM_FLOOR_FACTOR:g} rho sqrt(laps), rho {ref['rho']:.2e}; "
            f"= {rel / (ref['rho'] * np.sqrt(k)):.2f} rho sqrt(laps))")


def phase_irregular(n_points: int, agg_size: int = 256) -> list:
    import tpucg
    from tpucg.io.generator import fem_p1_system
    from tpucg.solver.operators import WellOperator

    A, b, _ = fem_p1_system(n_points, seed=0)
    A64 = _scipy_csr(A)
    op = tpucg.best_sparse_operator(A)
    check(isinstance(op, WellOperator),
          f"best_sparse_operator chose {type(op).__name__}, want WELL")
    n = A.shape[0]
    xv = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    xp = np.zeros(op.padded_n, np.float32)
    xp[:n] = xv
    y = np.asarray(op.matvec(xp))[:n]
    e_mv = _rel(y, A64 @ xv.astype(np.float64))
    check(e_mv <= MATVEC_TOL, f"WELL matvec rel err {e_mv:.2e}")
    ref = _fem_reference(A, A64, b)
    rows = [dict(
        phase="irregular f64 reference", size=f"n={n} nnz={A.nnz}",
        laps=ref["laps"],
        err=f"WELL matvec rel err {e_mv:.2e} (<= {MATVEC_TOL}); reference "
            f"true rel residual {ref['rel']:.2e} (<= {FEM_RTOL}); rho "
            f"{ref['rho']:.2e}; wall {ref['wall']:.3f} s (compile incl.)")]
    tol = FEM_RTOL * float(np.linalg.norm(b))
    maxiter = 8 * int(np.sqrt(n)) + 1000
    tl = tpucg.build_two_level(A, agg_size=agg_size, npad=op.padded_n)
    arms = (
        ("jacobi", dict(precondition="jacobi")),
        (f"two_level({agg_size})", dict(two_level=tl)),
    )
    for name, kw in arms:
        res, t_first, t_warm, first = _timed(
            lambda: tpucg.cg_solve(op, b, tol=tol, maxiter=maxiter, **kw)
        )
        k, k_first = int(res.iterations), int(first.iterations)
        check(k < maxiter, f"FEM {name} ran to maxiter {maxiter}")
        text = _check_fem(f"FEM {name}", res.x, k, A64, b, ref)
        stop = ("converged" if bool(res.converged)
                else "stagnation stop at the f32 floor")
        rows.append(dict(
            phase=f"irregular {name}", size=f"n={n} nnz={A.nnz}",
            laps=f"{k} (first run {k_first})", err=f"{text}; {stop}",
            first_s=t_first, warm_s=t_warm))
    return rows


def phase_batch(nsys: int, n: int) -> dict:
    import tpucg
    from tpucg.solver.oracle import oracle_cg

    systems = [tpucg.generate_spd_system(n, seed=i) for i in range(nsys)]
    As = np.stack([s[0] for s in systems]).astype(np.float32)
    bs = np.stack([s[1] for s in systems]).astype(np.float32)
    res, t_first, t_warm, _ = _timed(lambda: tpucg.cg_solve_batch(As, bs))
    xs = np.asarray(res.x)
    ks = np.asarray(res.iterations)
    check(bool(np.all(np.asarray(res.converged))), "batch: not all converged")
    worst = 0.0
    for i, (A, b, x0) in enumerate(systems):
        x_ref, k_ref, _ = oracle_cg(A, b, x0, dtype=np.float64)
        check(abs(int(ks[i]) - k_ref) <= 1,
              f"batch system {i}: {int(ks[i])} laps, oracle {k_ref}")
        worst = max(worst, _rel(xs[i], x_ref))
    check(worst <= DENSE_XTOL["float32"], f"batch: x rel err {worst:.2e}")
    return dict(phase="batch", size=f"{nsys} x n={n}",
                laps=f"{int(ks.min())}-{int(ks.max())}",
                err=f"max x rel err {worst:.2e} vs per-system f64 oracle",
                first_s=t_first, warm_s=t_warm)


def _spans(x, ndev: int) -> int:
    nd = len(x.sharding.device_set)
    check(nd == ndev, f"result spans {nd} devices, want {ndev}")
    return nd


def phase_multi(n_dense: int, m: int, n_fem: int, ndev: int = 4) -> list:
    """The sharded entry points over ``ndev`` devices, each against the
    one-device solve in this process and the plain reference."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    import tpucg
    from tpucg.io.generator import fem_p1_system
    from tpucg.solver.operators import PoissonOperator
    from tpucg.solver.oracle import oracle_cg
    from tpucg.solver.sharded import (
        _prepare_sharded_operator,
        _sharded_operator_matvec_jit,
    )

    mesh1 = tpucg.make_mesh(ndev)
    rows = []

    A, b, x0 = tpucg.generate_spd_system(n_dense, seed=0)
    x_ref, k_ref, _ = oracle_cg(A, b, x0, dtype=np.float64)
    one = tpucg.cg_solve(A, b, x0)
    k1 = int(one.iterations)
    meshes = (("allgather", mesh1), ("overlap", mesh1),
              ("2d", tpucg.make_mesh2d(2, ndev // 2)))
    for name, mesh in meshes:
        kw = {} if name == "2d" else dict(strategy=name)
        res, t_first, t_warm, _ = _timed(
            lambda: tpucg.sharded_cg_solve(A, b, x0, mesh=mesh, **kw)
        )
        nd = _spans(res.x, ndev)
        k = int(res.iterations)
        e = _rel(res.x, x_ref)
        check(bool(res.converged), f"sharded dense {name} did not converge")
        check(abs(k - k1) <= LAP_SLACK, f"sharded dense {name}: {k} laps, "
              f"one-card {k1}")
        check(abs(k - k_ref) <= 1, f"sharded dense {name}: oracle {k_ref}")
        check(e <= DENSE_XTOL["float32"],
              f"sharded dense {name}: x rel err {e:.2e}")
        rows.append(dict(
            phase=f"sharded dense {name}", size=f"n={n_dense} on {nd} "
            "devices", laps=k,
            err=f"x rel err {e:.2e} vs f64 oracle; one-card {k1} laps",
            first_s=t_first, warm_s=t_warm))

    _, A64, bp = _poisson_rhs(m)
    tol = POISSON_RTOL * float(np.linalg.norm(bp))
    op = PoissonOperator(m=m)
    one = tpucg.cg_solve(op, bp, tol=tol, maxiter=4 * m ** 2)
    res, t_first, t_warm, _ = _timed(lambda: tpucg.sharded_operator_cg_solve(
        op, bp, mesh=mesh1, tol=tol, maxiter=4 * m ** 2))
    nd = _spans(res.x, ndev)
    rel = _true_rel_residual(A64, np.asarray(res.x)[: m ** 3], bp)
    k, k1 = int(res.iterations), int(one.iterations)
    check(bool(res.converged), "sharded Poisson did not converge")
    check(abs(k - k1) <= LAP_SLACK, f"sharded Poisson: {k} laps, one-card "
          f"{k1}")
    check(rel <= POISSON_RTOL, f"sharded Poisson true rel residual {rel:.2e}")
    rows.append(dict(
        phase="sharded poisson slab halo", size=f"m={m} on {nd} devices",
        laps=k, err=f"true rel residual {rel:.2e}; one-card {k1} laps",
        first_s=t_first, warm_s=t_warm))

    Af, bf, _ = fem_p1_system(n_fem, seed=0)
    A64 = _scipy_csr(Af)
    n = Af.shape[0]
    # The row-sharded WELL matvec against the one-card product and scipy's.
    op1 = tpucg.best_sparse_operator(Af)
    arrays, statics, _, npad, _ = _prepare_sharded_operator(
        Af, mesh1, tpucg.CGConfig())
    axis = mesh1.axis_names[0]
    xv = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    xp = np.zeros(max(npad, op1.padded_n), np.float32)
    xp[:n] = xv
    ysh = _sharded_operator_matvec_jit(
        arrays, jax.device_put(xp[:npad], NamedSharding(
            mesh1, PartitionSpec(axis))), mesh=mesh1, axis=axis, **statics)
    _spans(ysh, ndev)
    ysh = np.asarray(ysh)[:n]
    e_one = _rel(ysh, np.asarray(op1.matvec(xp[:op1.padded_n]))[:n])
    e_mv = _rel(ysh, A64 @ xv.astype(np.float64))
    check(e_one <= MATVEC_TOL, f"sharded WELL matvec vs one card {e_one:.2e}")
    check(e_mv <= MATVEC_TOL, f"sharded WELL matvec vs scipy {e_mv:.2e}")
    ref = _fem_reference(Af, A64, bf)
    tol = FEM_RTOL * float(np.linalg.norm(bf))
    maxiter = 8 * int(np.sqrt(n)) + 1000
    one = tpucg.cg_solve(op1, bf, tol=tol, maxiter=maxiter,
                         precondition="jacobi")
    res, t_first, t_warm, _ = _timed(lambda: tpucg.sharded_operator_cg_solve(
        Af, bf, mesh=mesh1, tol=tol, maxiter=maxiter,
        precondition="jacobi"))
    nd = _spans(res.x, ndev)
    k, k1 = int(res.iterations), int(one.iterations)
    check(k < maxiter, "sharded FEM ran to maxiter")
    text = _check_fem("sharded FEM", np.asarray(res.x)[:n], k, A64, bf, ref)
    # Jacobi laps on an f32-floor-bound system shift with summation order
    # and with the scatter-add's atomics (one card, two runs: 2239 and 2253
    # laps, PERF.md); the one-card comparison is the lap count to 5 %.
    check(abs(k - k1) <= max(LAP_SLACK, k1 // 20),
          f"sharded FEM: {k} laps, one-card {k1}")
    rows.append(dict(
        phase="sharded FEM WELL jacobi", size=f"n={n} on {nd} devices",
        laps=k, err=f"matvec rel err {e_one:.2e} vs one card, {e_mv:.2e} vs "
                    f"scipy; {text}; one-card {k1} laps; f64 reference "
                    f"{ref['laps']} laps",
        first_s=t_first, warm_s=t_warm))
    return rows


def _print_row(row: dict, label: str) -> None:
    t = ""
    if "first_s" in row:
        t = (f"; wall {row['first_s']:.3f} s first call (compile incl.), "
             f"{row['warm_s']:.3f} s warm [{label}]")
    print(f"[{row['phase']}] {row['size']}: laps {row['laps']}; "
          f"{row['err']}{t}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded solvers, on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform "
              f"{devices[0].platform!r}); nothing run", file=sys.stderr)
        return 1
    ndev = 4 if args.multi else 1
    if len(devices) < ndev:
        print(f"chip_smoke: --multi needs {ndev} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 1

    from tpucg.compile_cache import enable_compile_cache

    enable_compile_cache()
    label = card_label()
    print(f"platform {devices[0].platform}, device_kind "
          f"{devices[0].device_kind}, {len(devices)} device(s)")
    print(f"nvidia-smi: {label}")
    print(f"jax {jax.__version__}", flush=True)

    if args.multi:
        for row in phase_multi(8192, 128, 1_000_000, ndev):
            _print_row(row, label)
    else:
        _print_row(phase_goldens(), label)
        for storage in ("float32", "bfloat16"):
            _print_row(phase_dense(8192, storage), label)
        _print_row(phase_poisson(128), label)
        _print_row(phase_dia(128), label)
        for row in phase_irregular(1_000_000):
            _print_row(row, label)
        _print_row(phase_batch(256, 512), label)

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
