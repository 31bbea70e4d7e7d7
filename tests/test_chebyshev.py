"""Chebyshev-iteration tests (``method="chebyshev"``).

Chebyshev iteration is the terminal point of tpucg's reduction-cadence
spectrum (the collective extension of the reference's collective-vs-p2p
thesis, ``parallel_cg.c:287-313``): classic CG pays 2-3 scalar reductions
per lap, pipelined 1, CA-CG 2 per s laps — Chebyshev pays ZERO per lap
(every scalar comes from the spectral-interval recurrence), plus one exact
residual check per ``check_every`` laps. The price is a fixed,
non-minimizing rate: iteration counts are >= CG's and round up to the check
cadence. Convergence is always verified on the exact f32 r.r (the
reference's true-residual contract point, ``serialConjugate.c:235``)."""

import numpy as np
import pytest

import tpucg
from tpucg.config import CGConfig
from tpucg.comm.mesh import make_mesh2d
from tpucg.solver.oracle import oracle_cg
from tpucg.solver.operators import PoissonOperator
from tpucg.solver.sharded import sharded_operator_cg_solve


def test_chebyshev_golden(golden_2x2, golden_4x4):
    for g in (golden_2x2, golden_4x4):
        n = g["A"].shape[0]
        r = tpucg.cg_solve(
            g["A"], g["b"], g["x0"], method="chebyshev", maxiter=256
        )
        assert bool(r.converged)
        # True-residual guarantee at the absolute 1e-6 contract tolerance.
        resid = np.linalg.norm(
            np.asarray(g["b"]) - np.asarray(g["A"]) @ np.asarray(r.x)
        )
        assert resid < 2e-6
        np.testing.assert_allclose(np.asarray(r.x), g["x_star"], atol=2e-3)


def test_chebyshev_clustered_spectrum():
    # The reference generator family (A ~ n*I + noise) has a tight spectral
    # interval — exactly where a fixed-rate interval method shines.
    A, b, x0 = tpucg.generate_spd_system(128, seed=0)
    ref = tpucg.cg_solve(A, b, x0)
    ch = tpucg.cg_solve(A, b, x0, method="chebyshev", maxiter=512)
    assert bool(ch.converged)
    np.testing.assert_allclose(
        np.asarray(ch.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5
    )
    # Honest reporting: residual_norm is the exact chunk-end ||r||.
    resid = np.linalg.norm(np.asarray(b) - np.asarray(A) @ np.asarray(ch.x))
    assert abs(float(ch.residual_norm) - resid) < 5e-6 + 0.5 * resid


def test_chebyshev_poisson_needs_more_laps_than_cg():
    # Spread spectrum: Chebyshev converges at the fixed sqrt(a/b) rate with
    # no CG superlinearity — documented cost, verified here.
    m = 8
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(np.asarray(x_true, np.float32)))
    tol = 1e-5 * float(np.linalg.norm(b))
    cg = tpucg.cg_solve(op, b, tol=tol, maxiter=8 * m ** 3)
    ch = tpucg.cg_solve(
        op, b, tol=tol, maxiter=8 * m ** 3, method="chebyshev"
    )
    assert bool(ch.converged)
    assert int(ch.iterations) >= int(cg.iterations)
    np.testing.assert_allclose(np.asarray(ch.x), x_true, atol=1e-3)


def test_chebyshev_check_cadence_and_cap():
    A, b, x0 = tpucg.generate_spd_system(96, seed=4)
    # Iteration counts round UP to the check cadence.
    r = tpucg.cg_solve(A, b, x0, method="chebyshev", check_every=8,
                       maxiter=512)
    assert bool(r.converged)
    assert int(r.iterations) % 8 == 0
    # check_every=1 observes convergence every lap.
    r1 = tpucg.cg_solve(A, b, x0, method="chebyshev", check_every=1,
                        maxiter=512)
    assert bool(r1.converged)
    assert int(r1.iterations) <= int(r.iterations)
    # The cap gates mid-chunk laps: k never exceeds maxiter.
    cap = tpucg.cg_solve(A, b, x0, method="chebyshev", check_every=8,
                         maxiter=3, tol=1e-30)
    assert int(cap.iterations) == 3
    assert not bool(cap.converged)


@pytest.mark.parametrize("pc,kw", [
    ("jacobi", {}),
    ("poly", {"poly_degree": 2}),
])
def test_chebyshev_preconditioned(pc, kw):
    # Preconditioned Chebyshev iterates on M^-1 A (interval estimated on
    # the preconditioned operator); laps stay reduction-free. Jacobi gets a
    # badly diagonally scaled system (the failure it fixes); poly a 1-D
    # Laplacian.
    n = 256
    if pc == "jacobi":
        rng = np.random.default_rng(7)
        A, b, _ = tpucg.generate_spd_system(n, seed=7)
        d = np.exp(rng.uniform(0.0, np.log(30.0), n)).astype(np.float32)
        A = (np.asarray(A) * d[:, None] * d[None, :]).astype(np.float32)
        b = np.asarray(b, np.float32)
    else:
        A = (
            2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
        ).astype(np.float32)
        b = np.cos(np.arange(n) * 0.3).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    maxiter = 64 * n
    plain = tpucg.cg_solve(A, b, method="chebyshev", tol=tol,
                           maxiter=maxiter)
    pcd = tpucg.cg_solve(A, b, method="chebyshev", precondition=pc,
                         tol=tol, maxiter=maxiter, **kw)
    assert bool(pcd.converged)
    # The preconditioner must cut laps (or at worst match, if the plain
    # interval guard got lucky).
    if bool(plain.converged):
        assert int(pcd.iterations) <= int(plain.iterations)
    resid = np.linalg.norm(b - A @ np.asarray(pcd.x))
    assert resid < 5 * tol


def test_chebyshev_bad_interval_guard_recovers():
    # power_iters=1 gives a garbage interval; the chunk-boundary guard
    # (non-decreasing exact residual -> widen interval, restart direction)
    # must still converge the solve instead of diverging.
    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla
    from tpucg.solver.cg import chebyshev_loop

    n = 128
    A, b, x0 = tpucg.generate_spd_system(n, seed=3)
    Aj = jnp.asarray(np.asarray(A, np.float32))
    mv = lambda v: jnp.dot(Aj, v, precision="highest")
    st = chebyshev_loop(
        mv, dot_xla, jnp.asarray(np.asarray(b, np.float32)),
        jnp.zeros(n, jnp.float32),
        tol=1e-5 * float(np.linalg.norm(b)), maxiter=4096,
        check_every=4, power_iters=1,
    )
    assert bool(st.done)
    resid = np.linalg.norm(b - np.asarray(A) @ np.asarray(st.x))
    assert resid < 5e-5 * float(np.linalg.norm(b))


def test_chebyshev_scalar_identity_operator():
    # A = c*I: zero-width spectrum — the estimates collapse to a point and
    # the scalars must stay finite (the safety pads then open a deliberate
    # [0.75c, 1.05c] interval, so this converges in a few Richardson-like
    # laps rather than one).
    n = 32
    A = (3.0 * np.eye(n)).astype(np.float32)
    b = np.linspace(1, 2, n).astype(np.float32)
    r = tpucg.cg_solve(A, b, method="chebyshev", check_every=1, maxiter=64)
    assert bool(r.converged)
    assert int(r.iterations) <= 16
    np.testing.assert_allclose(np.asarray(r.x), b / 3.0, rtol=1e-5)


def test_chebyshev_sharded_both_strategies():
    n = 192
    A, b, x0 = tpucg.generate_spd_system(n, seed=2)
    tol = 1e-5 * float(np.linalg.norm(b))
    x_ref, _, _ = oracle_cg(A, b, x0, tol=tol)
    for strategy in ("allgather", "overlap"):
        r = tpucg.sharded_cg_solve(
            A, b, x0, method="chebyshev", strategy=strategy, tol=tol,
            maxiter=8 * n,
        )
        assert bool(r.converged), strategy
        np.testing.assert_allclose(
            np.asarray(r.x), x_ref, rtol=1e-3, atol=1e-4
        )


def test_chebyshev_sharded_padded_uneven_2d():
    # Identity-tail padding must not poison the interval estimate (the pad
    # block contributes eigenvalue 1); 2-D SUMMA mesh + uneven n.
    n = 67
    A, b, x0 = tpucg.generate_spd_system(n, seed=3)
    x_ref, _, _ = oracle_cg(A, b, x0)
    r = tpucg.sharded_cg_solve(A, b, x0, method="chebyshev", maxiter=8 * n)
    assert bool(r.converged)
    assert np.asarray(r.x).shape == (n,)
    np.testing.assert_allclose(np.asarray(r.x), x_ref, rtol=1e-3, atol=1e-4)
    n2 = 96
    A2, b2, x02 = tpucg.generate_spd_system(n2, seed=1)
    x_ref2, _, _ = oracle_cg(A2, b2, x02)
    r2 = tpucg.sharded_cg_solve(
        A2, b2, x02, mesh=make_mesh2d(2, 4), method="chebyshev",
        maxiter=8 * n2,
    )
    assert bool(r2.converged)
    np.testing.assert_allclose(
        np.asarray(r2.x), x_ref2, rtol=1e-3, atol=1e-4
    )


def test_chebyshev_operator_sharded():
    # Slab-halo Poisson and band-halo DIA arms: the per-lap communication is
    # the matvec's ONLY (zero scalar psums between checks).
    from tpucg.io.generator import poisson3d_dia

    m = 8
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(np.asarray(x_true, np.float32)))
    tol = 1e-5 * float(np.linalg.norm(b))
    sh = sharded_operator_cg_solve(
        op, b, tol=tol, maxiter=8 * m ** 3, method="chebyshev"
    )
    assert bool(sh.converged)
    np.testing.assert_allclose(np.asarray(sh.x), x_true, atol=1e-3)

    m2 = 6
    dia = poisson3d_dia(m2)
    n = m2 ** 3
    x_true2 = rng.standard_normal(n).astype(np.float32)
    b2 = dia.matvec(x_true2).astype(np.float32)
    tol2 = 1e-5 * float(np.linalg.norm(b2))
    sh2 = sharded_operator_cg_solve(
        dia, b2, tol=tol2, maxiter=8 * n, method="chebyshev"
    )
    assert bool(sh2.converged)
    np.testing.assert_allclose(np.asarray(sh2.x), x_true2, atol=1e-3)


def test_chebyshev_config_validation():
    with pytest.raises(ValueError, match="check_every"):
        CGConfig(check_every=0)
    A, b, x0 = tpucg.generate_spd_system(32, seed=0)
    with pytest.raises(ValueError, match="record_residuals"):
        tpucg.cg_solve(A, b, x0, method="chebyshev", record_residuals=True)


@pytest.mark.parametrize("power_iters", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_chebyshev_guard_fuzz(power_iters, seed):
    # Guard robustness: deliberately starved interval estimates across
    # random spectra must still converge via the widen-and-restart path.
    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla
    from tpucg.solver.cg import chebyshev_loop

    n = 96
    rng = np.random.default_rng(seed)
    # Log-spread eigenvalues over ~3 decades with a random orthogonal basis.
    w = np.exp(rng.uniform(np.log(1e-2), np.log(10.0), n))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * w) @ Q.T
    A = 0.5 * (A + A.T)
    b = rng.standard_normal(n).astype(np.float32)
    Aj = jnp.asarray(A.astype(np.float32))
    tol = 1e-4 * float(np.linalg.norm(b))
    st = chebyshev_loop(
        lambda v: jnp.dot(Aj, v, precision="highest"), dot_xla,
        jnp.asarray(b), jnp.zeros(n, jnp.float32),
        tol=tol, maxiter=65536, check_every=4, power_iters=power_iters,
    )
    assert bool(st.done), (power_iters, seed, float(st.rslast))
    resid = np.linalg.norm(b - A @ np.asarray(st.x, np.float64))
    assert resid < 10 * tol
