"""Polynomial (truncated-Neumann) preconditioner tests.

A strong preconditioner made of matvecs: M^-1 = w * sum_{i<d} (I - wA)^i —
only extra matvecs and collectives, no triangular solves. SPD for
w*lambda_max < 1, which the in-jit power-method estimate guarantees with a
safety margin, so PCG's theory applies unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.solver.operators import PoissonOperator


@pytest.fixture(scope="module")
def poisson_system():
    # Poisson conditioning grows like (m/pi)^2: a real multi-iteration
    # workload where polynomial preconditioning visibly pays.
    m = 12
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(jnp.asarray(x_true)))
    tol = 1e-5 * float(np.linalg.norm(b))
    return op, b, x_true, tol


def test_poly_cuts_iterations(poisson_system):
    op, b, x_true, tol = poisson_system
    n = op.n
    plain = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    poly = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n,
                          precondition="poly", poly_degree=4)
    assert bool(poly.converged)
    # Degree-4 Neumann should cut the iteration count well below plain CG.
    assert int(poly.iterations) < int(plain.iterations)
    np.testing.assert_allclose(np.asarray(poly.x), x_true, atol=2e-3)


def test_poly_degree_one_is_scaled_richardson(poisson_system):
    # degree 1 => M^-1 = w*I: same Krylov space as plain CG (scaling
    # invariance), so identical iterates up to f32 noise.
    op, b, x_true, tol = poisson_system
    n = op.n
    plain = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    d1 = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n,
                        precondition="poly", poly_degree=1)
    assert abs(int(d1.iterations) - int(plain.iterations)) <= 1
    np.testing.assert_allclose(
        np.asarray(d1.x), np.asarray(plain.x), rtol=1e-3, atol=1e-4
    )


def test_poly_sharded_matches_serial():
    from tpucg.solver.sharded import sharded_operator_cg_solve

    m = 16  # divisible by the 8-device mesh
    op = PoissonOperator(m=m)
    n = op.n
    rng = np.random.default_rng(2)
    b = np.asarray(op.matvec(jnp.asarray(
        rng.standard_normal(n).astype(np.float32)
    )))
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n,
                         precondition="poly", poly_degree=4)
    sh = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * n,
                                   precondition="poly", poly_degree=4)
    assert bool(sh.converged)
    # The power-method seed is shard-local, so the polynomial's omega (and
    # hence the iterates) differ slightly between decompositions; both must
    # honor the same residual contract and land in the same ballpark.
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 2
    for r in (ser, sh):
        resid = np.linalg.norm(
            b - np.asarray(op.matvec(jnp.asarray(np.asarray(r.x))))
        )
        assert resid < 2 * tol


def test_poly_dense_sharded_and_2d():
    n = 96
    A, b, x0 = tpucg.generate_spd_system(n, seed=7)
    A = (A - (n - n / 10.0) * np.eye(n)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(A, b, x0, tol=tol, precondition="poly",
                         poly_degree=3, maxiter=10 * n)
    assert bool(ser.converged)
    sh = tpucg.sharded_cg_solve(A, b, x0, tol=tol, precondition="poly",
                                poly_degree=3, maxiter=10 * n)
    assert bool(sh.converged)
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 2
    from tpucg.comm.mesh import make_mesh2d

    sh2 = tpucg.sharded_cg_solve(A, b, x0, tol=tol, precondition="poly",
                                 poly_degree=3, maxiter=10 * n,
                                 mesh=make_mesh2d(2, 4))
    assert bool(sh2.converged)
    assert abs(int(sh2.iterations) - int(ser.iterations)) <= 2


def test_poly_with_pipelined_and_multi(poisson_system):
    op, b, x_true, tol = poisson_system
    n = op.n
    pipe = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, method="pipelined",
                          precondition="poly", poly_degree=4)
    assert bool(pipe.converged)
    np.testing.assert_allclose(np.asarray(pipe.x), x_true, atol=5e-3)
    B = np.stack([b, 2 * b], axis=1)
    multi = tpucg.cg_solve_multi(op, B, tol=2 * tol, maxiter=4 * n,
                                 precondition="poly", poly_degree=4)
    assert bool(multi.converged.all())


def test_poly_validation():
    with pytest.raises(ValueError, match="poly_degree"):
        tpucg.CGConfig(precondition="poly", poly_degree=0)
    A, b, x0 = tpucg.generate_spd_system(16, seed=0)
    with pytest.raises(ValueError, match="poly"):
        tpucg.cg_solve_checkpointed(A, b, x0, precondition="poly")
