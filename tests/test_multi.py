"""Multi-RHS block solve tests: k CG recurrences in lockstep under vmap,
one A @ P GEMM per lap (extension beyond the reference's single-RHS
programs)."""

import numpy as np
import pytest

import tpucg
from tpucg.solver.oracle import oracle_cg


def test_multi_matches_per_column_solves():
    n, k = 64, 5
    A, _, _ = tpucg.generate_spd_system(n, seed=0)
    rng = np.random.default_rng(1)
    B = rng.random((n, k)).astype(np.float32)
    res = tpucg.cg_solve_multi(A, B)
    assert res.x.shape == (n, k)
    assert res.iterations.shape == (k,)
    for j in range(k):
        x_ref, k_ref, _ = oracle_cg(A, B[:, j], np.zeros(n, np.float32))
        assert bool(res.converged[j])
        assert abs(int(res.iterations[j]) - k_ref) <= 1
        np.testing.assert_allclose(
            np.asarray(res.x[:, j]), x_ref, rtol=1e-4, atol=1e-6
        )


def test_multi_independent_convergence():
    # Lanes with very different difficulty converge to their own counts.
    n = 48
    A, _, _ = tpucg.generate_spd_system(n, seed=2)
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal((n, 2)).astype(np.float32)
    B = (A @ x_true).astype(np.float32)
    B[:, 1] *= 1e-3  # much smaller RHS: converges in fewer laps at abs tol
    res = tpucg.cg_solve_multi(A, B)
    assert bool(res.converged.all())
    assert int(res.iterations[1]) <= int(res.iterations[0])


def test_multi_padded_and_jacobi():
    n, k = 67, 3
    A, _, _ = tpucg.generate_spd_system(n, seed=4)
    rng = np.random.default_rng(5)
    B = rng.random((n, k)).astype(np.float32)
    res = tpucg.cg_solve_multi(A, B, precondition="jacobi")
    assert res.x.shape == (n, k)
    assert bool(res.converged.all())
    for j in range(k):
        resid = np.linalg.norm(B[:, j] - A @ np.asarray(res.x[:, j]))
        assert resid < 1e-5


def test_multi_rejects_pipelined_and_bad_shapes():
    A, b, _ = tpucg.generate_spd_system(16, seed=0)
    with pytest.raises(ValueError, match="method"):
        tpucg.cg_solve_multi(A, np.ones((16, 2)), method="pipelined")
    with pytest.raises(ValueError, match="shape"):
        tpucg.cg_solve_multi(A, b)  # 1-D B


def test_multi_with_sparse_operators():
    from tpucg.io.generator import poisson3d_csr
    from tpucg.solver.operators import EllOperator, PoissonOperator

    csr = poisson3d_csr(8)
    n = csr.shape[0]
    rng = np.random.default_rng(0)
    X_true = rng.standard_normal((n, 3)).astype(np.float32)
    B = np.stack([csr.matvec(X_true[:, j]) for j in range(3)], axis=1)
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    r = tpucg.cg_solve_multi(EllOperator.from_csr(csr), B, tol=tol,
                             maxiter=4 * n)
    assert bool(r.converged.all())
    np.testing.assert_allclose(np.asarray(r.x), X_true, atol=1e-2)
    # Matrix-free stencil too (under vmap at m=16 in
    # test_multi_poisson_stencil_vmap).
    r2 = tpucg.cg_solve_multi(PoissonOperator(m=8), B, tol=tol, maxiter=4 * n)
    assert bool(r2.converged.all())
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r.x),
                               rtol=1e-3, atol=1e-4)


def test_multi_poisson_stencil_vmap():
    # The stencil operator batched by vmap over two right-hand sides.
    from tpucg.solver.operators import PoissonOperator

    m, k = 16, 2
    op = PoissonOperator(m=m)
    n = m ** 3
    rng = np.random.default_rng(1)
    import jax.numpy as jnp

    X_true = rng.standard_normal((n, k)).astype(np.float32)
    B = np.asarray(
        np.stack(
            [np.asarray(op.matvec(jnp.asarray(X_true[:, j])))
             for j in range(k)],
            axis=1,
        )
    )
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    r = tpucg.cg_solve_multi(op, B, tol=tol, maxiter=4 * n)
    assert bool(r.converged.all())
    np.testing.assert_allclose(np.asarray(r.x), X_true, atol=1e-2)


def test_sharded_multi_matches_serial_multi():
    """Distributed multi-RHS: row-sharded A, batched all_gather + GEMM —
    lanes match the serial vmapped solver and the per-lane oracle."""
    import tpucg
    from tpucg.solver.oracle import oracle_cg

    n, k = 96, 5
    A, _, _ = tpucg.generate_spd_system(n, seed=21)
    rng = np.random.default_rng(2)
    B = rng.random((n, k)).astype(np.float32)
    ser = tpucg.cg_solve_multi(A, B)
    sh = tpucg.sharded_cg_solve_multi(A, B)
    assert sh.x.shape == (n, k)
    assert bool(np.all(np.asarray(sh.converged)))
    np.testing.assert_array_equal(
        np.asarray(sh.iterations), np.asarray(ser.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )
    for j in range(k):
        ox, oiters, _ = oracle_cg(A, B[:, j], np.zeros(n, np.float32))
        assert abs(int(sh.iterations[j]) - oiters) <= 1
        np.testing.assert_allclose(
            np.asarray(sh.x[:, j]), ox, rtol=1e-4, atol=1e-5
        )


def test_sharded_multi_non_divisible():
    import tpucg

    n, k = 50, 3  # pads to 64 over 8 shards
    A, _, _ = tpucg.generate_spd_system(n, seed=22)
    rng = np.random.default_rng(3)
    B = rng.random((n, k)).astype(np.float32)
    sh = tpucg.sharded_cg_solve_multi(A, B)
    assert sh.x.shape == (n, k)
    np.testing.assert_allclose(
        A @ np.asarray(sh.x), B, atol=1e-4 * float(np.linalg.norm(B))
    )
