"""The reference stopping contract on the jitted while_loop, for every
serial operator class and preconditioner.

``cg_solve`` runs one path: the jitted ``lax.while_loop`` of ``cg_loop``.
The contract (``serialConjugate.c:213-244``): test ``||r|| < tol`` after the
x/r update and before the p update, at most ``maxiter`` laps, an exact
initial guess converged at lap 0 (the reference would divide 0/0). Each
case runs over {dense, DIA, Poisson} x {none, jacobi, poly}."""

import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.io.generator import poisson3d_csr
from tpucg.solver.operators import DenseOperator, DiaOperator, PoissonOperator
from tpucg.solver.oracle import oracle_cg
from tpucg.sparse.formats import DIAMatrix

OPS = ["dense", "dia", "poisson"]
PCS = ["none", "jacobi", "poly"]


def _system(kind, seed=0):
    """(operator, dense float64 matrix) for a small SPD system that needs
    tens of laps."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        n = 96
        A, _, _ = tpucg.generate_spd_system(n, seed=seed)
        A = (A - (n - n / 8.0) * np.eye(n)).astype(np.float32)
        return DenseOperator.create(A), A.astype(np.float64)
    if kind == "dia":
        n, offs = 200, (-7, -1, 0, 1, 7)
        A = np.zeros((n, n))
        for off in offs[3:]:
            v = -rng.uniform(0.5, 1.0, n - off)
            A += np.diag(v, off) + np.diag(v, -off)
        A += np.diag(np.abs(A).sum(axis=1) + rng.uniform(0.05, 0.3, n)
                     * np.exp(rng.uniform(0.0, 2.0, n)))
        A = A.astype(np.float32)
        data = np.zeros((len(offs), n), np.float32)
        for d, off in enumerate(offs):
            i = np.arange(max(0, -off), min(n, n - off))
            data[d, i] = A[i, i + off]
        dia = DIAMatrix(data=data, offsets=offs, shape=(n, n))
        return DiaOperator.from_dia(dia), A.astype(np.float64)
    m = 6
    return PoissonOperator(m=m), poisson3d_csr(m).to_dense().astype(
        np.float64)


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("kind", OPS)
def test_preconditioned_parity(kind, pc):
    op, A64 = _system(kind)
    n = A64.shape[0]
    x_true = np.random.default_rng(1).standard_normal(n)
    b = (A64 @ x_true).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, precondition=pc)
    assert bool(r.converged)
    x = np.asarray(r.x, np.float64)
    assert np.linalg.norm(b - A64 @ x) < 2 * tol
    np.testing.assert_allclose(x, np.linalg.solve(A64, b), rtol=0,
                               atol=2e-3 * np.abs(x_true).max())
    if pc == "none":
        _, k_ref, _ = oracle_cg(A64, b, np.zeros(n), tol=tol,
                                maxiter=4 * n, dtype=np.float64)
        assert abs(int(r.iterations) - k_ref) <= 2


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("kind", OPS)
def test_maxiter_cap(kind, pc):
    op, A64 = _system(kind, seed=2)
    n = A64.shape[0]
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    r = tpucg.cg_solve(op, b, tol=1e-6, maxiter=3, precondition=pc)
    assert int(r.iterations) == 3
    assert not bool(r.converged)
    assert np.isfinite(float(r.residual_norm))
    assert float(r.residual_norm) > 1e-6


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("kind", OPS)
def test_exact_initial_guess(kind, pc):
    # x0 already solves the system: converged at lap 0, no 0/0 NaN.
    op, A64 = _system(kind, seed=4)
    n = A64.shape[0]
    x0 = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    b = (A64 @ x0.astype(np.float64)).astype(np.float32)
    r = tpucg.cg_solve(op, b, x0, tol=1e-4 * float(np.linalg.norm(b)),
                       maxiter=n, precondition=pc)
    assert int(r.iterations) == 0
    assert bool(r.converged)
    x = np.asarray(r.x)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x, x0)


@pytest.mark.parametrize("which", ["2x2", "4x4"])
@pytest.mark.parametrize("pc", PCS)
def test_golden_contract(pc, which, golden_2x2, golden_4x4):
    # The reference's shipped systems at tol 1e-6: exact lap counts (2 and
    # 4) unpreconditioned; every preconditioner recovers x* within n laps.
    g = golden_2x2 if which == "2x2" else golden_4x4
    n = g["A"].shape[0]
    r = tpucg.cg_solve(jnp.asarray(g["A"]), g["b"], g["x0"], tol=1e-6,
                       precondition=pc)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), g["x_star"], atol=1e-5)
    if pc == "none":
        assert int(r.iterations) == g["iters"]
    else:
        assert int(r.iterations) <= n
