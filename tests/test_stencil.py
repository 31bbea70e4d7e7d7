"""The matrix-free 3-D 7-point stencil (``PoissonOperator``) vs the CSR
oracle, on every grid size: the XLA concat form is the only stencil."""

import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.io.generator import poisson3d_csr
from tpucg.solver.operators import PoissonOperator


@pytest.mark.parametrize("m", [16, 32, 2, 8, 12, 24])
def test_stencil_matches_csr(m):
    # Grids of every shape class (tiny, lane-aligned planes, neither).
    csr = poisson3d_csr(m)
    rng = np.random.default_rng(m)
    u = rng.standard_normal(m ** 3).astype(np.float32)
    y = np.asarray(PoissonOperator(m=m).matvec(jnp.asarray(u)))
    np.testing.assert_allclose(y, csr.matvec(u), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [5, 16])
def test_stencil_matches_dia_operator(m):
    # The matrix-free stencil and the banded DIA operator of the same
    # Laplacian agree (both run in f32, sums in another order).
    from tpucg.io.generator import poisson3d_dia
    from tpucg.solver.operators import DiaOperator

    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal(m ** 3).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(PoissonOperator(m=m).matvec(u)),
        np.asarray(DiaOperator.from_dia(poisson3d_dia(m)).matvec(u)),
        rtol=1e-6, atol=1e-5,
    )


def test_stencil_operator_is_static_pytree():
    # The grid size is static metadata: no array leaves, and a jitted
    # matvec retraces only for a new m.
    import jax

    op = PoissonOperator(m=4)
    assert jax.tree_util.tree_leaves(op) == []
    f = jax.jit(lambda o, v: o.matvec(v))
    y = f(op, jnp.ones(64, jnp.float32))
    assert y.shape == (64,)
    assert f(PoissonOperator(m=3), jnp.ones(27, jnp.float32)).shape == (27,)


def test_stencil_diagonal_and_f64_dtype():
    import jax

    m = 6
    op = PoissonOperator(m=m)
    np.testing.assert_array_equal(np.asarray(op.diagonal()),
                                  np.full(m ** 3, 6.0, np.float32))
    with jax.enable_x64():
        u = np.random.default_rng(3).standard_normal(m ** 3)
        y = np.asarray(op.matvec(jnp.asarray(u, jnp.float64)))
        assert y.dtype == np.float64
        np.testing.assert_allclose(
            y, poisson3d_csr(m, dtype=np.float64).matvec(u), rtol=1e-12)


def test_cg_solve_with_stencil():
    m = 16
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(2)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(jnp.asarray(x_true)))
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=2e-3)
