"""dtype extensions: float64 solves (x64 mode) and bfloat16 matrix storage.

The reference contract is float32 end-to-end (``float``/``MPI_FLOAT``); these
are documented tpucg extensions — f64 for tighter tolerances, bf16 storage for
halved HBM traffic on the bandwidth-bound GEMV (accumulation stays f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.solver.operators import DenseOperator


def test_f64_requires_x64_mode():
    A, b, x0 = tpucg.generate_spd_system(16, seed=0)
    if jax.config.jax_enable_x64:
        pytest.skip("x64 already on")
    with pytest.raises(ValueError, match="x64"):
        tpucg.cg_solve(A, b, x0, dtype=jnp.float64)


def test_f64_solve_tighter_than_f32():
    A, b, x0 = tpucg.generate_spd_system(64, seed=3)
    with jax.enable_x64():
        r = tpucg.cg_solve(
            A.astype(np.float64), b.astype(np.float64), x0.astype(np.float64),
            dtype=jnp.float64, tol=1e-12,
        )
        assert bool(r.converged)
        assert r.x.dtype == jnp.float64
        x64 = np.asarray(r.x)
    resid = np.linalg.norm(b - A.astype(np.float64) @ x64)
    assert resid < 1e-10  # far beyond f32 reach


def test_bf16_storage_solves_perturbed_system():
    n = 128
    A, b, x0 = tpucg.generate_spd_system(n, seed=1)
    op = DenseOperator.create(A, dtype=jnp.bfloat16)
    assert op.A.dtype == jnp.bfloat16
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(op, b, x0, tol=tol, maxiter=4 * n)
    assert bool(r.converged)
    assert r.x.dtype == jnp.float32
    # Converges on the bf16-rounded system; vs the f32 system the solution
    # differs by O(bf16 eps * kappa) — still close for this well-conditioned
    # family.
    ref = tpucg.cg_solve(A, b, x0, tol=tol, maxiter=4 * n)
    scale = np.abs(np.asarray(ref.x)).max()
    np.testing.assert_allclose(
        np.asarray(r.x), np.asarray(ref.x), atol=2e-2 * scale
    )


def test_bf16_gemv_accumulates_f32():
    # The dense GEMV (XLA's dot) over bf16 storage accumulates in f32.
    from tpucg.kernels.matvec import matvec_xla

    n = 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    Abf = jnp.asarray(A, jnp.bfloat16)
    y = np.asarray(matvec_xla(Abf, jnp.asarray(x)))
    assert y.dtype == np.float32
    y_ref = np.asarray(Abf, np.float32) @ x  # f32 product of bf16-rounded A
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-4)


def test_bf16_solve_dtype_rejected():
    with pytest.raises(ValueError, match="solve dtype"):
        tpucg.CGConfig(dtype=jnp.bfloat16)


def test_f64_poisson_takes_xla_stencil():
    """The Pallas stencil is f32-only; f64 Poisson solves must route to the
    dtype-generic XLA form instead of crashing in the kernel."""
    from tpucg.solver.operators import PoissonOperator

    m = 16  # lane-tileable: would pick the Pallas kernel for f32
    op = PoissonOperator(m=m)
    with jax.enable_x64():
        u = jnp.ones(m ** 3, jnp.float64)
        y = op.matvec(u)
        assert y.dtype == jnp.float64
        ref = PoissonOperator(m=m).matvec(u)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(ref))
