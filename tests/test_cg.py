"""Single-device jitted CG vs the oracle and golden systems."""

import numpy as np
import pytest

from tpucg import CGConfig, cg_solve
from tpucg.io.generator import generate_spd_system, poisson3d_csr
from tpucg.solver.operators import EllOperator, PoissonOperator
from tpucg.solver.oracle import oracle_cg


def test_golden_2x2(golden_2x2):
    g = golden_2x2
    res = cg_solve(g["A"], g["b"], g["x0"])
    np.testing.assert_allclose(np.asarray(res.x), g["x_star"], rtol=1e-6)
    assert int(res.iterations) == g["iters"]
    assert bool(res.converged)
    assert float(res.residual_norm) < 1e-6


def test_golden_4x4(golden_4x4):
    g = golden_4x4
    res = cg_solve(g["A"], g["b"], g["x0"])
    np.testing.assert_allclose(
        np.asarray(res.x), g["x_star"], rtol=1e-5, atol=1e-5
    )
    assert int(res.iterations) == g["iters"]
    assert bool(res.converged)


@pytest.mark.parametrize("n", [64, 200])
def test_matches_oracle_random_spd(n):
    A, b, x0 = generate_spd_system(n, seed=n)
    ox, oiters, _ = oracle_cg(A, b, x0)
    res = cg_solve(A, b, x0)
    # float32 reduction order differs (sequential C sum vs XLA tree sum);
    # the contract is same iteration count +/-1 and matching solution
    # (SURVEY.md §7 "bitwise-tolerance" definition).
    assert abs(int(res.iterations) - oiters) <= 1
    np.testing.assert_allclose(np.asarray(res.x), ox, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(A @ np.asarray(res.x), b, atol=1e-4)


def test_exact_initial_guess(golden_2x2):
    g = golden_2x2
    res = cg_solve(g["A"], g["b"], g["x_star"])
    assert int(res.iterations) == 0
    assert bool(res.converged)
    assert np.all(np.isfinite(np.asarray(res.x)))


def test_maxiter_cap(golden_4x4):
    g = golden_4x4
    res = cg_solve(g["A"], g["b"], g["x0"], config=CGConfig(maxiter=1))
    assert int(res.iterations) == 1
    assert not bool(res.converged)


def test_pallas_kernel_backend(golden_4x4):
    # kernel="pallas" is refused (no operator has a Pallas kernel);
    # kernel="xla" solves the 4x4 golden exactly, with no padding.
    g = golden_4x4
    with pytest.raises(ValueError, match="pallas"):
        cg_solve(g["A"], g["b"], g["x0"], kernel="pallas")
    res = cg_solve(g["A"], g["b"], g["x0"], config=CGConfig(kernel="xla"))
    np.testing.assert_allclose(
        np.asarray(res.x), g["x_star"], rtol=1e-5, atol=1e-5
    )
    assert int(res.iterations) == g["iters"]
    assert res.x.shape == (4,)


def test_ell_operator_poisson():
    csr = poisson3d_csr(5)  # n = 125
    op = EllOperator.from_csr(csr)
    rng = np.random.default_rng(0)
    b = rng.random(op.n).astype(np.float32)
    res = cg_solve(op, b)
    A = csr.to_dense()
    ox, oiters, _ = oracle_cg(A, b, np.zeros(op.n, np.float32))
    np.testing.assert_allclose(np.asarray(res.x), ox, rtol=1e-3, atol=1e-4)
    assert abs(int(res.iterations) - oiters) <= 1


def test_poisson_matrix_free_matches_csr():
    m = 5
    csr = poisson3d_csr(m)
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(1)
    x = rng.random(m**3).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op.matvec(x)), csr.matvec(x), rtol=1e-5, atol=1e-5
    )
    b = rng.random(m**3).astype(np.float32)
    res = cg_solve(op, b)
    ox, _, _ = oracle_cg(csr.to_dense(), b, np.zeros(m**3, np.float32))
    np.testing.assert_allclose(np.asarray(res.x), ox, rtol=1e-3, atol=1e-4)


def test_residual_history():
    import numpy as np

    import tpucg

    n = 64
    A, b, x0 = tpucg.generate_spd_system(n, seed=6)
    res = tpucg.cg_solve(A, b, x0, record_residuals=True)
    hist = np.asarray(res.residual_history)
    k = int(res.iterations)
    assert hist.shape == (n + 1,)
    # entry 0 = ||r0||, entry k = final residual, NaN beyond.
    assert abs(hist[0] - np.linalg.norm(b - A @ x0)) < 1e-4 * hist[0]
    assert abs(hist[k] - float(res.residual_norm)) < 1e-9
    assert np.all(np.isnan(hist[k + 1:]))
    assert np.all(np.diff(np.log(hist[: k + 1])) < 0)  # monotone decrease here

    plain = tpucg.cg_solve(A, b, x0)
    assert plain.residual_history is None
    np.testing.assert_array_equal(np.asarray(plain.x), np.asarray(res.x))


def test_spectral_interval_estimates():
    # Public two-sided spectrum estimate: on a known-spectrum matrix the
    # bounds must bracket-ish the truth (finite-iteration estimates:
    # lam_hi slightly under, lam_lo slightly over).
    import numpy as np

    n = 128
    rng = np.random.default_rng(0)
    w = np.linspace(0.5, 20.0, n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((Q * w) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    from tpucg import spectral_interval

    lo, hi, kappa = spectral_interval(A)
    assert 0.8 * 20.0 <= hi <= 1.05 * 20.0
    assert 0.5 * 0.95 <= lo <= 3.0 * 0.5
    assert 0.2 * 40.0 <= kappa <= 2.0 * 40.0
