"""Mixed-precision iterative refinement tests: bf16 inner solves must reach
the f32 TRUE-residual contract that a bf16-only solve cannot."""

import numpy as np
import pytest

import tpucg
from tpucg.solver.ir import cg_solve_ir


@pytest.fixture
def system():
    n = 128
    A, b, x0 = tpucg.generate_spd_system(n, seed=5)
    return A, b, x0


def test_ir_meets_f32_contract(system):
    A, b, x0 = system
    res = cg_solve_ir(A, b, x0)
    assert bool(res.converged)
    # TRUE residual against the f32 matrix honors the reference tolerance.
    r = b - A @ np.asarray(res.x)
    assert np.linalg.norm(r) < 1.2e-6  # f32 eval noise margin on 1e-6
    # And matches the plain f32 solution closely.
    ref = tpucg.cg_solve(A, b, x0)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-6
    )


def test_ir_beats_raw_bf16_accuracy(system):
    A, b, x0 = system
    from tpucg.solver.operators import DenseOperator
    import jax.numpy as jnp

    op16 = DenseOperator.create(A, dtype=jnp.bfloat16)
    raw = tpucg.cg_solve(op16, b, x0, tol=1e-6, maxiter=4 * A.shape[0])
    raw_true = np.linalg.norm(b - A @ np.asarray(raw.x))
    ir = cg_solve_ir(A, b, x0)
    ir_true = np.linalg.norm(b - A @ np.asarray(ir.x))
    # bf16-only cannot reach the true-f32 tolerance; IR can.
    assert ir_true < 1.2e-6 < raw_true


def test_ir_iteration_accounting(system):
    A, b, x0 = system
    res = cg_solve_ir(A, b, x0)
    # Total inner laps: a few rounds of a handful of laps each.
    assert 2 <= int(res.iterations) <= 64


def test_ir_validation(system):
    A, b, x0 = system
    with pytest.raises(ValueError, match="cg_solve_ir"):
        cg_solve_ir(A, b, x0, method="pipelined")
    with pytest.raises(ValueError, match="cg_solve_ir"):
        cg_solve_ir(A, b, x0, precondition="jacobi")


def test_sharded_ir_matches_serial_ir():
    """Distributed mixed-precision IR over the 8-device mesh: same f32
    true-residual contract, agreeing with the serial IR and the plain f32
    sharded solve."""
    import tpucg

    n = 96
    A, b, x0 = tpucg.generate_spd_system(n, seed=4)
    A = (A - (n - n / 32.0) * np.eye(n)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve_ir(A, b, x0, tol=tol)
    sh = tpucg.sharded_cg_solve_ir(A, b, x0, tol=tol)
    assert bool(sh.converged)
    assert float(sh.residual_norm) < tol
    # Independent host-side check of the TRUE f32 residual contract (the x
    # iterates of two converged solves differ by O(tol * kappa); comparing
    # residuals is the meaningful equivalence).
    r_host = b - A @ np.asarray(sh.x)
    assert float(np.linalg.norm(r_host)) < 2 * tol
    # Inner-lap counts in the same ballpark as the serial IR (reduction
    # order shifts the trajectory slightly).
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 10


def test_sharded_ir_overlap_strategy_and_padding():
    import tpucg

    n = 50  # pads over 8 shards
    A, b, x0 = tpucg.generate_spd_system(n, seed=6)
    tol = 1e-5 * float(np.linalg.norm(b))
    sh = tpucg.sharded_cg_solve_ir(A, b, x0, tol=tol, strategy="overlap")
    assert bool(sh.converged)
    np.testing.assert_allclose(
        A @ np.asarray(sh.x), b, atol=2 * tol
    )
