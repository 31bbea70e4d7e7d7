"""Multi-RHS WELL: the vmapped batched matvec and the lockstep loop.

``WellOperator.matvec_multi`` is ``jax.vmap`` of the single-RHS WELL product
over the RHS axis; its columns must equal single-RHS applies bit for bit.
``multi_cg_loop`` is the matrix-form lockstep recurrence on top of it; its
per-column iterates must match ``cg_loop``'s exactly (reference stopping
contract per column: true residual after the x/r update,
``serialConjugate.c:213-220``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.io.generator import random_geometric_spd
from tpucg.solver.cg import _cg_multi_jit


@pytest.fixture(scope="module")
def geo():
    A, b, _ = random_geometric_spd(2000, seed=4, avg_degree=10.0)
    return A, b


def _rhs(npad, n, k, seed=0):
    rng = np.random.default_rng(seed)
    B = np.zeros((npad, k), np.float32)
    B[:n] = rng.standard_normal((n, k)).astype(np.float32)
    return jnp.asarray(B)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_matvec_multi_parity(geo, k):
    A, _ = geo
    op = tpucg.WellOperator.from_csr(A)
    X = _rhs(op.padded_n, A.shape[0], k, seed=1)
    Y = np.asarray(op.matvec_multi(X))
    Yref = np.stack(
        [np.asarray(op.matvec(X[:, j])) for j in range(k)], axis=1
    )
    np.testing.assert_array_equal(Y, Yref)


def test_matvec_multi_parity_bf16(geo):
    A, _ = geo
    op = tpucg.WellOperator.from_csr(
        A, storage_dtype=jnp.bfloat16
    )
    X = _rhs(op.padded_n, A.shape[0], 4, seed=2)
    Y = np.asarray(op.matvec_multi(X))
    Yref = np.stack(
        [np.asarray(op.matvec(X[:, j])) for j in range(4)], axis=1
    )
    np.testing.assert_array_equal(Y, Yref)


@pytest.mark.parametrize("precondition", ["none", "jacobi", "block_jacobi"])
def test_multi_well_matches_singles(geo, precondition):
    """The matrix-form lockstep (multi_cg_loop via matvec_multi) must
    reproduce k independent single-vector solves on the SAME operator:
    per-column lap counts within one lap (reduction-order f32 drift),
    solutions to solver tolerance."""
    A, b = geo
    n, k = A.shape[0], 5
    pc_bs = 64
    op = tpucg.WellOperator.from_csr(
        A, pc_block_size=pc_bs if precondition == "block_jacobi" else None
    )
    npad = op.padded_n
    B = _rhs(npad, n, k, seed=3)
    X0 = jnp.zeros_like(B)
    tol = 1e-5 * float(np.linalg.norm(np.asarray(B[:n, 0])))
    minv = None
    if precondition == "jacobi":
        d = op.diagonal()
        minv = jnp.where(d != 0, 1.0 / d, 1.0)
    elif precondition == "block_jacobi":
        from tpucg.solver.cg import block_jacobi_minv

        minv = block_jacobi_minv(op, pc_bs)
    res = _cg_multi_jit(op, B, X0, minv, tol, 4 * n, True)
    assert bool(np.all(np.asarray(res.converged)))
    for j in range(k):
        single = tpucg.cg_solve(
            op, B[:n, j], tol=tol, maxiter=4 * n,
            precondition=precondition, pc_block_size=pc_bs,
        )
        assert bool(single.converged)
        assert abs(int(np.asarray(res.iterations)[j])
                   - int(single.iterations)) <= 1
        np.testing.assert_allclose(
            np.asarray(res.x)[:n, j], np.asarray(single.x)[:n],
            rtol=2e-3, atol=2e-4,
        )


def test_multi_well_column_tail_freezes(geo):
    """Columns that converge early must freeze (bit-identical x) while the
    slow columns keep iterating — the explicit where-mask analog of the
    vmapped while_loop's per-lane stop."""
    A, b = geo
    n = A.shape[0]
    op = tpucg.WellOperator.from_csr(A)
    npad = op.padded_n
    # Column 0: b itself. Column 1: a tiny multiple — same direction, so
    # identical lap count; column 2: already-converged (zero RHS).
    B = np.zeros((npad, 3), np.float32)
    rng = np.random.default_rng(5)
    B[:n, 0] = rng.standard_normal(n)
    B[:n, 1] = 0.01 * B[:n, 0]
    tol = 1e-5 * float(np.linalg.norm(B[:n, 0]))
    res = _cg_multi_jit(op, jnp.asarray(B), jnp.zeros((npad, 3)),
                        None, tol, 4 * n, True)
    its = np.asarray(res.iterations)
    assert bool(np.asarray(res.converged).all())
    # Zero RHS converges at 0 laps; the scaled column stops much earlier
    # than the full one (its residual starts 100x smaller).
    assert its[2] == 0
    assert its[1] < its[0]
    np.testing.assert_array_equal(np.asarray(res.x)[:, 2], 0.0)


def test_block_cg_well_uses_spmm_and_converges(geo):
    A, b = geo
    n, k = A.shape[0], 4
    op = tpucg.WellOperator.from_csr(A)
    npad = op.padded_n
    B = _rhs(npad, n, k, seed=6)
    from tpucg.solver.cg import _cg_block_jit

    tol = 1e-5 * float(np.linalg.norm(np.asarray(B[:n, 0])))
    res = _cg_block_jit(op, B, jnp.zeros_like(B), tol, 4 * n)
    assert bool(np.all(np.asarray(res.converged)))
    X = np.asarray(res.x)[:n]
    Bn = np.asarray(B)[:n]
    for j in range(k):
        r = np.linalg.norm(Bn[:, j] - A.matvec(X[:, j].astype(np.float64)))
        assert r < 4 * tol, (j, r)
