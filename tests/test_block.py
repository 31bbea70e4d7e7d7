"""TRUE block-CG tests (``cg_solve_block`` / ``sharded_cg_solve_block``).

Block CG (O'Leary 1980) couples the k right-hand sides into ONE shared
block-Krylov space — contrast ``cg_solve_multi``, whose vmapped lanes search
independently. The win is ITERATIONS (the block deflates k eigendirections
per lap); the per-lap cost is one (n, k) operator GEMM + one fused
(2k x 2k) Gram reduction + k x k replicated coordinate solves."""

import numpy as np
import pytest

import tpucg
from tpucg.solver.operators import PoissonOperator
from tpucg.solver.oracle import oracle_cg


def _laplacian1d(n):
    return (
        2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    ).astype(np.float32)


def test_block_parity_with_oracle():
    n, k = 128, 4
    A, b0, _ = tpucg.generate_spd_system(n, seed=0)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((n, k)).astype(np.float32)
    res = tpucg.cg_solve_block(A, B)
    assert np.asarray(res.converged).all()
    assert np.asarray(res.x).shape == (n, k)
    for j in range(k):
        x_ref, _, _ = oracle_cg(np.asarray(A), B[:, j],
                                np.zeros(n, np.float32))
        np.testing.assert_allclose(
            np.asarray(res.x)[:, j], x_ref, rtol=1e-4, atol=1e-5
        )


def test_block_beats_single_vector_iterations():
    # Spread spectrum (1-D Laplacian): the shared block space must cut the
    # lap count vs single-vector CG on the same tolerance.
    n, k = 256, 8
    A = _laplacian1d(n)
    rng = np.random.default_rng(2)
    B = rng.standard_normal((n, k)).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(B[:, 0]))
    res = tpucg.cg_solve_block(A, B, tol=tol, maxiter=4 * n)
    assert np.asarray(res.converged).all()
    worst_single = 0
    for j in range(k):
        r1 = tpucg.cg_solve(A, B[:, j], tol=tol, maxiter=4 * n)
        assert bool(r1.converged)
        worst_single = max(worst_single, int(r1.iterations))
    assert int(res.iterations) < worst_single
    # And vs the independent-lane multi solver (same laps as single CG).
    multi = tpucg.cg_solve_multi(A, B, tol=tol, maxiter=4 * n)
    assert int(res.iterations) < int(np.asarray(multi.iterations).max())


def test_block_k1_degenerates_to_cg():
    n = 96
    A, b, x0 = tpucg.generate_spd_system(n, seed=3)
    ref = tpucg.cg_solve(A, b, x0)
    res = tpucg.cg_solve_block(
        np.asarray(A), np.asarray(b)[:, None], np.asarray(x0)[:, None]
    )
    assert np.asarray(res.converged).all()
    assert abs(int(res.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(
        np.asarray(res.x)[:, 0], np.asarray(ref.x), rtol=1e-4, atol=1e-6
    )


def test_block_duplicate_columns_rank_deficient():
    # Two identical RHS make the direction block rank-deficient from lap 0;
    # the relative ridge must keep the coordinate solves finite and both
    # columns must converge to the same solution.
    n = 96
    A, b, _ = tpucg.generate_spd_system(n, seed=4)
    B = np.stack([np.asarray(b), np.asarray(b)], axis=1).astype(np.float32)
    res = tpucg.cg_solve_block(A, B)
    assert np.asarray(res.converged).all()
    np.testing.assert_allclose(
        np.asarray(res.x)[:, 0], np.asarray(res.x)[:, 1],
        rtol=1e-5, atol=1e-6,
    )
    x_ref, _, _ = oracle_cg(np.asarray(A), B[:, 0], np.zeros(n, np.float32))
    np.testing.assert_allclose(
        np.asarray(res.x)[:, 0], x_ref, rtol=1e-4, atol=1e-5
    )


def test_block_mixed_difficulty_freezes_converged_columns():
    # Column 0 is an eigenvector image (converges in ~1 lap) — it must
    # freeze while the random columns keep iterating, and stay correct.
    n, k = 192, 3
    A = _laplacian1d(n)
    w, V = np.linalg.eigh(A)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((n, k)).astype(np.float32)
    B[:, 0] = (A @ V[:, n // 2]).astype(np.float32)  # x* = eigenvector
    tol = 1e-4 * float(np.linalg.norm(B[:, 1]))
    res = tpucg.cg_solve_block(A, B, tol=tol, maxiter=4 * n)
    assert np.asarray(res.converged).all()
    for j in range(k):
        resid = np.linalg.norm(B[:, j] - A @ np.asarray(res.x)[:, j])
        assert resid < 5 * tol, j


def test_block_operator_stencil():
    # Matrix-free operator path: the vmapped stencil matvec carries the
    # (n, k) block.
    m, k = 8, 4
    op = PoissonOperator(m=m)
    n = m ** 3
    rng = np.random.default_rng(6)
    X_true = rng.standard_normal((n, k)).astype(np.float32)
    import jax

    B = np.stack(
        [np.asarray(op.matvec(X_true[:, j])) for j in range(k)], axis=1
    )
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    res = tpucg.cg_solve_block(op, B, tol=tol, maxiter=4 * n)
    assert np.asarray(res.converged).all()
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=1e-3)
    # Fewer shared laps than the worst independent lane.
    multi = tpucg.cg_solve_multi(op, B, tol=tol, maxiter=4 * n)
    assert int(res.iterations) <= int(np.asarray(multi.iterations).max())


def test_block_sharded_parity():
    n, k = 192, 4
    A, _, _ = tpucg.generate_spd_system(n, seed=7)
    rng = np.random.default_rng(8)
    B = rng.standard_normal((n, k)).astype(np.float32)
    ser = tpucg.cg_solve_block(A, B)
    sh = tpucg.sharded_cg_solve_block(np.asarray(A), B)
    assert np.asarray(sh.converged).all()
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 1
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )


def test_block_sharded_padded_uneven():
    # n=67 row-pads to the mesh: identity-tail pad rows must stay inert
    # through the block Gram.
    n, k = 67, 3
    A, _, _ = tpucg.generate_spd_system(n, seed=9)
    rng = np.random.default_rng(10)
    B = rng.standard_normal((n, k)).astype(np.float32)
    sh = tpucg.sharded_cg_solve_block(np.asarray(A), B)
    assert np.asarray(sh.converged).all()
    assert np.asarray(sh.x).shape == (n, k)
    for j in range(k):
        x_ref, _, _ = oracle_cg(np.asarray(A), B[:, j],
                                np.zeros(n, np.float32))
        np.testing.assert_allclose(
            np.asarray(sh.x)[:, j], x_ref, rtol=1e-4, atol=1e-5
        )


def test_block_validation():
    A, b, _ = tpucg.generate_spd_system(32, seed=0)
    with pytest.raises(ValueError, match="shape"):
        tpucg.cg_solve_block(A, np.asarray(b))  # 1-D B
    with pytest.raises(ValueError, match="method"):
        tpucg.sharded_cg_solve_block(
            np.asarray(A), np.asarray(b)[:, None], method="pipelined"
        )

def test_block_jacobi_equilibration():
    # Badly diagonally scaled SPD system: jacobi block CG is EXACT
    # symmetric equilibration — stopping is on the D^-1/2-weighted
    # residual (the natural PCG norm; documented deviation from the
    # single-RHS arms' unweighted contract). It must converge in the
    # equilibrated system's few laps and satisfy the weighted contract.
    n, k = 192, 4
    rng = np.random.default_rng(11)
    A, _, _ = tpucg.generate_spd_system(n, seed=11)
    d = np.exp(rng.uniform(0.0, np.log(1e3), n)).astype(np.float32)
    A = (np.asarray(A) * d[:, None] * d[None, :]).astype(np.float32)
    B = rng.standard_normal((n, k)).astype(np.float32)
    scale = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-5 * float(np.linalg.norm(scale * B[:, 0]))
    pc = tpucg.cg_solve_block(A, B, precondition="jacobi", tol=tol,
                              maxiter=4 * n)
    assert np.asarray(pc.converged).all()
    # Equilibration restores the generator family's few-lap convergence.
    assert int(pc.iterations) <= 40
    for j in range(k):
        wres = np.linalg.norm(scale * (B[:, j] - A @ np.asarray(pc.x)[:, j]))
        assert wres < 5 * tol, (j, wres, tol)


def test_block_jacobi_matrix_free_operator():
    # Jacobi block CG on a NON-dense operator: matrix-free symmetric
    # equilibration (two elementwise scales around the vmapped matvec).
    # A badly row/col-scaled diagonally-dominant band; must converge in
    # the equilibrated few laps and match the dense equilibrated path.
    from tpucg.solver.operators import DiaOperator
    from tpucg.sparse.formats import DIAMatrix

    n, k = 192, 4
    rng = np.random.default_rng(12)
    band = (3 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(
        np.float32
    )
    d = np.exp(rng.uniform(0.0, np.log(100.0), n)).astype(np.float32)
    A = (band * d[:, None] * d[None, :]).astype(np.float32)
    idx = np.arange(n)
    data = np.zeros((3, n), np.float32)
    data[0, idx[1:]] = A[idx[1:], idx[1:] - 1]
    data[1] = np.diag(A)
    data[2, idx[:-1]] = A[idx[:-1], idx[:-1] + 1]
    dia = DIAMatrix(offsets=np.array([-1, 0, 1]), data=data, shape=(n, n))
    np.testing.assert_allclose(dia.to_dense(), A)
    op = DiaOperator.from_dia(dia)
    B = rng.standard_normal((n, k)).astype(np.float32)
    scale = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-5 * float(np.linalg.norm(scale * B[:, 0]))
    mf = tpucg.cg_solve_block(op, B, precondition="jacobi", tol=tol,
                              maxiter=4 * n)
    assert np.asarray(mf.converged).all()
    plain = tpucg.cg_solve_block(op, B, tol=tol, maxiter=4 * n)
    assert int(mf.iterations) < int(plain.iterations)
    dense = tpucg.cg_solve_block(A, B, precondition="jacobi", tol=tol,
                                 maxiter=4 * n)
    for j in range(k):
        wres = np.linalg.norm(scale * (B[:, j] - A @ np.asarray(mf.x)[:, j]))
        assert wres < 5 * tol, (j, wres, tol)
    np.testing.assert_allclose(
        np.asarray(mf.x), np.asarray(dense.x), rtol=1e-3, atol=1e-4
    )


def test_block_poly_preconditioned():
    # Poly block CG (flexible M^-1-inner-product BCGrQ, block_pcg_loop):
    # must cut laps vs plain block CG on the stencil-conditioned Poisson
    # system and match the single-vector poly-PCG solutions.
    m, k = 8, 4
    op = PoissonOperator(m=m)
    n = m ** 3
    rng = np.random.default_rng(13)
    B = rng.standard_normal((n, k)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    pr = tpucg.cg_solve_block(op, B, tol=tol, maxiter=4 * n,
                              precondition="poly", poly_degree=3)
    assert np.asarray(pr.converged).all()
    plain = tpucg.cg_solve_block(op, B, tol=tol, maxiter=4 * n)
    assert int(pr.iterations) < int(plain.iterations)
    for j in range(k):
        ref = tpucg.cg_solve(op, B[:, j], tol=tol, maxiter=4 * n,
                             precondition="poly", poly_degree=3)
        np.testing.assert_allclose(
            np.asarray(pr.x)[:, j], np.asarray(ref.x), rtol=1e-3, atol=1e-4
        )
    # Zero columns must stay finite through the signed pair Gram
    # (clip-and-pin guard in _cholqr_pc).
    rz = tpucg.cg_solve_block(op, np.zeros((n, 2), np.float32),
                              precondition="poly", poly_degree=2)
    assert np.asarray(rz.converged).all()
    assert np.isfinite(np.asarray(rz.x)).all()


def test_block_sharded_preconditioned_parity():
    # Sharded jacobi (matrix-free equilibration, shard-local scales) and
    # sharded poly (flexible loop, psum Grams) must match their serial
    # counterparts on an uneven (padded) n.
    n, k = 131, 3
    rng = np.random.default_rng(14)
    A0, _, _ = tpucg.generate_spd_system(n, seed=14)
    d = np.exp(rng.uniform(0.0, np.log(100.0), n)).astype(np.float32)
    A = (np.asarray(A0) * d[:, None] * d[None, :]).astype(np.float32)
    B = rng.standard_normal((n, k)).astype(np.float32)
    scale = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-5 * float(np.linalg.norm(scale * B[:, 0]))
    ser = tpucg.cg_solve_block(A, B, precondition="jacobi", tol=tol,
                               maxiter=4 * n)
    sh = tpucg.sharded_cg_solve_block(A, B, precondition="jacobi", tol=tol,
                                      maxiter=4 * n)
    assert np.asarray(sh.converged).all()
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 2
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-3, atol=1e-4
    )
    B2 = rng.standard_normal((n, k)).astype(np.float32)
    tol2 = 1e-5 * float(np.linalg.norm(B2[:, 0]))
    serp = tpucg.cg_solve_block(np.asarray(A0), B2, precondition="poly",
                                poly_degree=2, tol=tol2, maxiter=4 * n)
    shp = tpucg.sharded_cg_solve_block(
        np.asarray(A0), B2, precondition="poly", poly_degree=2, tol=tol2,
        maxiter=4 * n,
    )
    assert np.asarray(shp.converged).all()
    np.testing.assert_allclose(
        np.asarray(shp.x), np.asarray(serp.x), rtol=1e-3, atol=1e-4
    )


def test_block_zero_columns_do_not_nan():
    # Regression (review finding): an exactly-zero RHS column underflowed
    # the old 1e-30-relative column-scale floor — outer(d, d) hit 0 in f32
    # and 0/0 NaN-poisoned the whole block. The floor must survive its own
    # square.
    n = 32
    A, b, _ = tpucg.generate_spd_system(n, seed=0)
    r = tpucg.cg_solve_block(np.asarray(A), np.zeros((n, 2), np.float32))
    assert np.asarray(r.converged).all()
    assert np.isfinite(np.asarray(r.x)).all()
    assert np.abs(np.asarray(r.x)).max() == 0.0
    B = np.stack([np.zeros(n, np.float32), np.asarray(b)], axis=1)
    r2 = tpucg.cg_solve_block(np.asarray(A), B)
    assert np.asarray(r2.converged).all()
    assert np.abs(np.asarray(r2.x)[:, 0]).max() == 0.0
    x_ref, _, _ = oracle_cg(np.asarray(A), np.asarray(b),
                            np.zeros(n, np.float32))
    np.testing.assert_allclose(
        np.asarray(r2.x)[:, 1], x_ref, rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 5), (3, 6)])
def test_block_fuzz_random_spectra(seed, k):
    # Random log-spread spectra and batch widths: every column must meet
    # the exact true-residual contract at the confirm boundary.
    n = 96
    rng = np.random.default_rng(seed)
    w = np.exp(rng.uniform(np.log(0.1), np.log(10.0), n))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((Q * w) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    B = rng.standard_normal((n, k)).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(B[:, 0]))
    res = tpucg.cg_solve_block(A, B, tol=tol, maxiter=8 * n)
    assert np.asarray(res.converged).all(), (seed, k)
    for j in range(k):
        resid = np.linalg.norm(
            B[:, j].astype(np.float64)
            - A.astype(np.float64) @ np.asarray(res.x)[:, j]
        )
        assert resid < 5 * tol, (seed, k, j, resid)


def test_block_k_cap():
    A, _, _ = tpucg.generate_spd_system(64, seed=0)
    B = np.ones((64, 33), np.float32)
    with pytest.raises(ValueError, match="k <= 32"):
        tpucg.cg_solve_block(np.asarray(A), B)
    with pytest.raises(ValueError, match="k <= 32"):
        tpucg.sharded_cg_solve_block(np.asarray(A), B)


def test_block_cg_block_jacobi():
    # block_jacobi x block CG: BLOCKWISE equilibration (per-block
    # M^(+-1/2) pairs from one batched eigh) wrapped around the plain
    # BCGrQ loop. On an in-block-conditioned scaled band it must beat
    # point-jacobi block CG and match the single-vector block_jacobi
    # solutions; the sharded arm (shard-local blocks) must match serial.
    n, k = 512, 4
    rng = np.random.default_rng(15)
    band = 2.05 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    d = np.exp(rng.uniform(0.0, np.log(30.0), n))
    A = (band * d[:, None] * d[None, :]).astype(np.float32)
    B = rng.standard_normal((n, k)).astype(np.float32)
    sc = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-4 * float(np.linalg.norm(sc * B[:, 0]))
    rj = tpucg.cg_solve_block(A, B, precondition="jacobi", tol=tol,
                              maxiter=8 * n)
    rbj = tpucg.cg_solve_block(A, B, precondition="block_jacobi",
                               pc_block_size=64, tol=tol, maxiter=8 * n)
    assert np.asarray(rbj.converged).all()
    assert int(rbj.iterations) < int(rj.iterations)
    for j in range(k):
        ref = tpucg.cg_solve(A, B[:, j], precondition="block_jacobi",
                             pc_block_size=64, tol=tol, maxiter=8 * n)
        np.testing.assert_allclose(
            np.asarray(rbj.x)[:, j], np.asarray(ref.x),
            rtol=5e-3, atol=1e-3,
        )
    # Sharded: bs=16 divides this mesh's 64-row shards.
    sh = tpucg.sharded_cg_solve_block(A, B, precondition="block_jacobi",
                                      pc_block_size=16, tol=tol,
                                      maxiter=8 * n)
    assert np.asarray(sh.converged).all()
    ser16 = tpucg.cg_solve_block(A, B, precondition="block_jacobi",
                                 pc_block_size=16, tol=tol, maxiter=8 * n)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ser16.x),
                               rtol=5e-3, atol=1e-3)
    # Non-divisible bs: the partition pads each shard to a bs multiple
    # (identity tail blocks) instead of raising.
    sh24 = tpucg.sharded_cg_solve_block(A, B, precondition="block_jacobi",
                                        pc_block_size=24, tol=tol,
                                        maxiter=8 * n)
    assert np.asarray(sh24.converged).all()
    assert sh24.x.shape == (n, k)
    np.testing.assert_allclose(A @ np.asarray(sh24.x)[:, 0], B[:, 0],
                               atol=tol * 20)
