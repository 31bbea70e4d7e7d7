"""Jacobi-preconditioned CG tests (extension beyond the reference's
unpreconditioned solver; stopping contract unchanged: sqrt(r.r) < tol on the
TRUE residual, checked after the x/r update)."""

import numpy as np
import pytest

import tpucg
from tpucg.solver.operators import DenseOperator, EllOperator, PoissonOperator
from tpucg.io.generator import poisson3d_csr


def _badly_scaled_system(n=64, seed=2):
    """SPD system whose rows/columns span 4 orders of magnitude — plain CG
    crawls; Jacobi renormalizes it. (Wider spans exceed what float32 can
    solve accurately at all.)"""
    rng = np.random.default_rng(seed)
    R = rng.random((n, n))
    A0 = 0.5 * (R + R.T) + n * np.eye(n)
    d = 10.0 ** rng.uniform(-2, 2, n)
    A = (A0 * d).T * d  # D A0 D, SPD
    x_true = rng.standard_normal(n)
    b = A @ x_true
    return A.astype(np.float32), b.astype(np.float32), x_true


def _rel_residual(A, b, x):
    r = b.astype(np.float64) - A.astype(np.float64) @ np.asarray(x, np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def test_jacobi_beats_plain_on_bad_scaling():
    A, b, x_true = _badly_scaled_system()
    n = A.shape[0]
    tol = 1e-5 * float(np.linalg.norm(b))
    plain = tpucg.cg_solve(A, b, tol=tol, maxiter=10 * n)
    jac = tpucg.cg_solve(A, b, tol=tol, maxiter=10 * n,
                         precondition="jacobi")
    assert bool(jac.converged)
    assert int(jac.iterations) < int(plain.iterations)
    # The contract is on the residual; for this conditioning the solution
    # itself is only determined to ~kappa * eps_f32.
    assert _rel_residual(A, b, jac.x) < 1e-4


def test_jacobi_same_solution_as_plain(golden_4x4):
    g = golden_4x4
    r = tpucg.cg_solve(g["A"], g["b"], g["x0"], precondition="jacobi")
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), g["x_star"], atol=1e-4)


def test_jacobi_sharded_matches_serial():
    A, b, x_true = _badly_scaled_system(n=96, seed=5)
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(A, b, tol=tol, precondition="jacobi", maxiter=960)
    assert _rel_residual(A, b, ser.x) < 1e-4
    for strategy in ("allgather", "overlap"):
        sh = tpucg.sharded_cg_solve(
            A, b, tol=tol, precondition="jacobi", strategy=strategy,
            maxiter=960,
        )
        assert bool(sh.converged), strategy
        # Different reduction order -> different f32 trajectory; both must
        # satisfy the same residual contract on the true system.
        assert _rel_residual(A, b, sh.x) < 1e-4, strategy


def test_jacobi_checkpointed():
    A, b, _ = _badly_scaled_system(n=48, seed=7)
    tol = 1e-5 * float(np.linalg.norm(b))
    ref = tpucg.cg_solve(A, b, tol=tol, precondition="jacobi", maxiter=480)
    res = tpucg.cg_solve_checkpointed(
        A, b, tol=tol, precondition="jacobi", maxiter=480, segment_iters=5
    )
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_diagonal_ell_and_poisson():
    csr = poisson3d_csr(4)
    op = EllOperator.from_csr(csr)
    np.testing.assert_allclose(np.asarray(op.diagonal()), 6.0)
    pop = PoissonOperator(m=4)
    np.testing.assert_allclose(np.asarray(pop.diagonal()), 6.0)
    A = np.diag([2.0, 5.0, 9.0]).astype(np.float32)
    dop = DenseOperator.create(A)
    np.testing.assert_allclose(np.asarray(dop.diagonal()), [2.0, 5.0, 9.0])


def test_jacobi_on_poisson_operator():
    m = 6
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    import jax.numpy as jnp

    b = np.asarray(op.matvec(jnp.asarray(x_true)))
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(op, b, tol=tol, precondition="jacobi", maxiter=2000)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-3)


def test_unknown_preconditioner_rejected():
    with pytest.raises(ValueError, match="preconditioner"):
        tpucg.CGConfig(precondition="ilu")

# --- block-Jacobi (precondition="block_jacobi") ---------------------------
# The batched-GEMM strong preconditioner: diagonal bs x bs blocks inverted
# once at setup, applied as ONE batched block GEMV per lap. Unlike point
# Jacobi it absorbs WITHIN-block coupling — on a banded operator whose
# diagonal is constant (where point Jacobi is a no-op) it still slashes
# laps.


def _laplacian1d(n):
    return (
        2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    ).astype(np.float32)


def test_block_jacobi_extraction_matches_dense():
    # diagonal_blocks must be EXACT for every implementing operator
    # (probing cannot be: any nonzero bandwidth aliases off-block entries).
    from tpucg.solver.operators import DiaOperator
    from tpucg.sparse.formats import DIAMatrix

    def blocks_ref(A, bs):
        N = A.shape[0]
        nb = -(-N // bs)
        out = np.zeros((nb, bs, bs), np.float32)
        for q in range(nb):
            lo, hi = q * bs, min((q + 1) * bs, N)
            w = hi - lo
            out[q, :w, :w] = A[lo:hi, lo:hi]
            for r in range(w, bs):
                out[q, r, r] = 1.0
        return out

    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, 100)).astype(np.float32)
    A = A + A.T + 200 * np.eye(100, dtype=np.float32)
    op = DenseOperator.create(A)
    for bs in (8, 64):  # 64 does not divide 100: tail identity blocks
        np.testing.assert_allclose(
            np.asarray(op.diagonal_blocks(bs)), blocks_ref(A, bs), atol=0
        )

    n = 256
    offs = [-7, -1, 0, 1, 7]
    data = np.zeros((5, n), np.float32)
    Ad = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        v = rng.standard_normal(hi - lo).astype(np.float32)
        data[d, lo:hi] = v
        Ad[idx[lo:hi], idx[lo:hi] + off] = v
    dia = DIAMatrix(offsets=np.array(offs), data=data, shape=(n, n))
    opd = DiaOperator.from_dia(dia)
    Adp = np.eye(opd.padded_n, dtype=np.float32)
    Adp[:n, :n] = Ad
    for bs in (8, 64):
        np.testing.assert_allclose(
            np.asarray(opd.diagonal_blocks(bs)), blocks_ref(Adp, bs),
            atol=0, err_msg=f"bs={bs}",
        )

    pop = PoissonOperator(m=8)
    Ap = poisson3d_csr(8).to_dense().astype(np.float32)
    for bs in (4, 16, 128):  # 128 > m^2: all three stencil offsets in-block
        np.testing.assert_allclose(
            np.asarray(pop.diagonal_blocks(bs)), blocks_ref(Ap, bs),
            atol=0, err_msg=f"bs={bs}",
        )


def test_block_jacobi_beats_plain_and_point_on_band():
    # Constant-diagonal band: point Jacobi is an (iterate-exact) no-op,
    # block Jacobi absorbs the in-block band and cuts laps >= 4x. tol sits
    # above the f32 attainable floor at this kappa (~4e5).
    n = 1024
    L = _laplacian1d(n)
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    plain = tpucg.cg_solve(L, b, tol=tol, maxiter=8 * n)
    bj = tpucg.cg_solve(L, b, tol=tol, maxiter=8 * n,
                        precondition="block_jacobi", pc_block_size=64)
    assert bool(bj.converged)
    assert int(bj.iterations) * 4 < int(plain.iterations)
    resid = np.linalg.norm(b - L @ np.asarray(bj.x))
    assert resid < 2 * tol, resid


def test_block_jacobi_operators_and_methods():
    # DIA and chebyshev composition, same band.
    from tpucg.solver.operators import DiaOperator
    from tpucg.sparse.formats import DIAMatrix

    n = 512
    L = _laplacian1d(n)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    ref = tpucg.cg_solve(L, b, tol=tol, maxiter=8 * n,
                         precondition="block_jacobi")
    idx = np.arange(n)
    data = np.zeros((3, n), np.float32)
    data[0, idx[1:]] = -1.0
    data[1] = 2.0
    data[2, idx[:-1]] = -1.0
    dia = DIAMatrix(offsets=np.array([-1, 0, 1]), data=data, shape=(n, n))
    opd = DiaOperator.from_dia(dia)
    rd = tpucg.cg_solve(opd, b, tol=tol, maxiter=8 * n,
                        precondition="block_jacobi")
    assert bool(rd.converged)
    resid = np.linalg.norm(b - L @ np.asarray(rd.x)[:n])
    assert resid < 2 * tol, resid
    rc = tpucg.cg_solve(L, b, tol=tol, maxiter=8 * n, method="chebyshev",
                        precondition="block_jacobi")
    assert bool(rc.converged)
    np.testing.assert_allclose(np.asarray(rc.x), np.asarray(ref.x),
                               rtol=0.05, atol=5e-2 * float(np.abs(np.asarray(ref.x)).max()))


def test_block_jacobi_poisson_parity():
    m = 8
    n = m ** 3
    op = PoissonOperator(m=m)
    b = np.ones(n, np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    p0 = tpucg.cg_solve(op, b, tol=tol, maxiter=8 * n)
    pb = tpucg.cg_solve(op, b, tol=tol, maxiter=8 * n,
                        precondition="block_jacobi", pc_block_size=64)
    assert bool(pb.converged)
    assert int(pb.iterations) < int(p0.iterations)
    np.testing.assert_allclose(np.asarray(pb.x), np.asarray(p0.x),
                               rtol=1e-3, atol=1e-4)


def test_block_jacobi_multi_rhs():
    n = 512
    L = _laplacian1d(n)
    B = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(B[:, 0]))
    rm = tpucg.cg_solve_multi(L, B, tol=tol, maxiter=8 * n,
                              precondition="block_jacobi")
    assert np.asarray(rm.converged).all()
    for j in range(3):
        ref = tpucg.cg_solve(L, B[:, j], tol=tol, maxiter=8 * n,
                             precondition="block_jacobi")
        assert abs(int(np.asarray(rm.iterations)[j]) - int(ref.iterations)) <= 1


def test_block_jacobi_sharded_matches_serial():
    n = 1024
    L = _laplacian1d(n)
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(L, b, tol=tol, maxiter=8 * n,
                         precondition="block_jacobi", pc_block_size=64)
    for strategy in ("allgather", "overlap"):
        sh = tpucg.sharded_cg_solve(
            L, b, tol=tol, maxiter=8 * n, strategy=strategy,
            precondition="block_jacobi", pc_block_size=64,
        )
        assert bool(sh.converged), strategy
        resid = np.linalg.norm(b - L @ np.asarray(sh.x))
        assert resid < 2 * tol, (strategy, resid)
        np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ser.x),
                                   rtol=0.05, atol=0.05)


def test_block_jacobi_validation():
    n = 256
    L = _laplacian1d(n)
    b = np.ones(n, np.float32)
    with pytest.raises(ValueError, match="pc_block_size"):
        tpucg.CGConfig(precondition="block_jacobi", pc_block_size=1)
    # Non-divisible bs in the sharded path: shards pad to a bs multiple
    # (identity tail blocks) instead of raising, and match the serial
    # solve (same M^-1/2-weighted stopping contract).
    sh24 = tpucg.sharded_cg_solve(L, b, precondition="block_jacobi",
                                  pc_block_size=24, tol=1e-5)
    ser24 = tpucg.cg_solve(L, b, precondition="block_jacobi",
                           pc_block_size=24, tol=1e-5)
    assert bool(sh24.converged) and sh24.x.shape == (n,)
    np.testing.assert_allclose(np.asarray(sh24.x), np.asarray(ser24.x),
                               rtol=5e-3, atol=5e-3)
    # Operator-sharded block Jacobi (round-3-late): shard-local block
    # grid — converges and matches the unsharded operator solve.
    from tpucg.solver.operators import PoissonOperator as _P

    shp = tpucg.sharded_operator_cg_solve(
        _P(m=8), np.ones(512, np.float32),
        precondition="block_jacobi", pc_block_size=64, tol=1e-5,
    )
    assert bool(shp.converged)
    # Unimplemented compositions refuse loudly instead of silently
    # degrading to unpreconditioned.
    with pytest.raises(ValueError, match="block"):
        tpucg.cg_solve_batch(
            np.stack([L, L]), np.stack([b, b]),
            precondition="block_jacobi",
        )
    # Operators without addressable diagonal blocks refuse loudly.
    from tpucg.io.generator import poisson3d_csr as _csr
    from tpucg.solver.operators import EllOperator

    with pytest.raises(NotImplementedError, match="diagonal blocks"):
        tpucg.cg_solve(EllOperator.from_csr(_csr(4)),
                       np.ones(64, np.float32),
                       precondition="block_jacobi")


def test_block_jacobi_checkpointed():
    # Checkpoint/resume must be bit-identical under block_jacobi (same
    # recomputed block inverses, same recurrence), and the bs is part of
    # the checkpoint's preconditioner identity.
    n = 512
    L = _laplacian1d(n)
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    ref = tpucg.cg_solve(L, b, tol=tol, maxiter=8 * n,
                         precondition="block_jacobi", pc_block_size=64)
    res = tpucg.cg_solve_checkpointed(
        L, b, tol=tol, maxiter=8 * n, precondition="block_jacobi",
        pc_block_size=64, segment_iters=7,
    )
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_block_jacobi_checkpoint_bs_mismatch_refuses(tmp_path):
    n = 256
    L = _laplacian1d(n)
    b = np.ones(n, np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    path = str(tmp_path / "ck.npz")
    # Run a few segments at bs=64, cap before convergence, keep the file.
    r1 = tpucg.cg_solve_checkpointed(
        L, b, tol=tol, maxiter=4, precondition="block_jacobi",
        pc_block_size=64, segment_iters=2, checkpoint_path=path,
        keep_checkpoint=True,
    )
    assert not bool(r1.converged)
    with pytest.raises(ValueError, match="precondition"):
        tpucg.cg_solve_checkpointed(
            L, b, tol=tol, maxiter=8 * n, precondition="block_jacobi",
            pc_block_size=32, segment_iters=2, checkpoint_path=path,
        )
