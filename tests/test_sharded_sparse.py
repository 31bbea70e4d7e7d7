"""Distributed sparse/stencil solves: slab-decomposed matrix-free Poisson
with ppermute halo exchange (the BASELINE north star: halo transfer
overlapped with local stencil compute) and row-sharded ELL SpMV."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.io.generator import poisson3d_csr
from tpucg.solver.operators import EllOperator, PoissonOperator
from tpucg.solver.sharded import sharded_operator_cg_solve


@pytest.fixture(scope="module")
def poisson_system():
    m = 8  # 8 slabs of 1 plane each on the 8-device mesh
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(jnp.asarray(x_true)))
    return m, op, b, x_true


def test_poisson_halo_matches_serial(poisson_system):
    m, op, b, x_true = poisson_system
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    sh = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    assert bool(sh.converged)
    assert int(sh.iterations) == int(ser.iterations)
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(sh.x), x_true, atol=1e-3)


def test_poisson_halo_jacobi_and_pipelined(poisson_system):
    m, op, b, _ = poisson_system
    tol = 1e-5 * float(np.linalg.norm(b))
    base = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    jac = sharded_operator_cg_solve(
        op, b, tol=tol, maxiter=4 * m ** 3, precondition="jacobi"
    )
    assert bool(jac.converged)
    # Jacobi on constant-diagonal Poisson is exact scaling: same iterates.
    assert abs(int(jac.iterations) - int(base.iterations)) <= 1
    pipe = sharded_operator_cg_solve(
        op, b, tol=tol, maxiter=4 * m ** 3, method="pipelined"
    )
    assert bool(pipe.converged)
    assert abs(int(pipe.iterations) - int(base.iterations)) <= 1


def test_poisson_halo_matvec_exact():
    # One maxiter=1 lap computes r0 = b - A x0 through the halo matvec;
    # compare its residual against the serial operator on a random x0.
    m = 8
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(m ** 3).astype(np.float32)
    x0 = rng.standard_normal(m ** 3).astype(np.float32)
    ser = tpucg.cg_solve(op, b, x0, maxiter=1)
    sh = sharded_operator_cg_solve(op, b, x0, maxiter=1)
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        float(sh.residual_norm), float(ser.residual_norm), rtol=1e-5
    )


def test_poisson_non_divisible_grid_padded():
    """m=9 over 8 devices: the grid is plane-padded to 16 (the pad planes a
    decoupled identity block) instead of inheriting the reference's
    ROWS %% P == 0 restriction (parallel_cg.c:86-90; SURVEY.md §7c)."""
    m = 9
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(6)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(jnp.asarray(x_true)))
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    sh = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    assert bool(sh.converged)
    assert int(sh.iterations) == int(ser.iterations)
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )


def test_ell_non_divisible_padded():
    """n = 7^3 = 343 (not divisible by 8): rows identity-padded."""
    csr = poisson3d_csr(7)
    n = csr.shape[0]
    rng = np.random.default_rng(8)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    op = EllOperator.from_csr(csr)
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    sh = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * n)
    assert bool(sh.converged)
    assert int(sh.iterations) == int(ser.iterations)
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )


def test_dia_sharded_band_halo():
    """Row-block-sharded DIA with the ppermute BAND-halo exchange (O(band)
    comm per lap) vs the serial solve. m=16 -> n=4096 = 8 x 512-row blocks,
    band reach 256."""
    from tpucg.io.generator import poisson3d_dia

    m = 16
    n = m ** 3
    dia = poisson3d_dia(m)
    rng = np.random.default_rng(9)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = dia.matvec(x_true).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(PoissonOperator(m=m), b, tol=tol, maxiter=4 * n)
    sh = sharded_operator_cg_solve(dia, b, tol=tol, maxiter=4 * n)
    assert bool(sh.converged)
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 1
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-4
    )


def test_dia_sharded_non_divisible_and_jacobi():
    """General banded (non-Poisson), n not divisible by P*128, Jacobi."""
    from tpucg.sparse.formats import COOMatrix, csr_to_dia

    rng = np.random.default_rng(11)
    n, bw = 1000, 3  # pads to 1024 over 8 shards
    rows, cols, vals = [], [], []
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        rows.append(idx)
        cols.append(idx + off)
        v = rng.random(idx.size).astype(np.float32)
        if off == 0:
            v += 4 * bw
        vals.append(v)
    coo = COOMatrix(
        row=np.concatenate(rows), col=np.concatenate(cols),
        data=np.concatenate(vals), shape=(n, n),
    )
    csr = coo.to_csr()
    dia = csr_to_dia(csr)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    sh = sharded_operator_cg_solve(
        dia, b, tol=tol, maxiter=4 * n, precondition="jacobi"
    )
    assert bool(sh.converged)
    np.testing.assert_allclose(np.asarray(sh.x), x_true, atol=1e-3)


def test_bsr_sharded_matches_serial():
    """Block-row-sharded BSR (identity-padded to P) vs the serial solve."""
    from tpucg.sparse.formats import csr_to_bsr

    csr = poisson3d_csr(6)  # n=216, bs=4 -> nbr=54, pads to 56 block rows
    n = csr.shape[0]
    bsr = csr_to_bsr(csr, blocksize=4)
    rng = np.random.default_rng(12)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(bsr, b, tol=tol, maxiter=4 * n)
    sh = sharded_operator_cg_solve(bsr, b, tol=tol, maxiter=4 * n)
    assert bool(sh.converged)
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 1
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-4
    )
    sh_j = sharded_operator_cg_solve(
        bsr, b, tol=tol, maxiter=4 * n, precondition="jacobi"
    )
    assert bool(sh_j.converged)
    np.testing.assert_allclose(np.asarray(sh_j.x), x_true, atol=1e-3)


def test_ell_sharded_matches_serial():
    csr = poisson3d_csr(8)  # n=512, divisible by 8
    n = csr.shape[0]
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    op = EllOperator.from_csr(csr)
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    sh = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * n)
    assert bool(sh.converged)
    assert int(sh.iterations) == int(ser.iterations)
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )


def test_poisson_slab_matches_serial():
    # m=16 grid: the sharded slab solve (XLA stencil + halo planes) against
    # the serial operator, lap for lap.
    m = 16
    op = PoissonOperator(m=m)
    rng = np.random.default_rng(4)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.asarray(op.matvec(jnp.asarray(x_true)))
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    sh = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    assert bool(sh.converged)
    assert int(sh.iterations) == int(ser.iterations)
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-4, atol=1e-5
    )


def test_poisson_slab_kernel_direct():
    """The slab-halo matvec alone (one ppermute'd plane from each
    neighbour, then the in-slab stencil) on a 4-device mesh equals the
    serial stencil."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from tpucg.solver.sharded import (
        _prepare_sharded_operator,
        _sharded_operator_matvec_jit,
    )

    m, ndev = 16, 4
    mesh = tpucg.make_mesh(ndev)
    axis = mesh.axis_names[0]
    op = PoissonOperator(m=m)
    op_arrays, statics, n, npad, _ = _prepare_sharded_operator(
        op, mesh, tpucg.CGConfig()
    )
    assert npad == n == m ** 3
    u = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    v = jax.device_put(jnp.asarray(u), NamedSharding(mesh,
                                                    PartitionSpec(axis)))
    y = np.asarray(_sharded_operator_matvec_jit(
        op_arrays, v, mesh=mesh, axis=axis, **statics))
    y_ref = np.asarray(op.matvec(jnp.asarray(u)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-5)


def test_poisson_larger_grid_smoke():
    """Scale smoke: the slab solver handles production-sized grids — the
    BASELINE config-5 grid (m=512, n=134M) runs 2 laps in ~20 s on the CPU
    mesh (checked manually; m=64 here to keep the suite fast)."""
    m = 64
    op = PoissonOperator(m=m)
    b = np.ones(m ** 3, np.float32)
    r = sharded_operator_cg_solve(op, b, maxiter=3)
    assert np.all(np.isfinite(np.asarray(r.x)))
    assert int(r.iterations) == 3


def test_operator_sharded_record_residuals():
    """record_residuals composes with the operator-sharded solver (slab-halo
    Poisson): finite monotone-trending trace, NaN-padded past convergence."""
    m = 8
    op = PoissonOperator(m=m)
    b = np.ones(m ** 3, np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    r = sharded_operator_cg_solve(
        op, b, tol=tol, maxiter=4 * m ** 3, record_residuals=True
    )
    assert bool(r.converged)
    assert r.residual_history is not None
    k = int(r.iterations)
    h = np.asarray(r.residual_history)
    assert np.all(np.isfinite(h[: k + 1]))
    assert h[k] < tol
    assert np.all(np.isnan(h[k + 1:]))
    with pytest.raises(ValueError, match="record_residuals"):
        sharded_operator_cg_solve(
            op, b, method="pipelined", record_residuals=True
        )


class TestOperatorShardedMultiAndBlock:
    """Multi-RHS and TRUE block CG on the operator decompositions — the
    right-edge columns of the README solver matrix (batched halo/allgather
    collectives, XLA matvec arms)."""

    def test_multi_rhs_poisson_parity(self):
        from tpucg.solver.operators import PoissonOperator

        m = 8
        n = m ** 3
        op = PoissonOperator(m=m)
        B = np.random.default_rng(40).standard_normal((n, 3)).astype(
            np.float32)
        res = tpucg.sharded_cg_solve_multi(op, B, tol=1e-5)
        assert np.asarray(res.converged).all()
        assert res.x.shape == (n, 3)
        for j in range(3):
            one = tpucg.sharded_operator_cg_solve(op, B[:, j], tol=1e-5)
            assert int(np.asarray(res.iterations)[j]) == int(one.iterations)
            np.testing.assert_allclose(np.asarray(res.x)[:, j],
                                       np.asarray(one.x),
                                       rtol=5e-3, atol=5e-3)

    def test_multi_rhs_dia_and_ell(self):
        from tpucg.io.generator import poisson3d_dia
        from tpucg.solver.operators import DiaOperator, EllOperator

        m = 8
        n = m ** 3
        B = np.random.default_rng(41).standard_normal((n, 2)).astype(
            np.float32)
        for op in (DiaOperator.from_dia(poisson3d_dia(m)),
                   EllOperator.from_csr(tpucg.poisson3d_csr(m))):
            res = tpucg.sharded_cg_solve_multi(op, B, tol=1e-5)
            assert np.asarray(res.converged).all(), type(op).__name__
            A = np.asarray(tpucg.poisson3d_csr(m).to_dense())
            for j in range(2):
                r = B[:, j] - A @ np.asarray(res.x)[:, j]
                assert np.linalg.norm(r) < 2e-5, (type(op).__name__, j)

    def test_block_cg_dia_jacobi_parity_with_serial(self):
        from tpucg.io.generator import poisson3d_dia
        from tpucg.solver.operators import DiaOperator

        m = 8
        n = m ** 3
        dia = DiaOperator.from_dia(poisson3d_dia(m))
        B = np.random.default_rng(42).standard_normal((n, 3)).astype(
            np.float32)
        sh = tpucg.sharded_cg_solve_block(dia, B, tol=1e-5,
                                          precondition="jacobi")
        A = np.asarray(tpucg.poisson3d_csr(m).to_dense())
        ser = tpucg.cg_solve_block(A, B, tol=1e-5, precondition="jacobi")
        assert np.asarray(sh.converged).all()
        np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ser.x),
                                   rtol=5e-3, atol=5e-3)
        assert abs(int(sh.iterations) - int(ser.iterations)) <= 2

    def test_block_cg_poisson_poly_and_guard(self):
        from tpucg.solver.operators import PoissonOperator

        m = 8
        n = m ** 3
        op = PoissonOperator(m=m)
        B = np.random.default_rng(43).standard_normal((n, 2)).astype(
            np.float32)
        res = tpucg.sharded_cg_solve_block(op, B, tol=1e-5,
                                           precondition="poly",
                                           poly_degree=3)
        assert np.asarray(res.converged).all()
        plain = tpucg.sharded_cg_solve_block(op, B, tol=1e-5)
        assert int(res.iterations) < int(plain.iterations)
        with pytest.raises(ValueError, match="block Jacobi"):
            tpucg.sharded_cg_solve_block(op, B, precondition="block_jacobi")


class TestShardedWell:
    """Row-block sharded WELL — distributed IRREGULAR sparsity (the
    matrices that are neither banded nor blocky). CSRMatrix inputs to the
    sharded entry points take this decomposition."""

    @staticmethod
    def _geo(n=3000, seed=7):
        from tpucg.io.generator import random_geometric_spd

        return random_geometric_spd(n, seed=seed, avg_degree=10.0)

    def test_builder_global_matvec_parity(self):
        from tpucg.sparse.well import csr_to_well_sharded

        A, _, _ = self._geo()
        stacked, st = csr_to_well_sharded(A, 8)
        npad, rps = st["npad"], st["rps"]
        x = np.random.default_rng(1).standard_normal(npad)
        x[A.shape[0]:] = 0.0
        y_ref = A.matvec(x[: A.shape[0]].astype(np.float64))
        # Host-side replay of the sharded semantics: each shard's pack
        # applied to the full x must give its row block.
        from tpucg.sparse.well import CHUNK, LANE

        for s in range(8):
            vals = stacked["vals"][s].astype(np.float64)
            lidx = stacked["lidx"][s].astype(np.int64)
            wrow = np.repeat(stacked["wrow"][s], CHUNK)
            gidl = stacked["gidl"][s].reshape(-1)
            sgb = stacked["sgb"][s]
            BS = stacked["gidl"][s].shape[1]
            bg = st["bg"]
            x2 = x.reshape(-1, LANE)
            xg = x2[wrow]
            Pm = vals * np.take_along_axis(xg, lidx, axis=1)
            g_of_sub = np.repeat(sgb, BS) * bg + gidl
            y2 = np.zeros((st["nsg"] * bg, LANE))
            np.add.at(y2, g_of_sub, Pm)
            y_blk = y2.reshape(-1)[:rps]
            lo, hi = s * rps, min((s + 1) * rps, A.shape[0])
            if lo < A.shape[0]:
                np.testing.assert_allclose(
                    y_blk[: hi - lo], y_ref[lo:hi], rtol=1e-6, atol=1e-9,
                    err_msg=f"shard {s}")

    def test_sharded_cg_parity_and_jacobi(self):
        A, b, _ = self._geo()
        tol = 1e-5 * float(np.linalg.norm(b))
        ser = tpucg.cg_solve(tpucg.best_sparse_operator(A), b, tol=tol)
        for pc in ("none", "jacobi"):
            sh = tpucg.sharded_operator_cg_solve(A, b, tol=tol,
                                                 precondition=pc)
            assert bool(sh.converged), pc
            r = b - A.matvec(np.asarray(sh.x)[: A.shape[0]].astype(
                np.float64)).astype(np.float32)
            assert np.linalg.norm(r) <= 2 * tol, pc
        np.testing.assert_allclose(
            np.asarray(sh.x)[: A.shape[0]], np.asarray(ser.x)[: A.shape[0]],
            rtol=5e-3, atol=5e-3)

    def test_sharded_well_multi_block_deflated_minres(self):
        A, b, _ = self._geo(n=2000, seed=9)
        n = A.shape[0]
        tol = 1e-5 * float(np.linalg.norm(b))
        B = np.random.default_rng(10).standard_normal((n, 2)).astype(
            np.float32)
        rm = tpucg.sharded_cg_solve_multi(A, B, tol=tol)
        rb = tpucg.sharded_cg_solve_block(A, B, tol=tol,
                                          precondition="jacobi")
        assert np.asarray(rm.converged).all()
        assert np.asarray(rb.converged).all()
        for j in range(2):
            rr = B[:, j] - A.matvec(
                np.asarray(rm.x)[:n, j].astype(np.float64)).astype(
                np.float32)
            assert np.linalg.norm(rr) <= 2 * tol, ("multi", j)
            rrb = B[:, j] - A.matvec(
                np.asarray(rb.x)[:n, j].astype(np.float64)).astype(
                np.float32)
            # jacobi block CG stops on the M^-1/2-weighted residual
            # (documented contract); the unweighted norm can sit a few x
            # above tol on degree-varying Laplacians.
            assert np.linalg.norm(rrb) <= 10 * tol, ("block", j)

        plain = tpucg.sharded_operator_cg_solve(A, b, tol=tol)
        defl = tpucg.sharded_cg_solve_deflated(A, b, np.asarray(plain.x),
                                               tol=tol)
        assert bool(defl.converged) and int(defl.iterations) <= 2

        # Indefinite irregular CSR (staggered-sign diagonal added to the
        # graph Laplacian's off-diagonal pattern) through sharded MINRES.
        from tpucg.sparse.formats import COOMatrix

        coo = A.to_coo()
        off = coo.row != coo.col
        sign = np.where((np.arange(n) // 64) % 2 == 0, 1.0, -1.0)
        deg = np.zeros(n)
        np.add.at(deg, coo.row[off], np.abs(coo.data[off]).astype(
            np.float64))
        diag_v = sign * (deg + 1.0)
        rows = np.concatenate([coo.row[off], np.arange(n)])
        cols = np.concatenate([coo.col[off], np.arange(n)])
        data = np.concatenate([coo.data[off].astype(np.float32),
                               diag_v.astype(np.float32)])
        Aind = COOMatrix(row=rows, col=cols, data=data,
                         shape=(n, n)).to_csr()
        bind = np.random.default_rng(11).standard_normal(n).astype(
            np.float32)
        tind = 1e-4 * float(np.linalg.norm(bind))
        rmr = tpucg.sharded_minres_solve(Aind, bind, tol=tind,
                                         maxiter=8 * n,
                                         precondition="jacobi")
        assert bool(rmr.converged)
        rres = bind - Aind.matvec(
            np.asarray(rmr.x)[:n].astype(np.float64)).astype(np.float32)
        assert np.linalg.norm(rres) <= 2 * tind

    def test_sharded_well_checkpoint_resume(self, tmp_path):
        # The segmented checkpoint driver is kind-generic: a WELL solve
        # interrupted by maxiter resumes bit-identically.
        A, b, _ = self._geo(n=1500, seed=3)
        tol = 1e-5 * float(np.linalg.norm(b))
        ck = str(tmp_path / "w.ckpt")
        cap = tpucg.sharded_operator_cg_solve_checkpointed(
            A, b, segment_iters=3, maxiter=3, checkpoint_path=ck, tol=tol)
        assert not bool(cap.converged) and os.path.exists(ck)
        res = tpucg.sharded_operator_cg_solve_checkpointed(
            A, b, segment_iters=5, checkpoint_path=ck, tol=tol)
        plain = tpucg.sharded_operator_cg_solve(A, b, tol=tol)
        assert bool(res.converged)
        assert int(res.iterations) == int(plain.iterations)
        np.testing.assert_array_equal(np.asarray(res.x),
                                      np.asarray(plain.x))


class TestOperatorShardedBlockJacobi:
    """precondition='block_jacobi' on the operator-sharded arms: the block
    grid restarts at every shard boundary (shard-local apply, zero comm);
    bs need not divide rows-per-shard (virtual identity tail rows)."""

    def test_poisson_slab_block_jacobi_nondivisible(self):
        # m=6: plane-padded to 8 slabs; bs=24 does not divide the
        # 1-plane-per-shard 36-row blocks either.
        m, n = 6, 216
        op = PoissonOperator(m=m)
        A = poisson3d_csr(m).to_dense().astype(np.float64)
        rng = np.random.default_rng(0)
        b = rng.standard_normal(n).astype(np.float32)
        xs = np.linalg.solve(A, b.astype(np.float64))
        tol = 1e-5 * float(np.linalg.norm(b))
        for bs in (24, 16):
            r = sharded_operator_cg_solve(
                op, b, tol=tol, maxiter=4 * n,
                precondition="block_jacobi", pc_block_size=bs,
            )
            assert bool(r.converged), bs
            np.testing.assert_allclose(
                np.asarray(r.x, np.float64), xs, rtol=1e-3, atol=1e-4
            )

    def test_dia_band_halo_block_jacobi_beats_jacobi(self):
        # Badly block-scaled tridiagonal SPD: block Jacobi absorbs the
        # within-block coupling point Jacobi cannot.
        from tpucg.sparse.formats import COOMatrix, csr_to_dia

        rng = np.random.default_rng(5)
        n = 1100  # pads to 8*LANE-aligned shards
        d = np.exp(rng.uniform(0, 3, n))
        Ad = (
            np.diag(4.0 * np.ones(n))
            + np.diag(-np.ones(n - 1), 1)
            + np.diag(-np.ones(n - 1), -1)
        )
        Ad = d[:, None] * Ad * d[None, :]
        ii, jj = np.nonzero(Ad)
        csr = COOMatrix(
            row=ii, col=jj, data=Ad[ii, jj].astype(np.float32),
            shape=(n, n),
        ).to_csr()
        dia = csr_to_dia(csr)
        b = rng.standard_normal(n).astype(np.float32)
        xs = np.linalg.solve(Ad, b.astype(np.float64))
        tol = 1e-5 * float(np.linalg.norm(b))
        rj = sharded_operator_cg_solve(
            dia, b, tol=tol, maxiter=8 * n, precondition="jacobi"
        )
        rb = sharded_operator_cg_solve(
            dia, b, tol=tol, maxiter=8 * n,
            precondition="block_jacobi", pc_block_size=32,
        )
        assert bool(rb.converged)
        assert int(rb.iterations) < int(rj.iterations)
        np.testing.assert_allclose(
            np.asarray(rb.x, np.float64), xs, rtol=1e-3, atol=1e-4
        )
        # Serial/sharded recurrence parity on the same preconditioner.
        ser = tpucg.cg_solve(
            dia, b, tol=tol, maxiter=8 * n,
            precondition="block_jacobi", pc_block_size=32,
        )
        # Serial blocks span the whole matrix; sharded blocks restart per
        # shard — same M here because 32 divides the 128-row shards and
        # the band never crosses a 32-block... it does at boundaries, so
        # iteration counts may differ by a lap.
        assert abs(int(ser.iterations) - int(rb.iterations)) <= 2

    def test_well_sharded_block_jacobi_parity(self):
        from tpucg.io.generator import random_geometric_spd

        A, b, _ = random_geometric_spd(900, seed=1)
        n = A.shape[0]
        xs = np.linalg.solve(
            A.to_dense().astype(np.float64), b.astype(np.float64)
        )
        tol = 1e-5 * float(np.linalg.norm(b))
        rb = sharded_operator_cg_solve(
            A, b, tol=tol, maxiter=4 * n,
            precondition="block_jacobi", pc_block_size=32,
        )
        rj = sharded_operator_cg_solve(
            A, b, tol=tol, maxiter=4 * n, precondition="jacobi"
        )
        assert bool(rb.converged)
        assert int(rb.iterations) <= int(rj.iterations)
        np.testing.assert_allclose(
            np.asarray(rb.x, np.float64)[:n], xs, rtol=1e-3, atol=1e-4
        )

    def test_block_jacobi_composes_with_pipelined(self):
        m, n = 8, 512
        op = PoissonOperator(m=m)
        rng = np.random.default_rng(2)
        b = rng.standard_normal(n).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        base = sharded_operator_cg_solve(
            op, b, tol=tol, maxiter=4 * n,
            precondition="block_jacobi", pc_block_size=64,
        )
        pipe = sharded_operator_cg_solve(
            op, b, tol=tol, maxiter=4 * n, method="pipelined",
            precondition="block_jacobi", pc_block_size=64,
        )
        assert bool(base.converged) and bool(pipe.converged)
        assert abs(int(pipe.iterations) - int(base.iterations)) <= 1

    def test_ell_bsr_block_jacobi_rejected(self):
        from tpucg.sparse.formats import COOMatrix, csr_to_bsr

        n = 64
        ii = np.arange(n)
        csr = COOMatrix(
            row=ii, col=ii, data=np.full(n, 2.0, np.float32), shape=(n, n)
        ).to_csr()
        b = np.ones(n, np.float32)
        for bad in (EllOperator.from_csr(csr), csr_to_bsr(csr, 8)):
            with pytest.raises(ValueError, match="block_jacobi"):
                sharded_operator_cg_solve(
                    bad, b, precondition="block_jacobi", pc_block_size=8
                )
