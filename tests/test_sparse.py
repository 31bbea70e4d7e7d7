"""Sparse container round trips and the Poisson generator."""

import numpy as np
import pytest

from tpucg.io.generator import poisson3d_csr
from tpucg.sparse.formats import COOMatrix, csr_to_ell


def test_poisson_csr_structure():
    m = 4
    csr = poisson3d_csr(m)
    n = m**3
    assert csr.shape == (n, n)
    A = csr.to_dense()
    np.testing.assert_allclose(A, A.T)
    assert np.all(np.diag(A) == 6.0)
    # interior point has 6 neighbors
    assert csr.row_lengths.max() == 7
    assert csr.row_lengths.min() == 4  # corner: 3 neighbors + diag
    eigs = np.linalg.eigvalsh(A.astype(np.float64))
    assert eigs.min() > 0


def test_coo_csr_round_trip():
    rng = np.random.default_rng(0)
    n = 12
    row = rng.integers(0, n, 30)
    col = rng.integers(0, n, 30)
    val = rng.standard_normal(30).astype(np.float32)
    coo = COOMatrix(row=row, col=col, data=val, shape=(n, n))
    dense = coo.to_dense()
    csr = coo.to_csr()
    np.testing.assert_allclose(csr.to_dense(), dense, rtol=1e-6)
    back = csr.to_coo()
    np.testing.assert_allclose(back.to_dense(), dense, rtol=1e-6)


def test_csr_to_ell_padding():
    csr = poisson3d_csr(3)
    ell = csr_to_ell(csr, width_align=8)
    assert ell.row_width == 8  # max 7 nnz padded to 8
    # padded entries are zero-valued at column 0
    x = np.arange(csr.shape[0], dtype=np.float32)
    y_ell = (ell.values * x[ell.indices]).sum(axis=1)
    np.testing.assert_allclose(y_ell, csr.matvec(x), rtol=1e-5, atol=1e-5)


def test_csr_to_bsr_round_trip():
    from tpucg.sparse.formats import csr_to_bsr

    csr = poisson3d_csr(4)  # n=64, divisible by bs=4
    bsr = csr_to_bsr(csr, blocksize=4)
    np.testing.assert_allclose(bsr.to_dense(), csr.to_dense())
    assert bsr.blocksize == 4
    assert bsr.nnz == csr.nnz
    x = np.arange(csr.shape[0], dtype=np.float32)
    np.testing.assert_allclose(bsr.matvec(x), csr.matvec(x), rtol=1e-6)


def test_bsr_operator_spmv_and_diag():
    import jax.numpy as jnp

    from tpucg.solver.operators import BsrOperator
    from tpucg.sparse.formats import csr_to_bsr

    csr = poisson3d_csr(4)
    bsr = csr_to_bsr(csr, blocksize=8)
    op = BsrOperator.from_bsr(bsr)
    x = np.random.default_rng(0).standard_normal(csr.shape[0]).astype(
        np.float32
    )
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, csr.matvec(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(op.diagonal()), 6.0)


def test_cg_solve_accepts_bsr():
    import tpucg
    from tpucg.sparse.formats import csr_to_bsr

    csr = poisson3d_csr(4)
    n = csr.shape[0]
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    bsr = csr_to_bsr(csr, blocksize=4)
    r = tpucg.cg_solve(bsr, b, tol=tol, maxiter=10 * n)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-3)


def test_csr_to_dia_round_trip():
    from tpucg.sparse.formats import csr_to_dia

    csr = poisson3d_csr(4)
    dia = csr_to_dia(csr)
    assert dia.ndiag == 7
    assert set(dia.offsets.tolist()) == {-16, -4, -1, 0, 1, 4, 16}
    np.testing.assert_allclose(dia.to_dense(), csr.to_dense())
    x = np.arange(csr.shape[0], dtype=np.float32)
    np.testing.assert_allclose(dia.matvec(x), csr.matvec(x), rtol=1e-6)


def test_dia_operator_spmv_and_solve():
    import jax.numpy as jnp

    import tpucg
    from tpucg.solver.operators import DiaOperator
    from tpucg.sparse.formats import csr_to_dia

    csr = poisson3d_csr(6)
    n = csr.shape[0]
    dia = csr_to_dia(csr)
    op = DiaOperator.from_dia(dia)  # auto: pads n=216 -> 256
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    xp = np.zeros(op.padded_n, np.float32)
    xp[:n] = x
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(xp)))[:n], csr.matvec(x),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(np.asarray(op.diagonal())[:n], 6.0)
    # The DIA operator keeps the logical shape (no alignment padding).
    op_x = DiaOperator.from_dia(dia)
    assert op_x.padded_n == n
    np.testing.assert_allclose(
        np.asarray(op_x.matvec(jnp.asarray(x))), csr.matvec(x),
        rtol=1e-5, atol=1e-5,
    )
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(dia, b, tol=tol, maxiter=4 * n,
                       precondition="jacobi")
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-3)


def test_dia_rejects_unbanded():
    from tpucg.sparse.formats import csr_to_dia

    rng = np.random.default_rng(1)
    n = 64
    coo = COOMatrix(
        row=rng.integers(0, n, 200),
        col=rng.integers(0, n, 200),
        data=rng.random(200).astype(np.float32),
        shape=(n, n),
    )
    with pytest.raises(ValueError, match="diagonals"):
        csr_to_dia(coo.to_csr(), max_diags=8)


def test_random_banded_dia_round_trip():
    """Property: random banded SPD matrices survive CSR<->DIA<->dense and
    agree on SpMV."""
    from tpucg.sparse.formats import COOMatrix, csr_to_bsr, csr_to_dia

    rng = np.random.default_rng(3)
    n, bw = 48, 5
    rows, cols, vals = [], [], []
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        rows.append(idx)
        cols.append(idx + off)
        v = rng.random(idx.size).astype(np.float32)
        if off == 0:
            v += 4 * bw  # diagonal dominance
        vals.append(v)
    coo = COOMatrix(
        row=np.concatenate(rows), col=np.concatenate(cols),
        data=np.concatenate(vals), shape=(n, n),
    )
    csr = coo.to_csr()
    dia = csr_to_dia(csr)
    np.testing.assert_allclose(dia.to_dense(), csr.to_dense(), rtol=1e-6)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(dia.matvec(x), csr.matvec(x), rtol=1e-5,
                               atol=1e-5)
    bsr = csr_to_bsr(csr, blocksize=4)
    np.testing.assert_allclose(bsr.matvec(x), csr.matvec(x), rtol=1e-5,
                               atol=1e-5)


def test_dia_spmv_matches_host():
    """``dia_spmv`` (the XLA shift-and-add every DIA operator runs) vs the
    host oracle over offsets of every size class — within a 128-row tile,
    exactly one tile, and beyond it — of both signs."""
    import jax.numpy as jnp

    from tpucg.kernels.spmv import dia_spmv
    from tpucg.sparse.formats import DIAMatrix

    rng = np.random.default_rng(7)
    n = 1024
    offsets = (-257, -128, -3, 0, 1, 127, 128, 300)
    data = rng.standard_normal((len(offsets), n)).astype(np.float32)
    # Zero entries whose column falls outside [0, n) — the DIA contract.
    idx = np.arange(n)
    for d, off in enumerate(offsets):
        cols = idx + off
        data[d, (cols < 0) | (cols >= n)] = 0.0
    dia = DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(n, n))
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(dia_spmv(jnp.asarray(data), offsets, jnp.asarray(x)))
    np.testing.assert_allclose(y, dia.matvec(x), rtol=1e-5, atol=1e-4)


def test_dia_poisson_parity():
    """poisson3d_dia == csr path: the DIA operator's matvec matches the
    matrix-free stencil and the host CSR on the m=16 grid (n=4096)."""
    import jax.numpy as jnp

    from tpucg.io.generator import poisson3d_csr, poisson3d_dia
    from tpucg.solver.operators import DiaOperator, PoissonOperator

    m = 16
    dia = poisson3d_dia(m)
    n = m ** 3
    op = DiaOperator.from_dia(dia)
    assert op.padded_n == n
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    y_s = np.asarray(PoissonOperator(m=m).matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, y_s, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(y, poisson3d_csr(m).matvec(x), rtol=1e-5,
                               atol=1e-4)


def test_dia_unaligned_solve():
    """A non-128-divisible banded system: the DIA operator keeps the logical
    size (no padding) and the CG solve matches."""
    import tpucg
    from tpucg.sparse.formats import COOMatrix, csr_to_dia
    from tpucg.solver.operators import DiaOperator

    rng = np.random.default_rng(5)
    n, bw = 200, 2  # pads to 256
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
    op = DiaOperator.from_dia(dia)
    assert op.padded_n == n and op.n == n
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-3)


def test_best_sparse_operator_promotion():
    """Auto-promotion picks DIA for banded, BSR for blocky-unbanded, ELL for
    scattered; solves work through each choice end-to-end."""
    import tpucg
    from tpucg.solver.operators import (
        BsrOperator,
        DiaOperator,
        EllOperator,
        best_sparse_operator,
    )

    # Banded (Poisson) -> DIA.
    csr = poisson3d_csr(6)
    op = best_sparse_operator(csr)
    assert isinstance(op, DiaOperator)
    n = csr.shape[0]
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    r = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-3)

    # Block-dense but diagonal-scattered -> BSR (n=100 also exercises the
    # identity pad to the blocksize).
    nb, bs = 100, 8
    npad_b = 13 * bs  # 104
    rng2 = np.random.default_rng(4)
    A = np.zeros((nb, nb), np.float32)
    # random dense 8x8 blocks scattered off a block-diagonal spine
    for br in range(nb // bs):
        A[br*bs:(br+1)*bs, br*bs:(br+1)*bs] = rng2.random((bs, bs))
        bc = int(rng2.integers(0, nb // bs))
        A[br*bs:(br+1)*bs, bc*bs:(bc+1)*bs] = rng2.random((bs, bs))
    A = 0.5 * (A + A.T) + nb * np.eye(nb, dtype=np.float32)
    from tpucg.sparse.formats import COOMatrix

    rr, cc = np.nonzero(A)
    csr2 = COOMatrix(row=rr, col=cc, data=A[rr, cc], shape=A.shape).to_csr()
    op2 = best_sparse_operator(csr2, max_diags=8)
    assert isinstance(op2, BsrOperator)
    assert op2.n == nb and op2.padded_n == npad_b
    b2 = rng2.random(nb).astype(np.float32)
    r2 = tpucg.cg_solve(op2, b2, maxiter=4 * nb)
    assert bool(r2.converged)
    np.testing.assert_allclose(A @ np.asarray(r2.x), b2, atol=1e-4 * nb)

    # Scattered scalars -> ELL.
    n3 = 96
    rng3 = np.random.default_rng(5)
    rows = rng3.integers(0, n3, 300)
    cols = rng3.integers(0, n3, 300)
    vals = rng3.random(300).astype(np.float32)
    M = np.zeros((n3, n3), np.float32)
    np.add.at(M, (rows, cols), vals)
    M = 0.5 * (M + M.T) + n3 * np.eye(n3, dtype=np.float32)
    rr3, cc3 = np.nonzero(M)
    csr3 = COOMatrix(
        row=rr3, col=cc3, data=M[rr3, cc3], shape=M.shape
    ).to_csr()
    # Scattered scalars now promote to WELL by default; fallback="ell"
    # restores the legacy arm (both solve identically).
    op3 = best_sparse_operator(csr3, max_diags=8, bsr_fill_cap=1.2)
    assert isinstance(op3, tpucg.WellOperator)
    op3e = best_sparse_operator(csr3, max_diags=8, bsr_fill_cap=1.2,
                                fallback="ell")
    assert isinstance(op3e, EllOperator)
    b3 = rng3.random(n3).astype(np.float32)
    r3w = tpucg.cg_solve(op3, b3, maxiter=4 * n3)
    assert bool(r3w.converged)
    np.testing.assert_allclose(
        M @ np.asarray(r3w.x)[:n3], b3, atol=1e-4 * n3)
    r3 = tpucg.cg_solve(op3e, b3, maxiter=4 * n3)
    assert bool(r3.converged)
    np.testing.assert_allclose(M @ np.asarray(r3.x), b3, atol=1e-4 * n3)


def test_csr_to_dia_sums_unsorted_duplicates():
    """Regression (round-2 review): duplicate (row, col) entries must SUM
    even when non-adjacent/unsorted within a row (CSRMatrix guarantees
    neither merging nor column order)."""
    from tpucg.sparse.formats import CSRMatrix, csr_to_dia

    # Row 0: cols [3, 1, 3] — duplicate col 3, NOT adjacent.
    indptr = np.array([0, 3, 3, 3, 3], dtype=np.int64)
    indices = np.array([3, 1, 3], dtype=np.int32)
    data = np.array([2.0, 5.0, 7.0], dtype=np.float32)
    csr = CSRMatrix(indptr=indptr, indices=indices, data=data, shape=(4, 4))
    dia = csr_to_dia(csr)
    A = dia.to_dense()
    assert A[0, 3] == 9.0  # 2 + 7 summed, not last-write-wins
    assert A[0, 1] == 5.0


def test_dia_fuzz_random_offset_sets():
    """Property: ``dia_spmv`` matches the host oracle for randomized banded
    structures (random offset sets of both signs, random sizes)."""
    _dia_fuzz(halo=False)


def test_dia_halo_fuzz_random_offset_sets():
    """The same product taken block by block through ``dia_spmv_halo`` with
    the neighbours' elements as halos — the per-shard form of the
    band-halo decomposition — matches the host oracle."""
    _dia_fuzz(halo=True)


def _dia_fuzz(halo):
    import jax.numpy as jnp

    from tpucg.kernels.spmv import dia_halo_width, dia_spmv, dia_spmv_halo
    from tpucg.sparse.formats import DIAMatrix

    rng = np.random.default_rng(17)
    for trial in range(6):
        nblk = 4
        blk = int(rng.integers(16, 200))
        n = nblk * blk
        ndiag = int(rng.integers(1, 9))
        offs = set()
        while len(offs) < ndiag:
            offs.add(int(rng.integers(-blk, blk + 1)))
        offsets = tuple(sorted(offs))
        data = rng.standard_normal((len(offsets), n)).astype(np.float32)
        idx = np.arange(n)
        for d, off in enumerate(offsets):
            cols = idx + off
            data[d, (cols < 0) | (cols >= n)] = 0.0
        dia = DIAMatrix(
            offsets=np.asarray(offsets), data=data, shape=(n, n)
        )
        x = rng.standard_normal(n).astype(np.float32)
        if not halo:
            y = np.asarray(dia_spmv(jnp.asarray(data), offsets,
                                    jnp.asarray(x)))
        else:
            w = dia_halo_width(offsets)
            xp = np.concatenate([np.zeros(w, np.float32), x,
                                 np.zeros(w, np.float32)])
            y = np.concatenate([
                np.asarray(dia_spmv_halo(
                    jnp.asarray(data[:, i * blk:(i + 1) * blk]), offsets,
                    jnp.asarray(x[i * blk:(i + 1) * blk]),
                    jnp.asarray(xp[i * blk:i * blk + w]),
                    jnp.asarray(xp[(i + 1) * blk + w:(i + 1) * blk + 2 * w]),
                ))
                for i in range(nblk)
            ])
        np.testing.assert_allclose(
            y, dia.matvec(x), rtol=1e-5, atol=1e-4,
            err_msg=f"trial={trial} n={n} offsets={offsets}",
        )


class TestDiaBf16Storage:
    """bfloat16 DIA slab storage (f32 accumulate) — the sparse analog of
    the dense solver's storage_dtype extension."""

    def test_matvec_and_solve_exact_on_poisson(self):
        # Poisson slab values (6, -1, 1) are exactly bf16-representable, so
        # bf16 storage must match f32 bit-for-bit through matvec and solve.
        import jax.numpy as jnp

        import tpucg
        from tpucg.io.generator import poisson3d_dia
        from tpucg.solver.operators import DiaOperator

        m = 8
        n = m ** 3
        dia = poisson3d_dia(m)
        op32 = DiaOperator.from_dia(dia)
        op16 = DiaOperator.from_dia(dia, storage_dtype=jnp.bfloat16)
        assert op16.data.dtype == jnp.bfloat16
        x = np.random.default_rng(50).standard_normal(
            op32.padded_n).astype(np.float32)
        y32 = np.asarray(op32.matvec(jnp.asarray(x)))
        y16 = np.asarray(op16.matvec(jnp.asarray(x)))
        np.testing.assert_array_equal(y32, y16)
        b = np.random.default_rng(51).standard_normal(n).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        r32 = tpucg.cg_solve(op32, b, tol=tol)
        r16 = tpucg.cg_solve(op16, b, tol=tol)
        assert bool(r16.converged)
        assert int(r16.iterations) == int(r32.iterations)
        np.testing.assert_allclose(np.asarray(r16.x), np.asarray(r32.x),
                                   rtol=1e-4, atol=1e-5)

    def test_fused_dispatch_and_random_band(self):
        # Random-valued band: bf16 rounds A (rel ~1e-2); the solve
        # converges on the ROUNDED system (f32 contract on bf16 A) through
        # the jitted while_loop, the only solve path.
        import jax.numpy as jnp

        import tpucg
        from tpucg.solver.operators import DiaOperator
        from tpucg.sparse.formats import DIAMatrix

        n = 1024
        rng = np.random.default_rng(52)
        off = rng.uniform(0.5, 1.5, n).astype(np.float32)
        data = np.stack([off, np.full(n, 8.0, np.float32), off])
        dia = DIAMatrix(data=data, offsets=(-1, 0, 1), shape=(n, n))
        op16 = DiaOperator.from_dia(dia, storage_dtype=jnp.bfloat16)
        assert op16.data.dtype == jnp.bfloat16 and op16.padded_n == n
        b = rng.standard_normal(n).astype(np.float32)
        tol = 1e-4 * float(np.linalg.norm(b))
        res = tpucg.cg_solve(op16, b, tol=tol)
        assert bool(res.converged)
        # Accuracy vs the f32 system is bounded by the bf16 rounding.
        ref = tpucg.cg_solve(DiaOperator.from_dia(dia), b, tol=tol)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                                   rtol=2e-2, atol=2e-2)

    def test_sharded_dia_bf16(self):
        import jax.numpy as jnp

        import tpucg
        from tpucg.io.generator import poisson3d_dia
        from tpucg.solver.operators import DiaOperator

        m = 8
        n = m ** 3
        op = DiaOperator.from_dia(poisson3d_dia(m))
        b = np.random.default_rng(53).standard_normal(n).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        r32 = tpucg.sharded_operator_cg_solve(op, b, tol=tol)
        r16 = tpucg.sharded_operator_cg_solve(op, b, tol=tol,
                                              storage_dtype=jnp.bfloat16)
        assert bool(r16.converged)
        np.testing.assert_allclose(np.asarray(r16.x), np.asarray(r32.x),
                                   rtol=1e-4, atol=1e-5)
        from tpucg.solver.operators import PoissonOperator

        with pytest.raises(ValueError, match="storage_dtype"):
            tpucg.sharded_operator_cg_solve(
                PoissonOperator(m=m), b, storage_dtype=jnp.bfloat16)
