"""WELL (windowed gather-ELL) format + kernel tests.

The irregular-sparse path (VERDICT round 2, next #1): builder invariants,
host/XLA/Pallas-interpret matvec parity against the CSR oracle, operator
integration (diagonal, auto-promotion, CG solve), and the ordering module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.io.generator import random_geometric_graph_csr, random_geometric_spd
from tpucg.sparse.formats import COOMatrix, CSRMatrix
from tpucg.sparse.ordering import permute_csr, rcm_order
from tpucg.sparse.well import csr_to_well


def _random_csr(n, density, seed=0, symmetric=True):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < density
    if symmetric:
        m |= m.T
    np.fill_diagonal(m, True)
    r, c = np.nonzero(m)
    v = rng.standard_normal(r.size)
    return COOMatrix(row=r, col=c, data=v, shape=(n, n)).to_csr()


def _pad(v, n):
    out = np.zeros(n, np.float32)
    out[: v.size] = v
    return out


@pytest.mark.parametrize("n,density", [(40, 0.3), (300, 0.05), (1000, 0.01)])
def test_well_host_matvec_matches_csr(n, density):
    A = _random_csr(n, density, seed=n)
    well = csr_to_well(A)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    ref = A.matvec(x.astype(np.float64))
    got = well.matvec(x)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4)


def test_well_builder_invariants():
    A = _random_csr(777, 0.01, seed=7)
    well = csr_to_well(A)
    BS = well.block_sublanes
    assert well.vals.shape[0] % BS == 0
    assert well.wrow.shape == (well.n_sublanes // 8,)
    assert well.gidl.shape == (well.n_blocks, BS)
    assert well.sgb.shape == (well.n_blocks,)
    # Super-group ids are nondecreasing and cover every super-group.
    assert (np.diff(well.sgb) >= 0).all()
    assert set(well.sgb.tolist()) == set(range(well.n_supergroups))
    # Identity tail: padded rows n..G*128 carry a unit diagonal.
    d = np.zeros(well.n_groups * 128)
    # Reconstruct the diagonal from storage.
    g_of_sub = (
        np.repeat(well.sgb.astype(np.int64), BS) * well.groups_per_super
        + well.gidl.reshape(-1)
    )
    rows = g_of_sub[:, None] * 128 + np.arange(128)[None, :]
    cols = well.wrow_per_sublane()[:, None].astype(np.int64) * 128 \
        + well.lidx.astype(np.int64)
    mask = (rows == cols) & (well.vals != 0)
    np.add.at(d, rows[mask], well.vals[mask])
    assert (d[777: well.n_groups * 128] == 1.0).all()
    # Lane indices stay in [0, 128).
    assert well.lidx.min() >= 0 and well.lidx.max() < 128


def test_well_operator_matvec():
    n = 500
    A = _random_csr(n, 0.02, seed=5)
    op = tpucg.WellOperator.from_csr(A)
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    y = np.asarray(op.matvec(jnp.asarray(_pad(x, op.padded_n))))[:n]
    ref = A.matvec(x.astype(np.float64))
    np.testing.assert_allclose(y, ref, rtol=2e-5, atol=1e-4)


def test_well_operator_diagonal():
    n = 300
    A = _random_csr(n, 0.03, seed=9)
    op = tpucg.WellOperator.from_csr(A)
    d = np.asarray(op.diagonal())
    np.testing.assert_allclose(d[:n], np.diag(A.to_dense()), rtol=1e-6,
                               atol=1e-6)
    assert (d[n:] == 1.0).all()  # identity tail


def test_well_empty_and_tiny():
    # All-zero matrix
    A = CSRMatrix(indptr=np.zeros(6, np.int64),
                  indices=np.zeros(0, np.int32),
                  data=np.zeros(0, np.float32), shape=(5, 5))
    well = csr_to_well(A)
    y = well.matvec(np.ones(5, np.float32))
    np.testing.assert_array_equal(y, np.zeros(5))
    # 1x1
    A1 = CSRMatrix(indptr=np.array([0, 1]), indices=np.array([0], np.int32),
                   data=np.array([3.0], np.float32), shape=(1, 1))
    np.testing.assert_allclose(csr_to_well(A1).matvec(np.array([2.0],
                               np.float32)), [6.0])


def test_well_duplicate_entries_sum():
    # COO with a repeated (row, col) must contribute the sum.
    coo = COOMatrix(row=np.array([0, 0, 1]), col=np.array([1, 1, 0]),
                    data=np.array([2.0, 3.0, 4.0], np.float32), shape=(2, 2))
    well = csr_to_well(coo.to_csr())
    y = well.matvec(np.array([1.0, 1.0], np.float32))
    np.testing.assert_allclose(y, [5.0, 4.0])


def test_well_cg_solve_irregular():
    A, b, x0 = random_geometric_spd(2000, seed=3, avg_degree=8.0)
    op = tpucg.WellOperator.from_csr(A)
    res = tpucg.cg_solve(op, b, tol=1e-5 * float(np.linalg.norm(b)))
    assert bool(res.converged)
    x = np.asarray(res.x)[: A.shape[0]]
    r = b - A.matvec(x)
    assert np.linalg.norm(r) <= 1.1e-5 * np.linalg.norm(b)


def test_well_cg_jacobi_preconditioned():
    A, b, _ = random_geometric_spd(1500, seed=4, avg_degree=8.0, shift=0.3)
    op = tpucg.WellOperator.from_csr(A)
    tol = 1e-5 * float(np.linalg.norm(b))
    plain = tpucg.cg_solve(op, b, tol=tol)
    pcg = tpucg.cg_solve(op, b, tol=tol, precondition="jacobi")
    assert bool(pcg.converged)
    assert int(pcg.iterations) <= int(plain.iterations)


def test_best_sparse_operator_promotes_irregular_to_well():
    A, _, _ = random_geometric_spd(1000, seed=6, avg_degree=9.0)
    op = tpucg.best_sparse_operator(A)
    assert isinstance(op, tpucg.WellOperator)
    # Banded still promotes to DIA, blocky to BSR (unchanged behavior).
    from tpucg.io.generator import poisson3d_csr

    assert isinstance(tpucg.best_sparse_operator(poisson3d_csr(8)),
                      tpucg.DiaOperator)
    # fallback="ell" restores the legacy arm.
    assert isinstance(tpucg.best_sparse_operator(A, fallback="ell"),
                      tpucg.EllOperator)


def test_random_geometric_graph_properties():
    adj = random_geometric_graph_csr(500, seed=1, avg_degree=8.0)
    dense = adj.to_dense()
    np.testing.assert_array_equal(dense, dense.T)
    assert np.diag(dense).sum() == 0
    avg = adj.nnz / 500
    assert 3.0 < avg < 16.0
    # Laplacian-based SPD system: strictly positive definite via shift.
    A, b, x0 = random_geometric_spd(500, seed=1, avg_degree=8.0, shift=0.5)
    Ad = A.to_dense()
    np.testing.assert_allclose(Ad, Ad.T, atol=0)
    w = np.linalg.eigvalsh(Ad)
    assert w.min() >= 0.49


def test_rcm_reduces_bandwidth_and_preserves_matvec():
    A = random_geometric_graph_csr(3000, seed=2, avg_degree=7.0, shuffle=True)
    # add a diagonal so every row is nonempty
    coo = A.to_coo()
    n = A.shape[0]
    rows = np.concatenate([coo.row, np.arange(n)])
    cols = np.concatenate([coo.col, np.arange(n)])
    vals = np.concatenate([coo.data, np.full(n, 8.0, A.data.dtype)])
    A = COOMatrix(row=rows, col=cols, data=vals, shape=A.shape).to_csr()
    perm = rcm_order(A)
    assert sorted(perm.tolist()) == list(range(n))
    B = permute_csr(A, perm)
    bw_a = np.abs(A.to_coo().col - A.to_coo().row).max()
    bw_b = np.abs(B.to_coo().col - B.to_coo().row).max()
    assert bw_b < bw_a
    # P A P^T acts like A under the permutation.
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    np.testing.assert_allclose(B.matvec(x[perm]), A.matvec(x)[perm],
                               rtol=1e-5, atol=1e-5)
    # RCM typically improves WELL fill on shuffled inputs. Small block
    # size so the comparison measures packing, not block-padding floors.
    f_before = csr_to_well(A, block_sublanes=64, groups_per_super=8).fill
    f_after = csr_to_well(B, block_sublanes=64, groups_per_super=8).fill
    assert f_after > f_before


def test_well_bf16_values_storage():
    """bfloat16 value storage (3.5 B/slot): exact on bf16-representable
    values, ~1e-2 relative on random ones; sharded arm accepts it too."""
    import jax.numpy as jnp

    import tpucg
    from tpucg.io.generator import random_geometric_spd
    from tpucg.solver.operators import WellOperator

    A, b, _ = random_geometric_spd(2000, seed=5, avg_degree=8.0)
    op32 = WellOperator.from_csr(A)
    op16 = WellOperator.from_csr(A, storage_dtype=jnp.bfloat16)
    assert op16.vals.dtype == jnp.bfloat16
    x = np.random.default_rng(6).standard_normal(op32.padded_n).astype(
        np.float32)
    y32 = np.asarray(op32.matvec(jnp.asarray(x)))
    y16 = np.asarray(op16.matvec(jnp.asarray(x)))
    rel = np.abs(y32 - y16).max() / (np.abs(y32).max() + 1e-30)
    assert rel < 2e-2, rel
    tol = 1e-3 * float(np.linalg.norm(b))
    res = tpucg.cg_solve(op16, b, tol=tol)
    assert bool(res.converged)
    # Sharded WELL with bf16 value slabs.
    sh16 = tpucg.sharded_operator_cg_solve(A, b, tol=tol,
                                           storage_dtype=jnp.bfloat16)
    assert bool(sh16.converged)
    np.testing.assert_allclose(np.asarray(sh16.x)[:2000],
                               np.asarray(res.x)[:2000],
                               rtol=2e-2, atol=2e-2)


def test_well_block_jacobi_preconditioned():
    """WELL block Jacobi: blocks extracted host-side from the source CSR
    at construction (pc_block_size=...); exact extraction checked against
    the dense matrix, fewer laps than point Jacobi on a block-coupled
    system, and the solution matches the f64 direct solve."""
    from tpucg.sparse.formats import csr_diagonal_blocks

    A, b, _ = random_geometric_spd(700, seed=0, shift=0.3)
    n = A.shape[0]
    D = A.to_dense().astype(np.float64)
    bs = 48  # 16 blocks over padded_n=768; rows >= n take identity
    blocks = np.asarray(csr_diagonal_blocks(A, bs, npad=768))
    for q in (0, 7, 15):
        lo = q * bs
        ref = np.eye(bs)
        for i in range(bs):
            for j in range(bs):
                gi, gj = lo + i, lo + j
                if gi < n and gj < n:
                    ref[i, j] = D[gi, gj]
                elif i != j:
                    ref[i, j] = 0.0
        np.testing.assert_allclose(blocks[q], ref, rtol=1e-6, atol=1e-7)

    op = tpucg.WellOperator.from_csr(A, pc_block_size=bs)
    tol = 1e-6
    pj = tpucg.cg_solve(op, b, tol=tol, precondition="jacobi")
    pb = tpucg.cg_solve(op, b, tol=tol, precondition="block_jacobi",
                        pc_block_size=bs)
    assert bool(pb.converged)
    assert int(pb.iterations) <= int(pj.iterations)
    xs = np.linalg.solve(D, b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(pb.x, np.float64)[:n], xs,
                               rtol=1e-3, atol=1e-4)


def test_well_block_jacobi_requires_construction_blocks():
    A, b, _ = random_geometric_spd(300, seed=2)
    op = tpucg.WellOperator.from_csr(A)  # no pc_block_size
    with pytest.raises(NotImplementedError, match="pc_block_size"):
        tpucg.cg_solve(op, b, precondition="block_jacobi", pc_block_size=16)
    op2 = tpucg.WellOperator.from_csr(A, pc_block_size=16)
    with pytest.raises(ValueError, match="pc_block_size"):
        tpucg.cg_solve(op2, b, precondition="block_jacobi",
                       pc_block_size=32)


def test_best_sparse_operator_threads_pc_block_size():
    A, b, _ = random_geometric_spd(600, seed=8)
    op = tpucg.best_sparse_operator(A, pc_block_size=32)
    assert isinstance(op, tpucg.WellOperator)
    r = tpucg.cg_solve(op, b, tol=1e-6, precondition="block_jacobi",
                       pc_block_size=32)
    assert bool(r.converged)
