"""Two-level (AMG-lite) preconditioner tests.

The round-4 iteration-count answer for FEM-class irregular systems
(``tpucg.solver.twolevel``): contiguous-aggregate coarse space (restriction
= reshape-sum, prolongation = broadcast, coarse solve = one dense GEMV
against a precomputed f64 inverse) wrapped in a symmetric V(1,1) damped-
Jacobi cycle. These tests pin (a) correctness on the goldens-by-proxy
(solution parity with plain CG), (b) the SPD structure PCG requires,
(c) the lap-count win vs point Jacobi on a mesh Laplacian, and (d) the
validation surface (npad / method / precondition mismatches fail loudly).
"""

import numpy as np
import pytest

import tpucg
from tpucg.io.generator import fem_p1_system, random_geometric_spd


@pytest.fixture(scope="module")
def fem():
    A, b, x0 = fem_p1_system(6_000, seed=0)
    return A, b, x0


def test_two_level_matches_plain_cg_solution(fem):
    A, b, _ = fem
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    # above the n=6k FEM TRUE-residual f32 floor (~4e-4 ||b||) — round
    # 5's true-residual stopping refuses tolerances the recurrence only
    # pretended to reach
    tol = 1e-3 * float(np.linalg.norm(b))
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    plain = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n)
    two = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl)
    assert bool(two.converged)
    # Both solve the same system; compare through the true residual (the
    # f32 recurrence drift bounds how close the x's themselves get).
    res_two = np.linalg.norm(b - A.matvec(np.asarray(two.x, np.float64)))
    res_plain = np.linalg.norm(
        b - A.matvec(np.asarray(plain.x, np.float64))
    )
    assert res_two < 10 * max(res_plain, tol)


def test_two_level_cuts_fem_laps_vs_jacobi(fem):
    A, b, _ = fem
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tol = 1e-3 * float(np.linalg.norm(b))
    jac = tpucg.cg_solve(
        op, b, tol=tol, maxiter=4 * n, precondition="jacobi"
    )
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    two = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl)
    assert bool(two.converged)
    # The design target (VERDICT round-3 item 1): a multiple-of-laps win.
    # At the HONEST (true-residual) tolerance the small-n gap narrows
    # (64 vs 172 here); the >=3x wins live at n>=300k (RESULTS.md).
    assert int(two.iterations) * 2 <= int(jac.iterations)


def test_two_level_preconditioner_is_spd():
    # PCG requires M fixed and SPD: materialize B = precond(I) on a small
    # FEM system and check symmetry + positive eigenvalues.
    import jax
    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla
    from tpucg.solver.twolevel import make_two_level_precond

    A, b, _ = fem_p1_system(900, seed=1)
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    pc = make_two_level_precond(tl, op.matvec, dot_xla, jnp.asarray(b))
    B = np.asarray(
        jax.jit(jax.vmap(pc, in_axes=1, out_axes=1))(
            jnp.eye(n, dtype=jnp.float32)
        )
    )
    assert np.abs(B - B.T).max() <= 1e-5 * np.abs(B).max()
    w = np.linalg.eigvalsh(0.5 * (B + B.T).astype(np.float64))
    assert w.min() > 0


def test_two_level_on_well_operator():
    # The target pipeline: irregular CSR -> WELL,
    # two-level built against the WELL padding (round_up(n, 128) default).
    A, b, _ = random_geometric_spd(20_000, seed=0, avg_degree=12.0,
                                   shift=0.05)
    n = A.shape[0]
    op = tpucg.WellOperator.from_csr(A)
    tol = 1e-5 * float(np.linalg.norm(b))
    tl = tpucg.build_two_level(A, agg_size=64)
    assert tl.npad == op.padded_n
    jac = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n,
                         precondition="jacobi")
    two = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl)
    assert bool(two.converged)
    assert int(two.iterations) < int(jac.iterations)
    res = np.linalg.norm(b - A.matvec(np.asarray(two.x, np.float64)))
    assert res < 100 * tol


def test_two_level_validation(fem):
    A, b, _ = fem
    op = tpucg.EllOperator.from_csr(A)
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    with pytest.raises(ValueError, match="padded size"):
        bad = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n + 128)
        tpucg.cg_solve(op, b, two_level=bad)
    with pytest.raises(ValueError, match="method='cg'"):
        tpucg.cg_solve(op, b, two_level=tl, method="chebyshev")
    with pytest.raises(ValueError, match="precondition"):
        tpucg.cg_solve(op, b, two_level=tl, precondition="jacobi")
    with pytest.raises(ValueError, match="agg_size"):
        tpucg.build_two_level(A, agg_size=1)
    with pytest.raises(ValueError, match="square"):
        from tpucg.sparse.formats import COOMatrix

        tpucg.build_two_level(
            COOMatrix(
                row=np.array([0]), col=np.array([0]),
                data=np.array([1.0], np.float32), shape=(2, 3),
            ).to_csr()
        )


def test_two_level_sharded_matches_serial():
    # Row-block-sharded two-level on the WELL decomposition (8-device CPU
    # mesh): same preconditioner algebra, shard-local restrict/prolong,
    # one (nc,) all_gather per apply. Lap counts must track the serial
    # solve closely (identical math, different reduction order).
    import jax

    A, b, _ = random_geometric_spd(20_000, seed=2, avg_degree=12.0,
                                   shift=0.05)
    n = A.shape[0]
    num = len(jax.devices())
    tol = 1e-5 * float(np.linalg.norm(b))
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl_sh = tpucg.build_two_level(A, agg_size=64, npad=npad_sh)
    sh = tpucg.sharded_operator_cg_solve(
        A, b, tol=tol, maxiter=4 * n, two_level=tl_sh
    )
    assert bool(sh.converged)

    op = tpucg.WellOperator.from_csr(A)
    tl = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n)
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl)
    # lap counts quantize to the true-check cadence (16): one quantum
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 16
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-2, atol=1e-4
    )


def test_two_level_sharded_dia():
    # The band-halo DIA decomposition takes the same two_level argument
    # (the closure only needs the sharded matvec + dinv + coarse inverse).
    import jax

    from tpucg.io.generator import poisson3d_dia

    dia = poisson3d_dia(16)
    n = 16 ** 3
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n).astype(np.float32)
    num = len(jax.devices())
    tol = 1e-5 * float(np.linalg.norm(b))
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl = tpucg.build_two_level(
        tpucg.poisson3d_csr(16), agg_size=64, npad=npad_sh
    )
    two = tpucg.sharded_operator_cg_solve(
        dia, b, tol=tol, maxiter=4 * n, two_level=tl
    )
    plain = tpucg.sharded_operator_cg_solve(dia, b, tol=tol, maxiter=4 * n)
    assert bool(two.converged)
    assert int(two.iterations) < int(plain.iterations)
    np.testing.assert_allclose(
        np.asarray(two.x), np.asarray(plain.x), rtol=1e-2, atol=1e-4
    )


def test_two_level_sharded_validation():
    A, b, _ = random_geometric_spd(5_000, seed=3, avg_degree=10.0)
    tl = tpucg.build_two_level(A, agg_size=64)  # serial npad: wrong here
    import jax

    num = len(jax.devices())
    npad_sh = -(-A.shape[0] // (128 * num)) * (128 * num)
    if npad_sh != tl.npad:
        with pytest.raises(ValueError, match="sharded decomposition"):
            tpucg.sharded_operator_cg_solve(A, b, two_level=tl)
    tl_badagg = tpucg.build_two_level(A, agg_size=3 * 128, npad=npad_sh)
    if (npad_sh // num) % (3 * 128):
        with pytest.raises(ValueError, match="rows-per-shard"):
            tpucg.sharded_operator_cg_solve(A, b, two_level=tl_badagg)
    with pytest.raises(ValueError, match="method='cg'"):
        tpucg.sharded_operator_cg_solve(A, b, two_level=tl, method="ca")


def test_two_level_pipelined_serial(fem):
    # The method x preconditioner cell the round-4 guard closed off: the
    # cycle is a fixed SPD operator, so pipelined PCG (Ghysels-Vanroose,
    # with the measured-mandatory residual replacement —
    # solver.cg.PIPE_REPLACE_EVERY) takes it directly; iterates track the
    # classic PCG ones within recurrence drift. Tolerance sits above the
    # method's f32 attainable-accuracy floor on FEM (~1e-4 ||b|| here;
    # classic PCG reaches ~10x lower — that trade IS the method).
    A, b, _ = fem
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tol = 1e-3 * float(np.linalg.norm(b))
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    classic = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl)
    pipe = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl,
                          method="pipelined")
    assert bool(pipe.converged)
    # classic laps quantize to the true-check cadence (16); pipelined
    # tests per lap
    assert abs(int(pipe.iterations) - int(classic.iterations)) <= 18
    res = np.linalg.norm(b - A.matvec(np.asarray(pipe.x, np.float64)))
    assert res <= 2.0 * tol


def test_two_level_pipelined_sharded():
    # Distributed: the strong preconditioner + the latency-hiding method
    # (one fused scalar psum per lap; the cycle's coarse all_gather is
    # dataflow-independent of the lap's scalars) on the sharded WELL
    # decomposition.
    import jax

    A, b, _ = random_geometric_spd(20_000, seed=2, avg_degree=12.0,
                                   shift=0.05)
    n = A.shape[0]
    num = len(jax.devices())
    tol = 1e-5 * float(np.linalg.norm(b))
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl_sh = tpucg.build_two_level(A, agg_size=64, npad=npad_sh)
    pipe = tpucg.sharded_operator_cg_solve(
        A, b, tol=tol, maxiter=4 * n, two_level=tl_sh, method="pipelined"
    )
    classic = tpucg.sharded_operator_cg_solve(
        A, b, tol=tol, maxiter=4 * n, two_level=tl_sh
    )
    assert bool(pipe.converged)
    # classic laps quantize to the true-check cadence (16)
    assert abs(int(pipe.iterations) - int(classic.iterations)) <= 18
    np.testing.assert_allclose(
        np.asarray(pipe.x), np.asarray(classic.x), rtol=1e-2, atol=1e-4
    )


def test_two_level_chebyshev_smoother(fem):
    # smooth_degree >= 2: the l-step Chebyshev smoother on the upper
    # spectrum of D^-1 A — measurably fewer laps than the Jacobi cycle
    # (measured 68 vs 123 at n~30k), same SPD structure.
    A, b, _ = fem
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tol = 1e-3 * float(np.linalg.norm(b))
    tl1 = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n)
    tl2 = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n,
                                smooth_degree=2)
    r1 = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl1)
    r2 = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl2)
    assert bool(r2.converged)
    assert int(r2.iterations) <= int(r1.iterations)
    res = np.linalg.norm(b - A.matvec(np.asarray(r2.x, np.float64)))
    assert res < 100 * tol
    with pytest.raises(ValueError, match="smooth_degree"):
        tpucg.build_two_level(A, agg_size=64, smooth_degree=0)


def test_two_level_chebyshev_smoother_is_spd():
    import jax
    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla
    from tpucg.solver.twolevel import make_two_level_precond

    A, b, _ = fem_p1_system(900, seed=1)
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n,
                               smooth_degree=3)
    pc = make_two_level_precond(tl, op.matvec, dot_xla, jnp.asarray(b))
    B = np.asarray(
        jax.jit(jax.vmap(pc, in_axes=1, out_axes=1))(
            jnp.eye(n, dtype=jnp.float32)
        )
    )
    assert np.abs(B - B.T).max() <= 1e-5 * np.abs(B).max()
    assert np.linalg.eigvalsh(0.5 * (B + B.T).astype(np.float64)).min() > 0


def test_two_level_sharded_chebyshev_smoother():
    import jax

    A, b, _ = random_geometric_spd(20_000, seed=2, avg_degree=12.0,
                                   shift=0.05)
    n = A.shape[0]
    num = len(jax.devices())
    tol = 1e-5 * float(np.linalg.norm(b))
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl = tpucg.build_two_level(A, agg_size=64, npad=npad_sh,
                               smooth_degree=2)
    sh = tpucg.sharded_operator_cg_solve(
        A, b, tol=tol, maxiter=4 * n, two_level=tl
    )
    assert bool(sh.converged)

    op = tpucg.WellOperator.from_csr(A)
    tl_s = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n,
                                 smooth_degree=2)
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl_s)
    # The serial/sharded coarse spaces differ in their identity tails
    # (npad 128-pad vs 128P-pad) and reduction order; lap counts quantize
    # to the 16-lap true-residual check cadence.
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 16


def test_two_level_composes_with_deflation_and_recycling(fem):
    # The FEM sequence story: two-level handles the smooth band, the
    # recycled basis the sequence's specific directions. Later solves of
    # a smooth RHS sequence must need (far) fewer laps than the first.
    A, b, _ = fem
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    # 1e-3 ||b||: above the composed TRUE-residual f32 floor (~4e-4 ||b||
    # at this n=6k FEM conditioning — round 5's true-residual stopping
    # measures the honest floor; the old 3e-5 target was only ever met by
    # the drifted recurrence, never in truth).
    tol = 1e-3 * float(np.linalg.norm(b))
    tl = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n,
                               smooth_degree=2)
    rec = tpucg.RecyclingCG(op, max_vectors=4, two_level=tl, tol=tol,
                            maxiter=4 * n)
    laps = []
    for k in range(4):
        # Perturbations at b's own scale (the fixed config tol is
        # derived from the first b).
        res = rec.solve(b * (1.0 + 0.05 * k)
                        + 0.02 * k * np.roll(np.asarray(b), 7 * k))
        assert bool(res.converged), k
        laps.append(int(res.iterations))
    # ~2x on this mixed (scaled + rolled) sequence: rolls inject genuinely
    # new directions each step, so the cut is real but smaller than the
    # smooth-drift sequences'. The A-orthonormal basis fold (round 4)
    # shifted the trajectory a couple laps (49 -> 24/26/26 where the
    # explicit-Ginv basis gave <24) — threshold sized to the payoff, not
    # the fp path.
    assert laps[-1] <= (3 * laps[0]) // 5, laps

    # Explicit deflated + two_level composition and its validation.
    r = tpucg.cg_solve_deflated(
        op, b, np.stack(rec._vectors, axis=1), tol=tol, maxiter=4 * n,
        two_level=tl,
    )
    assert bool(r.converged)
    with pytest.raises(ValueError, match="base preconditioner"):
        tpucg.cg_solve_deflated(op, b, np.asarray(b)[:, None], tol=tol,
                                two_level=tl, precondition="jacobi")
    with pytest.raises(ValueError, match="serial-only"):
        from tpucg.comm.mesh import make_mesh

        tpucg.RecyclingCG(op, mesh=make_mesh(), two_level=tl)


# --- Multilevel (round 5, VERDICT r4 #3): recursive coarse solve ----------


def test_multilevel_builds_and_matches_dense_inverse_laps(fem):
    """coarse_max triggers sparse assembly + a recursive V-cycle coarse
    solve; lap counts must stay within ~1.5x of the dense-inverse
    two-level and the hierarchy must carry NO large dense inverse."""
    A, b, _ = fem
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tol = 1e-3 * float(np.linalg.norm(b))
    # agg=8 -> nc ~ 760 > the 256 recursion floor (coarse levels pad to
    # 128 rows, so coarse_max clamps at 2*LANE) -> at least one recursion.
    dense_tl = tpucg.build_two_level(A, agg_size=8, npad=op.padded_n)
    multi_tl = tpucg.build_two_level(A, agg_size=8, npad=op.padded_n,
                                     coarse_max=128)
    assert multi_tl.levels >= 2 and dense_tl.levels == 1
    assert multi_tl.acinv.shape == (1, 1)  # no big dense inverse
    assert multi_tl.inner.acinv.shape[0] <= 384 or \
        multi_tl.inner.levels >= 2
    r_dense = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n,
                             two_level=dense_tl)
    r_multi = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n,
                             two_level=multi_tl)
    assert bool(r_multi.converged)
    assert int(r_multi.iterations) <= 1.5 * int(r_dense.iterations) + 18
    np.testing.assert_allclose(
        np.asarray(r_multi.x), np.asarray(r_dense.x), rtol=2e-2, atol=1e-4
    )


def test_multilevel_preconditioner_is_spd():
    import jax
    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla
    from tpucg.solver.twolevel import make_two_level_precond

    A, b, _ = fem_p1_system(900, seed=1)
    n = A.shape[0]
    op = tpucg.EllOperator.from_csr(A)
    tl = tpucg.build_two_level(A, agg_size=2, npad=op.padded_n,
                               coarse_max=32)
    assert tl.levels >= 2
    pc = make_two_level_precond(tl, op.matvec, dot_xla, jnp.asarray(b))
    B = np.asarray(
        jax.jit(jax.vmap(pc, in_axes=1, out_axes=1))(
            jnp.eye(n, dtype=jnp.float32)
        )
    )
    assert np.abs(B - B.T).max() <= 1e-5 * np.abs(B).max()
    w = np.linalg.eigvalsh(0.5 * (B + B.T).astype(np.float64))
    assert w.min() > 0


def test_multilevel_sharded_matches_serial():
    import jax

    A, b, _ = random_geometric_spd(20_000, seed=2, avg_degree=12.0,
                                   shift=0.05)
    n = A.shape[0]
    num = len(jax.devices())
    tol = 1e-5 * float(np.linalg.norm(b))
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl_sh = tpucg.build_two_level(A, agg_size=64, npad=npad_sh,
                                  coarse_max=64)
    assert tl_sh.levels >= 2, (tl_sh.levels, tl_sh.nc)
    sh = tpucg.sharded_operator_cg_solve(
        A, b, tol=tol, maxiter=4 * n, two_level=tl_sh
    )
    assert bool(sh.converged)
    op = tpucg.WellOperator.from_csr(A)
    tl = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n,
                               coarse_max=64)
    ser = tpucg.cg_solve(op, b, tol=tol, maxiter=4 * n, two_level=tl)
    # the two hierarchies differ slightly (sharded npad alignment ->
    # different coarse systems at every level) and lap counts quantize
    # to the true-check cadence (16); allow a wider gap
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 26
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-2, atol=1e-4
    )
