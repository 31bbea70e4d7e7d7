"""Checkpoint/resume tests (tpucg.solver.checkpoint).

The invariant: a solve interrupted at any segment boundary and resumed from
its .npz checkpoint must follow the bit-identical float32 trajectory of an
uninterrupted solve (the CG state (k, x, r, p, rsold) is saved exactly)."""

import os

import numpy as np
import pytest

import tpucg
from tpucg.solver.checkpoint import (
    cg_solve_checkpointed,
    load_checkpoint,
    save_checkpoint,
)


@pytest.fixture
def system():
    # Mildly conditioned so CG needs a healthy number of iterations: shrink
    # the diagonal shift from the generator's n down to ~n/8.
    n = 96
    A, b, x0 = tpucg.generate_spd_system(n, seed=4)
    A = A - (n - n / 8.0) * np.eye(n, dtype=np.float32)
    return A.astype(np.float32), b, x0


def test_checkpointed_matches_plain(system):
    A, b, x0 = system
    ref = tpucg.cg_solve(A, b, x0)
    res = cg_solve_checkpointed(A, b, x0, segment_iters=3)
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_resume_is_bit_identical(system, tmp_path):
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    ref = cg_solve_checkpointed(A, b, x0, segment_iters=4)
    k_total = int(ref.iterations)
    assert k_total > 8, "fixture must need multiple segments"

    # Phase 1: run a few segments then "crash" (stop driving).
    partial = cg_solve_checkpointed(
        A, b, x0, segment_iters=4, maxiter=8,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    assert int(partial.iterations) == 8
    assert os.path.exists(ck)

    # Phase 2: new driver resumes from the checkpoint to completion.
    res = cg_solve_checkpointed(A, b, x0, segment_iters=4, checkpoint_path=ck)
    assert int(res.iterations) == k_total
    assert bool(res.converged)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    assert not os.path.exists(ck), "checkpoint removed after convergence"


def test_checkpoint_roundtrip_exact(tmp_path):
    n = 32
    A, b, x0 = tpucg.generate_spd_system(n, seed=1)
    ck = str(tmp_path / "s.npz")
    cg_solve_checkpointed(
        A, b, x0, segment_iters=1, maxiter=1,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    state, n_ck, tol, sig, pre = load_checkpoint(ck)
    assert sig.size  # system signature recorded
    assert pre == "none"
    assert n_ck == n and tol == 1.0e-6
    assert int(state.k) == 1
    save_checkpoint(ck, state, n_ck, tol)
    state2, _, _, _, _ = load_checkpoint(ck)
    np.testing.assert_array_equal(np.asarray(state.x), np.asarray(state2.x))
    np.testing.assert_array_equal(np.asarray(state.p), np.asarray(state2.p))


def test_mismatched_checkpoint_rejected(system, tmp_path):
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    cg_solve_checkpointed(
        A, b, x0, segment_iters=2, maxiter=2,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    A2, b2, x02 = tpucg.generate_spd_system(48, seed=0)
    with pytest.raises(ValueError, match="checkpoint"):
        cg_solve_checkpointed(A2, b2, x02, checkpoint_path=ck)
    with pytest.raises(ValueError, match="tol"):
        cg_solve_checkpointed(A, b, x0, checkpoint_path=ck, tol=1e-4)


def test_golden_through_checkpointing(golden_4x4):
    g = golden_4x4
    res = cg_solve_checkpointed(g["A"], g["b"], g["x0"], segment_iters=1)
    assert int(res.iterations) == g["iters"]
    np.testing.assert_allclose(
        np.asarray(res.x), g["x_star"], atol=2e-3
    )


def test_checkpoint_survives_maxiter_cap(system, tmp_path):
    """A maxiter-capped (non-converged) exit must LEAVE the checkpoint on
    disk so the solve can be resumed — only convergence cleans it up."""
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    partial = cg_solve_checkpointed(
        A, b, x0, segment_iters=3, maxiter=6, checkpoint_path=ck
    )
    assert not bool(partial.converged)
    assert os.path.exists(ck), "capped exit must not delete the checkpoint"
    full = cg_solve_checkpointed(A, b, x0, segment_iters=3, checkpoint_path=ck)
    assert bool(full.converged)
    assert not os.path.exists(ck)
    ref = tpucg.cg_solve(A, b, x0)
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(ref.x))


def test_checkpoint_rejects_pipelined_and_f64(system):
    A, b, x0 = system
    with pytest.raises(ValueError, match="pipelined"):
        cg_solve_checkpointed(A, b, x0, method="pipelined")
    import jax.numpy as jnp

    with pytest.raises(ValueError, match="float32"):
        cg_solve_checkpointed(A, b, x0, dtype=jnp.float64)


def test_stale_checkpoint_from_other_system_rejected(system, tmp_path):
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    cg_solve_checkpointed(A, b, x0, segment_iters=3, maxiter=3,
                          checkpoint_path=ck)
    # Same n, same tol, DIFFERENT system: must refuse to resume.
    A2 = A + np.float32(0.5) * np.eye(A.shape[0], dtype=np.float32)
    with pytest.raises(ValueError, match="signature"):
        cg_solve_checkpointed(A2, b, x0, checkpoint_path=ck)
    b2 = b + 1.0
    with pytest.raises(ValueError, match="signature"):
        cg_solve_checkpointed(A, b2, x0, checkpoint_path=ck)


def test_checkpoint_resumes_across_kernel_backends(tmp_path):
    """The identity guard is tolerance-based: the SAME system resumed under
    another ``kernel`` setting must resume, not be misreported as a
    different system (ADVICE.md round 1); ``kernel="pallas"`` is refused
    before any checkpoint is read."""
    n = 128
    A, b, x0 = tpucg.generate_spd_system(n, seed=4)
    A = A - (n - n / 8.0) * np.eye(n, dtype=np.float32)
    ck = str(tmp_path / "cg.npz")
    cg_solve_checkpointed(A, b, x0, segment_iters=3, maxiter=3,
                          checkpoint_path=ck, kernel="xla")
    with pytest.raises(ValueError, match="pallas"):
        cg_solve_checkpointed(A, b, x0, segment_iters=64,
                              checkpoint_path=ck, kernel="pallas")
    res = cg_solve_checkpointed(A, b, x0, segment_iters=64,
                                checkpoint_path=ck, kernel="auto")
    assert bool(res.converged)


def _conditioned_system(n, seed=4):
    A, b, x0 = tpucg.generate_spd_system(n, seed=seed)
    A = A - np.float32(n - n / 8.0) * np.eye(n, dtype=np.float32)
    return A.astype(np.float32), b, x0


def test_sharded_checkpointed_matches_sharded(tmp_path):
    """The distributed segmented driver follows the identical trajectory of
    an uninterrupted sharded solve and resumes bit-identically over the
    8-device CPU mesh (VERDICT round 1, weak 7)."""
    from tpucg.solver.checkpoint import sharded_cg_solve_checkpointed

    A, b, x0 = _conditioned_system(96)
    ref = tpucg.sharded_cg_solve(A, b, x0)
    res = sharded_cg_solve_checkpointed(A, b, x0, segment_iters=3)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))

    # Interrupt, then resume from disk.
    ck = str(tmp_path / "sh.npz")
    partial = sharded_cg_solve_checkpointed(
        A, b, x0, segment_iters=4, maxiter=8,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    assert int(partial.iterations) == 8 and os.path.exists(ck)
    full = sharded_cg_solve_checkpointed(
        A, b, x0, segment_iters=4, checkpoint_path=ck
    )
    assert bool(full.converged)
    assert int(full.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(ref.x))
    assert not os.path.exists(ck), "checkpoint removed on convergence"


def test_sharded_checkpoint_rejects_different_system(tmp_path):
    from tpucg.solver.checkpoint import sharded_cg_solve_checkpointed

    A, b, x0 = _conditioned_system(96)
    ck = str(tmp_path / "sh.npz")
    sharded_cg_solve_checkpointed(
        A, b, x0, segment_iters=3, maxiter=3, checkpoint_path=ck
    )
    A2 = A + np.float32(0.5) * np.eye(A.shape[0], dtype=np.float32)
    with pytest.raises(ValueError, match="signature"):
        sharded_cg_solve_checkpointed(A2, b, x0, checkpoint_path=ck)


def test_sharded_checkpoint_overlap_and_jacobi(tmp_path):
    from tpucg.solver.checkpoint import sharded_cg_solve_checkpointed

    A, b, x0 = _conditioned_system(96, seed=6)
    for kw in (dict(strategy="overlap"), dict(precondition="jacobi")):
        ref = tpucg.sharded_cg_solve(A, b, x0, **kw)
        res = sharded_cg_solve_checkpointed(A, b, x0, segment_iters=5, **kw)
        assert bool(res.converged)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_signature_blocks_compared_on_own_scales():
    """Regression (round-2 review): the b-projection block must be compared
    against ITS OWN scale — under a single global scale the A-probe block
    (orders of magnitude larger for diag-dominant systems) would mask a
    changed right-hand side and resume silently against the wrong b."""
    from tpucg.solver.checkpoint import signatures_match

    a = np.array([1e6, -2e6, 1.5e6, 9e5, 1.0, 2.0, -1.5, 0.5])
    b = a.copy()
    b[5] += 0.5  # a real change to the b block, tiny vs the A block's scale
    assert not signatures_match(a, b)
    # Unchanged signatures (with f32-level jitter) still match.
    c = a * (1 + 1e-7)
    assert signatures_match(a, c)


def test_operator_sharded_checkpointed_poisson(tmp_path):
    """Checkpoint/resume over the slab-halo Poisson solver: identical
    trajectory, bit-identical resume, cross-operator guard."""
    from tpucg.solver.checkpoint import sharded_operator_cg_solve_checkpointed
    from tpucg.solver.operators import PoissonOperator
    from tpucg.solver.sharded import sharded_operator_cg_solve

    m = 8
    op = PoissonOperator(m=m)
    b = np.ones(m ** 3, np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    ref = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    res = sharded_operator_cg_solve_checkpointed(
        op, b, tol=tol, maxiter=4 * m ** 3, segment_iters=5
    )
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))

    ck = str(tmp_path / "p.npz")
    partial = sharded_operator_cg_solve_checkpointed(
        op, b, tol=tol, maxiter=7, segment_iters=4,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    assert int(partial.iterations) == 7 and os.path.exists(ck)
    full = sharded_operator_cg_solve_checkpointed(
        op, b, tol=tol, maxiter=4 * m ** 3, segment_iters=16,
        checkpoint_path=ck,
    )
    assert bool(full.converged)
    assert int(full.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(ref.x))
    assert not os.path.exists(ck)

    # A checkpoint from a DIFFERENT rhs must be refused.
    sharded_operator_cg_solve_checkpointed(
        op, b, tol=tol, maxiter=4, segment_iters=4, checkpoint_path=ck,
        keep_checkpoint=True,
    )
    with pytest.raises(ValueError, match="signature"):
        sharded_operator_cg_solve_checkpointed(
            op, b + 1.0, tol=tol, segment_iters=4, checkpoint_path=ck
        )


def test_operator_sharded_checkpointed_dia_jacobi(tmp_path):
    """Same driver over the band-halo DIA arm with Jacobi, non-divisible n."""
    from tpucg.io.generator import poisson3d_csr
    from tpucg.solver.checkpoint import sharded_operator_cg_solve_checkpointed
    from tpucg.sparse.formats import csr_to_dia

    m = 7  # n = 343: pads to 1024 over 8 shards x 128 lanes
    csr = poisson3d_csr(m)
    n = csr.shape[0]
    dia = csr_to_dia(csr)
    rng = np.random.default_rng(5)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    ck = str(tmp_path / "d.npz")
    partial = sharded_operator_cg_solve_checkpointed(
        dia, b, tol=tol, maxiter=5, segment_iters=5,
        precondition="jacobi", checkpoint_path=ck, keep_checkpoint=True,
    )
    assert os.path.exists(ck)
    full = sharded_operator_cg_solve_checkpointed(
        dia, b, tol=tol, maxiter=4 * n, segment_iters=10,
        precondition="jacobi", checkpoint_path=ck,
    )
    assert bool(full.converged)
    np.testing.assert_allclose(np.asarray(full.x), x_true, atol=1e-3)


def test_sharded2d_checkpointed(tmp_path):
    """Checkpoint/resume on the 2-D SUMMA decomposition: identical
    trajectory to the uninterrupted 2-D solve, bit-identical resume."""
    from tpucg import make_mesh2d
    from tpucg.solver.checkpoint import sharded_cg_solve_checkpointed

    A, b, x0 = _conditioned_system(96, seed=7)
    mesh = make_mesh2d(2, 4)
    ref = tpucg.sharded_cg_solve(A, b, x0, mesh=mesh)
    res = sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, segment_iters=4)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))

    ck = str(tmp_path / "s2.npz")
    partial = sharded_cg_solve_checkpointed(
        A, b, x0, mesh=mesh, segment_iters=4, maxiter=8,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    assert int(partial.iterations) == 8 and os.path.exists(ck)
    full = sharded_cg_solve_checkpointed(
        A, b, x0, mesh=mesh, segment_iters=4, checkpoint_path=ck
    )
    assert bool(full.converged)
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(ref.x))
    assert not os.path.exists(ck)


def test_checkpoint_rejects_precondition_mismatch(system, tmp_path):
    """Regression (round-2 review): a Jacobi checkpoint's rsold carries r.z,
    not r.r — resuming it under precondition='none' (or vice versa) must be
    REFUSED, not silently corrupt the recurrence."""
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    cg_solve_checkpointed(
        A, b, x0, segment_iters=3, maxiter=3, precondition="jacobi",
        checkpoint_path=ck, keep_checkpoint=True,
    )
    with pytest.raises(ValueError, match="precondition"):
        cg_solve_checkpointed(A, b, x0, checkpoint_path=ck)
    # Same guard on the distributed drivers.
    from tpucg.io.generator import poisson3d_dia
    from tpucg.solver.checkpoint import sharded_operator_cg_solve_checkpointed

    m = 8
    dia = poisson3d_dia(m)
    bp = np.ones(m ** 3, np.float32)
    tolp = 1e-5 * float(np.linalg.norm(bp))
    ck2 = str(tmp_path / "op.npz")
    sharded_operator_cg_solve_checkpointed(
        dia, bp, tol=tolp, maxiter=4, segment_iters=4,
        precondition="jacobi", checkpoint_path=ck2, keep_checkpoint=True,
    )
    with pytest.raises(ValueError, match="precondition"):
        sharded_operator_cg_solve_checkpointed(
            dia, bp, tol=tolp, segment_iters=4, checkpoint_path=ck2
        )


@pytest.mark.parametrize("form", ["bsr", "ell"])
def test_operator_sharded_checkpointed_bsr_ell(form, tmp_path):
    """The tuple-op_arrays arms (BSR/ELL) through the segment jit's nested
    in_specs: interrupted runs resume bit-identically."""
    from tpucg.io.generator import poisson3d_csr
    from tpucg.solver.checkpoint import sharded_operator_cg_solve_checkpointed
    from tpucg.solver.operators import EllOperator
    from tpucg.solver.sharded import sharded_operator_cg_solve
    from tpucg.sparse.formats import csr_to_bsr

    csr = poisson3d_csr(6)  # n=216 (non-divisible: padding in play)
    n = csr.shape[0]
    op = csr_to_bsr(csr, 4) if form == "bsr" else EllOperator.from_csr(csr)
    rng = np.random.default_rng(14)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = csr.matvec(x_true)
    tol = 1e-5 * float(np.linalg.norm(b))
    ref = sharded_operator_cg_solve(op, b, tol=tol, maxiter=4 * n)
    ck = str(tmp_path / f"{form}.npz")
    sharded_operator_cg_solve_checkpointed(
        op, b, tol=tol, maxiter=6, segment_iters=3,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    full = sharded_operator_cg_solve_checkpointed(
        op, b, tol=tol, maxiter=4 * n, segment_iters=16, checkpoint_path=ck
    )
    assert bool(full.converged)
    assert int(full.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(ref.x))


def test_sharded_bf16_presharded_dtype_guard():
    """Regression (round-2 review): storage_dtype on a pre-sharded device A
    of a different dtype must raise, not silently run in f32."""
    import jax.numpy as jnp

    import tpucg
    from tpucg.io.partitioner import RowPartition
    from tpucg.solver.sharded import distribute_system, ROW_ALIGN

    n = 64
    A, b, x0 = tpucg.generate_spd_system(n, seed=3)
    mesh = tpucg.make_mesh()
    part = RowPartition(n=n, num_shards=8, align=ROW_ALIGN)
    Ad, bd, x0d = distribute_system(
        A.astype(np.float32), b, x0, mesh, part
    )  # f32 shards
    with pytest.raises(ValueError, match="storage_dtype"):
        tpucg.sharded_cg_solve(
            Ad, bd, x0d, mesh=mesh, n=n, storage_dtype=jnp.bfloat16
        )


# --- Irregular (WELL) + two-level checkpointing (round 5) ------------------


@pytest.fixture(scope="module")
def irregular():
    from tpucg.io.generator import fem_p1_system

    A, b, _ = fem_p1_system(6_000, seed=1)
    return A, b


def test_checkpointed_well_two_level_resume_bit_identical(irregular, tmp_path):
    """The VERDICT r4 gap: only dense systems — the ones that converge in
    4 laps — could checkpoint. The long-lap FEM/WELL class is the actual
    segment-and-resume workload; a kill/resume under the two-level cycle
    must follow the bit-identical trajectory."""
    A, b = irregular
    op = tpucg.best_sparse_operator(A)
    assert type(op).__name__ == "WellOperator"
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    tol = 1e-3 * float(np.linalg.norm(b))  # above the FEM true floor
    ck = str(tmp_path / "well.npz")

    ref = cg_solve_checkpointed(op, b, tol=tol, segment_iters=8,
                                two_level=tl, maxiter=4 * A.shape[0])
    assert bool(ref.converged)
    k_total = int(ref.iterations)
    assert k_total >= 16, "fixture must span multiple segments"
    plain = tpucg.cg_solve(op, b, tol=tol, two_level=tl,
                           maxiter=4 * A.shape[0])
    assert int(plain.iterations) == k_total
    np.testing.assert_array_equal(np.asarray(ref.x), np.asarray(plain.x))

    partial = cg_solve_checkpointed(
        op, b, tol=tol, segment_iters=8, maxiter=16, two_level=tl,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    assert int(partial.iterations) == 16 and os.path.exists(ck)
    res = cg_solve_checkpointed(
        op, b, tol=tol, segment_iters=8, two_level=tl,
        checkpoint_path=ck, maxiter=4 * A.shape[0],
    )
    assert int(res.iterations) == k_total
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    assert not os.path.exists(ck)


def test_checkpoint_rejects_two_level_identity_mismatch(irregular, tmp_path):
    A, b = irregular
    op = tpucg.best_sparse_operator(A)
    tol = 1e-5 * float(np.linalg.norm(b))
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    ck = str(tmp_path / "tl.npz")
    cg_solve_checkpointed(op, b, tol=tol, segment_iters=4, maxiter=4,
                          two_level=tl, checkpoint_path=ck,
                          keep_checkpoint=True)
    # Different aggregate size -> different cycle -> refuse to resume.
    tl2 = tpucg.build_two_level(A, agg_size=64, npad=op.padded_n)
    with pytest.raises(ValueError, match="precondition"):
        cg_solve_checkpointed(op, b, tol=tol, two_level=tl2,
                              checkpoint_path=ck)
    # Dropping the preconditioner entirely must refuse too.
    with pytest.raises(ValueError, match="precondition"):
        cg_solve_checkpointed(op, b, tol=tol, checkpoint_path=ck)
    # npad mismatch fails loudly at validation.
    with pytest.raises(ValueError, match="padded size"):
        bad = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n + 128)
        cg_solve_checkpointed(op, b, tol=tol, two_level=bad)


def test_checkpointed_stagnation_stop_matches_plain(irregular):
    """A floor-bound two_level solve (tol below the f32 attainable floor)
    stagnation-stops; the segmented driver must stop at the SAME lap, not
    grind to maxiter. A round-5 smoke run found the grind: the
    stagnation bookkeeping (prev boundary true r.r + stagnant flag) lived
    outside the carried state and reset at every segment, so the
    two-consecutive-windows rule never fired. segment_iters=24 lands
    segment ends mid-check-window on purpose."""
    A, b = irregular
    op = tpucg.best_sparse_operator(A)
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    tol = 1e-7 * float(np.linalg.norm(b))  # below the f32 floor
    cap = 4 * A.shape[0]
    plain = tpucg.cg_solve(op, b, tol=tol, two_level=tl, maxiter=cap)
    k_plain = int(plain.iterations)
    assert not bool(plain.converged) and k_plain < cap, (
        "fixture must stagnation-stop for this test to mean anything"
    )
    seg = cg_solve_checkpointed(op, b, tol=tol, segment_iters=24,
                                two_level=tl, maxiter=cap)
    assert not bool(seg.converged)
    assert int(seg.iterations) == k_plain
    np.testing.assert_array_equal(np.asarray(seg.x), np.asarray(plain.x))


def test_checkpointed_bare_csr_promotes_to_well(irregular, tmp_path):
    """A bare CSR handed to the checkpointed driver rides the WELL
    promotion chain (the docstring's contract), NOT as_operator's legacy
    scalar-gather ELL mapping — the ELL route's un-128-padded npad also
    rejected any correctly built two_level (found by the round-5
    smoke: build_two_level(npad=op.padded_n) vs the Ell operator's raw n)."""
    A, b = irregular
    op = tpucg.best_sparse_operator(A)
    assert type(op).__name__ == "WellOperator"
    tl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    tol = 1e-3 * float(np.linalg.norm(b))
    # Bare CSR, two_level built against the PROMOTED padding: must solve.
    res = cg_solve_checkpointed(A, b, tol=tol, segment_iters=64,
                                two_level=tl, maxiter=4 * A.shape[0])
    assert bool(res.converged)
    # Identical trajectory to the explicit-operator route.
    ref = cg_solve_checkpointed(op, b, tol=tol, segment_iters=64,
                                two_level=tl, maxiter=4 * A.shape[0])
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_operator_sharded_checkpointed_stagnation_stop(irregular):
    """The sharded analog of test_checkpointed_stagnation_stop_matches_
    plain: the operator-sharded segmented driver threads the stagnation
    carry across segments, so a floor-bound two_level solve stops at the
    same lap as the unsegmented sharded solve."""
    import jax

    from tpucg.solver.checkpoint import sharded_operator_cg_solve_checkpointed
    from tpucg.solver.sharded import sharded_operator_cg_solve

    A, b = irregular
    num = len(jax.devices())
    n = A.shape[0]
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl = tpucg.build_two_level(A, agg_size=64, npad=npad_sh)
    tol = 1e-7 * float(np.linalg.norm(b))  # below the f32 floor
    cap = 4 * n
    plain = sharded_operator_cg_solve(A, b, tol=tol, two_level=tl,
                                      maxiter=cap)
    k_plain = int(plain.iterations)
    assert not bool(plain.converged) and k_plain < cap, (
        "fixture must stagnation-stop for this test to mean anything"
    )
    seg = sharded_operator_cg_solve_checkpointed(
        A, b, tol=tol, segment_iters=24, two_level=tl, maxiter=cap,
    )
    assert not bool(seg.converged)
    assert int(seg.iterations) == k_plain


def test_operator_sharded_checkpointed_well_two_level(irregular, tmp_path):
    """Distributed WELL + two-level kill/resume on the CPU mesh."""
    import jax

    from tpucg.solver.checkpoint import sharded_operator_cg_solve_checkpointed

    A, b = irregular
    num = len(jax.devices())
    n = A.shape[0]
    npad_sh = -(-n // (128 * num)) * (128 * num)
    tl = tpucg.build_two_level(A, agg_size=64, npad=npad_sh)
    tol = 1e-3 * float(np.linalg.norm(b))  # above the FEM true floor
    ck = str(tmp_path / "wsh.npz")

    ref = sharded_operator_cg_solve_checkpointed(
        A, b, tol=tol, segment_iters=8, two_level=tl, maxiter=4 * n,
    )
    assert bool(ref.converged)
    k_total = int(ref.iterations)
    assert k_total > 16
    partial = sharded_operator_cg_solve_checkpointed(
        A, b, tol=tol, segment_iters=8, maxiter=16, two_level=tl,
        checkpoint_path=ck, keep_checkpoint=True,
    )
    assert int(partial.iterations) == 16 and os.path.exists(ck)
    res = sharded_operator_cg_solve_checkpointed(
        A, b, tol=tol, segment_iters=8, two_level=tl,
        checkpoint_path=ck, maxiter=4 * n,
    )
    assert int(res.iterations) == k_total
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    assert not os.path.exists(ck)
