"""Sharded SPMD CG on a forced 8-device CPU mesh: both communication
strategies vs the serial oracle (the reference's serial-vs-parallel
cross-check, SURVEY.md §4.1 item 3)."""

import jax
import numpy as np
import pytest

from tpucg import CGConfig, make_mesh, sharded_cg_solve
from tpucg.io.generator import generate_spd_system
from tpucg.io.partitioner import RowPartition, pad_system
from tpucg.solver.oracle import oracle_cg


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(8)


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
@pytest.mark.parametrize("n", [96, 50])  # 50 exercises pad-to-shardable
def test_sharded_matches_oracle(mesh8, strategy, n):
    A, b, _ = generate_spd_system(n, seed=n)
    ox, oiters, _ = oracle_cg(A, b, np.zeros(n, np.float32))
    res = sharded_cg_solve(
        A, b, mesh=mesh8, config=CGConfig(strategy=strategy)
    )
    assert res.x.shape == (n,)
    assert abs(int(res.iterations) - oiters) <= 1
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), ox, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_sharded_golden_4x4(mesh8, strategy, golden_4x4):
    # n=4 over 8 shards: pure padding corner (more shards than rows).
    g = golden_4x4
    res = sharded_cg_solve(
        g["A"], g["b"], g["x0"], mesh=mesh8,
        config=CGConfig(strategy=strategy),
    )
    np.testing.assert_allclose(
        np.asarray(res.x), g["x_star"], rtol=1e-5, atol=1e-5
    )
    assert bool(res.converged)


def test_strategies_agree(mesh8):
    n = 128
    A, b, x0 = generate_spd_system(n, seed=7)
    r1 = sharded_cg_solve(A, b, x0, mesh=mesh8, strategy="allgather")
    r2 = sharded_cg_solve(A, b, x0, mesh=mesh8, strategy="overlap")
    assert int(r1.iterations) == int(r2.iterations)
    np.testing.assert_allclose(
        np.asarray(r1.x), np.asarray(r2.x), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_sharded_gemv_under_shard_map(mesh8, strategy):
    """The sharded dense GEMV has no Pallas kernel: ``kernel="pallas"`` is
    refused loudly (never served by an interpreter or another kernel), and
    the default kernel inside shard_map matches the oracle at n=1024."""
    n = 1024
    A, b, x0 = generate_spd_system(n, seed=3)
    ox, oiters, _ = oracle_cg(A, b, x0)
    with pytest.raises(ValueError, match="pallas"):
        sharded_cg_solve(A, b, x0, mesh=mesh8, strategy=strategy,
                         kernel="pallas")
    res = sharded_cg_solve(
        A, b, x0, mesh=mesh8, config=CGConfig(strategy=strategy),
    )
    assert bool(res.converged)
    assert abs(int(res.iterations) - oiters) <= 1
    np.testing.assert_allclose(np.asarray(res.x), ox, rtol=1e-4, atol=1e-5)


def test_sharded2d_gemv_under_shard_map():
    """The 2-D SUMMA arm refuses ``kernel="pallas"`` and solves with the
    default kernel."""
    from tpucg import make_mesh2d

    n = 2048
    A, b, x0 = generate_spd_system(n, seed=5)
    with pytest.raises(ValueError, match="pallas"):
        sharded_cg_solve(A, b, x0, mesh=make_mesh2d(2, 4), kernel="pallas")
    res = sharded_cg_solve(A, b, x0, mesh=make_mesh2d(2, 4))
    assert bool(res.converged)
    np.testing.assert_allclose(
        A @ np.asarray(res.x), b, atol=1e-3 * float(np.linalg.norm(b))
    )


def test_pad_system_preserves_solution():
    n = 10
    A, b, x0 = generate_spd_system(n, seed=9)
    part = RowPartition(n=n, num_shards=8, align=8)
    Ap, bp, x0p = pad_system(A, b, x0, part)
    assert Ap.shape == (part.n_padded, part.n_padded)
    xp, _, _ = oracle_cg(Ap, bp, x0p)
    x, _, _ = oracle_cg(A, b, x0)
    np.testing.assert_allclose(xp[:n], x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xp[n:], 0.0, atol=1e-7)


def test_smaller_mesh():
    mesh2 = make_mesh(2)
    n = 64
    A, b, _ = generate_spd_system(n, seed=11)
    res = sharded_cg_solve(A, b, mesh=mesh2, strategy="overlap")
    np.testing.assert_allclose(A @ np.asarray(res.x), b, atol=1e-4)


def test_load_system_sharded_end_to_end(tmp_path):
    """Host-sharded loading: per-shard row reads -> sharded solve matches the
    all-at-once path (SURVEY.md §7 hard part d)."""
    import numpy as np

    import tpucg
    from tpucg.io.textio import save_array
    from tpucg.solver.sharded import load_system_sharded

    n = 72  # not divisible by 8: exercises the identity-tail pad rows too
    A, b, x0 = tpucg.generate_spd_system(n, seed=8)
    pa, pb, px = (str(tmp_path / f) for f in ("A.txt", "b.txt", "x0.txt"))
    save_array(pa, A, fmt="%r")
    save_array(pb, b, fmt="%r")
    save_array(px, x0, fmt="%r")

    mesh = tpucg.make_mesh()
    Ad, bd, x0d, n_logical = load_system_sharded(pa, pb, px, mesh=mesh)
    assert n_logical == n
    assert Ad.shape[0] % mesh.devices.size == 0
    res = tpucg.sharded_cg_solve(Ad, bd, x0d, mesh=mesh, n=n_logical)
    ref = tpucg.cg_solve(A, b, x0)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-6
    )


def test_sharded_record_residuals(mesh8):
    """The per-iteration ||r|| trace composes with the distributed solver
    and matches the serial trace (psum-reduced global scalars)."""
    import tpucg

    n = 96
    A, b, x0 = generate_spd_system(n, seed=13)
    A = (A - (n - n / 8.0) * np.eye(n)).astype(np.float32)
    ser = tpucg.cg_solve(A, b, x0, record_residuals=True)
    sh = sharded_cg_solve(A, b, x0, mesh=mesh8, record_residuals=True)
    assert sh.residual_history is not None
    k = int(sh.iterations)
    assert int(ser.iterations) == k
    hs = np.asarray(sh.residual_history)[: k + 1]
    hr = np.asarray(ser.residual_history)[: k + 1]
    assert np.all(np.isfinite(hs))
    # Entry 0 is the initial residual (deterministic); later entries drift
    # by f32 reduction order between the psum and serial sums — compare at
    # order-of-magnitude resolution, and the converged tail below tol.
    np.testing.assert_allclose(hs[0], hr[0], rtol=1e-4)
    np.testing.assert_allclose(
        np.log10(hs[1:]), np.log10(hr[1:]), atol=0.5
    )
    assert hs[-1] < 1.0e-6
    # Beyond the converged lap the trace is NaN-padded, as in serial.
    assert np.all(np.isnan(np.asarray(sh.residual_history)[k + 1:]))


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_sharded_bf16_storage(mesh8, strategy):
    """bfloat16 A shards (f32 accumulation/vectors): the distributed analog
    of DenseOperator.create(dtype=bfloat16) — agrees with the SERIAL bf16
    solve on the same bf16-rounded system."""
    import jax.numpy as jnp

    import tpucg
    from tpucg.solver.operators import DenseOperator

    n = 96
    A, b, x0 = tpucg.generate_spd_system(n, seed=23)
    tol = 1e-5 * float(np.linalg.norm(b))
    ser = tpucg.cg_solve(
        DenseOperator.create(A, dtype=jnp.bfloat16), b, x0, tol=tol,
        maxiter=4 * n,
    )
    sh = sharded_cg_solve(
        A, b, x0, mesh=mesh8, tol=tol, strategy=strategy,
        storage_dtype=jnp.bfloat16,
    )
    assert bool(sh.converged)
    assert abs(int(sh.iterations) - int(ser.iterations)) <= 1
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(ser.x), rtol=1e-3, atol=1e-3
    )
    # Jacobi under bf16 storage (diagonal upcast before inversion).
    shj = sharded_cg_solve(
        A, b, x0, mesh=mesh8, tol=tol, strategy=strategy,
        storage_dtype=jnp.bfloat16, precondition="jacobi",
    )
    assert bool(shj.converged)
