"""Batched independent-systems solver (cg_solve_batch).

An extension beyond the reference (one system per process run,
serialConjugate.c:43-73): B systems solve concurrently in one vmapped
while_loop (one batched GEMM per lap). Per-system convergence must match
the serial solver lap-for-lap even when systems in the same batch need
different iteration counts.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import tpucg


def _make_batch(nsys, n, seed=0):
    """SPD systems of deliberately DIFFERENT conditioning (diagonal shifts
    n, n/2, n/4, ... per system) so per-lane iteration counts diverge."""
    rng = np.random.default_rng(seed)
    As, bs = [], []
    for i in range(nsys):
        M = rng.standard_normal((n, n)).astype(np.float32)
        A = 0.5 * (M + M.T) + (n / (1 + i)) * np.eye(n, dtype=np.float32)
        As.append(A)
        bs.append(rng.standard_normal(n).astype(np.float32))
    return np.stack(As), np.stack(bs)


def test_batch_matches_serial():
    nsys, n = 4, 96  # n not 128-aligned: no padding anywhere
    As, bs = _make_batch(nsys, n)
    res = tpucg.cg_solve_batch(As, bs)
    assert res.x.shape == (nsys, n)
    iters = set()
    for i in range(nsys):
        ref = tpucg.cg_solve(As[i], bs[i])
        assert bool(res.converged[i])
        assert int(res.iterations[i]) == int(ref.iterations)
        iters.add(int(ref.iterations))
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(ref.x), rtol=2e-4, atol=1e-5
        )
    # The batch must actually exercise divergent lane lifetimes.
    assert len(iters) > 1, iters


def test_batch_goldens_together(golden_2x2, golden_4x4):
    # Both shipped reference systems in ONE batch: exact lap counts (2, 4).
    n = 4
    As = np.stack([
        np.pad(golden_2x2["A"], ((0, 2), (0, 2))) + np.diag([0, 0, 1, 1]),
        golden_4x4["A"],
    ]).astype(np.float32)
    bs = np.stack([
        np.pad(golden_2x2["b"], (0, 2)), golden_4x4["b"]
    ]).astype(np.float32)
    res = tpucg.cg_solve_batch(As, bs)
    assert int(res.iterations[0]) == golden_2x2["iters"]
    assert int(res.iterations[1]) == golden_4x4["iters"]
    np.testing.assert_allclose(
        np.asarray(res.x[0])[:2], golden_2x2["x_star"], atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res.x[1]), golden_4x4["x_star"], atol=2e-3
    )


@pytest.mark.parametrize("precondition,kw", [
    ("jacobi", {}),
    ("poly", {"poly_degree": 3}),
])
def test_batch_preconditioned(precondition, kw):
    nsys, n = 3, 64
    As, bs = _make_batch(nsys, n, seed=1)
    res = tpucg.cg_solve_batch(As, bs, precondition=precondition, **kw)
    for i in range(nsys):
        ref = tpucg.cg_solve(As[i], bs[i], precondition=precondition, **kw)
        assert bool(res.converged[i])
        assert int(res.iterations[i]) == int(ref.iterations)
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(ref.x), rtol=2e-4, atol=1e-5
        )


def test_batch_x0_and_fused_gate():
    # A nonzero X0 is honoured per system (same laps and x as the serial
    # solve from the same guess); kernel="pallas" is refused.
    nsys, n = 2, 128
    As, bs = _make_batch(nsys, n, seed=2)
    x0 = 0.1 * np.ones((nsys, n), np.float32)
    with pytest.raises(ValueError, match="pallas"):
        tpucg.cg_solve_batch(As, bs, x0, kernel="pallas")
    res = tpucg.cg_solve_batch(As, bs, x0)
    for i in range(nsys):
        ref = tpucg.cg_solve(As[i], bs[i], x0[i])
        assert int(res.iterations[i]) == int(ref.iterations)
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(ref.x),
            rtol=2e-4, atol=1e-5,
        )


def test_batch_input_validation():
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        tpucg.cg_solve_batch(np.eye(4, dtype=np.float32), np.ones(4))
    As, bs = _make_batch(2, 32)
    with pytest.raises(ValueError, match="b must be"):
        tpucg.cg_solve_batch(As, bs[:1])
    with pytest.raises(ValueError, match="X0 must be"):
        tpucg.cg_solve_batch(As, bs, np.ones((2, 16), np.float32))
    with pytest.raises(ValueError, match="method='cg'"):
        tpucg.cg_solve_batch(As, bs, method="pipelined")


def test_batch_jacobi_rides_the_grid_kernel():
    # precondition='jacobi' on a badly scaled f32 batch: per-system 1/diag
    # inside the vmapped loop matches the per-system serial PCG.
    nsys, n = 4, 96
    rng = np.random.default_rng(0)
    As, bs = [], []
    for i in range(nsys):
        M = rng.standard_normal((n, n)).astype(np.float32)
        A = 0.5 * (M + M.T) + n * np.eye(n, dtype=np.float32)
        d = np.exp(rng.uniform(0.0, np.log(30.0), n)).astype(np.float32)
        As.append((A * d[:, None] * d[None, :]).astype(np.float32))
        bs.append(rng.standard_normal(n).astype(np.float32))
    As, bs = np.stack(As), np.stack(bs)
    tol = 1e-5 * float(np.linalg.norm(bs[0]))
    res = tpucg.cg_solve_batch(As, bs, precondition="jacobi", tol=tol,
                               maxiter=4 * n)
    assert bool(np.all(np.asarray(res.converged)))
    for i in range(nsys):
        ref = tpucg.cg_solve(As[i], bs[i], precondition="jacobi", tol=tol,
                             maxiter=4 * n)
        assert bool(ref.converged)
        assert abs(int(np.asarray(res.iterations)[i])
                   - int(ref.iterations)) <= 2
        np.testing.assert_allclose(
            np.asarray(res.x)[i], np.asarray(ref.x), rtol=2e-3, atol=2e-4
        )
        # Preconditioning must genuinely cut laps on the scaled systems.
        plain = tpucg.cg_solve(As[i], bs[i], tol=tol, maxiter=4 * n)
        assert int(np.asarray(res.iterations)[i]) < int(plain.iterations)


class TestBatchBanded:
    """Batched banded (DIA) systems — the serving shape of implicit PDE
    time stepping (cg_solve_batch_banded; one vmapped while_loop)."""

    @staticmethod
    def _battery(nsys=6, n=500, seed=0):
        rng = np.random.default_rng(seed)
        data = np.zeros((nsys, 3, n), np.float32)
        off = rng.uniform(0.2, 1.0, (nsys, n)).astype(np.float32)
        data[:, 0] = off
        data[:, 2] = off
        data[:, 1] = 4.0 + rng.uniform(0, 1, (nsys, n)).astype(np.float32)
        b = rng.standard_normal((nsys, n)).astype(np.float32)
        return data, (-1, 0, 1), b

    def test_parity_with_per_system_solves(self):
        import tpucg
        from tpucg.sparse.formats import DIAMatrix

        data, offsets, b = self._battery()
        res = tpucg.cg_solve_batch_banded(data, offsets, b, tol=1e-5)
        assert np.asarray(res.converged).all()
        for i in range(data.shape[0]):
            dia = DIAMatrix(data=data[i], offsets=offsets,
                            shape=(data.shape[2],) * 2)
            one = tpucg.cg_solve(dia, b[i], tol=1e-5)
            assert int(np.asarray(res.iterations)[i]) == int(one.iterations)
            np.testing.assert_allclose(np.asarray(res.x)[i],
                                       np.asarray(one.x),
                                       rtol=2e-4, atol=1e-5)

    def test_jacobi_and_bf16(self):
        import jax.numpy as jnp

        import tpucg

        data, offsets, b = self._battery(seed=1)
        # Badly scale each system symmetrically (A' = D A D stays SPD):
        # data[d, j] = A[j, j+off] scales by s_j * s_{j+off}.
        s = 10.0 ** np.random.default_rng(2).uniform(
            -1, 1, (data.shape[0], data.shape[2])).astype(np.float32)
        data[:, 1] *= s * s
        data[:, 0, 1:] *= s[:, 1:] * s[:, :-1]
        data[:, 2, :-1] *= s[:, :-1] * s[:, 1:]
        res = tpucg.cg_solve_batch_banded(data, offsets, b, tol=1e-4,
                                          precondition="jacobi",
                                          maxiter=4 * data.shape[2])
        assert np.asarray(res.converged).all()
        r16 = tpucg.cg_solve_batch_banded(data, offsets, b, tol=1e-3,
                                          precondition="jacobi",
                                          maxiter=4 * data.shape[2],
                                          storage_dtype=jnp.bfloat16)
        assert np.asarray(r16.converged).all()

    def test_jacobi_parity_with_per_system_solves(self):
        # Each system of a Jacobi-preconditioned batch against its own
        # serial Jacobi solve (n=512: no alignment padding either way).
        import tpucg
        from tpucg.sparse.formats import DIAMatrix

        data, offsets, b = self._battery(nsys=3, n=512, seed=3)
        res = tpucg.cg_solve_batch_banded(data, offsets, b, tol=1e-5,
                                          precondition="jacobi")
        assert np.asarray(res.converged).all()
        for i in range(data.shape[0]):
            dia = DIAMatrix(data=data[i], offsets=offsets,
                            shape=(data.shape[2],) * 2)
            one = tpucg.cg_solve(dia, b[i], tol=1e-5, precondition="jacobi")
            assert abs(int(np.asarray(res.iterations)[i])
                       - int(one.iterations)) <= 1
            np.testing.assert_allclose(np.asarray(res.x)[i],
                                       np.asarray(one.x),
                                       rtol=2e-4, atol=1e-5)
