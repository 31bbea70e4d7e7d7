"""MINRES tests (solver/minres.py) — symmetric indefinite extension.

CG's alpha = r.r / p.Ap contract requires SPD (the reference would NaN on
an indefinite quadratic form, serialConjugate.c:219-220); MINRES needs
symmetry only.
"""

import numpy as np
import pytest

import tpucg
from tpucg.solver.minres import minres_solve


def _sym_indefinite(n=192, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    half = n // 2
    lam = np.concatenate([
        -(1.0 + rng.uniform(0.0, 1.0, half)),   # negative branch
        1.0 + rng.uniform(0.0, 1.0, n - half),  # positive branch
    ])
    A = (Q * lam) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32)


class TestMinres:
    def test_indefinite_converges_where_cg_cannot(self):
        A = _sym_indefinite()
        n = A.shape[0]
        b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        res = minres_solve(A, b, tol=tol, maxiter=4 * n)
        assert bool(res.converged)
        x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(np.asarray(res.x), x_ref,
                                   rtol=1e-3, atol=1e-3)
        # (CG on indefinite systems is UNGUARANTEED — it may luck into a
        # solution or NaN depending on the spectrum; MINRES is the
        # guaranteed path, which is the point of this module.)

    def test_spd_matches_cg(self):
        A, b, x0 = tpucg.generate_spd_system(128, seed=2)
        A, b, x0 = map(np.asarray, (A, b, x0))
        tol = 1e-5 * float(np.linalg.norm(b))
        r_mr = minres_solve(A, b, x0, tol=tol)
        r_cg = tpucg.cg_solve(A, b, x0, tol=tol)
        assert bool(r_mr.converged)
        np.testing.assert_allclose(np.asarray(r_mr.x), np.asarray(r_cg.x),
                                   rtol=1e-3, atol=1e-4)

    def test_golden_2x2(self):
        from tpucg.io.golden import GOLDEN_2X2

        g = GOLDEN_2X2
        res = minres_solve(g["A"], g["b"], g["x0"])
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), g["x_star"],
                                   atol=1e-5)

    def test_exact_x0_zero_iterations(self):
        A = _sym_indefinite(n=64, seed=3)
        x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
        b = (A @ x).astype(np.float32)
        res = minres_solve(A, b, x, tol=1e-3)
        assert bool(res.converged)
        assert int(res.iterations) == 0

    def test_padding_and_operator_input(self):
        # n=100 (no 128 multiple) through the operator path; kernel="pallas"
        # is refused (no operator has a Pallas kernel).
        A = _sym_indefinite(n=100, seed=5)
        b = np.random.default_rng(6).standard_normal(100).astype(np.float32)
        tol = 1e-4 * float(np.linalg.norm(b))
        with pytest.raises(ValueError, match="pallas"):
            minres_solve(A, b, tol=tol, maxiter=800, kernel="pallas")
        res = minres_solve(tpucg.DenseOperator.create(A), b, tol=tol,
                           maxiter=800)
        assert bool(res.converged)
        assert res.x.shape == (100,)
        x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(np.asarray(res.x), x_ref,
                                   rtol=1e-2, atol=1e-2)

    def test_sharded_parity_both_strategies(self):
        # 8-device CPU mesh: row-sharded matvec + psum dots, same loop.
        A = _sym_indefinite(n=256, seed=9)
        b = np.random.default_rng(10).standard_normal(256).astype(np.float32)
        tol = 1e-4 * float(np.linalg.norm(b))
        ser = minres_solve(A, b, tol=tol, maxiter=1024)
        assert bool(ser.converged)
        for strategy in ("allgather", "overlap"):
            sh = tpucg.sharded_minres_solve(A, b, tol=tol, maxiter=1024,
                                            strategy=strategy)
            assert bool(sh.converged), strategy
            assert abs(int(sh.iterations) - int(ser.iterations)) <= 2
            np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ser.x),
                                       rtol=1e-2, atol=1e-3)

    def test_sharded_nondivisible_pads(self):
        A = _sym_indefinite(n=100, seed=11)
        b = np.random.default_rng(12).standard_normal(100).astype(np.float32)
        tol = 1e-4 * float(np.linalg.norm(b))
        res = tpucg.sharded_minres_solve(A, b, tol=tol, maxiter=800)
        assert bool(res.converged)
        assert res.x.shape == (100,)
        x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(np.asarray(res.x), x_ref,
                                   rtol=1e-2, atol=1e-2)

    def test_maxiter_cap_and_guards(self):
        A = _sym_indefinite(n=96, seed=7)
        b = np.random.default_rng(8).standard_normal(96).astype(np.float32)
        res = minres_solve(A, b, tol=1e-30, maxiter=5)
        assert int(res.iterations) == 5 and not bool(res.converged)
        with pytest.raises(ValueError, match="SPD M"):
            minres_solve(A, b, precondition="poly")
        with pytest.raises(ValueError, match="method"):
            minres_solve(A, b, method="pipelined")

    def test_jacobi_preconditioned_indefinite(self):
        # Badly diagonal-scaled indefinite system: in f32, PLAIN MINRES
        # stalls far above tol (residual ~1e1 after 16n laps) while |diag|
        # Jacobi converges in a few hundred — preconditioning is load-
        # bearing here, not an optimization.
        n = 256
        rng = np.random.default_rng(13)
        A = _sym_indefinite(n=n, seed=13)
        s = 10.0 ** rng.uniform(-2, 2, n)
        A = (A * s[None, :] * s[:, None]).astype(np.float32)
        A = 0.5 * (A + A.T)
        b = rng.standard_normal(n).astype(np.float32)
        tol = 1e-3 * float(np.linalg.norm(b))
        plain = minres_solve(A, b, tol=tol, maxiter=16 * n)
        pc = minres_solve(A, b, tol=tol, maxiter=16 * n,
                          precondition="jacobi")
        assert bool(pc.converged) and not bool(plain.converged)
        assert int(pc.iterations) < int(plain.iterations)
        # True-residual contract: the reported norm is honest.
        r = b - A @ np.asarray(pc.x)
        np.testing.assert_allclose(np.linalg.norm(r),
                                   float(pc.residual_norm), rtol=1e-2)
        assert np.linalg.norm(r) <= tol

    def test_block_jacobi_preconditioned(self):
        n = 192
        rng = np.random.default_rng(14)
        A = _sym_indefinite(n=n, seed=14)
        s = 10.0 ** rng.uniform(-1.5, 1.5, n)
        A = (A * s[None, :] * s[:, None]).astype(np.float32)
        A = 0.5 * (A + A.T)
        b = rng.standard_normal(n).astype(np.float32)
        tol = 1e-3 * float(np.linalg.norm(b))
        plain = minres_solve(A, b, tol=tol, maxiter=16 * n)
        pc = minres_solve(A, b, tol=tol, maxiter=16 * n,
                          precondition="block_jacobi", pc_block_size=32)
        assert bool(pc.converged)
        assert int(pc.iterations) < int(plain.iterations)
        r = b - A @ np.asarray(pc.x)
        assert np.linalg.norm(r) <= tol

    def test_jacobi_spd_matches_unpreconditioned_solution(self):
        # On an SPD system |diag| == diag: preconditioned MINRES solves to
        # the same x as plain (different lap counts allowed).
        A, b, _ = tpucg.generate_spd_system(160, seed=15)
        A, b = np.asarray(A), np.asarray(b)
        tol = 1e-5 * float(np.linalg.norm(b))
        pc = minres_solve(A, b, tol=tol, precondition="jacobi")
        assert bool(pc.converged)
        x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(np.asarray(pc.x), x_ref,
                                   rtol=1e-3, atol=1e-3)

    def test_operator_backends_dia_and_stencil(self):
        # MINRES over sparse operator backends (SPD instances: the
        # operators themselves are SPD; MINRES must match CG's answer).
        from tpucg.io.generator import poisson3d_dia
        from tpucg.solver.operators import DiaOperator, PoissonOperator

        dia = poisson3d_dia(8)
        n = 512
        op = DiaOperator.from_dia(dia)
        b = np.random.default_rng(16).standard_normal(n).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        r_mr = minres_solve(op, b, tol=tol)
        r_cg = tpucg.cg_solve(op, b, tol=tol)
        assert bool(r_mr.converged)
        np.testing.assert_allclose(np.asarray(r_mr.x), np.asarray(r_cg.x),
                                   rtol=1e-3, atol=1e-4)
        pois = PoissonOperator(m=8)
        r_p = minres_solve(pois, b, tol=tol, precondition="jacobi")
        assert bool(r_p.converged)
        np.testing.assert_allclose(np.asarray(r_p.x), np.asarray(r_cg.x),
                                   rtol=1e-3, atol=1e-4)

    def test_sharded_preconditioned(self):
        n = 256
        rng = np.random.default_rng(17)
        A = _sym_indefinite(n=n, seed=17)
        s = 10.0 ** rng.uniform(-1.5, 1.5, n)
        A = (A * s[None, :] * s[:, None]).astype(np.float32)
        A = 0.5 * (A + A.T)
        b = rng.standard_normal(n).astype(np.float32)
        tol = 1e-3 * float(np.linalg.norm(b))
        ser = minres_solve(A, b, tol=tol, maxiter=16 * n,
                           precondition="jacobi")
        assert bool(ser.converged)
        its = {}
        for pc in ("jacobi", "block_jacobi"):
            sh = tpucg.sharded_minres_solve(A, b, tol=tol, maxiter=16 * n,
                                            precondition=pc,
                                            pc_block_size=32)
            assert bool(sh.converged), pc
            r = b - A @ np.asarray(sh.x)
            assert np.linalg.norm(r) <= tol, pc
            its[pc] = int(sh.iterations)
        # Parity on the SAME preconditioner (block-Jacobi quality differs
        # from point-Jacobi by construction): sharded jacobi must track the
        # serial jacobi lap count.
        assert abs(its["jacobi"] - int(ser.iterations)) <= 50

    def test_operator_sharded_dia_indefinite(self):
        # Band-halo sharded MINRES on an INDEFINITE banded system: the 1-D
        # Laplacian shifted into its spectrum (tridiag(-1, 2-1.7, -1));
        # sharded_minres_solve dispatches DIA inputs to the operator
        # decomposition of sharded_operator_cg_solve.
        from tpucg.sparse.formats import DIAMatrix

        n = 1024
        shift = 1.7
        data = np.zeros((3, n), np.float32)
        data[0, :] = -1.0   # offset -1
        data[1, :] = 2.0 - shift
        data[2, :] = -1.0   # offset +1
        dia = DIAMatrix(data=data, offsets=(-1, 0, 1), shape=(n, n))
        A = dia.to_dense()
        lam = np.linalg.eigvalsh(A.astype(np.float64))
        assert lam[0] < 0 < lam[-1]  # genuinely indefinite
        b = np.random.default_rng(21).standard_normal(n).astype(np.float32)
        tol = 1e-4 * float(np.linalg.norm(b))
        x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        for pc in ("none", "jacobi"):
            sh = tpucg.sharded_minres_solve(dia, b, tol=tol, maxiter=8 * n,
                                            precondition=pc)
            assert bool(sh.converged), pc
            assert np.linalg.norm(b - A @ np.asarray(sh.x)) <= tol * 1.5, pc
            np.testing.assert_allclose(np.asarray(sh.x), x_ref,
                                       rtol=5e-3, atol=5e-3)

    def test_operator_sharded_poisson_and_ell(self):
        # Slab-halo (Poisson stencil) and allgather (ELL) operator arms of
        # sharded MINRES; SPD instances so the answer must match sharded CG.
        from tpucg.solver.operators import EllOperator, PoissonOperator

        m = 8
        n = m ** 3
        pois = PoissonOperator(m=m)
        b = np.random.default_rng(22).standard_normal(n).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        cg = tpucg.sharded_operator_cg_solve(pois, b, tol=tol)
        mr = tpucg.sharded_minres_solve(pois, b, tol=tol, maxiter=4 * n)
        assert bool(mr.converged)
        np.testing.assert_allclose(np.asarray(mr.x), np.asarray(cg.x),
                                   rtol=1e-3, atol=1e-4)

        ell = EllOperator.from_csr(tpucg.poisson3d_csr(m))
        mre = tpucg.sharded_minres_solve(ell, b, tol=tol, maxiter=4 * n,
                                         precondition="jacobi")
        assert bool(mre.converged)
        np.testing.assert_allclose(np.asarray(mre.x), np.asarray(cg.x),
                                   rtol=1e-3, atol=1e-4)

    def test_operator_sharded_block_jacobi_refuses(self):
        from tpucg.solver.operators import PoissonOperator

        b = np.ones(512, np.float32)
        with pytest.raises(ValueError, match="block Jacobi"):
            tpucg.sharded_minres_solve(PoissonOperator(m=8), b,
                                       precondition="block_jacobi")
