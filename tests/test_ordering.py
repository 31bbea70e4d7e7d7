"""Ordering tests: strength-filtered RCM (semi-coarsening by numbering).

The two-level preconditioner aggregates CONTIGUOUS index blocks
(``twolevel.py``); ``strength_order`` makes contiguity follow the strong
couplings so those aggregates semi-coarsen anisotropic operators — the
ordering-based analog of classic AMG's strength-of-connection coarsening
(the reference has no preconditioning at all; ``serialConjugate.c:180-259``
is plain CG, so this whole axis is tpucg extension surface).
"""

import numpy as np
import pytest

import tpucg
from tpucg.io.generator import aniso_grid_system, fem_p1_system
from tpucg.sparse.ordering import permute_csr, rcm_order, strength_order


def _is_perm(p, n):
    return p.shape == (n,) and np.array_equal(np.sort(p), np.arange(n))


def test_strength_order_is_permutation_fem():
    A, _, _ = fem_p1_system(400, seed=3)
    n = A.shape[0]
    for theta in (0.05, 0.25, 0.6):
        assert _is_perm(strength_order(A, theta=theta), n)


def test_strength_order_handles_empty_strong_graph():
    # theta so high every off-diagonal is weak: the strong graph is all
    # isolated vertices; the order must still be a permutation.
    A, _, _ = aniso_grid_system(8, eps=0.5)
    assert _is_perm(strength_order(A, theta=10.0), A.shape[0])


def test_aniso_grid_system_spd_and_shuffle_similar():
    A, b, x0 = aniso_grid_system(12, eps=1e-2, shuffle=False)
    As, _, _ = aniso_grid_system(12, eps=1e-2, shuffle=True)
    D = A.to_dense().astype(np.float64)
    assert np.allclose(D, D.T)
    w = np.linalg.eigvalsh(D)
    assert w.min() > 0
    # Shuffling is a symmetric permutation: same spectrum.
    ws = np.linalg.eigvalsh(As.to_dense().astype(np.float64))
    np.testing.assert_allclose(np.sort(w), np.sort(ws), rtol=1e-6)
    assert b.shape == (144,) and x0.shape == (144,)


def test_strength_order_semicoarsens_aniso_grid():
    """On a SHUFFLED structured anisotropic grid, strength ordering must
    recover line-contiguous numbering — measurably fewer two-level PCG
    laps than plain RCM (which follows weak and strong edges alike).
    Measured at m=80: rcm 206 laps vs strength 137 vs 117 for the native
    row-major ordering; asserted here at m=40 with slack."""
    import jax.numpy as jnp

    from tpucg.solver.operators import as_operator

    m = 40
    A, b, _ = aniso_grid_system(m, eps=1e-2, seed=0, shuffle=True)
    n = A.shape[0]
    # above the TRUE-residual f32 floor (~1.2e-5 relative here) the
    # round-5 honest stopping enforces
    tol = 5e-5 * float(np.linalg.norm(b))

    def laps(order_fn):
        perm = order_fn(A)
        B = permute_csr(A, perm)
        op = as_operator(jnp.asarray(B.to_dense()))
        tl = tpucg.build_two_level(B, agg_size=32, npad=op.padded_n)
        r = tpucg.cg_solve(op, b[perm], tol=tol, maxiter=8 * n,
                           two_level=tl)
        assert bool(r.converged)
        # Solution correctness through the permutation round-trip.
        x = np.empty(n, np.float32)
        x[perm] = np.asarray(r.x)[:n]
        res = np.linalg.norm(A.to_dense().astype(np.float64) @ x - b)
        assert res < 2.0 * tol
        return int(r.iterations)

    l_rcm = laps(rcm_order)
    l_str = laps(lambda c: strength_order(c, theta=0.25))
    assert l_str < 0.85 * l_rcm, (l_str, l_rcm)


def test_cli_strength_order_two_level(tmp_path, capsys):
    from tpucg.cli import main

    A, b, _ = aniso_grid_system(24, eps=1e-2, seed=1, shuffle=True)
    amtx = str(tmp_path / "Aaniso.mtx")
    bmtx = str(tmp_path / "baniso.mtx")
    tpucg.save_matrix_market(amtx, A.to_coo(), symmetric=True)
    tpucg.save_matrix_market(bmtx, b)
    tol = 1e-4 * float(np.linalg.norm(b))
    rc = main(["solve", amtx, bmtx, "--strength-order",
               "--two-level", "16", "--tol", str(tol)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "+strength" in out and "converged            : True" in out
