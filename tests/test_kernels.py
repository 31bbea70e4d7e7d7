"""Kernel unit tests vs NumPy references: the dense GEMV, the BLAS-1 update,
the sparse products, and the precision every f32 contraction requests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpucg.kernels.blas1 import dot_xla, fused_update
from tpucg.kernels.matvec import matvec_xla
from tpucg.kernels.spmv import bsr_ell_spmv, ell_spmv
from tpucg.io.generator import poisson3d_csr
from tpucg.sparse.formats import csr_to_bsr, csr_to_ell


@pytest.mark.parametrize("shape", [(128, 128), (256, 512), (100, 300)])
def test_matvec_xla_shapes(shape):
    # The dense GEMV (XLA's dot) on square, wide and unaligned shapes.
    rng = np.random.default_rng(0)
    A = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape[1]).astype(np.float32)
    got = np.asarray(matvec_xla(jnp.asarray(A), jnp.asarray(x)))
    np.testing.assert_allclose(got, A @ x, rtol=1e-5, atol=1e-4)


def test_matvec_xla_rectangular():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((16, 48)).astype(np.float32)
    x = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(matvec_xla(jnp.asarray(A), jnp.asarray(x))),
        A @ x,
        rtol=1e-5,
        atol=1e-5,
    )


@pytest.mark.parametrize("n", [128, 1024, 1000])
def test_dot_xla(n):
    rng = np.random.default_rng(2)
    u = rng.standard_normal(n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    got = float(dot_xla(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, float(u @ v), rtol=1e-5, atol=1e-4)


def test_fused_update():
    n = 500
    rng = np.random.default_rng(3)
    x, r, p, ap = (rng.standard_normal(n).astype(np.float32) for _ in range(4))
    alpha = np.float32(0.37)
    xn, rn, beta = jax.jit(fused_update)(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(p), jnp.asarray(ap),
        jnp.float32(alpha),
    )
    exp_x = x + alpha * p
    exp_r = r - alpha * ap
    # A fused multiply-add rounds differently from NumPy's two-op
    # sequence; the tolerance covers the one-ulp difference.
    np.testing.assert_allclose(np.asarray(xn), exp_x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rn), exp_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(beta), float(exp_r @ exp_r), rtol=1e-5)


def test_ell_spmv_matches_csr():
    csr = poisson3d_csr(4)
    ell = csr_to_ell(csr)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(csr.shape[0]).astype(np.float32)
    got = np.asarray(
        ell_spmv(jnp.asarray(ell.values), jnp.asarray(ell.indices), jnp.asarray(x))
    )
    np.testing.assert_allclose(got, csr.matvec(x), rtol=1e-5, atol=1e-5)


def test_bsr_ell_spmv_matches_csr():
    from tpucg.solver.operators import BsrOperator

    csr = poisson3d_csr(4)
    op = BsrOperator.from_bsr(csr_to_bsr(csr, 4))
    x = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    got = np.asarray(bsr_ell_spmv(op.values, op.indices, jnp.asarray(x)))
    np.testing.assert_allclose(got, csr.matvec(x), rtol=1e-5, atol=1e-5)


def _lowered(fn, *args) -> str:
    return jax.jit(fn).lower(*args).as_text()


@pytest.mark.parametrize("which", ["matvec", "dot", "bsr", "minres_block"])
def test_f32_contractions_request_highest_precision(which):
    """On the GPU an f32 product may run in TF32 (about three decimal
    digits) unless the contraction asks for full precision, which breaks
    the float32 contract (the 4x4 golden stops short of tol 1e-6). Every
    contraction on the solve path must carry precision HIGHEST."""
    f = jnp.zeros((8, 8), jnp.float32)
    v = jnp.zeros((8,), jnp.float32)
    if which == "matvec":
        text = _lowered(matvec_xla, f, v)
    elif which == "dot":
        text = _lowered(dot_xla, v, v)
    elif which == "bsr":
        text = _lowered(bsr_ell_spmv, jnp.zeros((2, 1, 4, 4)),
                        jnp.zeros((2, 1), jnp.int32), v)
    else:
        from tpucg.solver.minres import abs_inv_blocks

        blocks = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (2, 1, 1))
        text = _lowered(abs_inv_blocks, blocks)
    assert "dot_general" in text
    for line in text.splitlines():
        if "dot_general" in line:
            assert "HIGHEST" in line, line


def test_chain_extra_sizing():
    """Chain-repetition sizing: small estimates keep the floor of 8 (the
    extra work must dominate host noise), large estimates drop to one extra
    solve, and the target_s budget bounds the middle."""
    from tpucg.bench.timing import _chain_extra

    assert _chain_extra(None, 0.05) == 8
    assert _chain_extra(0.0, 0.05) == 8
    assert _chain_extra(1e-5, 0.05) == 256   # capped
    assert _chain_extra(0.002, 0.05) == 25   # target/est
    assert _chain_extra(0.01, 0.05) == 5     # floor ceil(40ms/est)=4 < 5
    assert _chain_extra(0.05, 0.05) == 1
    assert _chain_extra(1.0, 0.05) == 1
