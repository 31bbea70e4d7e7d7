"""BLAS-1 level operations: dot products and the fused CG vector update.

The reference performs the per-iteration vector work as six separate O(n)
passes (``scalarVec`` + ``vecAdd`` for x, ``scalarVec`` + ``vecSub`` for r, a
``vecVec`` for beta — ``serialConjugate.c:221-234``). Written as one jnp
expression inside the jitted loop, XLA fuses the x/r update and r.r into a
single streaming pass (PERF.md records the fusions per lap).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot_xla(u: jax.Array, v: jax.Array) -> jax.Array:
    """Exact vector dot (reference ``vecVec``). precision=HIGHEST keeps the
    product out of TF32 — CG's alpha/beta scalars need full-precision
    products (see matvec_xla). Accumulates in at least f32 (f64 solves keep
    f64)."""
    pet = jnp.promote_types(u.dtype, jnp.float32)
    return jnp.dot(
        u, v,
        preferred_element_type=pet,
        precision=jax.lax.Precision.HIGHEST,
    )


def fused_update(x, r, p, ap, alpha):
    """The CG vector update: returns (x + alpha p, r - alpha Ap, r'.r')."""
    xn = x + alpha * p
    rn = r - alpha * ap
    return xn, rn, dot_xla(rn, rn)
