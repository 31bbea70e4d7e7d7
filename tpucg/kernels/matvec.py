"""Dense GEMV: y = A @ x.

This is the hot kernel of dense CG — O(n^2) per iteration, every iteration
(reference: ``matVec``, ``serialConjugate.c:109-120`` / ``parallel_cg.c:172-184``).
It is bound by memory bandwidth (A is read once per call; FLOP:byte = 0.5 for
f32) and has nothing to fuse, so it is XLA's dot, which the GPU backend hands
to cuBLAS.

Shapes may be rectangular (rows, cols) — the sharded solver calls this on
row-blocks A_blk (n/P, n) (reference: ``parallel_cg.c:292``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matvec_xla(A: jax.Array, x: jax.Array) -> jax.Array:
    """jnp dot with at least f32 accumulation (bf16 storage upcasts).

    precision=HIGHEST is load-bearing: without it an f32 product may run in
    TF32, which keeps about three decimal digits per product and stalls
    CG's residual around 1e-3-1e-4 — the reference's 4x4 golden system then
    fails to reach tol=1e-6.
    """
    pet = jnp.promote_types(jnp.promote_types(A.dtype, x.dtype), jnp.float32)
    return jnp.dot(
        A, x,
        preferred_element_type=pet,
        precision=jax.lax.Precision.HIGHEST,
    )
