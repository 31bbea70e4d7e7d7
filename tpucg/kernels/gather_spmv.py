"""Irregular-sparse SpMV over the WELL (windowed gather-ELL) format.

See ``tpucg.sparse.well`` for the format: nonzeros packed into 128-slot
sublane rows whose columns share one 128-wide window of x, grouped into
8-row chunks that share a window row. The product is a row gather of the
windows, a lane gather inside each window, a multiply, and a scatter-add of
each sublane row into its output group row.

Reference analog: the hot-kernel contract of ``serialConjugate.c:109-120``
(do the platform's matvec right), extended to irregular sparsity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LANE = 128
CHUNK = 8


@functools.partial(jax.jit, static_argnames=("bg", "nsg"))
def well_spmv_xla(
    vals: jax.Array,
    lidx: jax.Array,
    gidl: jax.Array,
    wrow: jax.Array,
    sgb: jax.Array,
    x2: jax.Array,
    bg: int,
    nsg: int,
) -> jax.Array:
    """WELL SpMV. Returns y2 (nsg*bg, 128).

    The segment sum is XLA's scatter-add, which the GPU runs with atomics:
    its rounding changes from run to run, so compare results with a
    tolerance, never bit for bit.
    """
    NB, BS = gidl.shape
    xg = jnp.repeat(jnp.take(x2, wrow, axis=0), CHUNK, axis=0)
    # bf16 storage upcasts to the vector dtype (f32); f64 stays generic.
    acc_t = jnp.promote_types(vals.dtype, x2.dtype)
    P = vals.astype(acc_t) * jnp.take_along_axis(
        xg, lidx.astype(jnp.int32), axis=1
    )
    g_of_sub = jnp.repeat(sgb.astype(jnp.int32), BS) * bg + gidl.reshape(-1)
    y2 = jnp.zeros((nsg * bg, LANE), P.dtype)
    return y2.at[g_of_sub].add(P)
