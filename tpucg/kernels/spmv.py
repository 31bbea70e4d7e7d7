"""Sparse matrix-vector products.

The general device format is ELLPACK (``tpucg.sparse.formats.EllMatrix``):
values and column indices as dense (n, L) arrays. SpMV is then a gather of x
by the index matrix followed by an elementwise multiply and row-sum — fully
static shapes. Banded matrices take DIA (one shifted multiply-add per stored
diagonal, no gather); stencil operators (Poisson) take the matrix-free
``PoissonOperator``, which needs no stored matrix at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ell_spmv(values: jax.Array, indices: jax.Array, x: jax.Array) -> jax.Array:
    """y[i] = sum_k values[i, k] * x[indices[i, k]].

    Padded entries carry value 0 (index 0), contributing nothing.
    """
    gathered = jnp.take(x, indices, axis=0)
    return jnp.sum(values * gathered, axis=1)


def _shift_flat(x: jax.Array, off: int) -> jax.Array:
    """x shifted by a static offset with zero fill: result[i] = x[i + off]
    (0 outside [0, n)) — the DIA shift semantics, shared by every XLA arm."""
    if off == 0:
        return x
    if off > 0:
        return jnp.concatenate([x[off:], jnp.zeros((off,), x.dtype)])
    k = -off
    return jnp.concatenate([jnp.zeros((k,), x.dtype), x[:-k]])


def _acc_dtype(data: jax.Array, x: jax.Array):
    # bf16 storage accumulates in f32; f64 solves stay f64.
    return jnp.promote_types(jnp.promote_types(data.dtype, x.dtype),
                             jnp.float32)


def dia_spmv(
    data: jax.Array, offsets: tuple, x: jax.Array
) -> jax.Array:
    """DIA SpMV: y[i] = sum_d data[d, i] * x[i + offsets[d]].

    ``data`` is the canonical (ndiag, n) layout; ``offsets`` is a static
    tuple, so each diagonal lowers to a statically shifted (pad + slice)
    multiply-add — no gather. XLA fuses the shifts into one pass.
    """
    acc = _acc_dtype(data, x)
    y = jnp.zeros(x.shape, acc)
    for d, off in enumerate(offsets):
        y = y + data[d].astype(acc) * _shift_flat(x, int(off)).astype(acc)
    return y


def dia_halo_width(offsets: tuple) -> int:
    """Elements each neighbour contributes to a row block's DIA product:
    the band's reach (at least 1, so the ppermute ring always has a
    payload)."""
    return max(1, max(abs(int(o)) for o in offsets))


def dia_spmv_halo(
    data: jax.Array,
    offsets: tuple,
    x: jax.Array,
    halo_lo: jax.Array,
    halo_hi: jax.Array,
) -> jax.Array:
    """Row-block DIA SpMV with neighbour halos: ``data`` is this block's
    (ndiag, nb) slab, ``halo_lo``/``halo_hi`` the ``dia_halo_width``
    elements before and after the block (zeros at the ends of the chain).
    Extends the block once, then takes one static slice per diagonal."""
    n = x.shape[0]
    pad = halo_lo.shape[0]
    x_ext = jnp.concatenate([halo_lo, x, halo_hi])
    acc = _acc_dtype(data, x)
    y = jnp.zeros(x.shape, acc)
    for d, off in enumerate(offsets):
        xs = jax.lax.slice(x_ext, (pad + off,), (pad + off + n,))
        y = y + data[d].astype(acc) * xs.astype(acc)
    return y


def bsr_ell_spmv(
    values: jax.Array, indices: jax.Array, x: jax.Array
) -> jax.Array:
    """Block-ELL SpMV: values (nbr, L, bs, bs), indices (nbr, L) block-column
    ids, x (nbr_cols * bs,). Each block row gathers L dense x-blocks and does
    a batched (bs x bs) matvec — the gather moves bs elements per index (vs 1
    for scalar ELL). precision=HIGHEST keeps the f32 block products out of
    TF32 (same contract as kernels.matvec).
    """
    nbr, L, bs, _ = values.shape
    xb = x.reshape(-1, bs)
    gathered = jnp.take(xb, indices.reshape(-1), axis=0).reshape(nbr, L, bs)
    return jnp.einsum(
        "rlij,rlj->ri",
        values,
        gathered,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(nbr * bs)
