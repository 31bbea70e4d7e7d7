"""Linear operators — the abstraction CG actually needs.

The reference's CG is welded to a dense row-major matrix (``matVec``,
``serialConjugate.c:109-120``). tpucg decouples the iteration from the
operator: anything with a ``matvec`` is solvable — dense (GEMV), banded
(DIA), blocky (BSR), irregular sparse (ELL, WELL), or matrix-free stencils
(7-point Poisson).
Operators are registered JAX pytrees so they flow through ``jit`` /
``lax.while_loop`` with their arrays as traced leaves and their structure
(shapes) as static metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpucg.io.partitioner import round_up
from tpucg.kernels.matvec import matvec_xla
from tpucg.kernels.spmv import bsr_ell_spmv, dia_spmv, ell_spmv
from tpucg.sparse.formats import (
    BSRMatrix,
    CSRMatrix,
    DIAMatrix,
    EllMatrix,
    csr_to_ell,
)


class LinearOperator:
    """Abstract SPD operator. Subclasses: DenseOperator, EllOperator,
    PoissonOperator, or any user pytree with ``matvec`` and ``n``."""

    n: int  # logical system size

    @property
    def padded_n(self) -> int:
        """Device-side vector length (>= n; kernels may require alignment)."""
        return self.n

    def matvec(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def diagonal(self) -> jax.Array:
        """diag(A), padded length — for the Jacobi preconditioner."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a diagonal; "
            "precondition='jacobi' is unavailable for it"
        )

    def diagonal_blocks(self, bs: int) -> jax.Array:
        """The (ceil(padded_n/bs), bs, bs) diagonal blocks of A — for the
        block-Jacobi preconditioner. Rows past padded_n (when bs does not
        divide it) are identity. Exact extraction is format-specific
        (probing with strided basis vectors aliases off-block entries for
        ANY nonzero bandwidth), so only formats that store their
        diagonal-block entries addressably implement it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose diagonal blocks; "
            "precondition='block_jacobi' is unavailable for it"
        )

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)


def _blocks_from_diag_data(offsets, data, bs: int) -> jax.Array:
    """Assemble (nb, bs, bs) diagonal blocks from DIA-style storage:
    ``data[d, i] = A[i, i + offsets[d]]`` (canonical (ndiag, N)). An entry
    lands in a block iff its row AND column share the block, i.e.
    r = i mod bs satisfies 0 <= r + off < bs — offsets with |off| >= bs
    never contribute. Rows in the bs-alignment tail (>= N) get identity."""
    ndiag, N = len(offsets), data.shape[1]
    nb = -(-N // bs)
    dtype = jnp.promote_types(data.dtype, jnp.float32)
    if nb * bs != N:
        data = jnp.pad(data, ((0, 0), (0, nb * bs - N)))
    blocks = jnp.zeros((nb, bs, bs), dtype)
    for d in range(ndiag):
        off = int(offsets[d])
        if abs(off) >= bs:
            continue
        rs = np.arange(max(0, -off), bs - max(0, off))
        blocks = blocks.at[:, rs, rs + off].set(
            data[d].reshape(nb, bs)[:, rs].astype(dtype)
        )
    if nb * bs != N:
        tail = jnp.arange(nb * bs).reshape(nb, bs) >= N
        blocks = jnp.where(
            tail[:, :, None] | tail[:, None, :], 0.0, blocks
        ) + jnp.eye(bs, dtype=dtype)[None] * tail[:, :, None]
    return blocks


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense SPD matrix; the matvec is XLA's GEMV at HIGHEST precision."""

    A: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, A, dtype=np.float32) -> "DenseOperator":
        """``dtype`` is the device STORAGE dtype of A: float32 (the reference
        contract), bfloat16 (half the bytes streamed per matvec; f32
        accumulation — an extension), or float64 (needs x64 mode)."""
        dtype = jnp.dtype(dtype)
        A = np.asarray(A)
        if jnp.dtype(A.dtype) != dtype:
            # bf16 has no native NumPy repr; stage in f32 (ml_dtypes-typed
            # bf16 input passes through, halving the host->device transfer
            # for the large-n benchmarks).
            A = A.astype(np.float32 if dtype == jnp.bfloat16 else dtype)
        n = A.shape[0]
        if A.shape != (n, n):
            raise ValueError(f"A must be square, got {A.shape}")
        return cls(A=jnp.asarray(A, dtype=dtype), n=n)

    @property
    def padded_n(self) -> int:
        return self.A.shape[0]

    def matvec(self, x: jax.Array) -> jax.Array:
        return matvec_xla(self.A, x)

    def diagonal(self) -> jax.Array:
        # Identity pad tail -> 1.0, safe to invert; bf16 storage upcast.
        return jnp.diagonal(self.A).astype(
            jnp.promote_types(self.A.dtype, jnp.float32)
        )

    def diagonal_blocks(self, bs: int) -> jax.Array:
        # One-time setup gather of (nb, bs, bs) entries; out-of-range tail
        # indices (bs not dividing padded_n) clamp, get zeroed by the
        # validity mask, and take identity diagonals.
        N = self.padded_n
        nb = -(-N // bs)
        dtype = jnp.promote_types(self.A.dtype, jnp.float32)
        idx = jnp.arange(nb * bs)
        valid = (idx < N).reshape(nb, bs)
        idxc = jnp.minimum(idx, N - 1).reshape(nb, bs)
        blocks = self.A[idxc[:, :, None], idxc[:, None, :]].astype(dtype)
        both = valid[:, :, None] & valid[:, None, :]
        blocks = jnp.where(both, blocks, 0.0)
        return blocks + jnp.eye(bs, dtype=dtype)[None] * (
            ~valid[:, :, None]
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllOperator(LinearOperator):
    """ELLPACK sparse operator (device form of CSR/COO)."""

    values: jax.Array
    indices: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_csr(cls, csr: CSRMatrix) -> "EllOperator":
        ell = csr_to_ell(csr)
        return cls.from_ell(ell)

    @classmethod
    def from_ell(cls, ell: EllMatrix) -> "EllOperator":
        return cls(
            values=jnp.asarray(ell.values),
            indices=jnp.asarray(ell.indices),
            n=ell.shape[0],
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        return ell_spmv(self.values, self.indices, x)

    def diagonal(self) -> jax.Array:
        rows = jax.lax.broadcasted_iota(
            self.indices.dtype, self.indices.shape, 0
        )
        return jnp.sum(
            jnp.where(self.indices == rows, self.values, 0.0), axis=1
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaOperator(LinearOperator):
    """Diagonal-storage banded operator (device form of DIA).

    ``data`` is the canonical (ndiag, n) layout: ``data[d, i] =
    A[i, i + offsets[d]]``. SpMV is a static shift-and-add per diagonal, no
    gather (``kernels.spmv.dia_spmv``). Offsets are static metadata so the
    compiler sees fixed shift shapes.
    """

    data: jax.Array
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_dia(cls, dia: DIAMatrix,
                 storage_dtype=np.float32) -> "DiaOperator":
        """``storage_dtype=bfloat16`` stores the diagonal slab in bfloat16 —
        half the footprint and streamed bytes of the SpMV (products upcast
        and accumulate in f32; the same storage-dtype extension as
        ``DenseOperator.create``). The solve satisfies the f32 contract on
        the bf16-rounded system."""
        if jnp.dtype(storage_dtype) not in (jnp.float32, jnp.bfloat16):
            raise ValueError(
                f"storage_dtype must be float32 or bfloat16, "
                f"got {storage_dtype}"
            )
        data = np.asarray(dia.data)
        if jnp.dtype(storage_dtype) == jnp.bfloat16:
            import ml_dtypes

            data = data.astype(np.float32).astype(ml_dtypes.bfloat16)
        return cls(
            data=jnp.asarray(data),
            offsets=tuple(int(o) for o in dia.offsets),
            n=dia.shape[0],
        )

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def padded_n(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: jax.Array) -> jax.Array:
        return dia_spmv(self.data, self.offsets, x)

    def diagonal(self) -> jax.Array:
        # bf16 storage upcasts (1/d must be f32); f64 stays f64.
        up = jnp.promote_types(self.data.dtype, jnp.float32)
        if 0 not in self.offsets:
            return jnp.zeros(self.padded_n, up)
        return self.data[self.offsets.index(0)].astype(up)

    def diagonal_blocks(self, bs: int) -> jax.Array:
        return _blocks_from_diag_data(self.offsets, self.data, bs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BsrOperator(LinearOperator):
    """Block-ELL sparse operator (device form of BSR).

    Block rows are padded to a uniform width L of (bs x bs) blocks — static
    shapes for XLA, with dense per-block tiles (see ``kernels.spmv.
    bsr_ell_spmv``). Padded blocks are all-zero with block-column 0.
    """

    values: jax.Array   # (nbr, L, bs, bs)
    indices: jax.Array  # (nbr, L) int32
    n: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_bsr(cls, bsr: BSRMatrix) -> "BsrOperator":
        bs = bsr.blocksize
        nbr = bsr.shape[0] // bs
        lengths = bsr.block_row_lengths
        L = max(1, int(lengths.max()) if nbr else 1)
        values = np.zeros((nbr, L, bs, bs), dtype=bsr.data.dtype)
        indices = np.zeros((nbr, L), dtype=np.int32)
        within = (
            np.arange(bsr.nnzb, dtype=np.int64)
            - np.repeat(bsr.indptr[:-1], lengths)
        )
        rows = np.repeat(np.arange(nbr, dtype=np.int64), lengths)
        values[rows, within] = bsr.data
        indices[rows, within] = bsr.indices
        return cls(
            values=jnp.asarray(values),
            indices=jnp.asarray(indices),
            n=bsr.shape[0],
        )

    @property
    def padded_n(self) -> int:
        # n may be logical (< stored rows) when the skeleton was
        # identity-padded to the blocksize (best_sparse_operator).
        nbr, _, bs, _ = self.values.shape
        return nbr * bs

    def matvec(self, x: jax.Array) -> jax.Array:
        return bsr_ell_spmv(self.values, self.indices, x)

    def diagonal(self) -> jax.Array:
        nbr, L, bs, _ = self.values.shape
        rows = jax.lax.broadcasted_iota(self.indices.dtype, (nbr, L), 0)
        on_diag = (self.indices == rows)[..., None]  # (nbr, L, 1)
        diag_blocks = jnp.sum(
            jnp.where(
                on_diag,
                jnp.diagonal(self.values, axis1=2, axis2=3),
                0.0,
            ),
            axis=1,
        )  # (nbr, bs)
        return diag_blocks.reshape(nbr * bs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WellOperator(LinearOperator):
    """Windowed gather-ELL operator — the irregular-sparse path.

    Device form of ``tpucg.sparse.well.WellMatrix``: nonzeros packed into
    128-slot sublane rows whose columns share one 128-wide window, applied
    by a window-row gather, a lane gather and a scatter-add (see
    ``kernels.gather_spmv``). Replaces scalar-gather ELL as the fallback for
    matrices that are neither banded (DIA) nor blocky (BSR).
    """

    vals: jax.Array   # (NS, 128) float32 or bfloat16 (storage_dtype)
    lidx: jax.Array   # (NS, 128) int8
    gidl: jax.Array   # (NB, BS) int32
    wrow: jax.Array   # (NS/8,) int32 — window id per 8-sublane chunk
    sgb: jax.Array    # (NB,) int32
    dvec: jax.Array   # (padded_n,) float32 — diag(A), host-built at setup
    n: int = dataclasses.field(metadata=dict(static=True))
    bg: int = dataclasses.field(metadata=dict(static=True))
    nsg: int = dataclasses.field(metadata=dict(static=True))
    # Optional (nb, bs, bs) raw diagonal blocks for block Jacobi, built
    # host-side from the source CSR (the packed WELL slabs are not
    # addressable by (row, col); see ``diagonal_blocks``).
    dblk: jax.Array = None

    @classmethod
    def from_csr(cls, csr: CSRMatrix,
                 storage_dtype=np.float32, pc_block_size=None,
                 **well_kwargs) -> "WellOperator":
        """``pc_block_size`` pre-extracts the (nb, bs, bs) diagonal blocks
        from the CSR coordinates so ``precondition='block_jacobi'`` works
        on the WELL path (the packed device form loses addressability)."""
        from tpucg.sparse.formats import csr_diagonal_blocks
        from tpucg.sparse.well import csr_to_well

        if csr.shape[0] != csr.shape[1]:
            raise ValueError(f"WellOperator needs a square matrix, got {csr.shape}")
        dblk = None
        if pc_block_size is not None:
            dblk = jnp.asarray(csr_diagonal_blocks(
                csr, int(pc_block_size), npad=round_up(csr.shape[0], 128)
            ))
        return cls.from_well(csr_to_well(csr, **well_kwargs),
                             storage_dtype=storage_dtype, dblk=dblk)

    @classmethod
    def from_well(cls, well, storage_dtype=np.float32,
                  dblk=None) -> "WellOperator":
        """``storage_dtype=bfloat16`` stores the packed VALUES in bfloat16
        (lane indices stay int8, the gathered window f32); products upcast
        and accumulate in f32. The solve satisfies the f32 contract on the
        bf16-rounded system."""
        if jnp.dtype(storage_dtype) not in (jnp.float32, jnp.bfloat16):
            raise ValueError(
                f"storage_dtype must be float32 or bfloat16, "
                f"got {storage_dtype}"
            )
        vals = well.vals
        if jnp.dtype(storage_dtype) == jnp.bfloat16:
            import ml_dtypes

            vals = np.asarray(vals, np.float32).astype(ml_dtypes.bfloat16)
        return cls(
            vals=jnp.asarray(vals),
            lidx=jnp.asarray(well.lidx),
            gidl=jnp.asarray(well.gidl),
            wrow=jnp.asarray(well.wrow),
            sgb=jnp.asarray(well.sgb),
            dvec=jnp.asarray(well.diagonal()),
            n=well.shape[0],
            bg=well.groups_per_super,
            nsg=well.n_supergroups,
            dblk=dblk,
        )

    @property
    def padded_n(self) -> int:
        # Rows [n, padded_n) carry the builder's identity tail.
        return round_up(self.n, 128)

    @property
    def n_groups(self) -> int:
        return self.padded_n // 128

    def matvec(self, x: jax.Array) -> jax.Array:
        from tpucg.kernels.gather_spmv import well_spmv_xla

        y2 = well_spmv_xla(
            self.vals, self.lidx, self.gidl, self.wrow, self.sgb,
            x.reshape(self.n_groups, 128), bg=self.bg, nsg=self.nsg,
        )
        return y2.reshape(-1)[: self.padded_n]

    def matvec_multi(self, X: jax.Array) -> jax.Array:
        """A @ X for X (padded_n, k) — the batched SpMM the multi/block
        solvers apply per lap: ``vmap`` of the single-RHS product, so the
        matrix-form lockstep loop (``multi_cg_loop``), block CG, and the
        sharded WELL decomposition share one batched-apply API."""
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def diagonal(self) -> jax.Array:
        # Built host-side at from_well time from the packed slots.
        return self.dvec

    def diagonal_blocks(self, bs: int) -> jax.Array:
        if self.dblk is None:
            raise NotImplementedError(
                "block Jacobi on a WellOperator needs the diagonal blocks "
                "extracted from the source CSR at construction: use "
                "WellOperator.from_csr(csr, pc_block_size=bs) (or "
                "best_sparse_operator(csr, pc_block_size=bs))"
            )
        if self.dblk.shape[1] != bs:
            raise ValueError(
                f"this WellOperator was built with pc_block_size="
                f"{self.dblk.shape[1]}, solve requested {bs}"
            )
        return self.dblk


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoissonOperator(LinearOperator):
    """Matrix-free 3-D 7-point Laplacian on an m^3 grid (Dirichlet).

    Identical to ``tpucg.io.generator.poisson3d_csr`` but applied as a
    stencil: 6*u - sum(in-grid neighbors), no gather, no stored matrix. The
    matvec is XLA's concat/shift form on every platform.
    """

    m: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.m ** 3

    def matvec(self, x: jax.Array) -> jax.Array:
        m = self.m
        u = x.reshape(m, m, m)
        y = 6.0 * u
        zeros = jnp.zeros_like(u[:1])
        y = y - jnp.concatenate([u[1:], zeros], axis=0)
        y = y - jnp.concatenate([zeros, u[:-1]], axis=0)
        zeros = jnp.zeros_like(u[:, :1])
        y = y - jnp.concatenate([u[:, 1:], zeros], axis=1)
        y = y - jnp.concatenate([zeros, u[:, :-1]], axis=1)
        zeros = jnp.zeros_like(u[:, :, :1])
        y = y - jnp.concatenate([u[:, :, 1:], zeros], axis=2)
        y = y - jnp.concatenate([zeros, u[:, :, :-1]], axis=2)
        return y.reshape(-1)

    def diagonal(self) -> jax.Array:
        return jnp.full(self.n, 6.0, jnp.float32)

    def diagonal_blocks(self, bs: int) -> jax.Array:
        # Stencil offsets are +-1 (x, broken at each x-line end), +-m (y,
        # broken at slab ends), +-m^2 (z); build their DIA rows with the
        # grid-boundary masks and assemble like any banded operator.
        m, N = self.m, self.n
        i = jnp.arange(N)
        offsets, rows = [0], [jnp.full(N, 6.0, jnp.float32)]
        for off, ok_fwd in (
            (1, (i % m) != m - 1),
            (m, ((i // m) % m) != m - 1),
            (m * m, (i // (m * m)) != m - 1),
        ):
            if off >= bs:
                continue  # never lands inside a bs-block
            fwd = jnp.where(ok_fwd & (i + off < N), -1.0, 0.0)
            bwd = jnp.where(
                (i >= off) & jnp.roll(ok_fwd, off), -1.0, 0.0
            )
            offsets += [off, -off]
            rows += [fwd.astype(jnp.float32), bwd.astype(jnp.float32)]
        return _blocks_from_diag_data(offsets, jnp.stack(rows), bs)


def best_sparse_operator(
    csr: CSRMatrix,
    max_diags: int = 64,
    dia_fill_cap: float = 4.0,
    blocksize: int = 8,
    bsr_fill_cap: float = 3.0,
    fallback: str = "well",
    pc_block_size=None,
) -> LinearOperator:
    """Auto-promote a CSR matrix to a structured device format.

    Picks, in order:

    1. **DIA** when the matrix is banded: at most ``max_diags`` distinct
       diagonals and dense storage (ndiag * n) within ``dia_fill_cap`` x nnz.
       Gather-free shift-and-add.
    2. **BSR** when re-blocking into (blocksize x blocksize) dense tiles
       inflates stored entries by at most ``bsr_fill_cap``: each gather then
       moves bs elements per index and the tile products are dense.
       (n is identity-padded to the blocksize if needed.)
    3. **WELL** otherwise (square matrices) — windowed gather-ELL
       (``kernels.gather_spmv``); ``fallback="ell"`` takes scalar ELL
       instead.
    """
    from tpucg.sparse.formats import csr_to_bsr, csr_to_dia

    n = csr.shape[0]
    nnz = max(csr.nnz, 1)
    offs = np.unique(csr.indices.astype(np.int64) - csr.to_coo().row)
    if offs.size <= max_diags and offs.size * n <= dia_fill_cap * nnz:
        return DiaOperator.from_dia(csr_to_dia(csr, max_diags=max_diags))
    bs = blocksize
    csr_b = csr
    if n % bs:
        npad = round_up(n, bs)
        # Identity-pad the CSR skeleton (same invariant as the partitioner).
        pad_rows = np.arange(n, npad)
        indptr = np.concatenate([
            csr.indptr,
            csr.indptr[-1] + np.arange(1, npad - n + 1),
        ])
        indices = np.concatenate([csr.indices, pad_rows.astype(np.int32)])
        data = np.concatenate([
            csr.data, np.ones(npad - n, dtype=csr.data.dtype)
        ])
        csr_b = CSRMatrix(
            indptr=indptr, indices=indices, data=data, shape=(npad, npad)
        )
    brow = csr_b.to_coo().row // bs
    bcol = csr_b.indices.astype(np.int64) // bs
    nnzb = np.unique(brow * (csr_b.shape[1] // bs) + bcol).size
    if nnzb * bs * bs <= bsr_fill_cap * nnz:
        op = BsrOperator.from_bsr(csr_to_bsr(csr_b, bs))
        if csr_b.shape[0] != n:
            # Report the logical size; solvers pad b/x via padded_n.
            op = BsrOperator(
                values=op.values, indices=op.indices, n=n
            )
        return op
    if fallback == "well" and n == csr.shape[1]:
        # pc_block_size: see WellOperator.from_csr — pre-extracts the
        # diagonal blocks so precondition='block_jacobi' is available
        # (DIA/BSR/dense extract theirs from addressable storage).
        return WellOperator.from_csr(csr, pc_block_size=pc_block_size)
    return EllOperator.from_csr(csr)


def as_operator(A, dtype=np.float32) -> LinearOperator:
    """Coerce a dense array / CSR / ELL / BSR / operator into a LinearOperator.

    ``dtype`` applies to dense storage only (sparse containers carry their own
    data dtype; pre-built operators are returned unchanged).
    """
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, CSRMatrix):
        return EllOperator.from_csr(A)
    if isinstance(A, EllMatrix):
        return EllOperator.from_ell(A)
    if isinstance(A, BSRMatrix):
        return BsrOperator.from_bsr(A)
    from tpucg.sparse.well import WellMatrix

    if isinstance(A, WellMatrix):
        return WellOperator.from_well(A)
    if isinstance(A, DIAMatrix):
        return DiaOperator.from_dia(A)
    arr = np.asarray(A) if not isinstance(A, jax.Array) else A
    if arr.ndim == 2:
        return DenseOperator.create(arr, dtype=dtype)
    raise TypeError(f"cannot interpret {type(A)!r} as a linear operator")
