"""Row-block partitioning for sharded solves.

The reference distributes A as contiguous row blocks ("row-wise block-striped
decomposition", report §5.2; ``MPI_Scatter`` at ``parallel_cg.c:112-115``) and
*requires* ``ROWS % P == 0`` (``parallel_cg.c:86-90``). tpucg lifts that
restriction by zero-padding to the next multiple of P (and of a row
alignment): padding A with an identity block and b/x with zeros leaves
the original solution untouched (the padded rows solve 1*x_pad = 0) while
keeping every shard the same static shape — a requirement for XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """A 1-D row-block partition of an n x n system over ``num_shards`` shards.

    ``n`` is the logical size; ``n_padded`` the padded size actually sharded
    (each shard holds ``n_padded // num_shards`` contiguous rows).
    """

    n: int
    num_shards: int
    align: int = 8  # rows per shard are a multiple of this

    @property
    def n_padded(self) -> int:
        return round_up(self.n, self.num_shards * self.align)

    @property
    def block_rows(self) -> int:
        return self.n_padded // self.num_shards

    def row_range(self, shard: int) -> Tuple[int, int]:
        """[start, stop) of padded-row indices owned by ``shard``."""
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range")
        return shard * self.block_rows, (shard + 1) * self.block_rows


def pad_identity_tail(A: np.ndarray, npad: int) -> np.ndarray:
    """Embed n x n ``A`` into npad x npad with a decoupled identity tail.

    The single source of the padding invariant: pad rows solve 1*x_pad = 0,
    stay at zero residual from lap 0, and contribute nothing to any dot
    product, so the padded solve is exactly the original solve plus inert
    coordinates.
    """
    n = A.shape[0]
    if npad == n:
        return A
    Ap = np.zeros((npad, npad), dtype=A.dtype)
    Ap[:n, :n] = A
    idx = np.arange(n, npad)
    Ap[idx, idx] = 1.0
    return Ap


def pad_system(
    A: np.ndarray,
    b: np.ndarray,
    x0: Optional[np.ndarray],
    part: RowPartition,
):
    """Pad (A, b, x0) from n to part.n_padded with an identity tail block.

    The padded system is block-diagonal: the original n x n system plus a
    decoupled identity on the pad rows with zero right-hand side, so CG on the
    padded system yields the original solution in the first n entries and exact
    zeros in the pad (the pad residual is zero from iteration 0 and contributes
    nothing to any dot product).
    """
    n, npad = part.n, part.n_padded
    if A.shape != (n, n):
        raise ValueError(f"A must be ({n},{n}), got {A.shape}")
    if npad == n:
        x0p = np.zeros(n, A.dtype) if x0 is None else x0
        return A, b, x0p
    Ap = pad_identity_tail(A, npad)
    bp = np.zeros(npad, dtype=b.dtype)
    bp[:n] = b
    x0p = np.zeros(npad, dtype=A.dtype)
    if x0 is not None:
        x0p[:n] = x0
    return Ap, bp, x0p
