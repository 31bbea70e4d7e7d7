"""Bandwidth/locality-reducing orderings for irregular sparse matrices.

tpucg's sparse formats are window-based (WELL gathers 128-wide windows of x per
sublane row, DIA wants a narrow band): the fewer distinct 128-column windows
the rows of a 128-row group touch, the higher the packing fill and the less
gathered-window traffic. ``rcm_order`` is a vectorized level-set variant of
reverse Cuthill-McKee: BFS level sets from a minimum-degree seed, each level
sorted by degree, order reversed. Classic RCM refines ordering WITHIN levels
by parent order; the level-set variant keeps the same O(bandwidth) envelope
while staying pure vectorized NumPy (no per-vertex Python loop).
"""

from __future__ import annotations

import numpy as np

from tpucg.sparse.formats import COOMatrix, CSRMatrix


def permute_csr(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric permutation P A P^T: row/col i of the result is row/col
    ``perm[i]`` of the input (``perm`` is the new-to-old order, as returned
    by ``rcm_order``)."""
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"symmetric permutation needs square, got {csr.shape}")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    coo = csr.to_coo()
    return COOMatrix(
        row=inv[coo.row],
        col=inv[coo.col.astype(np.int64)],
        data=coo.data,
        shape=csr.shape,
    ).to_csr()


def _neighbors_of(indptr, indices, frontier):
    """All column indices of the given rows, concatenated (vectorized)."""
    counts = indptr[frontier + 1] - indptr[frontier]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    starts = np.repeat(indptr[frontier], counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    return indices[starts + within]


def strength_order(csr: CSRMatrix, theta: float = 0.25) -> np.ndarray:
    """RCM on the STRENGTH-FILTERED graph: new-to-old permutation that
    makes contiguous index blocks follow the strong couplings.

    Classic AMG coarsens anisotropic operators ALONG the strong direction
    (semi-coarsening); tpucg's two-level preconditioner aggregates
    contiguous index blocks (``twolevel.py``), so the gather-free way to get
    the same effect is an ORDERING: keep only off-diagonal entries with
    ``|a_ij| >= theta * sqrt(|a_ii a_jj|)`` (the standard strength-of-
    connection test), symmetrize, and RCM the filtered graph. Weak-direction
    edges drop out, BFS level sets chain along the strong lines, and each
    contiguous ``agg_size`` block of the permuted matrix is a strong-line
    segment — the coarse space then captures the smooth-along-strong-lines
    modes plain contiguous aggregation misses. On isotropic operators the
    filter keeps most edges and this degenerates to ``rcm_order``.

    Measured effect on ``fem_p1_aniso_system`` (eps = 1e-2, n = 300k,
    two_level(64)): published in RESULTS.md's irregular solve table.
    """
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"strength_order needs square, got {csr.shape}")
    coo = csr.to_coo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    vals = np.abs(coo.data.astype(np.float64))
    diag = np.zeros(n, np.float64)
    on_d = rows == cols
    np.add.at(diag, rows[on_d], vals[on_d])
    scale = np.sqrt(np.maximum(diag, np.finfo(np.float64).tiny))
    keep = (~on_d) & (vals >= theta * scale[rows] * scale[cols])
    r, c = rows[keep], cols[keep]
    # Symmetrize (keep may be one-sided under asymmetric scaling) and
    # dedupe — COOMatrix.to_csr keeps duplicates, which would inflate the
    # degrees RCM sorts its level sets by.
    eid = np.unique(np.concatenate([r, c]) * n + np.concatenate([c, r]))
    strong = COOMatrix(
        row=eid // n, col=eid % n,
        data=np.ones(eid.size, np.float32), shape=(n, n),
    ).to_csr()
    return rcm_order(strong)


def rcm_order(csr: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee (level-set variant): new-to-old permutation.

    Handles disconnected graphs (each component seeded at its minimum-degree
    unvisited vertex). Use with ``permute_csr`` before ``csr_to_well`` /
    ``csr_to_dia`` when the input ordering has no locality (e.g. arbitrary
    .mtx files); measured effect is reported in RESULTS.md.
    """
    n = csr.shape[0]
    indptr = csr.indptr.astype(np.int64)
    indices = csr.indices.astype(np.int64)
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    # Seeds in globally increasing degree order; skip already-visited ones.
    seed_order = np.argsort(deg, kind="stable")
    seed_ptr = 0
    while pos < n:
        while seed_ptr < n and visited[seed_order[seed_ptr]]:
            seed_ptr += 1
        frontier = np.asarray([seed_order[seed_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            frontier = frontier[np.argsort(deg[frontier], kind="stable")]
            out[pos: pos + frontier.size] = frontier
            pos += frontier.size
            nbrs = _neighbors_of(indptr, indices, frontier)
            nbrs = nbrs[~visited[nbrs]]
            frontier = np.unique(nbrs)
            visited[frontier] = True
    return out[::-1].copy()
