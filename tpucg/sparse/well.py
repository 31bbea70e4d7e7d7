"""WELL — windowed gather-ELLPACK, the irregular-sparse format.

The reference's sparse story is "do the hot kernel right per platform"
(its dense analog is ``serialConjugate.c:109-120``); for matrices that are
neither banded (DIA) nor blocky (BSR), the fallback before WELL was
scalar-gather ELL. WELL replaces per-entry gathers with two coarser ones:
(a) a row gather of whole 128-wide windows of x and (b) a gather along the
128-wide lane dimension inside each window (``take_along_axis``):

- The vector x lives as ``x2 = x.reshape(G, 128)`` — row g is the 128-wide
  **window** of columns [128g, 128(g+1)).
- Nonzeros are packed into **sublane rows** of 128 slots. Every entry in a
  sublane row has (1) its column inside ONE window and (2) its row inside
  ONE output group of 128 rows, at lane position ``row % 128``.
- Sublane rows are laid out so every aligned **8-sublane chunk** shares one
  window (``wrow`` is per-chunk): the row gather materializes one x-window
  row per CHUNK, not per sublane — 8x less gather traffic.
- SpMV: gather the chunk windows (``xg = x2[wrow]``), broadcast each row
  to its 8 sublanes, lane-gather by the stored lane indices, multiply by
  the values, and reduce sublane rows into their output groups. No scalar
  gather anywhere.

Layout (within each super-group of ``BG`` output groups): tiles — the
(group, window) pairs with their per-row max entry count S — are sorted by
(window, group) so same-window tiles are adjacent, each (super-group,
window) RUN is padded to a multiple of 8 sublanes, and the super-group
total to a multiple of the ``BS``-sublane stream block; ``gidl`` names each
sublane row's output group inside its super-group.

Stored bytes per slot: 4 B value + 1 B lane index, plus the gathered window
amortized over the chunk; fill (nnz / slots) depends on how well a 128-row
group's entries cluster into shared windows — locality-preserving
orderings (mesh order, RCM — see ``tpucg.sparse.ordering``) keep it high.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

LANE = 128
CHUNK = 8  # sublanes per shared-window chunk (f32 sublane tile height)


@dataclasses.dataclass(frozen=True)
class WellMatrix:
    """Windowed gather-ELL storage (host arrays; device form is WellOperator).

    vals  (NS, 128)  float32 — packed nonzero values (0 = padding slot)
    lidx  (NS, 128)  int8    — column % 128 of each slot (0 for padding)
    wrow  (NS/8,)    int32   — window id (column // 128) per 8-sublane chunk
    gidl  (NB, BS)   int32   — group id WITHIN the super-group per sublane
                               row, laid out along lanes (one row per block)
    sgb   (NB,)      int32   — super-group id per stream block (nondecreasing)
    shape             logical (rows, cols)
    block_sublanes    BS — sublane rows per stream block
    groups_per_super  BG — output groups (of 128 rows) per super-group
    """

    vals: np.ndarray
    lidx: np.ndarray
    wrow: np.ndarray
    gidl: np.ndarray
    sgb: np.ndarray
    shape: Tuple[int, int]
    block_sublanes: int
    groups_per_super: int

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    @property
    def n_sublanes(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.sgb.size)

    @property
    def n_groups(self) -> int:
        """Output groups covering the (row-padded) system: ceil(rows/128)."""
        return -(-self.shape[0] // LANE)

    @property
    def n_supergroups(self) -> int:
        return int(self.sgb.max()) + 1 if self.sgb.size else 0

    @property
    def fill(self) -> float:
        """Useful fraction of streamed slots (1.0 = zero padding)."""
        slots = self.vals.size
        return self.nnz / slots if slots else 1.0

    def wrow_per_sublane(self) -> np.ndarray:
        """Expand the per-chunk window ids to one per sublane row."""
        return np.repeat(self.wrow, CHUNK)

    def diagonal(self) -> np.ndarray:
        """diag(A) over the padded rows [0, n_groups*128), float32.

        An entry at (sublane s, lane l) has row = group(s)*128 + l and
        col = wrow[s//8]*128 + lidx[s, l]; the diagonal sums entries with
        col == row (padding slots hold value 0 and never contribute).
        Host-side, once at construction.
        """
        BS, BG = self.block_sublanes, self.groups_per_super
        g_of_sub = (
            np.repeat(self.sgb.astype(np.int64), BS) * BG
            + self.gidl.reshape(-1)
        )
        lanes = np.arange(LANE, dtype=np.int64)[None, :]
        row = g_of_sub[:, None] * LANE + lanes
        col = self.wrow_per_sublane()[:, None].astype(np.int64) * LANE + (
            self.lidx.astype(np.int64)
        )
        contrib = np.where(col == row, self.vals, 0.0).astype(np.float32)
        d2 = np.zeros((self.n_supergroups * BG, LANE), np.float32)
        np.add.at(d2, g_of_sub, contrib)
        npad = -(-self.shape[0] // LANE) * LANE
        return d2.reshape(-1)[:npad]

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference SpMV (oracle for kernel tests)."""
        BS, BG = self.block_sublanes, self.groups_per_super
        ncol_pad = -(-self.shape[1] // LANE) * LANE
        x2 = np.zeros(ncol_pad, dtype=np.result_type(x, np.float32))
        x2[: self.shape[1]] = x
        x2 = x2.reshape(-1, LANE)
        xg = x2[self.wrow_per_sublane()]        # row-gather (chunk-shared)
        li = self.lidx.astype(np.int64)
        P = self.vals * np.take_along_axis(xg, li, axis=1)  # lane-gather
        g_of_sub = (
            np.repeat(self.sgb.astype(np.int64), BS) * BG
            + self.gidl.reshape(-1)
        )
        y2 = np.zeros((self.n_supergroups * BG, LANE), P.dtype)
        np.add.at(y2, g_of_sub, P)
        return y2.reshape(-1)[: self.shape[0]]


def _auto_block_sublanes(total_sublanes: int, n_supergroups: int,
                         sg_tot=None) -> int:
    """Stream-block size heuristic, padding-aware (round 4).

    Larger blocks were cheaper per slot for the stream kernel this layout
    was tuned for (since removed; PERF.md), but each super-group pads to a
    BS multiple, so the padding penalty depends on the per-super-group
    content MODULO BS, not its average: FEM n=1M sits just ABOVE 4096
    raw sublanes per super-group, so BS=4096 forced two blocks each
    (fill 0.14) while BS=2048 packs three (fill 0.19).

    With ``sg_tot`` (the exact per-super-group chunk-padded sublane
    counts, available at pack time) the choice minimizes
    ``padded_slots(bs) * (4096/bs)**0.263`` over powers of two in
    [256, 4096] — the exponent encodes that kernel's ~20% rate cost per
    block halving, so padding must shrink by more than that to justify a
    smaller block (ties go to the larger block). Without ``sg_tot`` the
    old average-content rule applies.
    """
    if sg_tot is not None and len(sg_tot) > 0:
        import numpy as _np

        sg = _np.asarray(sg_tot, _np.int64)
        best_bs, best_score = None, None
        bs = 4096
        while bs >= 256:
            padded = int(
                _np.where(sg == 0, bs, -(-sg // bs) * bs).sum()
            )
            score = padded * (4096.0 / bs) ** 0.263
            if best_score is None or score < best_score:
                best_bs, best_score = bs, score
            bs //= 2
        return best_bs
    per_sg = max(int(total_sublanes) // max(int(n_supergroups), 1), 1)
    bs = 256
    while bs * 2 <= min(per_sg + per_sg // 4, 4096):
        bs *= 2
    return bs


def csr_to_well(
    csr,
    block_sublanes=None,
    groups_per_super: int = 64,
) -> WellMatrix:
    """Pack a CSR matrix into WELL form (vectorized NumPy preprocessing).

    Square matrices get the partitioner's identity tail on rows
    [n, ceil(n/128)*128) so the padded operator stays SPD and Jacobi
    preconditioning sees unit diagonals in the tail.
    ``block_sublanes=None`` picks the stream-block size adaptively
    (:func:`_auto_block_sublanes`).
    """
    BS = None if block_sublanes is None else int(block_sublanes)
    BG = int(groups_per_super)
    if BS is not None and (BS % CHUNK or BS <= 0):
        raise ValueError(
            f"block_sublanes must be a positive multiple of {CHUNK}, got {BS}"
        )
    if BG <= 0:
        raise ValueError(f"groups_per_super must be positive, got {BG}")
    n_rows, n_cols = csr.shape
    G = -(-n_rows // LANE)
    NSG = -(-G // BG)

    rows = np.repeat(
        np.arange(n_rows, dtype=np.int64), np.diff(csr.indptr)
    )
    cols = csr.indices.astype(np.int64)
    vals = csr.data.astype(np.float32)
    if n_rows == n_cols and G * LANE != n_rows:
        tail = np.arange(n_rows, G * LANE, dtype=np.int64)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, np.float32)])

    nnz = vals.size
    if nnz == 0:
        # Degenerate all-zero matrix: one zero block per super-group so the
        # kernel still initializes every output row.
        if BS is None:
            BS = 256
        NS = max(NSG, 1) * BS
        NB = NS // BS
        return WellMatrix(
            vals=np.zeros((NS, LANE), np.float32),
            lidx=np.zeros((NS, LANE), np.int8),
            wrow=np.zeros(NS // CHUNK, np.int32),
            gidl=np.zeros((NB, BS), np.int32),
            sgb=np.arange(NB, dtype=np.int32) % max(NSG, 1),
            shape=(n_rows, n_cols),
            block_sublanes=BS,
            groups_per_super=BG,
        )

    g = rows // LANE
    w = cols // LANE
    lane = (rows % LANE).astype(np.int64)
    li = (cols % LANE).astype(np.int8)
    NW = -(-max(n_cols, 1) // LANE)

    order = np.lexsort((rows, w, g))
    g, w, lane, li, vals = (a[order] for a in (g, w, lane, li, vals))
    rows_s = rows[order]

    # Slot index k within each (row, window) run: within a tile (g, w) the
    # sort puts each row's entries contiguously, so k = position in run.
    key_rw = rows_s * NW + w
    new_rw = np.r_[True, key_rw[1:] != key_rw[:-1]]
    starts = np.flatnonzero(new_rw)
    run_len = np.diff(np.r_[starts, nnz])
    k = np.arange(nnz, dtype=np.int64) - np.repeat(starts, run_len)

    # Tiles = (group, window) pairs; a tile occupies S = max per-row count
    # sublane rows (rows with fewer entries in the window pad within lanes).
    key_t = g * NW + w
    new_t = np.r_[True, key_t[1:] != key_t[:-1]]
    tstarts = np.flatnonzero(new_t)
    tid = np.cumsum(new_t) - 1
    S = np.maximum.reduceat(k + 1, tstarts)
    tg = g[tstarts]
    tw = w[tstarts]
    tsg = tg // BG

    # Super-group layout, window-major: tiles sort by (super-group, window,
    # group), every (super-group, window) RUN pads to a CHUNK multiple (so
    # each aligned 8-sublane chunk is window-uniform), and each super-group
    # pads to a BS multiple (empty ones get one zero block so their output
    # rows are still written).
    torder = np.lexsort((tg, tw, tsg))
    tsg_s, tw_s, S_s = tsg[torder], tw[torder], S[torder]
    runkey = tsg_s * NW + tw_s
    new_run = np.r_[True, runkey[1:] != runkey[:-1]]
    ridx = np.cumsum(new_run) - 1                 # run id per sorted tile
    rstarts = np.flatnonzero(new_run)
    runS = np.add.reduceat(S_s, rstarts)
    runS_pad = -(-runS // CHUNK) * CHUNK
    run_sg = tsg_s[rstarts]
    run_w = tw_s[rstarts]

    sg_tot = np.bincount(run_sg, weights=runS_pad.astype(np.float64),
                         minlength=NSG).astype(np.int64)
    if BS is None:
        BS = _auto_block_sublanes(int(runS_pad.sum()), NSG, sg_tot=sg_tot)
    sg_pad = np.where(sg_tot == 0, BS, -(-sg_tot // BS) * BS)
    sg_base = np.concatenate([[0], np.cumsum(sg_pad)])
    NS = int(sg_base[-1])
    NB = NS // BS

    # Run bases: exclusive cumsum of padded run lengths, rebased per
    # super-group onto sg_base.
    crp = np.cumsum(runS_pad) - runS_pad
    new_sg_run = np.r_[True, run_sg[1:] != run_sg[:-1]]
    first_run = np.flatnonzero(new_sg_run)
    run_to_first = first_run[np.cumsum(new_sg_run) - 1]
    run_base = sg_base[run_sg] + (crp - crp[run_to_first])

    # Tile bases: exclusive cumsum of S within each run.
    ctp = np.cumsum(S_s) - S_s
    tbase_sorted = run_base[ridx] + (ctp - ctp[rstarts][ridx])
    tbase = np.empty_like(tbase_sorted)
    tbase[torder] = tbase_sorted
    sub = tbase[tid] + k

    vals_a = np.zeros((NS, LANE), np.float32)
    lidx_a = np.zeros((NS, LANE), np.int8)
    gid_a = np.zeros(NS, np.int32)
    vals_a[sub, lane] = vals
    lidx_a[sub, lane] = li
    gid_a[sub] = (g % BG).astype(np.int32)

    # Per-sublane window ids (run-uniform, padding included), then checked
    # chunk-uniform and stored per chunk. Super-group BS-padding gaps keep
    # window 0 (zero-value sublanes gather a valid row and contribute 0).
    wrow_sub = np.zeros(NS, np.int32)
    tot = int(runS_pad.sum())
    within = np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(runS_pad) - runS_pad, runS_pad
    )
    pos = np.repeat(run_base, runS_pad) + within
    wrow_sub[pos] = np.repeat(run_w, runS_pad).astype(np.int32)
    wrow8 = wrow_sub.reshape(-1, CHUNK)
    assert (wrow8 == wrow8[:, :1]).all(), "chunks must be window-uniform"

    sgb = (
        np.searchsorted(sg_base, np.arange(NB, dtype=np.int64) * BS, "right")
        - 1
    ).astype(np.int32)
    # Padding sublanes keep gid 0; their zero values route 0 to group 0 of
    # the right super-group — inert by construction.
    return WellMatrix(
        vals=vals_a,
        lidx=lidx_a,
        wrow=wrow8[:, 0].copy(),
        gidl=gid_a.reshape(NB, BS),
        sgb=sgb,
        shape=(n_rows, n_cols),
        block_sublanes=BS,
        groups_per_super=BG,
    )


def local_rows_to_well_shard(
    coo_local,
    shard: int,
    rps: int,
    npad: int,
    n: int,
    block_sublanes: int,
    groups_per_super: int = 64,
) -> "WellMatrix":
    """ONE shard's WELL pack from ONLY its local rows — the host-sharded
    loading form of :func:`csr_to_well_sharded` (which needs the full CSR
    on every host, the reference's rank-0 ceiling, parallel_cg.c:100-108).

    ``coo_local`` holds rows with LOCAL numbering [0, rps) and GLOBAL
    columns (e.g. from ``tpucg.io.mmio.load_matrix_market_rows``); global
    rows in [n, npad) covered by this shard get the partitioner's identity
    tail here. ``block_sublanes`` must be the mesh-wide agreed BS (every
    shard shares one — see ``load_well_system_sharded``'s two-phase
    agreement); the caller pads the result to the mesh-wide max shapes
    with :func:`pad_well_shard`.
    """
    from tpucg.sparse.formats import COOMatrix

    rows = coo_local.row.astype(np.int64)
    cols = coo_local.col.astype(np.int64)
    vals = coo_local.data.astype(np.float32)
    g0 = shard * rps
    t0, t1 = max(n, g0), min(npad, g0 + rps)
    if t1 > t0:
        tail = np.arange(t0, t1, dtype=np.int64)
        rows = np.concatenate([rows, tail - g0])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, np.float32)])
    return csr_to_well(
        COOMatrix(row=rows, col=cols, data=vals,
                  shape=(rps, npad)).to_csr(),
        block_sublanes=(
            None if block_sublanes is None else int(block_sublanes)
        ),
        groups_per_super=groups_per_super,
    )


def pad_well_shard(w: "WellMatrix", NS: int) -> dict:
    """Zero-pad one shard's pack to the mesh-wide max sublane count ``NS``
    (padding stream blocks carry vals=0 / the last super-group id — they
    accumulate exact zeros), returning the per-shard dict of arrays in the
    stacked layout ``csr_to_well_sharded`` produces (minus the leading
    shard axis)."""
    BS = w.block_sublanes
    NB = NS // BS
    nsg = w.n_supergroups

    def pad(a, shape, dtype, fill=0):
        out = np.full(shape, fill, dtype)
        out[: a.shape[0]] = a
        return out

    return dict(
        vals=pad(w.vals, (NS, LANE), np.float32),
        lidx=pad(w.lidx, (NS, LANE), np.int8),
        gidl=pad(w.gidl, (NB, BS), np.int32),
        wrow=pad(w.wrow, (NS // CHUNK,), np.int32),
        sgb=pad(w.sgb, (NB,), np.int32, fill=nsg - 1),
    )


def csr_to_well_sharded(
    csr,
    num_shards: int,
    block_sublanes=None,
    groups_per_super: int = 64,
):
    """Row-block partition a square CSR into per-shard WELL packs with
    UNIFORM static shapes, stacked along a leading shard axis (the form
    ``shard_map`` wants: device s reads slice [s] of each array).

    Each shard owns ``rps = ceil(n / (P*128)) * 128`` contiguous rows
    (whole output groups); rows beyond n get the partitioner's identity
    tail at their GLOBAL diagonal position, so the padded operator is
    exactly blockdiag(A, I) and stays SPD. Columns stay global — the
    sharded matvec all_gathers x and window ids index the full
    ``(npad/128, 128)`` x2. nnz varies per shard, so the value/index/
    layout arrays are zero-padded to the largest shard (padding stream
    blocks carry vals=0 / the last super-group id — they accumulate
    exact zeros).

    ``block_sublanes=None`` lets shard 0's adaptive pick
    (:func:`_auto_block_sublanes`) govern every shard (the stacked shapes
    must agree). Returns (stacked, statics) where ``stacked`` is a dict of
    (num_shards, ...) host arrays (vals f32, lidx int8, gidl int32,
    wrow int32, sgb int32) and ``statics`` has rps / npad / bg / nsg.
    """
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError(f"sharded WELL needs a square matrix, got {csr.shape}")
    P = int(num_shards)
    rps = -(-n_rows // (P * LANE)) * LANE
    npad = P * rps

    from tpucg.sparse.formats import COOMatrix

    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    vals = csr.data.astype(np.float32)
    if npad != n_rows:  # identity tail at the GLOBAL diagonal
        tail = np.arange(n_rows, npad, dtype=np.int64)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, np.float32)])

    shard_of = rows // rps
    wells = []
    for s in range(P):
        sel = shard_of == s
        wells.append(csr_to_well(
            COOMatrix(
                row=(rows[sel] - s * rps),
                col=cols[sel],
                data=vals[sel],
                shape=(rps, npad),
            ).to_csr(),
            block_sublanes=block_sublanes,
            groups_per_super=groups_per_super,
        ))
        if block_sublanes is None:
            # Every shard must share one BS (uniform stacked shapes):
            # shard 0's adaptive pick governs the rest.
            block_sublanes = wells[0].block_sublanes
    nsg = wells[0].n_supergroups
    assert all(w.n_supergroups == nsg for w in wells)  # rps uniform
    NS = max(w.n_sublanes for w in wells)
    NB = NS // wells[0].block_sublanes
    BS = wells[0].block_sublanes

    def pad_stack(get, shape, dtype, fill=0):
        out = np.full((P,) + shape, fill, dtype)
        for s, w in enumerate(wells):
            a = get(w)
            out[s, : a.shape[0]] = a
        return out

    stacked = dict(
        vals=pad_stack(lambda w: w.vals, (NS, LANE), np.float32),
        lidx=pad_stack(lambda w: w.lidx, (NS, LANE), np.int8),
        gidl=pad_stack(lambda w: w.gidl, (NB, BS), np.int32),
        wrow=pad_stack(lambda w: w.wrow, (NS // CHUNK,), np.int32),
        # Padding blocks carry the LAST super-group id (keeps sgb
        # nondecreasing; their zero values accumulate nothing).
        sgb=pad_stack(lambda w: w.sgb, (NB,), np.int32, fill=nsg - 1),
    )
    statics = dict(rps=rps, npad=npad, bg=groups_per_super, nsg=nsg)
    return stacked, statics
