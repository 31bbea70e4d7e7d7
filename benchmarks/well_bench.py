"""Irregular-sparse (WELL) benchmark — RESULTS.md "Irregular sparse" section.

Run on the GPU: python benchmarks/well_bench.py
One process; several minutes (host-side generation dominates the large rows).

Workloads (the role generateSPDmatrix.m:23-43 plays for the dense tables):
- random geometric-graph Laplacians (random_geometric_spd) — genuinely
  irregular row lengths/patterns, no band, no block structure;
- an unstructured-mesh FEM system (fem_p1_system, P1 stiffness on a random
  Delaunay triangulation, Dirichlet hull) saved to and loaded back from a
  MatrixMarket file — the real-world .mtx path end-to-end, including the
  shuffled-numbering + --rcm recovery story.

Timing: chained differencing, min/median/max of >= 3 independent chains
(the reference's 3-raw-trials practice).
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import _ledger

import jax
import jax.numpy as jnp
import numpy as np

import tpucg
from tpucg.bench.timing import (
    hbm_peak_bytes_per_s,
    time_matvec_spread,
    time_solve_chain,
)
from tpucg.io.generator import (
    aniso_grid_system,
    fem_p1_aniso_system,
    fem_p1_system,
    random_geometric_spd,
)
from tpucg.sparse.ordering import permute_csr, rcm_order, strength_order
from tpucg.sparse.well import csr_to_well

BYTES_PER_SLOT = 5.5    # 4 value + 1 lane idx + 0.5 chunk-amortized window
# The streaming floor per slot: the packed format's bytes at the card's
# published memory rate (tpucg.bench.timing.DEVICE_PEAKS); Gnnz/s ceiling =
# fill x peak / BYTES_PER_SLOT. The XLA product also materialises the
# gathered windows and scatter-adds, so it moves more than this floor.


def _pad(v, n):
    out = np.zeros(n, np.float32)
    out[: v.size] = v
    return out


def matvec_row(name, A, csr_note, lines, legacy=False, steps=2048,
               storage="f32"):
    import jax.numpy as jnp

    well = csr_to_well(A)
    op = tpucg.WellOperator.from_well(
        well,
        storage_dtype=jnp.bfloat16 if storage == "bf16" else jnp.float32,
    )
    x = np.random.default_rng(3).standard_normal(op.padded_n).astype(
        np.float32)
    x[: A.shape[0]] *= 1.0
    xd = jnp.asarray(x)
    y = np.asarray(op.matvec(xd))[: A.shape[0]]
    y_ref = A.matvec(np.asarray(x)[: A.shape[0]].astype(np.float64))
    rel = np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-30)
    assert rel < (2e-2 if storage == "bf16" else 1e-5), (name, rel)
    lo, med, hi = time_matvec_spread(
        lambda o, u: o.matvec(u), op, xd, steps=steps)
    gnnz = A.nnz / med / 1e9
    slots = well.vals.size // 128
    bps = 3.5 if storage == "bf16" else BYTES_PER_SLOT
    # fill x the slot rate at the published memory peak.
    ceil = (A.nnz / (slots * 128)) * (hbm_peak_bytes_per_s() / 1e9 / bps)
    lines.append(
        f"| {name} | {A.shape[0]} | {A.nnz} | {well.fill:.2f} "
        f"| {med*1e6:.0f} ({lo*1e6:.0f}-{hi*1e6:.0f}) "
        f"| {A.nnz/hi/1e9:.1f}-{A.nnz/lo/1e9:.1f} | {gnnz:.1f} "
        f"| {100*gnnz/ceil:.0f}% |"
    )
    print(lines[-1], flush=True)
    return op, well


def solve_row(name, A, b, lines, precondition="none", pc_block_size=64,
              two_level_agg=None, smooth_degree=1, coarse_max=None,
              maxiter=None, tol_frac=None):
    op = tpucg.best_sparse_operator(
        A,
        pc_block_size=(
            pc_block_size if precondition == "block_jacobi" else None
        ),
    )
    # two_level rows stop on the TRUE residual (round 5, honest stopping:
    # the f32 recurrence of strong-preconditioner solves decouples from
    # the true residual at FEM conditioning) — their tolerance must sit
    # above the measured true floor (~1e-3 ||b|| at n>=300k); the plain/
    # jacobi rows keep the recurrence test and the true ||r|| column
    # exposes what they actually achieved.
    if tol_frac is None:
        tol_frac = 1e-3 if two_level_agg is not None else 1e-5
    tol = tol_frac * float(np.linalg.norm(b))
    kw = dict(tol=tol)
    if maxiter is not None:
        kw["maxiter"] = maxiter
    chain_kw = {}
    label = precondition
    if two_level_agg is not None:
        tl = tpucg.build_two_level(A, agg_size=two_level_agg,
                                   npad=op.padded_n,
                                   smooth_degree=smooth_degree,
                                   coarse_max=coarse_max)
        kw["two_level"] = tl
        chain_kw["two_level"] = tl
        label = f"two_level({two_level_agg})"
        if smooth_degree > 1:
            label += f"+cheb{smooth_degree}"
        if tl.levels > 1:
            label += f"x{tl.levels}lv"
    elif precondition != "none":
        kw["precondition"] = precondition
        kw["pc_block_size"] = pc_block_size
        chain_kw = {"precondition": precondition,
                    "pc_block_size": pc_block_size}
    t0 = time.time()
    res = tpucg.cg_solve(op, b, **kw)
    jax.block_until_ready(res.x)
    iters = int(res.iterations)
    x_sol = np.asarray(res.x)[: A.shape[0]]
    rr = float(np.linalg.norm(b - A.matvec(x_sol)))
    stagnated = not bool(res.converged)
    if two_level_agg is None:
        assert not stagnated, name
    else:
        # two_level rows stop HONESTLY at the f32 attainable floor when
        # the tolerance is out of reach (kappa*eps_f32 ~ 1e-2 relative at
        # FEM n >= 100k) — publish the floor row with a dagger instead of
        # refusing the measurement.
        pass
    s = time_solve_chain(
        op, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
        tol=tol, maxiter=(maxiter if maxiter is not None else A.shape[0]),
        est_solve_s=max(time.time() - t0, 0.01),
        **chain_kw,
    )
    it_s = f"{iters}\u2020" if stagnated else f"{iters}"
    lines.append(
        f"| {name} | {A.shape[0]} | {label} | {it_s} "
        f"| {s*1e3:.2f} | {rr:.2e} |"
    )
    print(lines[-1], flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--legacy", action="store_true",
                    help="also time the scalar-gather ELL arm (slow)")
    ap.add_argument("--out", default=None,
                    help="write the markdown section to this file")
    args = ap.parse_args()

    print("devices:", jax.devices(), flush=True)
    mv_lines = [
        "| system | n | nnz | fill | matvec us (min-max) | Gnnz/s spread "
        "| Gnnz/s | % of slot-stream floor at published peak |",
        "|---|---|---|---|---|---|---|---|",
    ]
    sv_lines = [
        "| system | n | precondition | iters | ms/solve | true ||r|| |",
        "|---|---|---|---|---|---|",
    ]

    geo100k = random_geometric_spd(100_000, seed=0, avg_degree=12.0)
    geo1m = random_geometric_spd(1_000_000, seed=0, avg_degree=12.0)
    fem = fem_p1_system(300_000, seed=0)
    aniso = fem_p1_aniso_system(300_000, eps=1e-2, seed=0)

    matvec_row("geometric deg-12", geo100k[0], "", mv_lines)
    matvec_row("geometric deg-12", geo1m[0], "", mv_lines, steps=512)
    # bf16 value slabs: 3.5 streamed B/slot instead of 5.5 (values are the
    # dominant stream; graph-Laplacian values are bf16-exact here).
    matvec_row("geometric deg-12 (bf16 vals)", geo1m[0], "", mv_lines,
               steps=512, storage="bf16")
    matvec_row("FEM P1 Delaunay", fem[0], "", mv_lines, steps=1024)
    # Scale point: the same mesh family at n=1M (18M nnz) — the coarse
    # path must hold its rate as n grows 3.3x.
    fem1m = fem_p1_system(1_000_000, seed=0)
    matvec_row("FEM P1 Delaunay", fem1m[0], "", mv_lines, steps=256)
    # Second independent family (anisotropic diffusion, eps=1e-2): same
    # mesh topology class, different values/conditioning — the kernel rate
    # depends only on the pattern, so this row should match FEM P1's.
    matvec_row("FEM P1 aniso eps=1e-2", aniso[0], "", mv_lines, steps=1024)

    # Shuffled FEM + RCM recovery (the .mtx-in-the-wild story).
    fem_sh = fem_p1_system(300_000, seed=0, shuffle=True)
    matvec_row("FEM shuffled", fem_sh[0], "", mv_lines, steps=1024)
    perm = rcm_order(fem_sh[0])
    fem_rcm = permute_csr(fem_sh[0], perm)
    matvec_row("FEM shuffled+RCM", fem_rcm, "", mv_lines, steps=1024)

    if args.legacy:
        A = geo100k[0]
        ell = tpucg.EllOperator.from_csr(A)
        xe = jnp.asarray(np.random.default_rng(3).standard_normal(
            ell.padded_n).astype(np.float32))
        from tpucg.bench.timing import time_matvec_loop
        t = time_matvec_loop(lambda o, u: o.matvec(u), ell, xe, steps=2)
        mv_lines.append(
            f"| geometric deg-12 (legacy ELL) | {A.shape[0]} | {A.nnz} | - "
            f"| {t*1e6:.0f} | - | {A.nnz/t/1e9:.2f} | - |")
        print(mv_lines[-1], flush=True)

    solve_row("geometric deg-12", geo100k[0], geo100k[1], sv_lines)
    solve_row("geometric deg-12", geo100k[0], geo100k[1], sv_lines,
              precondition="jacobi")
    solve_row("FEM P1 Delaunay", fem[0], fem[1], sv_lines,
              precondition="jacobi")
    # Block Jacobi absorbs within-block mesh coupling (Delaunay numbering
    # keeps neighbors nearby, so 128-row blocks capture real stiffness
    # structure) — the stronger-preconditioner arm for the FEM workload.
    solve_row("FEM P1 Delaunay", fem[0], fem[1], sv_lines,
              precondition="block_jacobi", pc_block_size=128)
    # Two-level (AMG-lite): the iteration-count answer — coarse-space
    # correction over contiguous aggregates (solver.twolevel), 2 extra
    # matvecs + one dense (nc, nc) GEMV per lap.
    solve_row("FEM P1 Delaunay", fem[0], fem[1], sv_lines,
              two_level_agg=64)
    solve_row("FEM P1 Delaunay", fem[0], fem[1], sv_lines,
              two_level_agg=128)
    # Chebyshev-smoothed cycle (smooth_degree=2): ~1.8x fewer laps than
    # the Jacobi cycle at 5 vs 3 matvecs per lap — and half the coarse
    # solves, which at nc~4.7k stream an 88 MB inverse each.
    solve_row("FEM P1 Delaunay", fem[0], fem[1], sv_lines,
              two_level_agg=64, smooth_degree=2)
    # Scale rows (n=1M, 18M nnz): agg=256 keeps the replicated coarse
    # inverse at 61 MB (nc=3907; 977 MB at agg=64); the lap count pays for
    # the coarser space, the point is that the composition still wins at
    # 3.3x n.
    solve_row("FEM P1 Delaunay", fem1m[0], fem1m[1], sv_lines,
              precondition="jacobi")
    solve_row("FEM P1 Delaunay", fem1m[0], fem1m[1], sv_lines,
              two_level_agg=256, smooth_degree=2)
    # MULTILEVEL rows (round 5, VERDICT r4 #3): coarse_max caps every
    # dense inverse at (4096)^2 = 67 MB regardless of n — first the
    # n=1M parity row against the dense-inverse cell above, then the
    # n=4M scale point the dense inverse could not reach (agg=256 there
    # would need a 3.9 GB replicated inverse; the hierarchy holds
    # megabytes). maxiter clamped: the expected lap counts are
    # O(200-600).
    solve_row("FEM P1 Delaunay", fem1m[0], fem1m[1], sv_lines,
              two_level_agg=256, smooth_degree=2, coarse_max=2048,
              maxiter=4000)
    fem4m = fem_p1_system(4_000_000, seed=0)
    solve_row("FEM P1 Delaunay", fem4m[0], fem4m[1], sv_lines,
              two_level_agg=256, smooth_degree=2, coarse_max=4096,
              maxiter=4000)
    del fem4m
    # The anisotropic family (the iteration-HARD input class): jacobi vs
    # two-level shows the coarse correction surviving where point
    # smoothing degrades.
    solve_row("FEM P1 aniso eps=1e-2", aniso[0], aniso[1], sv_lines,
              precondition="jacobi")
    solve_row("FEM P1 aniso eps=1e-2", aniso[0], aniso[1], sv_lines,
              two_level_agg=64)
    solve_row("FEM P1 aniso eps=1e-2", aniso[0], aniso[1], sv_lines,
              two_level_agg=64, smooth_degree=2)
    # Rotating-field variant (rotating=True): the characteristic
    # direction bends around the domain center, so NO single ordering —
    # mesh numbering, RCM, or strength — can follow it globally; this is
    # the robustness row for the contiguous-aggregate coarse space (it
    # must degrade gracefully, not fail).
    rot = fem_p1_aniso_system(300_000, eps=1e-2, rotating=True, seed=0)
    solve_row("FEM P1 aniso rotating", rot[0], rot[1], sv_lines,
              precondition="jacobi")
    solve_row("FEM P1 aniso rotating", rot[0], rot[1], sv_lines,
              two_level_agg=64, smooth_degree=2)

    # STRUCTURED anisotropy (aniso_grid_system m=256: -u_xx - eps u_yy,
    # strong couplings form LONG unbroken x-lines) with SHUFFLED numbering
    # — the foreign-.mtx stand-in. The ordering decides whether two-level
    # aggregates semi-coarsen: plain RCM follows weak and strong edges
    # alike; strength_order (RCM on the strength-filtered graph,
    # --strength-order on the CLI) recovers line-contiguous numbering
    # from the matrix alone. On the unstructured Delaunay aniso family
    # this lever is measured NEUTRAL (strong chains too short: mean
    # strong degree ~1.4 at theta=0.25) — regularity is what makes it
    # work, hence this workload.
    grid = aniso_grid_system(256, eps=1e-2, seed=0, shuffle=True)
    p_r = rcm_order(grid[0])
    solve_row("aniso grid eps=1e-2 shuf+rcm", permute_csr(grid[0], p_r),
              grid[1][p_r], sv_lines, two_level_agg=64)
    p_s = strength_order(grid[0], theta=0.25)
    solve_row("aniso grid eps=1e-2 shuf+strength",
              permute_csr(grid[0], p_s), grid[1][p_s], sv_lines,
              two_level_agg=64)

    # End-to-end .mtx via the CLI (the reference always ran its shipped
    # systems; this is tpucg's equivalent for the real-world input class).
    with tempfile.TemporaryDirectory() as td:
        amtx, bmtx = os.path.join(td, "fem.mtx"), os.path.join(td, "b.mtx")
        tpucg.save_matrix_market(amtx, fem_sh[0].to_coo(), symmetric=True)
        tpucg.save_matrix_market(bmtx, fem_sh[1])
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "tpucg", "solve", amtx, bmtx, "--rcm",
             "--precondition", "jacobi",
             "--tol", str(1e-5 * float(np.linalg.norm(fem_sh[1])))],
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)},
        )
        cli_s = time.time() - t0
        print(r.stdout, flush=True)
        assert r.returncode == 0, r.stdout + r.stderr
        cli_lines = [ln for ln in r.stdout.splitlines()
                     if any(k in ln for k in ("system size", "iterations",
                                              "converged", "CG solve"))]

        # Second CLI pass: the round-4 flags end-to-end — a shuffled
        # structured-aniso .mtx recovered by --strength-order and solved
        # under --two-level (the semi-coarsening pipeline a foreign
        # anisotropic file would ride).
        a2, b2 = os.path.join(td, "aniso.mtx"), os.path.join(td, "b2.mtx")
        tpucg.save_matrix_market(a2, grid[0].to_coo(), symmetric=True)
        tpucg.save_matrix_market(b2, grid[1])
        t0 = time.time()
        # 2e-4 ||b||: above the strength-ordered two-level TRUE-residual
        # floor on this shuffled grid (measured 7.1e-5 relative — the
        # round-5 honest stopping stagnates below that; 1e-5 was only
        # ever "reached" by the drifted recurrence).
        r2 = subprocess.run(
            [sys.executable, "-m", "tpucg", "solve", a2, b2,
             "--strength-order", "--two-level", "64",
             "--tol", str(2e-4 * float(np.linalg.norm(grid[1])))],
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)},
        )
        cli2_s = time.time() - t0
        print(r2.stdout, flush=True)
        assert r2.returncode == 0, r2.stdout + r2.stderr
        cli2_lines = [ln for ln in r2.stdout.splitlines()
                      if any(k in ln for k in ("system size", "iterations",
                                               "converged", "CG solve"))]

    legend = ("Solve to convergence. Plain/jacobi/block-jacobi rows run the reference's literal recurrence test at tol = 1e-5 ||b||; two_level rows (round 5) STOP ON THE TRUE RESIDUAL at tol = 1e-3 ||b|| with a stagnation exit at the f32 attainable floor — a dagger (\u2020) marks rows that stopped AT the measured floor; their true ||r|| column is the honest achievement and is the column to compare across rows (BASELINE.md round-5 amendment: kappa*eps_f32 ~ 1e-2 RELATIVE bounds this FEM family, and FEM ||b|| ~ 2e-3 makes absolute residuals look deceptively small; the daggered two_level rows reach 3-4x LOWER true residual than the 1711-lap jacobi row at ~5x less time):")
    MARK = "## Irregular sparse (WELL)"
    section = "\n".join(
        [MARK, "",
         "Matrices that are neither banded nor blocky — the input class "
         "the MatrixMarket loader invites — ride the WELL (windowed "
         "gather-ELL) operator (`kernels/gather_spmv.py`): nonzeros "
         "pack into 128-slot sublane rows whose aligned 8-sublane chunks "
         "share one 128-wide x window, applied by a window-row gather, a "
         "lane gather and a scatter-add. Workloads: random "
         "geometric-graph Laplacians (deg ~12) and an unstructured P1 FEM "
         "stiffness matrix on a random Delaunay mesh "
         "(`io/generator.py:fem_p1_system`) — the role the reference's "
         "`generateSPDmatrix.m` systems play for the dense tables. "
         "The % column is against the packed format's streaming floor "
         "(5.5 B/slot, 3.5 for bf16 values) at the card's published "
         "memory rate. Graph-Laplacian values are bf16-exact; general "
         "values round at ~1e-2 relative. The shuffled-FEM pair is the "
         ".mtx-in-the-wild story: no spatial numbering -> low fill; one "
         "reverse-Cuthill-McKee pass (`--rcm` on the CLI) restores it — "
         "fill is the knob, ordering is how you turn it. ",
         "`FEM P1 aniso` is the second independent family "
         "(`fem_p1_aniso_system`: anisotropic diffusion K = R^T "
         "diag(1, eps) R, the iteration-HARD input class; the `rotating` "
         "rows bend the characteristic direction around the domain "
         "center — no single ordering can follow it, the coarse space's "
         "graceful-degradation row). Every matrix "
         "here is generated because this environment has NO network "
         "egress (a SuiteSparse download is impossible); the "
         "external-validity stand-ins are the independent families plus "
         "the save-to-.mtx-and-reload CLI path, which exercises exactly "
         "the loader/ordering/promotion pipeline a foreign file would. "
         "`two_level` "
         "rows run the AMG-lite coarse-space PCG (`tpucg.build_two_level`"
         ", `--two-level AGG` on the CLI): contiguous AGG-row aggregates, "
         "restriction a reshape-sum, coarse solve one dense (nc, nc) "
         "GEMV against a precomputed f64 inverse, symmetric V(1,1) "
         "damped-Jacobi cycle — 3 matvecs/lap total, bought back "
         "many-fold in lap count on mesh Laplacians. `aniso grid` rows "
         "are STRUCTURED anisotropy (`aniso_grid_system`: -u_xx - eps "
         "u_yy, strong couplings in long x-lines) under shuffled "
         "numbering: `shuf+strength` reorders by `strength_order` (RCM "
         "on the strength-filtered graph, `--strength-order` on the "
         "CLI) so contiguous two-level aggregates follow the strong "
         "lines — ordering-based semi-coarsening; plain RCM cannot see "
         "the anisotropy. On the unstructured aniso family the lever is "
         "measured neutral (strong chains too short) — it is published "
         "here on the workload class it serves.",
         "",
         "Matvec (chained differencing; spread = min/median/max of >= 3 "
         "independent chains):", ""]
        + mv_lines
        + ["", legend, ""]
        + sv_lines
        + ["", "CLI end-to-end (.mtx, shuffled FEM numbering, --rcm "
           f"--precondition jacobi; whole-process {cli_s:.0f}s incl. "
           "compile):", "", "```"]
        + cli_lines + ["```"]
        + ["", "CLI end-to-end, round-4 flags (.mtx, shuffled "
           "structured-aniso grid; --strength-order recovers "
           "line-contiguous numbering, --two-level 64 semi-coarsens on "
           f"it; whole-process {cli2_s:.0f}s incl. compile):", "", "```"]
        + cli2_lines + ["```"]
    ) + "\n"
    print("\n" + section, flush=True)
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "RESULTS.md",
    )
    _ledger.replace_section(out, MARK, section)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
