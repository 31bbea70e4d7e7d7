#!/usr/bin/env python
"""The reference's collective-vs-p2p A/B experiment, reproduced functionally.

The reference's core deliverable is its published table — data-distribution /
CG / total wall-clock for the collective (`parallel_cg.c`) and hand-rolled
point-to-point (`point-to-point_cg.c`) arms at P in {2,4,8} on an
OVERSUBSCRIBED single host (report §6: `mpiexec -np P` on one Xeon;
results.xlsx sheet2). This script is the like-for-like run: the same dense
SPD family through tpucg's two communication strategies ("allgather" = the
collective arm, "overlap" = the ppermute-ring p2p arm done right) over a
FORCED P-device CPU mesh on one host.

These numbers are FUNCTIONAL (CPU-mesh) — they validate the machinery and
mirror the reference's methodology, not a device: XLA's CPU collectives are
shared-memory copies, so inter-arm deltas reflect schedule/overhead, not the
interconnect. Device A/B timing needs several GPUs.

Usage: python benchmarks/ab_ledger.py [--sizes ...] [--out RESULTS.md]
Writes/updates the "Distributed A/B ledger" section of RESULTS.md and
RESULTS_AB.json.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import _ledger

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

# Reference numbers for the side-by-side columns (results.xlsx sheet2;
# BASELINE.md): {n: {P: (data, cg, clock)}}.
REF_COLLECTIVE = {
    512: {2: (0.006, 0.006, 0.125), 4: (0.010, 0.007, 0.155), 8: (0.010, 0.008, 0.158)},
    1024: {2: (0.020, 0.011, 0.319), 4: (0.033, 0.007, 0.363), 8: (0.052, 0.026, 0.384)},
    2048: {2: (0.077, 0.038, 1.044), 4: (0.113, 0.018, 1.076), 8: (0.137, 0.014, 1.110)},
    4096: {2: (0.300, 0.176, 3.951), 4: (0.442, 0.117, 4.070), 8: (0.518, 0.062, 4.101)},
    8192: {2: (1.195, 0.685, 15.603), 4: (1.751, 0.457, 15.971), 8: (2.036, 0.234, 16.013)},
}
REF_P2P = {
    512: {2: (0.096, 0.010, 0.136), 4: (0.112, 0.008, 0.150), 8: (0.103, 0.007, 0.153)},
    1024: {2: (0.270, 0.014, 0.416), 4: (0.317, 0.008, 0.353), 8: (0.315, 0.009, 0.441)},
    2048: {2: (1.030, 0.042, 1.066), 4: (1.079, 0.027, 1.118), 8: (1.083, 0.019, 1.123)},
    4096: {2: (3.754, 0.182, 3.965), 4: (3.925, 0.121, 4.083), 8: (3.962, 0.065, 4.066)},
    8192: {2: (15.697, 0.707, 16.443), 4: (15.718, 0.360, 16.120), 8: (16.062, 0.244, 16.185)},
}
REF_SERIAL_S = {512: 0.005, 1024: 0.016, 2048: 0.039, 4096: 0.186, 8192: 0.562}

SECTION_HEADER = "## Distributed A/B ledger (functional, oversubscribed CPU mesh)"


def comm_volume_rows(sizes, procs):
    """Per-lap comm volume per device (f32 floats), from the README model."""
    rows = []
    for n in sizes:
        for P in procs:
            # allgather: receive (P-1)*n/P + send n/P, plus 2 psum scalars.
            ag = n * (P - 1) // P + n // P
            # overlap: P-1 ppermute hops of n/P each way.
            ov = 2 * (P - 1) * (n // P)
            rows.append((n, P, ag, ov))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048,4096,8192")
    ap.add_argument("--procs", default="2,4,8")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    procs = [int(p) for p in args.procs.split(",")]

    import tpucg
    from tpucg.bench.timing import time_fn
    from tpucg.io.partitioner import RowPartition
    from tpucg.solver.sharded import distribute_system, ROW_ALIGN

    assert len(jax.devices()) >= max(procs), "need the forced CPU mesh"
    results = {}
    for n in sizes:
        A, b, x0 = tpucg.generate_spd_system(n, seed=0)
        # Serial CG on one CPU device (the reference's serial program role).
        t0 = time.perf_counter()
        res = tpucg.cg_solve(A, b, x0)
        jax.block_until_ready(res.x)
        serial_s = time_fn(
            lambda: tpucg.cg_solve(A, b, x0).x,
            warmup=1, iters=args.repeats, reduce="median",
        )
        results[(n, 0, "serial")] = dict(
            data_s=0.0, cg_s=serial_s, clock_s=time.perf_counter() - t0,
            iters=int(res.iterations),
        )
        print(f"n={n} serial: {serial_s:.4f} s", flush=True)
        for P in procs:
            mesh = tpucg.make_mesh(P)
            part = RowPartition(n=n, num_shards=P, align=ROW_ALIGN)
            for strategy in ("allgather", "overlap"):
                t_clock = time.perf_counter()
                t0 = time.perf_counter()
                Ad, bd, x0d = distribute_system(
                    A.astype(np.float32), b.astype(np.float32),
                    x0.astype(np.float32), mesh, part,
                )
                jax.block_until_ready(Ad)
                data_s = time.perf_counter() - t0

                solve = lambda: tpucg.sharded_cg_solve(
                    Ad, bd, x0d, mesh=mesh, strategy=strategy, n=n
                )
                r = solve()
                jax.block_until_ready(r.x)  # includes compile
                cg_s = time_fn(
                    lambda: solve().x,
                    warmup=1, iters=args.repeats, reduce="median",
                )
                clock_s = time.perf_counter() - t_clock
                results[(n, P, strategy)] = dict(
                    data_s=data_s, cg_s=cg_s, clock_s=clock_s,
                    iters=int(r.iterations), converged=bool(r.converged),
                )
                print(
                    f"n={n} P={P} {strategy}: data {data_s:.4f} s, "
                    f"CG {cg_s:.4f} s (iters {int(r.iterations)})",
                    flush=True,
                )

    # ---- reduction-cadence arms (method A/B at the largest P) ----
    # The extension of the same thesis: the reference's two arms
    # differ in HOW each lap's 3 blocking reductions travel; these three
    # differ in HOW OFTEN any reduction happens at all (2-3/lap, 1/lap
    # fused, 1 per s laps + verification, ZERO per lap / 1 per check chunk).
    P_m = max(procs)
    mesh_m = tpucg.make_mesh(P_m)
    method_results = {}
    for n in sizes:
        A, b, x0 = tpucg.generate_spd_system(n, seed=0)
        part = RowPartition(n=n, num_shards=P_m, align=ROW_ALIGN)
        Ad, bd, x0d = distribute_system(
            A.astype(np.float32), b.astype(np.float32),
            x0.astype(np.float32), mesh_m, part,
        )
        # ||b||-scaled tolerance: the pipelined recurrence's f32 residual
        # floor sits above the absolute 1e-6 the unit-scale goldens use
        # (RESULTS.md extensions caveat) — give all three arms the same
        # reachable target so iteration counts are comparable.
        tol_m = 1e-5 * float(np.linalg.norm(b))
        # Warm-interval rows (the reusable spectral artifact): ca/chebyshev
        # re-run with cached (lam_lo, lam_hi) so their rows show amortized
        # steady-state cost instead of paying the 2x16-matvec power-method
        # setup every solve (cg_solve(..., interval=...)).
        lam_lo, lam_hi, _ = tpucg.spectral_interval(A)
        arms = [("cg", None), ("pipelined", None), ("ca", None),
                ("chebyshev", None), ("ca-warm", (lam_lo, lam_hi)),
                ("chebyshev-warm", (lam_lo, lam_hi))]
        for method, iv in arms:
            base = method.removesuffix("-warm")
            solve = lambda: tpucg.sharded_cg_solve(
                Ad, bd, x0d, mesh=mesh_m, strategy="allgather", n=n,
                method=base, tol=tol_m, interval=iv,
            )
            r = solve()
            jax.block_until_ready(r.x)
            cg_s = time_fn(
                lambda: solve().x,
                warmup=1, iters=args.repeats, reduce="median",
            )
            method_results[(n, method)] = dict(
                cg_s=cg_s, iters=int(r.iterations),
                converged=bool(r.converged),
            )
            results[(n, P_m, f"method-{method}")] = method_results[(n, method)]
            print(
                f"n={n} P={P_m} method={method}: CG {cg_s:.4f} s "
                f"(iters {int(r.iterations)})",
                flush=True,
            )

    # ---- two_level x {cg, pipelined} cadence arm (round 5) ----
    # The method x preconditioner cell VERDICT r4 #5 opened: the strong
    # cycle under the one-fused-psum-per-lap recurrence, on the irregular
    # (sharded-WELL) decomposition where both matter.
    from tpucg.io.generator import random_geometric_spd
    from tpucg.solver.sharded import sharded_operator_cg_solve

    Aw, bw, _ = random_geometric_spd(32_768, seed=0, avg_degree=12.0)
    nw = Aw.shape[0]
    npad_w = -(-nw // (128 * P_m)) * (128 * P_m)
    tl_w = tpucg.build_two_level(Aw, agg_size=64, npad=npad_w)
    tol_w = 1e-5 * float(np.linalg.norm(bw))
    tl_results = {}
    for method in ("cg", "pipelined"):
        solve = lambda: sharded_operator_cg_solve(
            Aw, bw, mesh=mesh_m, method=method, tol=tol_w, two_level=tl_w,
        )
        r = solve()
        jax.block_until_ready(r.x)
        cg_s = time_fn(lambda: solve().x, warmup=1, iters=args.repeats,
                       reduce="median")
        assert bool(r.converged), method
        tl_results[method] = dict(cg_s=cg_s, iters=int(r.iterations))
        print(f"two_level x {method}: CG {cg_s:.4f} s "
              f"(iters {int(r.iterations)})", flush=True)

    # ---- render the RESULTS.md section ----
    lines = [
        SECTION_HEADER,
        "",
        "The reference's core experiment — collective (`parallel_cg.c`) vs "
        "hand-rolled p2p (`point-to-point_cg.c`) communication at P in "
        "{2,4,8} — reproduced with tpucg's two strategy arms on an "
        "oversubscribed single-host CPU mesh, the reference's own "
        "methodology (report §6: `mpiexec -np P` on one Xeon). "
        "**Functional/CPU numbers**: they exercise the real shard_map/"
        "collective code paths but CPU-mesh collectives are shared-memory "
        "copies — device A/B timing needs several GPUs. "
        "Reference columns from results.xlsx sheet2 for structure parity.",
        "",
        "| n | P | tpucg allgather data/CG (s) | tpucg overlap data/CG (s) |"
        " ref collective data/CG (s) | ref p2p data/CG (s) |",
        "|---|---|---|---|---|---|",
    ]
    for n in sizes:
        for P in procs:
            ag = results[(n, P, "allgather")]
            ov = results[(n, P, "overlap")]
            rc = REF_COLLECTIVE.get(n, {}).get(P)
            rp = REF_P2P.get(n, {}).get(P)
            lines.append(
                f"| {n} | {P} "
                f"| {ag['data_s']:.4f} / {ag['cg_s']:.4f} "
                f"| {ov['data_s']:.4f} / {ov['cg_s']:.4f} "
                + (f"| {rc[0]:.3f} / {rc[1]:.3f} " if rc else "| — ")
                + (f"| {rp[0]:.3f} / {rp[1]:.3f} |" if rp else "| — |")
            )
    n_big = max(sizes)
    ser_big = results[(n_big, 0, "serial")]["cg_s"]
    best_P, best_cg = min(
        ((P, results[(n_big, P, "allgather")]["cg_s"]) for P in procs),
        key=lambda t: t[1],
    )
    lines += [
        "",
        f"Headline (mirroring the reference's §6.1 finding): CG-phase "
        f"parallel speedup at n={n_big} is {ser_big:.3f} s serial -> "
        f"{best_cg:.3f} s at P={best_P} collective "
        f"({ser_big / best_cg:.1f}x; the reference measured 0.562 -> 0.234 s "
        f"at P=8, 2.4x). Data-distribution dominates total time in both "
        f"systems, as the reference found.",
        "",
        "Serial CG per size on one CPU device (same process, the serial "
        "program's role): "
        + ", ".join(
            f"n={n}: {results[(n, 0, 'serial')]['cg_s']:.4f} s"
            for n in sizes
        )
        + f". Reference serial (Xeon): "
        + ", ".join(f"n={k}: {v:.3f} s" for k, v in REF_SERIAL_S.items())
        + ".",
        "",
        "### Per-lap communication volume (model, f32 floats per device)",
        "",
        "From the README comm analysis: allgather moves O(n) per lap "
        "(receive (P-1)n/P + send n/P, plus 2-3 psum scalars); the overlap "
        "ring moves the same O(n) total but in P-1 pipelined n/P hops, each "
        "overlapped with a column-block GEMV; the reference's p2p arm moved "
        "2x that volume through rank 0 (gather+bcast per allgather, "
        "`point-to-point_cg.c:448-449`).",
        "",
        "| n | P | allgather floats/lap | overlap floats/lap (in n/P hops) |",
        "|---|---|---|---|",
    ]
    for n, P, ag, ov in comm_volume_rows(sizes, procs):
        lines.append(f"| {n} | {P} | {ag} | {ov} |")
    lines += [
        "",
        "### Reduction-cadence arms (method A/B, extension)",
        "",
        f"Same thesis, third axis: the reference's arms differ in HOW its 3 "
        f"blocking reductions per lap travel; tpucg's methods differ in HOW "
        f"OFTEN any blocking reduction happens — classic CG 2-3 scalar "
        f"psums/lap, pipelined (Ghysels-Vanroose) ONE fused psum/lap, CA "
        f"(s-step, Chebyshev basis) ONE fused Gram psum per s=3 laps (+ the "
        f"exact block-end verification dot) at ~2x matvec cost. CG-phase "
        f"seconds at P={P_m}, allgather strategy, tol = 1e-5*||b|| (the "
        f"target all three f32 recurrences can reach — see the pipelined "
        f"floor caveat), functional/CPU mesh — reduction-latency wins need "
        f"a real multi-chip mesh where psum latency is nonzero:",
        "",
        "| n | classic CG (s/iters) | pipelined (s/iters) | ca s=3 (s/iters)"
        " | chebyshev (s/iters) | ca warm (s/iters) | chebyshev warm "
        "(s/iters) |",
        "|---|---|---|---|---|---|---|",
    ]
    for n in sizes:
        row = f"| {n} "
        for method in ("cg", "pipelined", "ca", "chebyshev", "ca-warm",
                       "chebyshev-warm"):
            mr = method_results[(n, method)]
            row += f"| {mr['cg_s']:.4f} / {mr['iters']} "
        lines.append(row + "|")
    lines += [
        "",
        "COLD CA/chebyshev rows are dominated by their FIXED setup — 2x16 "
        "power-method matvecs estimating the Chebyshev interval — which "
        "dwarfs the 3-4 solve laps of this well-conditioned family. The "
        "WARM rows re-run the same arms with a cached interval "
        "(`cg_solve(..., interval=tpucg.spectral_interval(A)[:2])` — the "
        "reusable spectral artifact): setup vanishes and the rows show the "
        "amortized steady-state cost a repeated-solve workload sees. The "
        "chebyshev arm (ZERO reductions per lap, one exact check per 8 "
        "laps) additionally pays a no-minimization rate penalty — its "
        "iteration counts round up to the check cadence; it is the "
        "extreme latency point, not a bandwidth winner.",
        "",
        "#### two_level x pipelined (round 5)",
        "",
        f"The strong preconditioner under the latency-hiding method — the "
        f"multi-chip composition (guard removed round 5): geometric-graph "
        f"Laplacian n={nw} on the sharded-WELL decomposition at P={P_m}, "
        f"tol = 1e-5*||b||. The cycle is a fixed SPD operator, so the "
        f"pipelined recurrence keeps its ONE fused scalar psum per lap "
        f"(the cycle's coarse all_gather is dataflow-independent of the "
        f"lap's scalars); preconditioned pipelined runs carry periodic "
        f"residual replacement + a measured (p, Ap) pair in the same "
        f"fused reduction (solver.cg.PIPE_REPLACE_EVERY — the f32 "
        f"attainable floor scales ~kappa*1e-7*||b||, so ill-conditioned "
        f"FEM wants classic PCG; this kappa~1e2 family reaches 1e-5 with "
        f"exact lap parity):",
        "",
        "| arm | CG (s, CPU-functional) | iters |",
        "|---|---|---|",
        f"| two_level + classic CG (2 scalar psums/lap) "
        f"| {tl_results['cg']['cg_s']:.4f} | {tl_results['cg']['iters']} |",
        f"| two_level + pipelined (1 fused psum/lap) "
        f"| {tl_results['pipelined']['cg_s']:.4f} "
        f"| {tl_results['pipelined']['iters']} |",
        "",
    ]
    section = "\n".join(lines)

    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "RESULTS.md",
    )
    _ledger.replace_section(out, SECTION_HEADER, section)

    json_path = os.path.join(os.path.dirname(out), "RESULTS_AB.json")
    with open(json_path, "w") as f:
        json.dump(
            {
                f"n={n},P={P},{s}": v
                for (n, P, s), v in sorted(results.items())
            },
            f,
            indent=1,
        )
    print(f"wrote {out} and {json_path}")


if __name__ == "__main__":
    main()
