#!/usr/bin/env python
"""Driver benchmark: dense CG solve, reference's flagship n=8192 workload.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ...}

Baseline: the reference's serial CG-phase time at n=8192 is 0.562 s
(results.xlsx sheet2 C9; BASELINE.md). The workload is the same family —
generateSPDmatrix.m-style random dense SPD, float32, tol 1e-6 — solved here
as one jitted while_loop with XLA's GEMV on one GPU.
``vs_baseline`` is the speedup factor (baseline seconds / our seconds).

Methodology: the headline value is steady-state per-solve time, measured by
chaining K full CG solves inside ONE dispatched program (a traced zero makes
each solve data-depend on the previous, so XLA cannot CSE them) and
differencing two chain lengths — this cancels per-dispatch overhead,
mirroring how the reference fences only its CG phase with MPI_Wtime
(parallel_cg.c:278-279) and not process overheads. The single-dispatch
end-to-end time is reported alongside on stderr.

The benchmark measures the GPU: it exits non-zero when JAX finds none.
Diagnostics (card, roofline, phase split) go to stderr.
"""

import json
import os
import subprocess
import sys
import time

N = int(os.environ.get("TPUCG_BENCH_N", "8192"))
BASELINE_S = {512: 0.005, 1024: 0.016, 2048: 0.039, 4096: 0.186, 8192: 0.562}


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py: no GPU found (platform "
              f"{jax.devices()[0].platform!r}); nothing measured",
              file=sys.stderr)
        return 1

    import tpucg
    from tpucg.bench.timing import BenchReport, time_fn, time_solve_chain
    from tpucg.compile_cache import enable_compile_cache
    from tpucg.solver.operators import DenseOperator

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}", file=sys.stderr)

    t_total0 = time.perf_counter()
    A, b, x0 = tpucg.generate_spd_system(N, seed=0)

    # Distribution phase: host -> device placement of the operator
    # (the reference's MPI_Scatter phase, parallel_cg.c:109-117).
    t0 = time.perf_counter()
    op = DenseOperator.create(A)
    bj = jax.device_put(jax.numpy.asarray(b))
    x0j = jax.device_put(jax.numpy.asarray(x0))
    jax.block_until_ready(op.A)
    distribute_s = time.perf_counter() - t0

    solve = lambda: tpucg.cg_solve(op, bj, x0j)
    res = solve()  # compile + first run
    iters = int(res.iterations)
    rnorm = float(res.residual_norm)
    solve_e2e_s = time_fn(lambda: solve().x, warmup=1, iters=5)

    # Steady-state per-solve time: chain K data-dependent solves in one
    # dispatch and difference two chain lengths (see module docstring).
    solve_s = time_solve_chain(op, bj, x0j, maxiter=N,
                               est_solve_s=solve_e2e_s)

    # Isolated hot-kernel timing for the roofline number (dispatch-corrected).
    from tpucg.bench.timing import time_matvec_loop

    matvec_s = time_matvec_loop(lambda o, v: o.matvec(v), op, bj)

    total_s = time.perf_counter() - t_total0
    report = BenchReport(
        n=N,
        iterations=iters,
        residual_norm=rnorm,
        distribute_s=distribute_s,
        solve_s=solve_s,
        total_s=total_s,
        matvec_s=matvec_s,
        strategy="serial",
    ).finalize()
    print(report.pretty(), file=sys.stderr)
    print(f"solve (single dispatch): {solve_e2e_s:.6f} s [{card}]",
          file=sys.stderr)

    baseline = BASELINE_S.get(N)
    out = {
        "metric": f"dense_cg_solve_time_n{N}",
        "value": round(solve_s, 6),
        "unit": "s",
        "vs_baseline": round(baseline / solve_s, 2) if baseline else None,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
