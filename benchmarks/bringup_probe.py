#!/usr/bin/env python
"""Kernel- and lap-level readings of the XLA paths, on one GPU.

Measures, in one process:
  - a large copy (read + write of 1 GiB), the attainable streaming rate;
  - the dense GEMV at n=8192 (f32 and bf16 storage);
  - the DIA SpMV (f32 and bf16) and the matrix-free 7-point stencil at
    m=128 (n=2.1M), and the WELL SpMV on the FEM P1 system at n=1M;
  - warm CG solves (Poisson stencil, DIA, dense, FEM/WELL under jacobi):
    laps, wall time per lap, the device's kernel time per lap from a
    profiler trace, and the idle share (1 - kernel time / wall time);
  - the kernels XLA emits per CG lap (fusions, custom calls) from the
    optimized HLO of each serial solve.

Kernel times come from a profiler trace (device durations of the events on
the GPU's stream lines); wall times from the host clock around work that
ends in ``block_until_ready``. Every line names the card and its power
limit.

    python benchmarks/bringup_probe.py [--out chiprun_out/bringup_probe.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def on_gpu() -> bool:
    import jax

    return jax.devices()[0].platform == "gpu"


def trace_device_us(fn, args, reps, workdir):
    """Mean device microseconds per call of ``fn(*args)``, from a profiler
    trace of ``reps`` back-to-back calls: the events of the first GPU
    plane's kernel lines (``Stream`` lines), summed and divided by reps.
    Returns (mean_us, {event name: mean_us})."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    shutil.rmtree(workdir, ignore_errors=True)
    with jax.profiler.trace(workdir):
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
    pb = glob.glob(os.path.join(workdir, "**", "*.xplane.pb"),
                   recursive=True)[0]
    pd = ProfileData.from_file(pb)
    per = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per[ev.name] = per.get(ev.name, 0.0) + ev.duration_ns
    shutil.rmtree(workdir, ignore_errors=True)
    per = {k: v / reps / 1e3 for k, v in per.items()}
    return sum(per.values()), per


def wall_us(fn, args, reps=50, trials=5):
    """Median over trials of host microseconds per call for ``reps``
    queued calls ending in one block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / reps * 1e6)
    return statistics.median(ts)


def lap_kernels(compiled_text: str) -> dict:
    """Count the kernel-launching instructions in each while-loop body of
    an optimized HLO module: fusions, custom calls (cuBLAS, Pallas) and
    other top-level ops that are not pure bookkeeping."""
    bodies = {}
    comp = None
    for line in compiled_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if m:
            comp = m.group(1)
            bodies[comp] = []
            continue
        if comp is not None and "=" in line:
            bodies[comp].append(line)
    body_names = set()
    for lines in bodies.values():
        for ln in lines:
            m = re.search(r"while\(.*body=%?([\w.\-]+)", ln)
            if m:
                body_names.add(m.group(1))
    skip = ("parameter(", "get-tuple-element(", "tuple(", "constant(",
            "bitcast(", "copy-start", "copy-done")
    out = {}
    for name in body_names:
        ops = [ln for ln in bodies.get(name, [])
               if not any(s in ln for s in skip)]
        out[name] = {
            "fusion": sum(" fusion(" in ln for ln in ops),
            "custom-call": sum("custom-call(" in ln for ln in ops),
            "while": sum(" while(" in ln for ln in ops),
            "other": [re.sub(r"^.*= \S+ ", "", ln).split("(")[0]
                      for ln in ops
                      if not any(k in ln for k in (" fusion(",
                                                   "custom-call(",
                                                   " while("))],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/bringup_probe.json")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--fem", type=int, default=1_000_000)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    if not on_gpu():
        print("bringup_probe: no GPU found", file=sys.stderr)
        return 1
    import tpucg
    from tpucg.io.generator import fem_p1_system, poisson3d_dia
    from tpucg.kernels.matvec import matvec_xla
    from tpucg.kernels.spmv import dia_spmv
    from tpucg.solver.cg import _cg_jit
    from tpucg.solver.operators import (
        DenseOperator,
        DiaOperator,
        PoissonOperator,
    )

    dev = jax.devices()[0]
    label = f"{card()} ({dev.device_kind})"
    print(f"card: {label}; jax {jax.__version__}", flush=True)
    tdir = os.path.join(os.path.dirname(args.out) or ".", "_trace")
    rec = {"card": label, "rows": [], "solves": [], "lap_kernels": {}}

    def row(name, bytes_, fn, fargs, reps=20):
        dev_us, per = trace_device_us(fn, fargs, reps, tdir)
        w_us = wall_us(fn, fargs)
        gbs = bytes_ / (dev_us * 1e-6) / 1e9 if dev_us else float("nan")
        rec["rows"].append(dict(name=name, bytes=bytes_, device_us=dev_us,
                                wall_us=w_us, device_GBps=gbs, events=per))
        print(f"{name:<30} device {dev_us:9.2f} us  wall {w_us:9.2f} us  "
              f"{gbs:8.1f} GB/s  [{label}]  events={len(per)}", flush=True)

    # Copy: read + write of 1 GiB.
    big = jnp.ones((1 << 28,), jnp.float32)
    row("copy 1GiB (r+w)", 2 * big.nbytes, jax.jit(lambda a: a + 1.0),
        (big,), reps=10)
    del big

    rng = np.random.default_rng(0)
    n = 8192
    A = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    xv = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    gemv = jax.jit(matvec_xla)
    row("gemv f32 n=8192", 4 * n * n + 8 * n, gemv, (A, xv))
    row("gemv bf16 n=8192", 2 * n * n + 8 * n, gemv,
        (A.astype(jnp.bfloat16), xv))
    del A

    m = args.m
    dia = poisson3d_dia(m)
    offs = tuple(int(o) for o in dia.offsets)
    N = m ** 3
    data = jnp.asarray(np.asarray(dia.data, np.float32))
    x = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    nd = len(offs)
    xla_dia = jax.jit(lambda d, v: dia_spmv(d, offs, v))
    row(f"dia f32 m={m}", (nd * 4 + 8) * N, xla_dia, (data, x))
    row(f"dia bf16 m={m}", (nd * 2 + 8) * N, xla_dia,
        (data.astype(jnp.bfloat16), x))
    pois = PoissonOperator(m=m)
    row(f"stencil m={m}", 8 * N, jax.jit(pois.matvec), (x,))

    A_fem, b_fem, _ = fem_p1_system(args.fem, seed=0)
    well = tpucg.best_sparse_operator(A_fem)
    xw = jnp.asarray(rng.standard_normal(well.padded_n).astype(np.float32))
    slots = int(well.vals.size)
    # Format bytes: 4 B value + 1 B lane index per slot, window rows
    # gathered once per 8-row chunk, and x read + y written.
    row(f"well fem n={A_fem.shape[0]} nnz={A_fem.nnz}",
        5 * slots + 4 * slots // 8 + 8 * well.padded_n,
        jax.jit(lambda o, v: o.matvec(v)), (well, xw))

    def solve_row(name, op, b, **kw):
        b = jnp.asarray(b)
        tol = kw.pop("rtol") * float(jnp.linalg.norm(b))
        minv = None
        if kw.get("precondition") == "jacobi":
            d = op.diagonal()
            minv = jnp.where(d != 0, 1.0 / d, 1.0).astype(jnp.float32)
        x0 = jnp.zeros_like(b)
        run = lambda o, bb, xx, mm: _cg_jit(o, bb, xx, mm, tol, 20000, True)
        res = jax.block_until_ready(run(op, b, x0, minv))
        laps = int(res.iterations)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(run(op, b, x0, minv))
            ts.append(time.perf_counter() - t0)
        wall = statistics.median(ts)
        dev_us, per = trace_device_us(run, (op, b, x0, minv), 2, tdir)
        idle = 1.0 - dev_us * 1e-6 / wall
        kernels_per_lap = {k: v / max(laps, 1) for k, v in per.items()}
        text = jax.jit(run).lower(op, b, x0, minv).compile().as_text()
        rec["lap_kernels"][name] = lap_kernels(text)
        rec["solves"].append(dict(
            name=name, laps=laps, wall_s=ts, device_us=dev_us,
            idle_share=idle, per_lap_device_us=kernels_per_lap))
        print(f"solve {name}: {laps} laps, wall median {wall * 1e3:.3f} ms "
              f"({wall / laps * 1e6:.2f} us/lap), device {dev_us / laps:.2f}"
              f" us/lap, idle share {idle:.3f}, {len(per)} kernel kinds "
              f"[{label}]", flush=True)
        print(f"  lap kernels (optimized HLO): "
              f"{json.dumps(rec['lap_kernels'][name])}", flush=True)

    xt = rng.standard_normal(N).astype(np.float32)
    b_p = np.asarray(pois.matvec(jnp.asarray(xt)))
    solve_row(f"poisson m={m}", pois, b_p, rtol=1e-5)
    solve_row(f"dia m={m}", DiaOperator.from_dia(dia), b_p, rtol=1e-5)
    Ad, bd, _ = tpucg.generate_spd_system(n, seed=0)
    solve_row("dense n=8192", DenseOperator.create(Ad), bd, rtol=1e-7)
    solve_row(f"fem jacobi n={A_fem.shape[0]}", well, np.pad(
        b_fem, (0, well.padded_n - A_fem.shape[0])), rtol=1e-3,
        precondition="jacobi")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
