"""Timing + roofline utilities.

The reference reports three wall-clock phases — data distribution, CG loop,
total program — fenced by ``MPI_Barrier``/``MPI_Wtime``
(``parallel_cg.c:109-117,278-279,328-336``). tpucg keeps the same three-phase
report and adds what the reference lacks: per-kernel roofline accounting
(dense matvec is bound by memory bandwidth, so achieved GB/s against the
device's published peak is the "percent of speed-of-light" number that
BASELINE.json asks for).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import jax

# Published peaks per device, keyed by jax's device_kind. Source: NVIDIA
# H100 SXM data sheet (dense rates, without sparsity), at the full 700 W
# power limit. A device that is not in the table has no roofline: an error
# for ``hbm_peak_bytes_per_s``, "not measured" in ``BenchReport``.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_bytes_per_s=3.35e12,
        f32_flops_per_s=67e12,
        bf16_flops_per_s=989e12,
    ),
}


def _device_kind(device: Optional[jax.Device]) -> str:
    if device is None:
        device = jax.devices()[0]
    return getattr(device, "device_kind", "")


def has_peaks(device: Optional[jax.Device] = None) -> bool:
    """Whether the device is in ``DEVICE_PEAKS``."""
    return _device_kind(device) in DEVICE_PEAKS


def hbm_peak_bytes_per_s(device: Optional[jax.Device] = None) -> float:
    """The device's published memory bandwidth; ValueError if the device is
    not in ``DEVICE_PEAKS``."""
    kind = _device_kind(device)
    if kind not in DEVICE_PEAKS:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            "tpucg.bench.timing.DEVICE_PEAKS with its source"
        )
    return DEVICE_PEAKS[kind]["hbm_bytes_per_s"]


def _sync(result, fetch: bool):
    """Completion barrier for a timed call: ``fetch=True`` also copies the
    result to the host (jax.device_get), ``False`` waits with
    ``block_until_ready``."""
    if fetch:
        return jax.device_get(result)
    return jax.block_until_ready(result)


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 1,
    iters: int = 5,
    reduce: str = "min",
    fetch: bool = True,
) -> float:
    """Wall-clock seconds per call of ``fn(*args)``, fully synchronized
    (including a result fetch — see ``_sync``; keep returned results small or
    the transfer dominates). ``min``/``median`` over repeats rejects host
    noise.
    """
    for _ in range(warmup):
        _sync(fn(*args), fetch)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args), fetch)
        times.append(time.perf_counter() - t0)
    times.sort()
    if reduce == "min":
        return times[0]
    if reduce == "median":
        return times[len(times) // 2]
    if reduce == "mean":
        return sum(times) / len(times)
    raise ValueError(f"unknown reduce {reduce!r}")


def _chain_extra(est_solve_s, target_s: float) -> int:
    """Extra chained repetitions (khi - klo) for the differencing timers:
    enough that the extra work is about ``target_s``, at least
    ceil(40 ms / est) clamped to [1, 8] (a long solve needs few repeats to
    dominate host noise), at most 256.
    """
    if not est_solve_s or est_solve_s <= 0:
        return 8
    floor = int(min(8, max(1, -(-0.04 // est_solve_s))))
    return int(min(max(target_s / est_solve_s, floor), 256))


def time_run_chain(
    run: Callable,
    operands: tuple,
    b: jax.Array,
    x0: jax.Array,
    *,
    klo: int = 1,
    khi: Optional[int] = None,
    iters: int = 5,
    est_solve_s: Optional[float] = None,
    target_s: float = 0.05,
) -> float:
    """Generic chained-differencing timer for any solve ``run(operands, b, x0)
    -> x``-like callable: chains K data-dependent repetitions (a traced
    runtime zero defeats CSE) inside one jitted program and differences two
    chain lengths, cancelling dispatch and fetch overheads. ``operands`` are
    real arguments, never closure captures — captured device arrays would be
    baked into the compiled program as constants."""
    import functools

    import jax.numpy as jnp

    if khi is None:
        khi = klo + _chain_extra(est_solve_s, target_s)

    @functools.partial(jax.jit, static_argnames=("k",))
    def chain(operands, b, x0, eps, k):
        def body(_, x):
            return run(operands, b + eps * x, x0)

        return jax.lax.fori_loop(0, k, body, x0)

    eps = jnp.float32(0.0)
    t_lo = time_fn(chain, operands, b, x0, eps, klo, warmup=1, iters=iters)
    t_hi = time_fn(chain, operands, b, x0, eps, khi, warmup=1, iters=iters)
    d = (t_hi - t_lo) / (khi - klo)
    # When the difference is non-positive, or implausibly far below the
    # caller's own per-solve estimate, re-measure both chains once rather
    # than letting a median-of-trials average noise in.
    floor = 0.2 * est_solve_s if est_solve_s and est_solve_s > 0 else 0.0
    if d <= floor:
        t_lo = time_fn(chain, operands, b, x0, eps, klo, warmup=1,
                       iters=iters)
        t_hi = time_fn(chain, operands, b, x0, eps, khi, warmup=1,
                       iters=iters)
        d = (t_hi - t_lo) / (khi - klo)
    return max(d, 1e-9)


def time_solve_chain(
    op,
    b: jax.Array,
    x0: jax.Array,
    *,
    tol: float = 1.0e-6,
    maxiter: int,
    klo: int = 1,
    khi: Optional[int] = None,
    iters: int = 5,
    est_solve_s: Optional[float] = None,
    target_s: float = 0.05,
    precondition: str = "none",
    pc_block_size: int = 64,
    two_level=None,
) -> float:
    """Steady-state seconds per CG solve, dispatch-corrected.

    Chains K full solves inside one jitted program — each made data-dependent
    on the previous via a traced runtime zero (so XLA cannot CSE them) — and
    differences two chain lengths. Host dispatch and the result fetch
    cancel, mirroring the reference's practice of fencing only the CG
    phase (``parallel_cg.c:278-279``). ``b``/``x0`` are zero-padded to
    ``op.padded_n`` when the operator pads (same contract as ``cg_solve``).

    ``khi`` defaults so the extra chained work is ~``target_s`` (needs
    ``est_solve_s``, e.g. a measured single solve; see ``_chain_extra``).
    """
    if khi is None:
        khi = klo + _chain_extra(est_solve_s, target_s)
    import functools

    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla, fused_update
    from tpucg.solver.cg import cg_loop

    npad = getattr(op, "padded_n", None)
    if npad is not None and b.shape[0] != npad:
        b = jnp.zeros((npad,), b.dtype).at[: b.shape[0]].set(b)
        x0 = jnp.zeros((npad,), x0.dtype).at[: x0.shape[0]].set(x0)

    if two_level is not None:
        if precondition != "none":
            raise ValueError("two_level excludes precondition")
        from tpucg.solver.twolevel import make_two_level_precond

        # tl rides operands (NOT a closure capture: its (nc, nc) coarse
        # inverse would otherwise inline into the compile payload); the
        # per-solve lambda_max setup inside run matches what cg_solve's
        # jit pays per call — the honest steady-state number.
        def run_tl(operands, bj, x0_):
            op_, tl = operands
            precond = make_two_level_precond(tl, op_.matvec, dot_xla, bj)
            s = cg_loop(op_.matvec, dot_xla, fused_update, bj, x0_,
                        tol=tol, maxiter=maxiter, precond=precond)
            return s.x

        return time_run_chain(
            run_tl, (op, two_level), b, x0,
            klo=klo, khi=khi, iters=iters, est_solve_s=est_solve_s,
            target_s=target_s,
        )

    minv = None
    apply_minv = None
    if precondition == "jacobi":
        d = op.diagonal()
        minv = jnp.where(d != 0, 1.0 / d, 1.0).astype(jnp.float32)
        apply_minv = lambda r: minv * r
    elif precondition == "block_jacobi":
        from tpucg.solver.cg import block_jacobi_minv, make_block_precond

        minv = block_jacobi_minv(op, int(pc_block_size))
        apply_minv = make_block_precond(minv, b.shape[0])
    elif precondition != "none":
        raise ValueError(
            "time_solve_chain supports precondition in "
            "{'none', 'jacobi', 'block_jacobi'}"
        )

    def run(operands, bj, x0_):
        (op,) = operands
        s = cg_loop(op.matvec, dot_xla, fused_update, bj, x0_,
                    tol=tol, maxiter=maxiter, precond=apply_minv)
        return s.x

    return time_run_chain(
        run, (op,), b, x0,
        klo=klo, khi=khi, iters=iters, est_solve_s=est_solve_s,
        target_s=target_s,
    )


def time_matvec_loop(
    apply: Callable,
    operand,
    x: jax.Array,
    steps: int = 64,
    iters: int = 5,
) -> float:
    """Seconds per matvec of ``apply(operand, v)``, dispatch-corrected.

    Times a jitted power-iteration chain (y = A v / ||A v||, data-dependent
    so XLA cannot elide steps) at two step counts and divides the
    difference — dispatch and the result fetch cancel. The per-step time
    includes the normalisation (one dot and one scale). ``operand`` (e.g.
    the matrix, or any operator pytree) is a real argument, not a closure
    capture, which would be baked into the program as a constant.
    """
    import functools

    import jax.numpy as jnp

    from tpucg.kernels.blas1 import dot_xla

    @functools.partial(jax.jit, static_argnames=("k",))
    def loop(operand, v, k):
        def body(_, u):
            y = apply(operand, u)
            return y * jax.lax.rsqrt(dot_xla(y, y) + 1e-30)

        return jax.lax.fori_loop(0, k, body, v)

    lo, hi = 2, 2 + steps
    t_lo = time_fn(loop, operand, x, lo, warmup=1, iters=iters)
    t_hi = time_fn(loop, operand, x, hi, warmup=1, iters=iters)
    d = (t_hi - t_lo) / steps
    if d <= 0:
        # Noise swamped the difference: retry once with fresh chains rather
        # than returning a clamped near-zero that a min-of-trials reduction
        # would then latch onto as "fastest".
        t_lo = time_fn(loop, operand, x, lo, warmup=1, iters=iters)
        t_hi = time_fn(loop, operand, x, hi, warmup=1, iters=iters)
        d = (t_hi - t_lo) / steps
    return max(d, 1e-12)


def time_matvec_robust(
    apply: Callable,
    operand,
    x: jax.Array,
    steps: int = 32,
    trials: int = 3,
) -> float:
    """Median of ``trials`` independent ``time_matvec_loop`` chains — robust
    to one bad trial in either direction (a min would latch onto a
    near-zero difference)."""
    ts = sorted(
        time_matvec_loop(apply, operand, x, steps=steps)
        for _ in range(trials)
    )
    return ts[len(ts) // 2]


def time_matvec_spread(
    apply: Callable,
    operand,
    x: jax.Array,
    steps: int = 32,
    trials: int = 3,
) -> tuple:
    """(min, median, max) seconds over ``trials`` independent chains —
    the published-variance form of :func:`time_matvec_robust`, matching
    the reference's 3-raw-trials-per-config practice (results.xlsx
    sheet1; SURVEY.md §6)."""
    ts = sorted(
        time_matvec_loop(apply, operand, x, steps=steps)
        for _ in range(max(trials, 1))
    )
    return ts[0], ts[len(ts) // 2], ts[-1]


@dataclasses.dataclass
class BenchReport:
    """Structured per-run report (the reference's rank-0 printf block,
    ``parallel_cg.c:331-336``, made machine-readable)."""

    n: int
    iterations: int
    residual_norm: float
    distribute_s: float
    solve_s: float
    total_s: float
    matvec_s: Optional[float] = None
    matvec_gbps: Optional[float] = None
    roofline_frac: Optional[float] = None
    iters_per_s: Optional[float] = None
    nnz: Optional[int] = None          # sparse operators: nonzeros per matvec
    nnz_per_s: Optional[float] = None
    padded_n: Optional[int] = None     # device-side size the matvec streams
    strategy: str = "serial"
    device_kind: str = ""

    def finalize(self) -> "BenchReport":
        if self.solve_s and self.iterations:
            self.iters_per_s = self.iterations / self.solve_s
        if self.matvec_s and self.nnz:
            # Sparse operator: dense n^2-bytes roofline accounting does not
            # apply — report nnz/s only (GB/s fields stay None).
            self.nnz_per_s = self.nnz / self.matvec_s
        elif self.matvec_s and self.n:
            np_ = self.padded_n or self.n
            bytes_moved = 4 * np_ * np_  # stream padded A once per matvec
            self.matvec_gbps = bytes_moved / self.matvec_s / 1e9
            if has_peaks():
                self.roofline_frac = (
                    bytes_moved / self.matvec_s / hbm_peak_bytes_per_s()
                )
        if not self.device_kind:
            self.device_kind = getattr(jax.devices()[0], "device_kind", "?")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def pretty(self) -> str:
        lines = [
            f"system size          : {self.n} x {self.n}",
            f"device               : {self.device_kind} "
            f"[{self.strategy}]",
            f"data distribution (s): {self.distribute_s:.6f}",
            f"CG method (s)        : {self.solve_s:.6f}",
            f"total (s)            : {self.total_s:.6f}",
            f"iterations           : {self.iterations}"
            + (
                f"  ({self.iters_per_s:.1f} it/s)"
                if self.iters_per_s
                else ""
            ),
            f"final ||r||          : {self.residual_norm:.3e}",
        ]
        if self.matvec_gbps:
            roof = (
                f"{100 * self.roofline_frac:.0f}% of the published HBM peak"
                if self.roofline_frac is not None
                else "roofline not measured: no published peak for this "
                     "device"
            )
            lines.append(
                f"matvec               : {self.matvec_s * 1e3:.3f} ms, "
                f"{self.matvec_gbps:.0f} GB/s ({roof})"
            )
        elif self.nnz_per_s:
            lines.append(
                f"matvec               : {self.matvec_s * 1e3:.3f} ms, "
                f"{self.nnz_per_s / 1e9:.2f} Gnnz/s"
            )
        return "\n".join(lines)
