"""Checkpoint / resume for long CG solves.

The reference has no checkpointing at all — the CG state lives only in process
memory and any failure loses the whole solve (SURVEY.md §5: "Checkpoint /
resume: None"). Here the full solver state is tiny and explicit — exactly
(k, x, r, p, rsold), the carried tuple of the jitted while_loop — so tpucg can
dump and resume it trivially, on EVERY decomposition: serial, 1-D row-sharded
dense (``sharded_cg_solve_checkpointed``, which also routes 2-D SUMMA
meshes), and the sparse/stencil operator arms
(``sharded_operator_cg_solve_checkpointed``).

Design: a segmented driver, shared by all arms (``_resume_or_none`` +
``_drive_segments``). Each segment runs up to ``segment_iters`` more
iterations inside ONE jitted program (the cumulative-iteration bound is a
*traced* scalar, so every segment reuses the same executable), then the state
is pulled to host and written as an atomic ``.npz``. On restart the driver
finds the file and continues from the recorded iteration. The resumed
trajectory is bit-identical to an uninterrupted run because float32 CG state
is saved exactly. Checkpoints record (n, tol, preconditioner, and a
tolerance-compared probe signature of A and b); a mismatch on ANY of these
refuses to resume — a Jacobi trajectory's rsold carries r.z, not r.r, so a
silent cross-preconditioner resume would corrupt the recurrence.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpucg.config import CGConfig
from tpucg.kernels.blas1 import dot_xla as _dot
from tpucg.kernels.blas1 import fused_update
from tpucg.solver.cg import (
    CGResult,
    _State,
    cg_loop,
    dataclasses_replace,
    init_state,
)
from tpucg.solver.operators import as_operator

def _signature_probe_and_R(npad: int):
    """The deterministic probe vector and projection matrix shared by the
    single-process and multi-process signature paths (identical rng stream,
    so the two regimes produce comparable signatures for the same system)."""
    rng = np.random.default_rng(0xC6)
    probe = rng.standard_normal(npad).astype(np.float32)
    R = rng.standard_normal((4, npad))
    return probe, R


def _project_signature(
    R: np.ndarray, y: np.ndarray, b: np.ndarray
) -> np.ndarray:
    return np.concatenate(
        [R @ np.asarray(y, np.float64), R @ np.asarray(b, np.float64)]
    )


def system_signature(op, b: jnp.ndarray) -> np.ndarray:
    """Cheap identity check for (A, b): random projections of A applied to a
    fixed pseudorandom probe vector, plus projections of b. A stale checkpoint
    from a DIFFERENT system of the same size would otherwise resume silently
    and 'converge' to a solution of neither system.

    Compared with a RELATIVE tolerance on resume (``signatures_match``), not
    hashed bit-exactly: a different reduction order (another device, XLA's
    choice of algorithm, scatter-add atomics) perturbs the probe response at
    ~1e-7 relative,
    which must not be mistaken for a different system (O(1) relative).

    ``op`` is anything with a ``matvec`` attribute, or a bare matvec callable
    (e.g. the sharded distributed matvec).
    """
    npad = b.shape[0]
    probe, R = _signature_probe_and_R(npad)
    mv = op.matvec if hasattr(op, "matvec") else op
    y = np.asarray(mv(jnp.asarray(probe)), dtype=np.float64)
    return _project_signature(R, y, np.asarray(b, np.float64))


def signatures_match(
    a: np.ndarray, b: np.ndarray, rtol: float = 1e-4
) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    # The A-probe projections (first half; magnitude ~n^1.5 for the
    # diag-dominant family) and the b projections (second half; ~sqrt(n))
    # live on very different scales — compare each block against ITS OWN
    # scale, or a changed b would hide under the A block's tolerance and
    # resume silently against the wrong right-hand side.
    half = a.size // 2
    for sl in (slice(0, half), slice(half, None)):
        sa, sb = a[sl], b[sl]
        scale = float(np.max(np.maximum(np.abs(sa), np.abs(sb)))) + 1e-30
        if not np.all(np.abs(sa - sb) <= rtol * scale):
            return False
    return True


def save_checkpoint(
    path: str,
    state: _State,
    n: int,
    tol: float,
    signature: Optional[np.ndarray] = None,
    precondition: str = "none",
) -> None:
    """Write the CG state (padded device vectors + scalars) as an .npz.

    Atomic: writes to ``path + '.tmp'`` then renames, so a crash mid-write
    never leaves a truncated checkpoint behind. ``precondition`` is part of
    the trajectory identity: a Jacobi state's rsold carries r.z, so resuming
    it unpreconditioned (or vice versa) would corrupt the recurrence.
    """
    tmp = path + ".tmp"
    np.savez(
        tmp,
        x=np.asarray(state.x),
        r=np.asarray(state.r),
        p=np.asarray(state.p),
        rsold=np.asarray(state.rsold),
        rslast=np.asarray(state.rslast),
        k=np.asarray(state.k),
        done=np.asarray(state.done),
        n=np.int64(n),
        tol=np.float64(tol),
        signature=(
            np.zeros(0) if signature is None else np.asarray(signature)
        ),
        precondition=np.bytes_(precondition.encode()),
    )
    # np.savez appends .npz to paths without it.
    tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(tmp_real, path)


def load_checkpoint(path: str):
    """Read a checkpoint -> (state, n, tol, signature, precondition)."""
    with np.load(path) as z:
        state = _State(
            k=jnp.asarray(z["k"]),
            x=jnp.asarray(z["x"]),
            r=jnp.asarray(z["r"]),
            p=jnp.asarray(z["p"]),
            rsold=jnp.asarray(z["rsold"]),
            rslast=jnp.asarray(z["rslast"]),
            done=jnp.asarray(z["done"]),
        )
        sig = z["signature"] if "signature" in z else np.zeros(0)
        pre = (
            bytes(z["precondition"]).decode()
            if "precondition" in z
            else "none"
        )
        return state, int(z["n"]), float(z["tol"]), sig, pre


def _state_to_host(state_like) -> _State:
    """Pull a (possibly sharded) segment result fully to host memory."""
    if isinstance(state_like, _State):
        t = (
            state_like.k, state_like.x, state_like.r, state_like.p,
            state_like.rsold, state_like.rslast, state_like.done,
        )
    else:
        t = state_like
    k, x, r, p, rsold, rslast, done = jax.block_until_ready(t)
    return _State(
        k=jnp.asarray(np.asarray(k)),
        x=jnp.asarray(np.asarray(x)),
        r=jnp.asarray(np.asarray(r)),
        p=jnp.asarray(np.asarray(p)),
        rsold=jnp.asarray(np.asarray(rsold)),
        rslast=jnp.asarray(np.asarray(rslast)),
        done=jnp.asarray(np.asarray(done)),
    )


# --- Multi-process checkpoint I/O (per-host shard files) -------------------
# Under multi-process JAX (the reference's actual MPI-rank model,
# ``parallel_cg.c:76-82``) no host can materialize the full state vectors —
# ``np.asarray`` on a non-fully-addressable array is an error by design. So
# each process writes ONLY its own contiguous row block of (x, r, p) to its
# own file ``<path>.proc<i>`` (works on per-host local disks — no shared
# filesystem required) and resumes by reassembling the global arrays with
# ``jax.make_array_from_callback``, which invokes the callback only for
# locally-addressable shards. The replicated scalars (k, rsold, rslast,
# done) are duplicated into every file; on resume they are cross-checked
# with ``multihost_utils.assert_equal`` so a torn write (one process died
# between segment N's files and segment N+1's) can never splice two
# checkpoint generations into one corrupt trajectory.


def _mp_path(path: str) -> str:
    return f"{path}.proc{jax.process_index()}"


def _local_row_block(arr) -> tuple:
    """This process's addressable shards of a 1-D row-sharded global array,
    concatenated into one host block -> (block, global_row_start)."""
    shards = sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    start = shards[0].index[0].start or 0
    pos = start
    blocks = []
    for s in shards:
        lo = s.index[0].start or 0
        if lo != pos:
            raise NotImplementedError(
                "multi-process checkpointing requires each process's shards "
                f"to be contiguous rows (gap at row {pos} -> {lo}); use "
                "tpucg.make_mesh() device order"
            )
        d = np.asarray(s.data)
        blocks.append(d)
        pos = lo + d.shape[0]
    return np.concatenate(blocks), int(start)


def save_checkpoint_mp(
    path: str,
    state: _State,
    n: int,
    tol: float,
    signature: Optional[np.ndarray] = None,
    precondition: str = "none",
) -> None:
    """Multi-process ``save_checkpoint``: atomically write THIS process's row
    block of the sharded state to ``<path>.proc<process_index>``."""
    x, sx = _local_row_block(state.x)
    r, sr = _local_row_block(state.r)
    p, sp = _local_row_block(state.p)
    if not (sx == sr == sp and x.shape == r.shape == p.shape):
        raise AssertionError("x/r/p shard layouts diverged")
    real = _mp_path(path)
    tmp = real + ".tmp"
    np.savez(
        tmp,
        x=x,
        r=r,
        p=p,
        row_start=np.int64(sx),
        npad=np.int64(state.x.shape[0]),
        rsold=np.asarray(state.rsold),
        rslast=np.asarray(state.rslast),
        k=np.asarray(state.k),
        done=np.asarray(state.done),
        n=np.int64(n),
        tol=np.float64(tol),
        signature=(
            np.zeros(0) if signature is None else np.asarray(signature)
        ),
        precondition=np.bytes_(precondition.encode()),
        process_index=np.int64(jax.process_index()),
        process_count=np.int64(jax.process_count()),
    )
    tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(tmp_real, real)


def load_checkpoint_mp(path: str, mesh, axis: str):
    """Read this process's shard file and reassemble the GLOBAL sharded
    state -> (state, n, tol, signature, precondition). Requires the same
    process count and shard layout the checkpoint was written under."""
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    with np.load(_mp_path(path)) as z:
        if int(z["process_count"]) != jax.process_count():
            raise ValueError(
                f"checkpoint {path!r} was written by "
                f"{int(z['process_count'])} processes; this run has "
                f"{jax.process_count()} — resume on the same topology"
            )
        if int(z["process_index"]) != jax.process_index():
            raise ValueError(
                f"{_mp_path(path)!r} belongs to process "
                f"{int(z['process_index'])}, not {jax.process_index()}"
            )
        npad = int(z["npad"])
        start = int(z["row_start"])
        blocks = {key: z[key] for key in ("x", "r", "p")}
        scalars = {
            key: np.asarray(z[key])
            for key in ("k", "rsold", "rslast", "done")
        }
        meta = (
            int(z["n"]),
            float(z["tol"]),
            z["signature"],
            bytes(z["precondition"]).decode(),
        )
    # Torn-write guard: every process must hold the SAME generation.
    multihost_utils.assert_equal(
        (scalars["k"], scalars["rsold"], scalars["rslast"]),
        fail_message=(
            f"checkpoint {path!r} is torn across processes (per-process "
            "files carry different iteration states); delete and restart"
        ),
    )
    shard1 = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def mk(block):
        stop = start + block.shape[0]

        def cb(index):
            lo = index[0].start or 0
            hi = index[0].stop if index[0].stop is not None else npad
            if lo < start or hi > stop:
                raise ValueError(
                    f"checkpoint row block [{start},{stop}) does not cover "
                    f"this process's shard [{lo},{hi}) — mesh layout changed"
                )
            return block[lo - start: hi - start]

        return jax.make_array_from_callback((npad,), shard1, cb)

    state = _State(
        k=jax.device_put(jnp.asarray(scalars["k"]), rep),
        x=mk(blocks["x"]),
        r=mk(blocks["r"]),
        p=mk(blocks["p"]),
        rsold=jax.device_put(jnp.asarray(scalars["rsold"]), rep),
        rslast=jax.device_put(jnp.asarray(scalars["rslast"]), rep),
        done=jax.device_put(jnp.asarray(scalars["done"]), rep),
    )
    return (state,) + meta


def _state_block_on_device(state_like) -> _State:
    """Multi-process analog of ``_state_to_host``: fence the segment (the
    checkpoint must capture COMPLETED state) but keep the globally-sharded
    vectors on device — no host can hold them whole."""
    if isinstance(state_like, _State):
        t = (
            state_like.k, state_like.x, state_like.r, state_like.p,
            state_like.rsold, state_like.rslast, state_like.done,
        )
    else:
        t = state_like
    k, x, r, p, rsold, rslast, done = jax.block_until_ready(t)
    return _State(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rslast, done=done)


class _CkptIO:
    """Single-process checkpoint transport (whole-state .npz)."""

    to_host = staticmethod(_state_to_host)
    save = staticmethod(save_checkpoint)
    load = staticmethod(load_checkpoint)

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(path)

    @staticmethod
    def remove(path: str) -> None:
        os.remove(path)


class _MpCkptIO:
    """Multi-process transport: per-process row-block files."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis

    to_host = staticmethod(_state_block_on_device)
    save = staticmethod(save_checkpoint_mp)

    def load(self, path: str):
        return load_checkpoint_mp(path, self.mesh, self.axis)

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(_mp_path(path))

    @staticmethod
    def remove(path: str) -> None:
        os.remove(_mp_path(path))


# --- The shared segmented driver -------------------------------------------
# All checkpointed solvers (serial, 1-D/2-D dense sharded, operator-sharded)
# differ only in how they prepare the system and build init/segment/probe
# closures; the resume-validation and segment-loop protocol lives here ONCE.


def _resume_or_none(
    checkpoint_path: Optional[str],
    *,
    n: int,
    npad: int,
    tol: float,
    precondition: str,
    sig_fn: Callable[[], np.ndarray],
    io=_CkptIO,
):
    """Load + validate an existing checkpoint. Returns (state | None, sig |
    None); raises on any identity mismatch (size, tol, preconditioner, or
    the A/b probe signature). ``io`` is the checkpoint transport
    (``_CkptIO`` single-process whole-state files, ``_MpCkptIO``
    per-process row-block files)."""
    if checkpoint_path is None or not io.exists(checkpoint_path):
        return None, None
    state, n_ck, tol_ck, sig_ck, pre_ck = io.load(checkpoint_path)
    if n_ck != n or state.x.shape != (npad,):
        raise ValueError(
            f"checkpoint {checkpoint_path!r} is for n={n_ck} "
            f"(padded {state.x.shape}); this system is n={n} "
            f"(padded ({npad},))"
        )
    if tol_ck != tol:
        raise ValueError(f"checkpoint tol {tol_ck} != requested tol {tol}")
    if pre_ck != precondition:
        raise ValueError(
            f"checkpoint {checkpoint_path!r} was written under "
            f"precondition={pre_ck!r}; resuming with {precondition!r} would "
            "corrupt the recurrence (rsold carries r.z under Jacobi, r.r "
            "without)"
        )
    sig = sig_fn()
    if sig_ck.size and not signatures_match(sig_ck, sig):
        raise ValueError(
            f"checkpoint {checkpoint_path!r} was written for a DIFFERENT "
            "system (A/b probe-signature mismatch beyond tolerance); "
            "refusing to resume"
        )
    return state, sig


def _drive_segments(
    state: _State,
    segment_fn: Callable,
    *,
    n: int,
    npad: int,
    tol: float,
    maxiter: int,
    segment_iters: int,
    precondition: str,
    checkpoint_path: Optional[str],
    keep_checkpoint: bool,
    sig: Optional[np.ndarray],
    sig_fn: Callable[[], np.ndarray],
    io=_CkptIO,
) -> CGResult:
    """Run ``segment_fn(state, k_target) -> state`` until convergence or the
    cap, checkpointing after every segment; clean up only on CONVERGENCE (a
    capped exit must leave the state on disk for a later resume)."""
    while True:
        k_now = int(state.k)
        if bool(state.done) or k_now >= maxiter:
            break
        # numpy (not device) scalar: a traced operand in both regimes —
        # under multi-process a host scalar is the unambiguous
        # replicated-same-everywhere input form.
        k_target = np.int32(min(k_now + segment_iters, maxiter))
        state = io.to_host(segment_fn(state, k_target))
        if checkpoint_path is not None:
            if sig is None:
                sig = sig_fn()
            io.save(
                checkpoint_path, state, n, tol,
                signature=sig, precondition=precondition,
            )
    if (
        checkpoint_path is not None
        and not keep_checkpoint
        and bool(state.done)
        and io.exists(checkpoint_path)
    ):
        io.remove(checkpoint_path)
    x = state.x[:n] if npad != n else state.x
    return CGResult(
        x=x,
        iterations=state.k,
        residual_norm=jnp.sqrt(state.rslast),
        # under true-residual checking, done may also fire on stagnation;
        # convergence is rslast (the latest true r.r there) vs tol.
        converged=jnp.logical_and(
            state.done,
            state.rslast < jnp.asarray(tol, jnp.float32) ** 2,
        ),
    )


def _validate_checkpoint_config(
    config: CGConfig, segment_iters: int,
    allowed=("none", "jacobi"),
) -> None:
    if segment_iters < 1:
        raise ValueError("segment_iters must be >= 1")
    if config.method != "cg":
        raise ValueError(
            "checkpointed solves support method='cg' only (the pipelined "
            "state is not checkpointable)"
        )
    if config.precondition not in allowed:
        raise ValueError(
            f"this checkpointed solver supports precondition in {allowed} "
            "(a resumed poly preconditioner would re-estimate lambda_max "
            "and diverge from the saved trajectory; block_jacobi is "
            "serial-only so far)"
        )
    if jnp.dtype(config.dtype) != jnp.float32:
        raise ValueError(
            "checkpointed solves are float32-only (checkpoints store f32 "
            "state exactly)"
        )


# --- Serial driver ---------------------------------------------------------


def _precond(minv, npad):
    # 1-D minv = point Jacobi; 3-D = block Jacobi (same dispatch as
    # solver.cg._cg_jit — the checkpointed segments must run the exact
    # recurrence the plain solver runs).
    if minv is None:
        return None
    if minv.ndim == 3:
        from tpucg.solver.cg import make_block_precond

        return make_block_precond(minv, npad)
    return lambda r: minv * r


def _two_level_identity(tl) -> str:
    """The preconditioner-identity string for a two-level cycle: layout
    knobs plus low-precision random projections of the numerical content
    (acinv, dinv). 3 significant digits is robust to BLAS reduction-order
    jitter in a rebuilt-from-the-same-CSR inverse, yet two DIFFERENT
    preconditioners colliding on both digests is vanishingly unlikely.
    A mismatch refuses resume (the safe direction)."""
    acinv = np.asarray(tl.acinv, np.float64)
    dinv = np.asarray(tl.dinv, np.float64)
    rng = np.random.default_rng(0x2F)
    u = rng.standard_normal(acinv.shape[0])
    v = rng.standard_normal(acinv.shape[0])
    w = rng.standard_normal(dinv.shape[0])
    return (
        f"two_level[agg={tl.agg},om={tl.omega:g},sd={tl.smooth_degree},"
        f"sa={tl.smooth_alpha:g},npad={tl.npad},"
        f"a={float(u @ acinv @ v):.3e},d={float(w @ dinv):.3e}]"
    )


def _basis_identity(basis) -> str:
    """Low-precision content digest of a deflation basis (same rationale
    as :func:`_two_level_identity`): resuming under a DIFFERENT recycled
    stack would silently run a different recurrence."""
    W = np.asarray(basis.W, np.float64)
    rng = np.random.default_rng(0x5D)
    u = rng.standard_normal(W.shape[0])
    v = rng.standard_normal(W.shape[1])
    return f"deflated[m={W.shape[1]},w={float(u @ W @ v):.3e}]"


def _serial_precond(minv, op, like, two_level, basis=None):
    """Segment preconditioner, shared by init and segment jits. The
    two-level branch rebuilds the cycle closure from the SAME deterministic
    pieces every segment (lambda_max_estimate seeds from an iota, not from
    values), so a resumed trajectory is bit-identical; the deflation
    projection wraps whatever base results (solver.deflation semantics)."""
    if two_level is not None:
        from tpucg.solver.twolevel import make_two_level_precond

        base = make_two_level_precond(two_level, op.matvec, _dot, like)
    else:
        base = _precond(minv, like.shape[0])
    if basis is not None:
        from tpucg.solver.deflation import _deflate_precond

        return _deflate_precond(basis, base)
    return base


@functools.partial(jax.jit, static_argnames=("tol",))
def _init_jit(op, b, x0, minv, tol, two_level=None, basis=None):
    if basis is not None:
        # Galerkin warm start (cg_solve_deflated): x0 += W Ginv W^T r0.
        # Fresh starts only — a RESUMED state carries its own trajectory.
        _HI = jax.lax.Precision.HIGHEST
        r0 = b - op.matvec(x0)
        y = jnp.matmul(basis.Ginv,
                       jnp.matmul(basis.W.T, r0, precision=_HI),
                       precision=_HI)
        x0 = x0 + jnp.matmul(basis.W, y, precision=_HI)
    return init_state(
        op.matvec, _dot, b, x0, tol,
        precond=_serial_precond(minv, op, b, two_level, basis),
    )


@functools.partial(
    jax.jit, static_argnames=("tol", "safe_alpha")
)
def _segment_jit(op, state, minv, k_target, tol, safe_alpha,
                 two_level=None, basis=None, b=None, stag_carry=None):
    update = fused_update
    # The composed deflation x two-level recurrence replaces residuals
    # (solver.deflation.DEFLATED_REPLACE_EVERY, keyed on the CUMULATIVE
    # k) — the segments must run the exact recurrence cg_solve_deflated
    # runs or resume would not be bit-identical.
    replace_every = None
    replace_fn = None
    if basis is not None and two_level is not None:
        from tpucg.solver.deflation import (
            DEFLATED_REPLACE_EVERY,
            _galerkin_refresh,
        )

        replace_every = DEFLATED_REPLACE_EVERY  # None: measured negative
        if DEFLATED_REPLACE_EVERY:
            replace_fn = _galerkin_refresh(basis)
    from tpucg.solver.cg import TRUE_CHECK_EVERY

    return cg_loop(
        op.matvec, _dot, update, b, None,
        tol=tol, maxiter=k_target, safe_alpha=safe_alpha, state=state,
        precond=_serial_precond(minv, op, state.x, two_level, basis),
        replace_every=replace_every, replace_fn=replace_fn,
        # Same true-residual stopping as the unsegmented solvers (checks
        # take effect only at global k % cadence boundaries, so the
        # segmented trajectory stays bit-identical).
        check_true_every=(
            TRUE_CHECK_EVERY if two_level is not None else None
        ),
        # The stagnation bookkeeping must SURVIVE segment boundaries or a
        # floor-bound solve can never accumulate its two consecutive
        # stagnant windows and grinds to maxiter (cg_loop docstring).
        stag_carry=stag_carry, return_stag=True,
    )


def cg_solve_checkpointed(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    *,
    segment_iters: int = 128,
    checkpoint_path: Optional[str] = None,
    keep_checkpoint: bool = False,
    two_level=None,
    basis=None,
    **overrides,
) -> CGResult:
    """Solve A x = b, checkpointing every ``segment_iters`` iterations.

    If ``checkpoint_path`` exists, the solve resumes from it (size, tol,
    preconditioner, and A/b probe signature must all match). The checkpoint
    is deleted on convergence unless ``keep_checkpoint``. Semantics
    otherwise identical to ``tpucg.cg_solve``. ``A`` is anything
    ``as_operator`` takes — dense, or the sparse formats (CSR promotes to
    WELL): the long-running FEM/irregular class is exactly the
    segment-and-resume workload. ``two_level`` (a
    :func:`tpucg.build_two_level` result, ``precondition='none'``) runs
    the checkpointed segments under the two-level cycle; the cycle is a
    fixed deterministic operator, so resume stays bit-identical, and its
    identity (layout knobs + content digests) is recorded in the
    checkpoint like any other preconditioner. ``basis`` (a
    :func:`tpucg.build_deflation_basis` result) runs the DEFLATED
    recurrence (``cg_solve_deflated`` semantics: Galerkin warm start on
    fresh starts, the projection folded onto the base preconditioner) —
    so a :class:`tpucg.RecyclingCG` sequence's in-flight solve can
    segment-and-resume too.
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    _validate_checkpoint_config(
        config, segment_iters, allowed=("none", "jacobi", "block_jacobi")
    )
    from tpucg.sparse.formats import CSRMatrix

    if isinstance(A, CSRMatrix):
        # The docstring's promise: a bare CSR rides the WELL promotion
        # chain (DIA > BSR > WELL), not as_operator's legacy scalar-gather
        # ELL mapping — the long-lap irregular class this entry point
        # exists for is unusable on the ELL floor, and the un-128-padded
        # ELL npad also rejects any correctly built two_level.
        from tpucg.solver.operators import best_sparse_operator

        op = best_sparse_operator(A)
    else:
        op = as_operator(A)
    n, npad = op.n, op.padded_n
    maxiter = config.maxiter if config.maxiter is not None else n
    tol = float(config.tol)
    minv = None
    pre_id = config.precondition
    if two_level is not None:
        if config.precondition != "none":
            raise ValueError(
                "two_level runs as THE preconditioner (got "
                f"precondition={config.precondition!r})"
            )
        if two_level.npad != npad:
            raise ValueError(
                f"two_level was built for padded size {two_level.npad}, "
                f"operator has {npad} — rebuild with "
                f"build_two_level(csr, npad={npad})"
            )
        pre_id = _two_level_identity(two_level)
    elif config.precondition == "jacobi":
        d = op.diagonal()
        minv = jnp.where(d != 0, 1.0 / d, 1.0).astype(jnp.float32)
    elif config.precondition == "block_jacobi":
        from tpucg.solver.cg import block_jacobi_minv

        # bs is part of the preconditioner identity: a cross-bs resume
        # would silently run a different recurrence, so record it.
        minv = block_jacobi_minv(op, int(config.pc_block_size))
        pre_id = f"block_jacobi[bs={int(config.pc_block_size)}]"
    if basis is not None:
        if basis.W.shape[0] != npad:
            raise ValueError(
                f"basis was built for padded size {basis.W.shape[0]}, "
                f"operator has {npad}"
            )
        pre_id = _basis_identity(basis) + "+" + pre_id

    bj = jnp.asarray(b, jnp.float32)
    if bj.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {bj.shape}")
    if npad != n:
        bj = jnp.pad(bj, (0, npad - n))

    def sig_fn():
        return system_signature(op, bj)

    state, sig = _resume_or_none(
        checkpoint_path, n=n, npad=npad, tol=tol,
        precondition=pre_id, sig_fn=sig_fn,
    )
    if state is None:
        x0j = (
            jnp.zeros(n, jnp.float32)
            if x0 is None
            else jnp.asarray(x0, jnp.float32)
        )
        if npad != n:
            x0j = jnp.pad(x0j, (0, npad - n))
        state = _state_to_host(
            _init_jit(op, bj, x0j, minv, tol,
                      two_level=two_level, basis=basis)
        )

    # The stagnation carry is held here, NOT in the .npz: a kill/resume
    # restarts it at (inf, False), which only delays a stagnation stop by
    # up to two extra check windows — the on-disk trajectory is unchanged.
    # (Concrete from the start so every segment hits ONE _segment_jit
    # compile — checkpointed state is f32-only, validated above.)
    stag = [(jnp.asarray(np.inf, jnp.float32), jnp.zeros((), jnp.bool_))]

    def segment_fn(st, kt):
        st2, carry = _segment_jit(
            op, st, minv, kt, tol, bool(config.safe_alpha),
            two_level=two_level, basis=basis, b=bj,
            stag_carry=stag[0],
        )
        stag[0] = jax.block_until_ready(carry)
        return st2

    return _drive_segments(
        state, segment_fn,
        n=n, npad=npad, tol=tol, maxiter=maxiter,
        segment_iters=segment_iters, precondition=pre_id,
        checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
        sig=sig, sig_fn=sig_fn,
    )


# --- Distributed drivers ---------------------------------------------------


def sharded_cg_solve_checkpointed(
    A,
    b,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    segment_iters: int = 128,
    checkpoint_path: Optional[str] = None,
    keep_checkpoint: bool = False,
    n: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Checkpoint/resume for the DISTRIBUTED dense solver (1-D row-sharded
    or 2-D SUMMA meshes) — fault tolerance at the scale it matters.

    Same segmented-driver semantics as ``cg_solve_checkpointed``: the solve
    advances ``segment_iters`` laps per jitted shard_map call (cumulative
    bound is a traced scalar — one executable for all segments), the sharded
    state (k, x, r, p, rsold) is pulled to host and written atomically, and
    a restart resumes bit-identically. The identity guard probes the system
    through the DISTRIBUTED matvec and compares with a relative tolerance.

    Under multi-process JAX (``jax.process_count() > 1`` — the reference's
    MPI-rank model) the state cannot be pulled to any single host; each
    process instead writes its own contiguous row block to
    ``<checkpoint_path>.proc<i>`` (per-host local disks are fine) and resume
    reassembles the global arrays via ``jax.make_array_from_callback`` on
    the same process topology. Inputs must then be pre-sharded device
    arrays (``load_system_sharded``) — a host-array input would require
    every host to materialize all of A, the reference's rank-0 ceiling.

    Like ``sharded_cg_solve``, on 1-D meshes ``A``/``b``/``x0`` may be
    pre-sharded, pre-padded device arrays (e.g. from ``load_system_sharded``
    — no host ever materializes the full matrix; pass ``n`` for the logical
    size).
    """
    from tpucg.comm.mesh import make_mesh
    from tpucg.io.partitioner import RowPartition
    from tpucg.solver.sharded import (
        _sharded_init_jit,
        _sharded_matvec_jit,
        _sharded_segment_jit,
        distribute_system,
        ROW_ALIGN,
    )

    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    _validate_checkpoint_config(config, segment_iters)
    if mesh is None:
        mesh = make_mesh()
    multiprocess = jax.process_count() > 1
    if mesh.devices.ndim == 2:
        if n is not None or isinstance(A, jax.Array):
            raise ValueError(
                "2-D checkpointing takes host arrays (the column "
                "permutation is applied at distribution)"
            )
        if multiprocess:
            raise NotImplementedError(
                "multi-process checkpointing supports 1-D meshes. WON'T-DO "
                "for 2-D: the SUMMA arm distributes from HOST arrays (the "
                "column permutation is applied at distribution), so a "
                "multi-process 2-D run would make every host materialize "
                "all of A — exactly the rank-0 memory ceiling host-sharded "
                "loading exists to remove. Use a 1-D mesh (which scales the "
                "same collectives) for multi-process checkpointed runs."
            )
        return _sharded2d_cg_solve_checkpointed(
            A, b, x0, mesh, config,
            segment_iters=segment_iters, checkpoint_path=checkpoint_path,
            keep_checkpoint=keep_checkpoint,
        )
    axis = mesh.axis_names[0]
    if isinstance(A, jax.Array):
        n = A.shape[0] if n is None else n
        part = RowPartition(
            n=n, num_shards=mesh.devices.size, align=ROW_ALIGN
        )
        npad = part.n_padded
        if A.shape != (npad, npad):
            raise ValueError(
                f"pre-sharded A must be padded to ({npad},{npad}) for n={n} "
                f"on this mesh, got {A.shape}"
            )
        Ad = A
        bd = jnp.asarray(b, jnp.float32)
        if x0 is None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            x0d = jax.device_put(
                np.zeros(npad, np.float32), NamedSharding(mesh, P(axis))
            )
        else:
            x0d = jnp.asarray(x0, jnp.float32)
    else:
        if multiprocess:
            raise ValueError(
                "multi-process checkpointing takes pre-sharded device "
                "arrays (use load_system_sharded); a host-array input "
                "would make every host materialize all of A"
            )
        A = np.asarray(A, np.float32)
        if n is not None and n != A.shape[0]:
            raise ValueError("n override is for pre-sharded device inputs")
        n = A.shape[0]
        part = RowPartition(
            n=n, num_shards=mesh.devices.size, align=ROW_ALIGN
        )
        npad = part.n_padded
        Ad, bd, x0d = distribute_system(
            A,
            np.asarray(b, np.float32),
            None if x0 is None else np.asarray(x0, np.float32),
            mesh,
            part,
        )
    tol = float(config.tol)
    maxiter = config.maxiter if config.maxiter is not None else n
    static = dict(
        mesh=mesh, strategy=config.strategy, axis=axis,
    )

    if multiprocess:
        io = _MpCkptIO(mesh, axis)

        def sig_fn():
            from jax.experimental import multihost_utils
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            probe, R = _signature_probe_and_R(npad)
            probe_d = jax.device_put(probe, NamedSharding(mesh, P(axis)))
            y = _sharded_matvec_jit(Ad, probe_d, **static)
            y_full = multihost_utils.process_allgather(y, tiled=True)
            b_full = multihost_utils.process_allgather(bd, tiled=True)
            return _project_signature(R, y_full, b_full)

    else:
        io = _CkptIO

        def sig_fn():
            mv = lambda v: _sharded_matvec_jit(Ad, v, **static)
            return system_signature(mv, np.asarray(bd))

    state, sig = _resume_or_none(
        checkpoint_path, n=n, npad=npad, tol=tol,
        precondition=config.precondition, sig_fn=sig_fn, io=io,
    )
    if state is None:
        state = io.to_host(_sharded_init_jit(
            Ad, bd, x0d, tol=tol, precondition=config.precondition, **static
        ))

    def segment_fn(st, kt):
        return _sharded_segment_jit(
            Ad,
            (st.k, st.x, st.r, st.p, st.rsold, st.rslast, st.done),
            kt,
            tol=tol,
            safe_alpha=bool(config.safe_alpha),
            precondition=config.precondition,
            **static,
        )

    return _drive_segments(
        state, segment_fn,
        n=n, npad=npad, tol=tol, maxiter=maxiter,
        segment_iters=segment_iters, precondition=config.precondition,
        checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
        sig=sig, sig_fn=sig_fn, io=io,
    )


def sharded_operator_cg_solve_checkpointed(
    op,
    b,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    segment_iters: int = 128,
    checkpoint_path: Optional[str] = None,
    keep_checkpoint: bool = False,
    two_level=None,
    **overrides,
) -> CGResult:
    """Checkpoint/resume for the DISTRIBUTED sparse/stencil solvers — the
    scale where fault tolerance actually matters (the slab-halo Poisson
    solver runs BASELINE config 5's 512^3 = 134M-unknown grid).

    Accepts the same operator family as ``sharded_operator_cg_solve``
    (Poisson slab-halo, DIA band-halo, BSR, ELL, CSR-to-WELL), with the
    same padding; segmented-driver semantics identical to
    ``sharded_cg_solve_checkpointed`` (bit-identical resume,
    distributed-matvec identity probe, one segment executable for all
    segments). precondition: 'none' or 'jacobi', or pass ``two_level``
    (built with the SHARDED npad, ``agg_size`` dividing rows-per-shard,
    like ``sharded_operator_cg_solve``) — the long-lap FEM/irregular
    class is exactly the segment-and-resume workload.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpucg.comm.mesh import make_mesh
    from tpucg.solver.sharded import (
        _prepare_sharded_operator,
        _sharded_operator_init_jit,
        _sharded_operator_matvec_jit,
        _sharded_operator_segment_jit,
    )

    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses_replace(config, **overrides)
    _validate_checkpoint_config(config, segment_iters)
    if mesh is None:
        mesh = make_mesh()
    if mesh.devices.ndim != 1:
        raise ValueError("operator checkpointing runs on 1-D meshes")
    axis = mesh.axis_names[0]
    op_arrays, statics, n, npad, minv_host = _prepare_sharded_operator(
        op, mesh, config
    )
    precondition = config.precondition
    tl_static = {}
    acinv_host = np.zeros((1, 1), np.float32)
    if two_level is not None:
        if config.precondition != "none":
            raise ValueError(
                "two_level runs as THE preconditioner (got "
                f"precondition={config.precondition!r})"
            )
        if two_level.npad != npad:
            raise ValueError(
                f"two_level was built for padded size {two_level.npad}, "
                f"the sharded decomposition pads to {npad} — rebuild with "
                f"build_two_level(csr, agg_size={two_level.agg}, "
                f"npad={npad})"
            )
        if (npad // mesh.devices.size) % two_level.agg:
            raise ValueError(
                f"agg_size={two_level.agg} must divide rows-per-shard "
                f"({npad // mesh.devices.size}) so aggregates stay "
                "shard-local"
            )
        precondition = "two_level"
        pre_id = _two_level_identity(two_level)
        tl_static = dict(
            tl_agg=two_level.agg, tl_omega=two_level.omega,
            tl_sd=two_level.smooth_degree, tl_sa=two_level.smooth_alpha,
        )
        minv_host = np.asarray(two_level.dinv)
        acinv_host = np.asarray(two_level.acinv)
    else:
        pre_id = precondition
    b_host = np.asarray(b, np.float32)
    if b_host.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b_host.shape}")
    bp = np.zeros(npad, np.float32)
    bp[:n] = b_host
    x0p = np.zeros(npad, np.float32)
    if x0 is not None:
        x0p[:n] = np.asarray(x0, np.float32)
    minv = (
        minv_host if minv_host is not None else np.ones(npad, np.float32)
    )
    shard1 = NamedSharding(mesh, P(axis))
    bd = jax.device_put(jnp.asarray(bp), shard1)
    x0d = jax.device_put(jnp.asarray(x0p), shard1)
    minvd = jax.device_put(jnp.asarray(minv), shard1)
    acinvd = jax.device_put(jnp.asarray(acinv_host),
                            NamedSharding(mesh, P(None, None)))
    tol = float(config.tol)
    maxiter = config.maxiter if config.maxiter is not None else n
    static = dict(mesh=mesh, axis=axis, **statics)

    def sig_fn():
        mv = lambda v: _sharded_operator_matvec_jit(op_arrays, v, **static)
        return system_signature(mv, np.asarray(bd))

    state, sig = _resume_or_none(
        checkpoint_path, n=n, npad=npad, tol=tol,
        precondition=pre_id, sig_fn=sig_fn,
    )
    if state is None:
        state = _state_to_host(_sharded_operator_init_jit(
            op_arrays, bd, x0d, minvd, acinvd,
            tol=tol, precondition=precondition, **tl_static, **static,
        ))

    # Stagnation carry across segments (same rationale and restart
    # semantics as the serial driver's cell — see cg_solve_checkpointed).
    stag = [(jnp.asarray(np.inf, jnp.float32), jnp.zeros((), jnp.bool_))]

    def segment_fn(st, kt):
        out = _sharded_operator_segment_jit(
            op_arrays,
            (st.k, st.x, st.r, st.p, st.rsold, st.rslast, st.done),
            kt,
            minvd,
            acinvd,
            bd,
            tol=tol,
            safe_alpha=bool(config.safe_alpha),
            precondition=precondition,
            stag_carry=stag[0],
            **tl_static,
            **static,
        )
        stag[0] = jax.block_until_ready(out[7:9])
        return out[:7]

    return _drive_segments(
        state, segment_fn,
        n=n, npad=npad, tol=tol, maxiter=maxiter,
        segment_iters=segment_iters, precondition=pre_id,
        checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
        sig=sig, sig_fn=sig_fn,
    )


def _sharded2d_cg_solve_checkpointed(
    A, b, x0, mesh, config, *, segment_iters, checkpoint_path,
    keep_checkpoint,
) -> CGResult:
    """2-D (SUMMA) arm of ``sharded_cg_solve_checkpointed``: same segmented
    semantics with the state vectors sharded over both mesh axes. System
    prep (distribution, column permutation, Jacobi minv) is the shared
    ``_prepare_sharded2d``, so the checkpointed and plain 2-D solves can
    never diverge.
    """
    from tpucg.solver.sharded import (
        _prepare_sharded2d,
        _sharded2d_init_jit,
        _sharded2d_matvec_jit,
        _sharded2d_segment_jit,
    )

    A = np.asarray(A, np.float32)
    n = A.shape[0]
    Ad, bd, x0d, minvd, npad = _prepare_sharded2d(
        A, b, x0, mesh, config
    )
    tol = float(config.tol)
    maxiter = config.maxiter if config.maxiter is not None else n
    static = dict(mesh=mesh)

    def sig_fn():
        mv = lambda v: _sharded2d_matvec_jit(Ad, v, **static)
        return system_signature(mv, np.asarray(bd))

    state, sig = _resume_or_none(
        checkpoint_path, n=n, npad=npad, tol=tol,
        precondition=config.precondition, sig_fn=sig_fn,
    )
    if state is None:
        state = _state_to_host(_sharded2d_init_jit(
            Ad, bd, x0d, minvd,
            tol=tol, precondition=config.precondition, **static,
        ))

    def segment_fn(st, kt):
        return _sharded2d_segment_jit(
            Ad,
            (st.k, st.x, st.r, st.p, st.rsold, st.rslast, st.done),
            kt,
            minvd,
            tol=tol,
            safe_alpha=bool(config.safe_alpha),
            precondition=config.precondition,
            **static,
        )

    return _drive_segments(
        state, segment_fn,
        n=n, npad=npad, tol=tol, maxiter=maxiter,
        segment_iters=segment_iters, precondition=config.precondition,
        checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
        sig=sig, sig_fn=sig_fn,
    )
