"""Command-line interface: ``python -m tpucg <command>``.

The reference's entry points are four separately-compiled C programs taking
three positional file arguments each (``./serialConjugate A.txt b.txt x0.txt``,
``serialConjugate.c:43-73``; ``mpiexec -np P ./parallel_cg ...``), with every
other knob a compile-time ``#define``. tpucg replaces them with one CLI:

  solve      load a system from reference-format text files and solve it
             (serial on one chip, or sharded over the device mesh — the
             ``--strategy`` flag is the reference's collective-vs-p2p A/B)
  generate   write a random SPD test system in the reference's text format
             (the ``generateSPDmatrix.m`` role, same file naming)
  selftest   golden 2x2/4x4 systems + random SPD + sharded strategies
  bench      three-phase timing report (distribution / CG / total) + roofline
  info       devices, backends, native-parser status
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional


def _add_solver_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tol", type=float, default=None,
                   help="absolute residual tolerance (default: the reference "
                        "EPSILON 1e-6; bench scales sparse defaults to ||b|| "
                        "since f32 CG cannot reach 1e-6 absolute on "
                        "large-norm systems)")
    p.add_argument("--maxiter", type=int, default=None,
                   help="iteration cap (default: n, the reference's ROWS cap)")
    p.add_argument("--strategy", default="serial",
                   choices=("serial", "allgather", "overlap"),
                   help="serial = single device; allgather/overlap = sharded "
                        "(the reference's collective vs p2p arms)")
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "xla"))
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size for sharded strategies (default: all)")
    p.add_argument("--method", default="cg",
                   choices=("cg", "pipelined", "ca", "chebyshev", "minres"),
                   help="pipelined = Ghysels-Vanroose single-reduction CG; "
                        "ca = communication-avoiding s-step CG (one fused "
                        "Gram reduction per --s-step laps); chebyshev = "
                        "Chebyshev iteration (ZERO reductions per lap, one "
                        "exact residual check per --check-every laps); "
                        "minres = Paige-Saunders MINRES for symmetric "
                        "INDEFINITE systems (CG and the reference require "
                        "SPD)")
    p.add_argument("--storage", default="f32", choices=("f32", "bf16"),
                   help="device storage dtype for A: bf16 halves HBM "
                        "footprint/stream bytes with f32 accumulation "
                        "(dense systems and banded/DIA .mtx operators)")
    p.add_argument("--s-step", type=int, default=3, dest="s_step",
                   help="block size s for --method ca (3-4 is the usual "
                        "f32 sweet spot)")
    p.add_argument("--check-every", type=int, default=8, dest="check_every",
                   help="laps between exact residual checks for --method "
                        "chebyshev")
    p.add_argument("--interval", type=float, nargs=2, default=None,
                   metavar=("LAM_LO", "LAM_HI"),
                   help="cached spectrum bounds for --method ca/chebyshev "
                        "(e.g. from `tpucg info --spectrum`): skips the "
                        "per-solve power-method setup — the reusable-"
                        "artifact path for repeated solves on one operator")
    p.add_argument("--precondition", default="none",
                   choices=("none", "jacobi", "block_jacobi", "poly"))
    p.add_argument("--poly-degree", type=int, default=3,
                   help="degree for --precondition poly (truncated Neumann)")
    p.add_argument("--pc-block-size", type=int, default=64,
                   dest="pc_block_size",
                   help="diagonal-block size for --precondition "
                        "block_jacobi (inverted once, applied as one "
                        "batched block GEMV per lap)")
    p.add_argument("--two-level", type=int, default=None, metavar="AGG",
                   dest="two_level",
                   help="two-level (AMG-lite) preconditioning with "
                        "AGG-row contiguous aggregates (.mtx sparse "
                        "systems, method=cg): coarse-space correction "
                        "that cuts FEM-class lap counts ~5-10x where "
                        "Jacobi cannot (pairs well with --rcm)")
    p.add_argument("--smooth-degree", type=int, default=1,
                   dest="smooth_degree",
                   help="smoother degree for --two-level: 1 = damped "
                        "Jacobi; l >= 2 = l-step Chebyshev smoothing "
                        "(fewer laps at l extra matvecs per half-cycle)")
    p.add_argument("--coarse-max", type=int, default=None,
                   dest="coarse_max", metavar="NC",
                   help="with --two-level: recurse to a MULTILEVEL "
                        "hierarchy whenever a coarse level exceeds NC "
                        "rows (sparse coarse operators + recursive "
                        "V-cycles; lifts the (n/agg)^2 dense-inverse "
                        "memory ceiling for n >= 4M)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (the reference's informal "
                        "determinism/NaN checking, made a real tool)")


def _solve_args(args, A, b, x0):
    """Serial-only solve helper (the sharded flow lives in cmd_solve, which
    routes it through host-sharded loading)."""
    import jax

    import tpucg

    if getattr(args, "debug_nans", False):
        jax.config.update("jax_debug_nans", True)
    record = bool(
        getattr(args, "residual_history", False) and args.method == "cg"
    )
    if getattr(args, "residual_history", False) and not record:
        print("note: --residual-history requires --method cg; "
              "no history will be recorded")
    A = _apply_storage(args, A)
    t0 = time.perf_counter()
    if args.method == "minres":
        res = tpucg.minres_solve(
            A, b, x0,
            tol=args.tol if args.tol is not None else 1.0e-6,
            maxiter=args.maxiter, kernel=args.kernel,
            precondition=args.precondition,
            pc_block_size=args.pc_block_size,
        )
    else:
        res = tpucg.cg_solve(
            A, b, x0,
            tol=args.tol if args.tol is not None else 1.0e-6,
            maxiter=args.maxiter, kernel=args.kernel,
            method=args.method, precondition=args.precondition,
            poly_degree=args.poly_degree, s_step=args.s_step,
            pc_block_size=args.pc_block_size,
            check_every=args.check_every,
            record_residuals=record,
            interval=getattr(args, "interval", None),
        )
    jax.block_until_ready(res.x)
    return res, time.perf_counter() - t0


def _apply_storage(args, A):
    """--storage bf16: rebuild A's device operator with bfloat16 storage
    (f32 accumulation). Dense arrays and DIA operators support it; other
    inputs refuse loudly."""
    if getattr(args, "storage", "f32") != "bf16":
        return A
    import numpy as np

    from tpucg.solver.operators import DenseOperator, DiaOperator
    from tpucg.sparse.formats import DIAMatrix

    if isinstance(A, np.ndarray) and A.ndim == 2:
        return DenseOperator.create(A, dtype="bfloat16")
    if isinstance(A, (DiaOperator, DIAMatrix)):
        from tpucg.solver.sharded import _dia_canonical

        data, offsets, n = _dia_canonical(A)
        return DiaOperator.from_dia(
            DIAMatrix(data=data, offsets=offsets, shape=(n, n)),
            storage_dtype="bfloat16",
        )
    from tpucg.solver.operators import WellOperator

    if isinstance(A, WellOperator):
        # Only the packed VALUES re-cast (lane indices/layout unchanged).
        import dataclasses

        import jax.numpy as jnp

        return dataclasses.replace(A, vals=A.vals.astype(jnp.bfloat16))
    raise SystemExit(
        "--storage bf16 supports dense systems and banded (DIA) or "
        f"irregular (WELL) operators; got {type(A).__name__}"
    )


def _load_rhs_any(path: str, n: int) -> "np.ndarray":
    """Load a length-n vector from .mtx / .npy / reference text."""
    import numpy as np

    if path.endswith(".mtx"):
        from tpucg.io.mmio import load_matrix_market
        from tpucg.sparse.formats import COOMatrix

        v = load_matrix_market(path)
        if isinstance(v, COOMatrix):
            v = v.to_dense()
        v = np.asarray(v, np.float32).ravel()
        if v.size != n:
            raise ValueError(f"{path!r}: expected {n} values, got {v.size}")
        return v
    from tpucg.io.textio import load_vector

    return load_vector(path, n=n)


def _cmd_solve_mtx(args, t_total0) -> int:
    """Sparse MatrixMarket solve: auto-promote to a structured device
    format (DIA/BSR/WELL, `best_sparse_operator`) and run the
    operator CG path, serial or sharded."""
    import jax
    import numpy as np

    import tpucg
    from tpucg.io.mmio import load_matrix_market
    from tpucg.io.textio import save_array

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    t0 = time.perf_counter()
    coo = load_matrix_market(args.matrix)
    perm = None
    if isinstance(coo, np.ndarray):
        A_or_op = coo  # dense `array`-format file: the dense paths apply
        n = coo.shape[0]
        fmt = "dense"
    else:
        if coo.shape[0] != coo.shape[1]:
            raise SystemExit(f"matrix is {coo.shape[0]}x{coo.shape[1]}, "
                             "CG needs square SPD")
        csr = coo.to_csr()
        n = coo.shape[0]
        s_theta = getattr(args, "strength_order", None)
        if getattr(args, "rcm", False) or s_theta is not None:
            # Locality-restoring symmetric reordering: .mtx files in the
            # wild often carry no spatial numbering; RCM shrinks the
            # bandwidth so DIA/WELL packing (hence Gnnz/s) improves.
            # --strength-order runs RCM on the strength-filtered graph
            # instead, so contiguous index blocks (hence --two-level
            # aggregates) follow the STRONG couplings — semi-coarsening
            # for anisotropic operators. Solution is un-permuted before
            # reporting.
            from tpucg.sparse.ordering import (
                permute_csr, rcm_order, strength_order,
            )

            perm = (strength_order(csr, theta=s_theta)
                    if s_theta is not None else rcm_order(csr))
            csr = permute_csr(csr, perm)
        A_or_op = tpucg.best_sparse_operator(
            csr,
            # WELL needs its diagonal blocks extracted from the CSR at
            # construction (the packed slabs are not addressable).
            pc_block_size=(
                args.pc_block_size
                if args.precondition == "block_jacobi" else None
            ),
        )
        fmt = type(A_or_op).__name__
        if perm is not None:
            fmt += "+strength" if s_theta is not None else "+rcm"
    b = _load_rhs_any(args.rhs, n)
    x0 = _load_rhs_any(args.x0, n) if args.x0 else None
    if perm is not None:
        b = np.asarray(b)[perm]
        if x0 is not None:
            x0 = np.asarray(x0)[perm]
    load_s = time.perf_counter() - t0
    want_hist = bool(getattr(args, "residual_history", False))
    record = want_hist and args.method == "cg" and args.strategy == "serial"
    if want_hist and not record:
        print("note: --residual-history requires --method cg --strategy "
              "serial on .mtx systems; no history will be recorded")
    if getattr(args, "storage", "f32") == "bf16":
        A_or_op = _apply_storage(args, A_or_op)
        fmt += "+bf16"
    kw = dict(
        tol=args.tol if args.tol is not None else 1.0e-6,
        maxiter=args.maxiter, method=args.method,
        precondition=args.precondition, poly_degree=args.poly_degree,
        s_step=args.s_step, pc_block_size=args.pc_block_size,
        check_every=args.check_every,
    )
    if args.method == "minres" and (
        getattr(args, "two_level", None) is not None
        or getattr(args, "interval", None) is not None
    ):
        # MINRES takes neither knob; building the preconditioner and
        # stamping "+2lvl" into the report while silently solving without
        # it would misstate the published configuration (ADVICE r4).
        raise SystemExit(
            "--two-level/--interval do not apply to --method minres "
            "(MINRES preconditioning is --precondition jacobi/block_jacobi)"
        )
    if getattr(args, "interval", None) is not None:
        kw["interval"] = tuple(args.interval)
    if getattr(args, "two_level", None) is not None:
        if isinstance(A_or_op, np.ndarray):
            raise SystemExit(
                "--two-level applies to sparse .mtx systems "
                "(dense systems converge in O(10) laps already)"
            )
        import tpucg as _t

        # Built from the (possibly RCM-permuted) CSR against the target
        # decomposition's padding (serial: the operator's padded_n;
        # sharded WELL/DIA: round_up(n, 128 * P)); contiguous aggregates
        # inherit whatever locality the ordering has — hence --rcm.
        if args.strategy == "serial":
            tl_npad = A_or_op.padded_n
        else:
            from tpucg.solver.operators import DiaOperator, WellOperator

            if not isinstance(A_or_op, (WellOperator, DiaOperator)):
                raise SystemExit(
                    "--two-level with sharded strategies supports the "
                    "WELL/DIA decompositions (this matrix promoted to "
                    f"{type(A_or_op).__name__})"
                )
            P_ = len(jax.devices()) if args.devices is None else args.devices
            tl_npad = -(-n // (128 * P_)) * (128 * P_)
        kw["two_level"] = _t.build_two_level(
            csr, agg_size=args.two_level, npad=tl_npad,
            smooth_degree=getattr(args, "smooth_degree", 1),
            coarse_max=getattr(args, "coarse_max", None),
        )
        fmt += f"+2lvl{args.two_level}"
        if kw["two_level"].levels > 1:
            fmt += f"x{kw['two_level'].levels}lv"
    mr_kw = dict(
        tol=kw["tol"], maxiter=args.maxiter,
        precondition=args.precondition,
        pc_block_size=args.pc_block_size,
    )
    from tpucg.solver.operators import WellOperator

    sh_target, sh_kw = A_or_op, {}
    if args.strategy != "serial" and isinstance(A_or_op, WellOperator):
        # The sharded WELL decomposition re-packs each shard's rows
        # against global columns — hand it the source CSR (the serial
        # pack is not re-shardable); bf16 rides storage_dtype.
        sh_target = csr
        if getattr(args, "storage", "f32") == "bf16":
            sh_kw["storage_dtype"] = "bfloat16"
    t0 = time.perf_counter()
    if args.checkpoint is not None:
        # Segment-and-resume on the irregular path (VERDICT r4 #4): the
        # long-lap FEM/WELL class is exactly the workload checkpointing
        # exists for. method/precondition forward so the library's
        # "method='cg' only" guard fires loudly.
        from tpucg.solver.checkpoint import (
            cg_solve_checkpointed,
            sharded_cg_solve_checkpointed,
            sharded_operator_cg_solve_checkpointed,
        )

        if kw.get("interval") is not None:
            raise SystemExit("--interval does not compose with --checkpoint")
        if sh_kw:
            raise SystemExit(
                "--storage bf16 does not compose with --checkpoint on "
                "sharded irregular (WELL) systems yet"
            )
        if want_hist:
            print("note: --residual-history is not recorded by "
                  "checkpointed solves")
        ck_kw = dict(
            tol=kw["tol"], maxiter=args.maxiter, method=args.method,
            precondition=args.precondition,
            pc_block_size=args.pc_block_size,
            segment_iters=args.segment_iters,
            checkpoint_path=args.checkpoint,
        )
        tl = kw.get("two_level")
        if args.strategy == "serial":
            res = cg_solve_checkpointed(
                A_or_op, b, x0, kernel=args.kernel, two_level=tl, **ck_kw
            )
        elif isinstance(A_or_op, np.ndarray):
            res = sharded_cg_solve_checkpointed(
                A_or_op, b, x0, mesh=tpucg.make_mesh(args.devices),
                kernel=args.kernel, strategy=args.strategy, **ck_kw
            )
        else:
            res = sharded_operator_cg_solve_checkpointed(
                sh_target, b, x0, mesh=tpucg.make_mesh(args.devices),
                kernel=args.kernel, two_level=tl, **ck_kw
            )
    elif args.method == "minres":
        if args.strategy == "serial":
            res = tpucg.minres_solve(A_or_op, b, x0, kernel=args.kernel,
                                     **mr_kw)
        else:
            if sh_kw:
                print("note: --storage bf16 is serial-only for MINRES on "
                      "irregular (WELL) systems; solving in f32")
            res = tpucg.sharded_minres_solve(
                sh_target, b, x0, mesh=tpucg.make_mesh(args.devices),
                kernel=args.kernel, strategy=args.strategy, **mr_kw)
    elif args.strategy == "serial":
        res = tpucg.cg_solve(A_or_op, b, x0, kernel=args.kernel,
                             record_residuals=record, **kw)
    elif isinstance(A_or_op, np.ndarray):
        res = tpucg.sharded_cg_solve(
            A_or_op, b, x0, mesh=tpucg.make_mesh(args.devices),
            kernel=args.kernel, strategy=args.strategy, **kw)
    else:
        res = tpucg.sharded_operator_cg_solve(
            sh_target, b, x0, mesh=tpucg.make_mesh(args.devices),
            kernel=args.kernel, strategy=args.strategy, **sh_kw, **kw)
    jax.block_until_ready(res.x)
    solve_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_total0
    ck_note = (
        f" checkpointed every {args.segment_iters} iters"
        if args.checkpoint is not None else ""
    )
    print(f"system size          : {n} x {n}  [{fmt}]")
    print(f"strategy             : {args.strategy} [{args.kernel}]{ck_note}")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes jit compile)")
    print(f"total (s)            : {total_s:.6f}")
    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if args.checkpoint is not None and not bool(res.converged):
        print(f"checkpoint retained  : {args.checkpoint} (re-run to resume)")
    if res.residual_history is not None:
        hist = np.asarray(res.residual_history)
        for i in range(int(res.iterations) + 1):
            print(f"  ||r_{i}||{' ' * (12 - len(str(i)))}: {hist[i]:.6e}")
    x = np.asarray(res.x)
    if perm is not None:
        xo = np.empty_like(x[:n])
        xo[perm] = x[:n]
        x = xo
    if args.print_solution:
        np.set_printoptions(threshold=64, precision=7)
        print(f"x                    : {x}")
    if args.output:
        save_array(args.output, x, fmt="%r")
        print(f"solution written     : {args.output}")
    return 0 if bool(res.converged) else 3


def _load_deflation_v(path: str, n: int) -> "np.ndarray":
    """Load a deflation basis V (n, m) from .npy or .mtx."""
    import numpy as np

    if path.endswith(".npy"):
        V = np.load(path)
    elif path.endswith(".mtx"):
        from tpucg.io.mmio import load_matrix_market
        from tpucg.sparse.formats import COOMatrix

        V = load_matrix_market(path)
        if isinstance(V, COOMatrix):
            V = V.to_dense()
    else:
        raise SystemExit("--deflate expects a .npy or .mtx file")
    V = np.asarray(V, np.float32)
    if V.ndim == 1:
        V = V[:, None]
    if V.shape[0] != n:
        raise SystemExit(
            f"--deflate basis has {V.shape[0]} rows, system has {n}"
        )
    return V


def _cmd_solve_deflated(args, t_total0) -> int:
    """Deflated solve: project the basis loaded from --deflate out of the
    iteration (serial and sharded strategies; dense systems)."""
    import jax
    import numpy as np

    import tpucg
    from tpucg.io.textio import load_system, save_array

    if args.checkpoint is not None:
        raise SystemExit("--deflate does not compose with --checkpoint")
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    t0 = time.perf_counter()
    A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
    V = _load_deflation_v(args.deflate, A.shape[0])
    load_s = time.perf_counter() - t0
    kw = dict(
        tol=args.tol if args.tol is not None else 1.0e-6,
        maxiter=args.maxiter, kernel=args.kernel, method=args.method,
        precondition=args.precondition, poly_degree=args.poly_degree,
        pc_block_size=args.pc_block_size,
    )
    want_hist = bool(getattr(args, "residual_history", False))
    record = want_hist and args.method == "cg" and args.strategy == "serial"
    if want_hist and not record:
        print("note: --residual-history requires --method cg --strategy "
              "serial with --deflate; no history will be recorded")
    t0 = time.perf_counter()
    if args.strategy == "serial":
        res = tpucg.cg_solve_deflated(A, b, V, x0=x0,
                                      record_residuals=record, **kw)
    else:
        res = tpucg.sharded_cg_solve_deflated(
            A, b, V, x0=x0, mesh=tpucg.make_mesh(args.devices),
            strategy=args.strategy, **kw)
    jax.block_until_ready(res.x)
    solve_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_total0
    n = A.shape[0]
    print(f"system size          : {n} x {n}  [deflated m={V.shape[1]}]")
    print(f"strategy             : {args.strategy} [{args.kernel}]")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes jit compile)")
    print(f"total (s)            : {total_s:.6f}")
    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if getattr(res, "residual_history", None) is not None:
        hist = np.asarray(res.residual_history)
        for i in range(int(res.iterations) + 1):
            print(f"  ||r_{i}||{' ' * (12 - len(str(i)))}: {hist[i]:.6e}")
    x = np.asarray(res.x)
    if args.print_solution:
        np.set_printoptions(threshold=64, precision=7)
        print(f"x                    : {x}")
    if args.output:
        save_array(args.output, x, fmt="%r")
        print(f"solution written     : {args.output}")
    return 0 if bool(res.converged) else 3


def cmd_solve(args) -> int:
    import jax
    import numpy as np

    from tpucg.io.textio import load_system, save_array

    t_total0 = time.perf_counter()
    t0 = time.perf_counter()
    if args.matrix.endswith(".mtx"):
        if getattr(args, "deflate", None):
            raise SystemExit(
                "--deflate supports dense (text/.npy) matrices; sparse "
                ".mtx operators are not deflatable from the CLI"
            )
        return _cmd_solve_mtx(args, t_total0)
    if getattr(args, "deflate", None):
        return _cmd_solve_deflated(args, t_total0)
    if args.checkpoint is not None:
        return _cmd_solve_checkpointed(args, t_total0)
    if args.strategy != "serial" and args.method == "minres":
        # Sharded MINRES distributes from host arrays (the solver manages
        # its own padding/placement).
        import tpucg

        if args.debug_nans:
            jax.config.update("jax_debug_nans", True)
        A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
        n = A.shape[0]
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = tpucg.sharded_minres_solve(
            A, b, x0, mesh=tpucg.make_mesh(args.devices),
            tol=args.tol if args.tol is not None else 1.0e-6,
            maxiter=args.maxiter, kernel=args.kernel,
            strategy=args.strategy, precondition=args.precondition,
            pc_block_size=args.pc_block_size,
        )
        jax.block_until_ready(res.x)
        solve_s = time.perf_counter() - t0
    elif args.strategy != "serial":
        # Host-sharded loading: each shard's callback parses only its rows
        # (the reference's rank 0 reads everything, parallel_cg.c:100-108).
        import tpucg
        from tpucg.solver.sharded import load_system_sharded

        if args.debug_nans:
            jax.config.update("jax_debug_nans", True)
        if getattr(args, "storage", "f32") == "bf16":
            raise SystemExit(
                "--storage bf16 with sharded dense strategies: cast at "
                "distribution is not wired through host-sharded loading; "
                "use --strategy serial or the library API "
                "(sharded_cg_solve(..., storage_dtype=bfloat16))"
            )
        mesh = tpucg.make_mesh(args.devices)
        A, b, x0, n = load_system_sharded(
            args.matrix, args.rhs, args.x0, mesh=mesh, kernel=args.kernel
        )
        if args.n is not None and n != args.n:
            raise ValueError(
                f"--n {args.n} does not match the {n} values in {args.rhs!r}"
            )
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = tpucg.sharded_cg_solve(
            A, b, x0, mesh=mesh, n=n,
            tol=args.tol if args.tol is not None else 1.0e-6,
            maxiter=args.maxiter, kernel=args.kernel,
            strategy=args.strategy, method=args.method,
            precondition=args.precondition,
            poly_degree=args.poly_degree, s_step=args.s_step,
            pc_block_size=args.pc_block_size,
            check_every=args.check_every,
            interval=getattr(args, "interval", None),
        )
        jax.block_until_ready(res.x)
        solve_s = time.perf_counter() - t0
    else:
        A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
        n = A.shape[0]
        load_s = time.perf_counter() - t0
        res, solve_s = _solve_args(args, A, b, x0)
    total_s = time.perf_counter() - t_total0
    # The reference's rank-0 report block (parallel_cg.c:331-336), plus
    # convergence facts it never printed.
    print(f"system size          : {n} x {n}")
    print(f"strategy             : {args.strategy} [{args.kernel}]")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes jit compile)")
    print(f"total (s)            : {total_s:.6f}")
    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if res.residual_history is not None:
        hist = np.asarray(res.residual_history)
        for i in range(int(res.iterations) + 1):
            print(f"  ||r_{i}||{' ' * (12 - len(str(i)))}: {hist[i]:.6e}")
    x = np.asarray(res.x)
    if args.print_solution:
        np.set_printoptions(threshold=64, precision=7)
        print(f"x                    : {x}")
    if args.output:
        save_array(args.output, x, fmt="%r")
        print(f"solution written     : {args.output}")
    return 0 if bool(res.converged) else 3


def _cmd_solve_checkpointed(args, t_total0) -> int:
    """Segmented solve with on-disk checkpoints: interrupt at any segment
    boundary and re-run the same command to resume (the reference loses all
    state on failure — SURVEY.md §5 'Checkpoint / resume: None')."""
    import jax
    import numpy as np

    import tpucg
    from tpucg.io.textio import load_system, save_array
    from tpucg.solver.checkpoint import (
        cg_solve_checkpointed,
        sharded_cg_solve_checkpointed,
    )

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if getattr(args, "residual_history", False):
        print("note: --residual-history is not recorded by checkpointed "
              "solves")
    # method is forwarded so the library's "method='cg' only" guard fires
    # loudly for e.g. --method pipelined instead of silently running cg.
    kw = dict(
        tol=args.tol if args.tol is not None else 1.0e-6,
        maxiter=args.maxiter, kernel=args.kernel, method=args.method,
        precondition=args.precondition,
        pc_block_size=args.pc_block_size,
        segment_iters=args.segment_iters,
        checkpoint_path=args.checkpoint,
    )
    t0 = time.perf_counter()
    if args.strategy == "serial":
        A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
        n = A.shape[0]
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = cg_solve_checkpointed(A, b, x0, **kw)
    else:
        # Host-sharded loading, same as the non-checkpoint sharded branch:
        # each shard's callback parses only its own rows.
        from tpucg.solver.sharded import load_system_sharded

        mesh = tpucg.make_mesh(args.devices)
        A, b, x0, n = load_system_sharded(
            args.matrix, args.rhs, args.x0, mesh=mesh, kernel=args.kernel
        )
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sharded_cg_solve_checkpointed(
            A, b, x0, mesh=mesh, n=n, strategy=args.strategy, **kw
        )
    jax.block_until_ready(res.x)
    solve_s = time.perf_counter() - t0
    print(f"system size          : {n} x {n}")
    print(f"strategy             : {args.strategy} [{args.kernel}] "
          f"checkpointed every {args.segment_iters} iters")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes jit compile)")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if not bool(res.converged):
        print(f"checkpoint retained  : {args.checkpoint} (re-run to resume)")
    x = np.asarray(res.x)
    if args.print_solution:
        np.set_printoptions(threshold=64, precision=7)
        print(f"x                    : {x}")
    if args.output:
        save_array(args.output, x, fmt="%r")
        print(f"solution written     : {args.output}")
    return 0 if bool(res.converged) else 3


def cmd_generate(args) -> int:
    import os

    from tpucg.io.generator import generate_spd_system
    from tpucg.io.textio import save_array

    n = args.n
    A, b, x0 = generate_spd_system(n, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    # Same naming scheme and formats as generateSPDmatrix.m:23-43
    # (matrix2048X2048 / vector2048X1 / X2048X1; %.4f for A,b; %.1f for x0).
    pa = os.path.join(args.out_dir, f"matrix{n}X{n}.txt")
    pb = os.path.join(args.out_dir, f"vector{n}X1.txt")
    px = os.path.join(args.out_dir, f"X{n}X1.txt")
    save_array(pa, A, fmt="%.4f")
    save_array(pb, b, fmt="%.4f")
    save_array(px, x0, fmt="%.1f")
    print(f"wrote {pa}, {pb}, {px}")
    return 0


def cmd_convert(args) -> int:
    """Text <-> binary conversion. Binary .npy loads skip parsing entirely
    (the reference's dominant cost) and support memory-mapped row reads for
    host-sharded loading."""
    import numpy as np

    from tpucg.io.textio import load_matrix, load_vector, save_array

    src, dst = args.src, args.dst
    if src.endswith(".mtx") and dst.endswith(".mtx"):
        # The host-sharded loading ETL (one-time): expand symmetric
        # storage to general, row-sort, and write the byte-offset sidecar
        # so every process can range-read exactly its row block
        # (load_well_system_sharded).
        from tpucg.io.mmio import expand_matrix_market

        idx = expand_matrix_market(src, dst)
        print(f"wrote {dst} + sidecar {idx} (host-sharded loading ready)")
        return 0
    if src.endswith(".mtx"):
        from tpucg.io.mmio import load_matrix_market
        from tpucg.sparse.formats import COOMatrix

        arr = load_matrix_market(src)
        if isinstance(arr, COOMatrix):
            arr = arr.to_dense()  # text/.npy targets are dense formats
        if dst.endswith(".npy"):
            np.save(dst, arr)
        else:
            save_array(dst, arr, fmt=args.fmt)
    elif dst.endswith(".mtx"):
        from tpucg.io.mmio import save_matrix_market

        if src.endswith(".npy"):
            arr = np.load(src)
        elif args.kind == "matrix":
            arr = load_matrix(src, n=args.n)
        else:
            arr = load_vector(src, n=args.n)
        save_matrix_market(dst, arr)
    elif dst.endswith(".npy"):
        if args.kind == "matrix":
            arr = load_matrix(src, n=args.n)
        else:
            arr = load_vector(src, n=args.n)
        np.save(dst, arr)
    elif src.endswith(".npy"):
        arr = np.load(src)
        save_array(dst, arr, fmt=args.fmt)
    else:
        raise SystemExit("one of src/dst must be a .npy or .mtx file")
    print(f"wrote {dst} ({arr.size} values, shape {arr.shape})")
    return 0


def cmd_selftest(args) -> int:
    import jax
    import numpy as np

    import tpucg
    from tpucg.io.golden import GOLDEN_2X2, GOLDEN_4X4
    from tpucg.solver.oracle import oracle_cg

    failures = []

    def check(name, ok, detail=""):
        status = "ok" if ok else "FAIL"
        print(f"  [{status}] {name}" + (f" — {detail}" if detail else ""))
        if not ok:
            failures.append(name)

    print(f"devices: {jax.device_count()} x "
          f"{getattr(jax.devices()[0], 'device_kind', '?')}")
    for label, g in (("golden 2x2", GOLDEN_2X2), ("golden 4x4", GOLDEN_4X4)):
        r = tpucg.cg_solve(g["A"], g["b"], g["x0"])
        ok = (
            int(r.iterations) == g["iters"]
            and bool(r.converged)
            and np.allclose(np.asarray(r.x), g["x_star"], atol=1e-5)
        )
        check(label, ok,
              f"{int(r.iterations)} iters, ||r||={float(r.residual_norm):.2e}")

    n = args.n
    A, b, x0 = tpucg.generate_spd_system(n, seed=0)
    x_ref, k_ref, _ = oracle_cg(A, b, x0)
    r = tpucg.cg_solve(A, b, x0)
    check(
        f"random SPD n={n} vs oracle",
        bool(r.converged) and abs(int(r.iterations) - k_ref) <= 1
        and np.allclose(np.asarray(r.x), x_ref, atol=1e-4),
        f"{int(r.iterations)} iters (oracle {k_ref})",
    )
    for strategy in ("allgather", "overlap"):
        rs = tpucg.sharded_cg_solve(A, b, x0, strategy=strategy)
        check(
            f"sharded[{strategy}] n={n} ({jax.device_count()} devices)",
            bool(rs.converged)
            and np.allclose(np.asarray(rs.x), x_ref, atol=1e-4),
            f"{int(rs.iterations)} iters",
        )
    # Pipelined CG's recurrence drift puts its f32 residual floor slightly
    # above classic CG's; its contract is tested at a ||b||-scaled tolerance
    # (absolute 1e-6 on an arbitrary-norm system is below that floor).
    ptol = 1e-5 * float(np.linalg.norm(b))
    rp = tpucg.cg_solve(A, b, x0, method="pipelined", tol=ptol)
    check("pipelined", bool(rp.converged)
          and np.allclose(np.asarray(rp.x), x_ref, atol=1e-3),
          f"{int(rp.iterations)} iters")
    rj = tpucg.cg_solve(A, b, x0, precondition="jacobi")
    check("jacobi", bool(rj.converged)
          and np.allclose(np.asarray(rj.x), x_ref, atol=1e-4),
          f"{int(rj.iterations)} iters")
    B = np.stack([b, 0.5 * b], axis=1).astype(np.float32)
    rm = tpucg.cg_solve_multi(A, B)
    check("multi-RHS (k=2)", bool(rm.converged.all())
          and np.allclose(np.asarray(rm.x[:, 0]), x_ref, atol=1e-4),
          f"iters {[int(i) for i in rm.iterations]}")

    from tpucg.io import _native

    native = _native._load() is not None
    print(f"  [{'ok' if native else '--'}] native fast parser "
          f"({'loaded' if native else 'unavailable; NumPy fallback in use'})")
    if failures:
        print(f"FAILED: {failures}")
        return 1
    print("all selftests passed")
    return 0


def _build_bench_system(args):
    """Returns (label, operator-or-A, b, x0, n, nnz or None)."""
    import numpy as np

    import tpucg
    from tpucg.io.generator import poisson3d_csr
    from tpucg.solver.operators import BsrOperator, DenseOperator, PoissonOperator
    from tpucg.sparse.formats import csr_to_bsr

    if args.operator == "dense":
        A, b, x0 = tpucg.generate_spd_system(args.n, seed=0)
        return "dense", A, b, x0, args.n, None
    if args.operator not in (
        "poisson-ell", "poisson-bsr", "poisson-dia", "poisson-free",
        "poisson-auto",
    ):
        raise SystemExit(f"unknown operator {args.operator!r}")
    # Sparse 3-D Poisson workloads (BASELINE.json config: n=m^3 Laplacian).
    m = args.m
    n = m ** 3
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n).astype(np.float32)
    nnz = 7 * n - 6 * m * m  # Dirichlet 7-point Laplacian's exact count
    if args.operator == "poisson-free":
        op = PoissonOperator(m=m)
        import jax.numpy as jnp

        b = np.asarray(op.matvec(jnp.asarray(x_true)))
        return f"poisson-free m={m}", op, b, None, n, nnz
    csr = poisson3d_csr(m)
    b = csr.matvec(x_true)
    if args.operator == "poisson-auto":
        from tpucg.solver.operators import best_sparse_operator

        op = best_sparse_operator(csr)
        kindname = type(op).__name__.replace("Operator", "").lower()
        return f"poisson-auto[{kindname}] m={m}", op, b, None, n, csr.nnz
    if args.operator == "poisson-bsr":
        bs = 8 if n % 8 == 0 else 4
        return f"poisson-bsr m={m}", csr_to_bsr(csr, bs), b, None, n, csr.nnz
    if args.operator == "poisson-dia":
        from tpucg.sparse.formats import csr_to_dia

        return f"poisson-dia m={m}", csr_to_dia(csr), b, None, n, csr.nnz
    return f"poisson-ell m={m}", csr, b, None, n, csr.nnz


def _bench_one(args, strategy):
    import contextlib

    import jax
    import numpy as np

    import tpucg
    from tpucg.bench.timing import BenchReport, time_fn, time_matvec_loop
    from tpucg.solver.operators import DenseOperator, as_operator

    t_total0 = time.perf_counter()
    label, A, b, x0, n, nnz = _build_bench_system(args)

    profile_cm = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )
    if args.tol is not None:
        tol = args.tol
    elif args.operator == "dense":
        tol = 1.0e-6  # reference EPSILON; unit-scale generator systems
    else:
        # Large-norm sparse systems: absolute 1e-6 is below the f32 residual
        # floor (O(eps * kappa * ||b||)) and would spin to the iteration cap.
        tol = 1.0e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, method=args.method,
              precondition=args.precondition, poly_degree=args.poly_degree,
              s_step=args.s_step, check_every=args.check_every,
              pc_block_size=args.pc_block_size,
              kernel=args.kernel)
    t0 = time.perf_counter()
    if strategy == "serial":
        op = as_operator(A)
        bj = jax.device_put(jax.numpy.asarray(b, jax.numpy.float32))
        x0j = (
            jax.device_put(jax.numpy.asarray(x0))
            if x0 is not None else None
        )
        jax.tree_util.tree_map(jax.block_until_ready, (op, bj))
        distribute_s = time.perf_counter() - t0
        solve = lambda: tpucg.cg_solve(op, bj, x0j, maxiter=4 * n, **kw)
    else:
        if args.operator != "dense":
            raise SystemExit("sharded bench currently runs the dense operator")
        from tpucg.io.partitioner import RowPartition
        from tpucg.solver.sharded import distribute_system, ROW_ALIGN

        mesh = tpucg.make_mesh(args.devices)
        part = RowPartition(
            n=n, num_shards=mesh.devices.size, align=ROW_ALIGN
        )
        # Pad + place once, INSIDE the distribution phase (the reference's
        # MPI_Scatter fence) — not re-paid inside every timed solve.
        Ad, bd, x0d = distribute_system(
            np.asarray(A, np.float32), np.asarray(b, np.float32),
            None if x0 is None else np.asarray(x0, np.float32), mesh, part,
        )
        jax.block_until_ready(Ad)
        distribute_s = time.perf_counter() - t0
        solve = lambda: tpucg.sharded_cg_solve(
            Ad, bd, x0d, mesh=mesh, strategy=strategy, n=n,
            maxiter=4 * n, **kw
        )

    with profile_cm:
        res = solve()
        jax.block_until_ready(res.x)
        solve_s = time_fn(
            lambda: solve().x, warmup=1, iters=args.repeats, reduce="median"
        )
    matvec_s = None
    if strategy == "serial":
        v0 = jax.numpy.ones(op.padded_n, jax.numpy.float32)
        matvec_s = time_matvec_loop(lambda o, v: o.matvec(v), op, v0)
    report = BenchReport(
        n=n,
        iterations=int(res.iterations),
        residual_norm=float(res.residual_norm),
        distribute_s=distribute_s,
        solve_s=solve_s,
        total_s=time.perf_counter() - t_total0,
        matvec_s=matvec_s,
        nnz=nnz,
        padded_n=(op.padded_n if strategy == "serial" else None),
        strategy=f"{strategy}/{label}/{args.method}",
    ).finalize()
    return report


def cmd_bench(args) -> int:
    if args.compare_strategies:
        # The reference repo's entire research question — collective vs
        # hand-rolled p2p communication (results.xlsx; SURVEY.md §6) — as one
        # flag: run both sharded arms plus serial and print all three.
        reports = [
            _bench_one(args, s)
            for s in ("serial", "allgather", "overlap")
        ]
        for rep in reports:
            print(rep.to_json() if args.json else rep.pretty())
            if not args.json:
                print("-" * 60)
        return 0
    report = _bench_one(args, args.strategy)
    print(report.to_json() if args.json else report.pretty())
    return 0


def cmd_info(args) -> int:
    import jax

    import tpucg
    from tpucg.io import _native
    from tpucg.kernels.dispatch import resolve_backend

    devs = jax.devices()
    info = {
        "tpucg_version": tpucg.__version__,
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "device_count": len(devs),
        "device_kind": getattr(devs[0], "device_kind", "?"),
        "kernel_backend": resolve_backend("auto"),
        "native_parser": _native._load() is not None,
    }
    if getattr(args, "spectrum", None):
        # The reusable spectral artifact (power-method estimates): feed
        # lam_lo/lam_hi back into `solve --interval` so CA/Chebyshev skip
        # their per-solve setup (solver.cg.spectral_interval).
        import numpy as np

        path = args.spectrum
        if path.endswith(".mtx"):
            from tpucg.io.mmio import load_matrix_market
            from tpucg.sparse.formats import COOMatrix

            A = load_matrix_market(path)
            if isinstance(A, COOMatrix):
                A = tpucg.best_sparse_operator(A.to_csr())
        elif path.endswith(".npy"):
            A = np.load(path)
        else:
            from tpucg.io.textio import load_matrix

            A = load_matrix(path)
        lam_lo, lam_hi, kappa = tpucg.spectral_interval(A)
        info["spectrum"] = {
            "matrix": path, "lam_lo": lam_lo, "lam_hi": lam_hi,
            "kappa": kappa,
        }
    print(json.dumps(info, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpucg",
        description="Conjugate-gradient solver in JAX",
    )
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser(
        "solve", help="solve A x = b from text / .npy / .mtx files"
    )
    ps.add_argument("matrix",
                    help="matrix file: reference text (one float per line, "
                         "row-major), .npy, or MatrixMarket .mtx (sparse "
                         "files auto-promote to DIA/BSR/ELL)")
    ps.add_argument("rhs", help="right-hand-side vector file")
    ps.add_argument("x0", nargs="?", default=None,
                    help="initial-guess file (default zeros)")
    ps.add_argument("--n", type=int, default=None,
                    help="system size (default: inferred from file)")
    ps.add_argument("--print-solution", action="store_true")
    ps.add_argument("--rcm", action="store_true",
                    help="reverse Cuthill-McKee reorder a sparse .mtx "
                         "system before format promotion (solution is "
                         "un-permuted)")
    ps.add_argument("--strength-order", type=float, nargs="?", const=0.25,
                    default=None, metavar="THETA", dest="strength_order",
                    help="reorder by RCM on the strength-filtered graph "
                         "(|a_ij| >= THETA sqrt(a_ii a_jj), default 0.25): "
                         "contiguous blocks then follow strong couplings, "
                         "so --two-level aggregates semi-coarsen "
                         "anisotropic operators; overrides --rcm")
    ps.add_argument("--residual-history", action="store_true",
                    help="print per-iteration ||r|| (serial strategy only)")
    ps.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="segmented solve with resume-able .npz checkpoints "
                         "at PATH (serial and sharded strategies)")
    ps.add_argument("--segment-iters", type=int, default=128,
                    help="iterations per checkpoint segment")
    ps.add_argument("--output", default=None,
                    help="write the solution vector to this file")
    ps.add_argument("--deflate", default=None, metavar="V",
                    help="deflation basis (.npy or .mtx, n x m columns): "
                         "Galerkin warm start + per-lap A-orthogonal "
                         "projection (cg_solve_deflated; serial and "
                         "sharded strategies, dense systems, method=cg)")
    _add_solver_flags(ps)
    ps.set_defaults(fn=cmd_solve)

    pg = sub.add_parser("generate",
                        help="write a random SPD system (generateSPDmatrix.m role)")
    pg.add_argument("n", type=int)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--out-dir", default=".")
    pg.set_defaults(fn=cmd_generate)

    pc = sub.add_parser(
        "convert",
        help="convert between formats; .mtx -> .mtx expands+row-sorts+"
             "indexes for host-sharded loading; text <-> .npy (binary loads "
             "skip parsing — the production path)",
    )
    pc.add_argument("src")
    pc.add_argument("dst")
    pc.add_argument("--kind", default="matrix", choices=("matrix", "vector"))
    pc.add_argument("--n", type=int, default=None)
    pc.add_argument("--fmt", default="%r",
                    help="text format when converting npy -> text")
    pc.set_defaults(fn=cmd_convert)

    pt = sub.add_parser("selftest", help="golden + oracle + sharded checks")
    pt.add_argument("--n", type=int, default=256)
    pt.set_defaults(fn=cmd_selftest)

    pb = sub.add_parser("bench", help="three-phase timing + roofline report")
    pb.add_argument("--n", type=int, default=4096,
                    help="dense system size")
    pb.add_argument("--m", type=int, default=64,
                    help="Poisson grid edge (n = m^3) for sparse operators")
    pb.add_argument("--operator", default="dense",
                    choices=("dense", "poisson-ell", "poisson-bsr",
                             "poisson-dia", "poisson-free", "poisson-auto"))
    pb.add_argument("--repeats", type=int, default=5)
    pb.add_argument("--json", action="store_true")
    pb.add_argument("--compare-strategies", action="store_true",
                    help="run serial + allgather + overlap (the reference's "
                         "collective-vs-p2p A/B experiment)")
    pb.add_argument("--profile", default=None, metavar="DIR",
                    help="write an XLA profiler trace of the solve to DIR")
    _add_solver_flags(pb)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="device / backend / version info")
    pi.add_argument("--spectrum", default=None, metavar="MATRIX",
                    help="also estimate the SPD spectrum bounds of this "
                         "matrix (text/.npy/.mtx): prints lam_lo / lam_hi / "
                         "kappa — paste lam_lo lam_hi into `solve "
                         "--interval` to skip per-solve setup")
    pi.set_defaults(fn=cmd_info)
    return p


def main(argv: Optional[list] = None) -> int:
    from tpucg.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
