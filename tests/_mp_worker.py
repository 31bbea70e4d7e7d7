"""Worker for the multi-process distributed test (test_multiprocess.py).

Each OS process is one JAX process (the reference's MPI rank model,
``parallel_cg.c:76-82``): it initializes ``jax.distributed`` against the
localhost coordinator, contributes its forced CPU devices to the global
mesh, loads ONLY its own shards of the matrix file (host-sharded loading),
runs the sharded CG solve, and process 0 writes the gathered result for the
parent to check against the serial oracle.

Invoked as:
    python _mp_worker.py <coordinator> <num_processes> <process_id> <workdir> \
        [mode]

``mode``: "full" (default) runs the dense battery below; "operator" runs
the sparse/stencil operator decompositions (Poisson slab halo + DIA band
halo) — the reference's P=4 rank count (``parallel_cg.c:81-83``) exercised
on the operator arms.
"""

import json
import os
import sys

import jax

# The multi-process test runs on forced CPU devices (XLA_FLAGS is set by the
# parent), whatever platform the environment would pick.
jax.config.update("jax_platforms", "cpu")


def _operator_mode(workdir: str, pid: int, nproc: int) -> None:
    """Operator decompositions across OS processes: the slab-halo Poisson
    ppermutes and the DIA band-halo exchange ride the cross-process (gloo)
    mesh; every process holds the tiny host operator descriptor
    (device_put extracts only addressable shards — there is no dense A
    anywhere)."""
    import numpy as np
    from jax.experimental import multihost_utils

    import tpucg
    from tpucg.io.generator import poisson3d_dia
    from tpucg.solver.operators import PoissonOperator
    from tpucg.solver.sharded import sharded_operator_cg_solve

    mesh = tpucg.make_mesh()
    assert mesh.devices.size == len(jax.devices())
    m = 8
    n = m ** 3
    b = np.ones(n, np.float32)
    tol = 1.0e-5 * float(np.linalg.norm(b))
    res_p = sharded_operator_cg_solve(
        PoissonOperator(m=m), b, mesh=mesh, tol=tol
    )
    x_p = np.asarray(multihost_utils.process_allgather(res_p.x, tiled=True))
    res_d = sharded_operator_cg_solve(
        poisson3d_dia(m), b, mesh=mesh, tol=tol
    )
    x_d = np.asarray(multihost_utils.process_allgather(res_d.x, tiled=True))
    # WELL + two-level across OS processes (round 4): the irregular
    # decomposition's all-gather matvec AND the coarse space's
    # (nc,)-all_gather both ride the cross-process (gloo) mesh; the
    # coarse inverse is replicated per process. n=1024 pads to 128 rows
    # per shard at 8 shards — agg=32 divides it.
    from tpucg.io.generator import random_geometric_spd
    from tpucg.solver.twolevel import build_two_level

    Aw, bw, _ = random_geometric_spd(1024, seed=5, avg_degree=8.0)
    tol_w = 1e-5 * float(np.linalg.norm(bw))
    tl = build_two_level(Aw, agg_size=32, npad=1024)
    res_w = sharded_operator_cg_solve(
        Aw, bw, mesh=mesh, tol=tol_w, two_level=tl
    )
    x_w = np.asarray(multihost_utils.process_allgather(res_w.x, tiled=True))

    # Host-sharded .mtx loading (round 5, VERDICT r4 #2): each process
    # byte-range-reads ONLY its shards' rows of the indexed file, packs
    # its own WELL shards, and the two-level coarse matrix assembles
    # distributed (partial Ac + one (nc, nc) process-sum). The parent
    # asserts per-process bytes_read ~ 1/P of the file — the
    # rank-0-reads-everything ceiling (parallel_cg.c:100-108) removed on
    # the flagship irregular path.
    from tpucg.solver.sharded import load_well_system_sharded

    sys_mtx = load_well_system_sharded(
        os.path.join(workdir, "G.mtx"),
        os.path.join(workdir, "gb.npy"),
        mesh=mesh, two_level_agg=32,
    )
    res_mx = sharded_operator_cg_solve(
        sys_mtx, mesh=mesh, tol=tol_w, two_level=sys_mtx.two_level,
    )
    x_mx = np.asarray(
        multihost_utils.process_allgather(res_mx.x, tiled=True)
    )
    with open(os.path.join(workdir, f"mtx_bytes_{pid}.json"), "w") as f:
        json.dump({"bytes_read": sys_mtx.bytes_read}, f)
    if pid == 0:
        np.save(os.path.join(workdir, "x_op_poisson.npy"), x_p[:n])
        np.save(os.path.join(workdir, "x_op_dia.npy"), x_d[:n])
        np.save(os.path.join(workdir, "x_op_well2l.npy"), x_w[:1024])
        np.save(os.path.join(workdir, "x_op_mtx.npy"),
                x_mx[:sys_mtx.n])
        with open(os.path.join(workdir, "meta_op.json"), "w") as f:
            json.dump(
                {
                    "nproc": nproc,
                    "poisson_converged": bool(res_p.converged),
                    "poisson_iterations": int(res_p.iterations),
                    "dia_converged": bool(res_d.converged),
                    "dia_iterations": int(res_d.iterations),
                    "well2l_converged": bool(res_w.converged),
                    "well2l_iterations": int(res_w.iterations),
                    "mtx_converged": bool(res_mx.converged),
                    "mtx_iterations": int(res_mx.iterations),
                    "mtx_n": int(sys_mtx.n),
                },
                f,
            )
    print(f"operator worker {pid}/{nproc} done", flush=True)


def main() -> None:
    coord, nproc, pid, workdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    mode = sys.argv[5] if len(sys.argv) > 5 else "full"
    from tpucg.comm.mesh import init_distributed

    init_distributed(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    if mode == "operator":
        _operator_mode(workdir, pid, nproc)
        return

    import numpy as np

    import tpucg
    import tpucg.io.textio as textio
    from tpucg.solver.sharded import load_system_sharded, sharded_cg_solve

    # Record which matrix row-ranges THIS process parses: the scalability
    # claim is that make_array_from_callback only materializes
    # locally-addressable shards (no rank-0-reads-everything ceiling,
    # parallel_cg.c:100-108).
    reads = []
    orig = textio.load_matrix_rows

    def traced(path, r0, r1, ncols):
        reads.append([int(r0), int(r1)])
        return orig(path, r0, r1, ncols)

    textio.load_matrix_rows = traced

    mesh = tpucg.make_mesh()
    assert mesh.devices.size == len(jax.devices())
    Ad, bd, x0d, n = load_system_sharded(
        os.path.join(workdir, "A.txt"),
        os.path.join(workdir, "b.txt"),
        os.path.join(workdir, "x0.txt"),
        mesh=mesh,
    )
    for strategy in ("allgather", "overlap"):
        res = sharded_cg_solve(
            Ad, bd, x0d, mesh=mesh, n=n, strategy=strategy
        )
        from jax.experimental import multihost_utils

        x_full = np.asarray(
            multihost_utils.process_allgather(res.x, tiled=True)
        )
        if pid == 0:
            np.save(os.path.join(workdir, f"x_{strategy}.npy"), x_full)
            with open(
                os.path.join(workdir, f"meta_{strategy}.json"), "w"
            ) as f:
                json.dump(
                    {
                        "iterations": int(res.iterations),
                        "converged": bool(res.converged),
                        "residual_norm": float(res.residual_norm),
                    },
                    f,
                )
    # --- Multi-process checkpoint/resume (per-process row-block files) ---
    # Interrupt by capping maxiter (a capped exit must leave the state on
    # disk, exactly like the single-process driver), then resume to
    # convergence; the parent asserts oracle parity and that the resumed
    # trajectory matches an uninterrupted solve bit-for-bit.
    from jax.experimental import multihost_utils

    from tpucg.solver.checkpoint import _mp_path, sharded_cg_solve_checkpointed

    ckpt = os.path.join(workdir, "cg.ckpt")
    res_cap = sharded_cg_solve_checkpointed(
        Ad, bd, x0d, mesh=mesh, n=n,
        segment_iters=2, maxiter=2, checkpoint_path=ckpt,
    )
    assert not bool(res_cap.converged), "n=72 system converged in 2 laps?"
    assert os.path.exists(_mp_path(ckpt)), "capped exit left no shard file"
    res_ck = sharded_cg_solve_checkpointed(
        Ad, bd, x0d, mesh=mesh, n=n,
        segment_iters=3, checkpoint_path=ckpt,
    )
    assert not os.path.exists(
        _mp_path(ckpt)
    ), "converged solve must clean up its shard file"
    res_plain = sharded_cg_solve(Ad, bd, x0d, mesh=mesh, n=n)
    x_ck = np.asarray(
        multihost_utils.process_allgather(res_ck.x, tiled=True)
    )
    x_plain = np.asarray(
        multihost_utils.process_allgather(res_plain.x, tiled=True)
    )
    if pid == 0:
        np.save(os.path.join(workdir, "x_ckpt.npy"), x_ck)
        np.save(os.path.join(workdir, "x_ckpt_plain.npy"), x_plain)
        with open(os.path.join(workdir, "meta_ckpt.json"), "w") as f:
            json.dump(
                {
                    "iterations": int(res_ck.iterations),
                    "converged": bool(res_ck.converged),
                    "plain_iterations": int(res_plain.iterations),
                },
                f,
            )

    # --- Round-2 arms across OS processes -----------------------------
    # Chebyshev: the zero-psum laps + chunk-boundary dots over the
    # cross-process (gloo) mesh.
    res_ch = sharded_cg_solve(
        Ad, bd, x0d, mesh=mesh, n=n, method="chebyshev", maxiter=8 * n
    )
    x_ch = np.asarray(
        multihost_utils.process_allgather(res_ch.x, tiled=True)
    )
    # Block CG: the (n, k) all_gather GEMM + CholeskyQR2 Gram psums. Every
    # process holds the same host copy of the small system (device_put
    # extracts only addressable shards).
    from tpucg.solver.sharded import sharded_cg_solve_block

    A_full, b_full, _ = tpucg.load_system(
        os.path.join(workdir, "A.txt"),
        os.path.join(workdir, "b.txt"),
        os.path.join(workdir, "x0.txt"),
    )
    rngB = np.random.default_rng(3)
    Bk = rngB.standard_normal((n, 3)).astype(np.float32)
    res_blk = sharded_cg_solve_block(np.asarray(A_full), Bk, mesh=mesh)
    x_blk = np.asarray(
        multihost_utils.process_allgather(res_blk.x, tiled=True)
    )
    # Block-Jacobi: shard-local diagonal-block inverses (setup eigh/inv
    # per process, batched block-GEMV applies) over the cross-process
    # mesh — zero extra collectives, so this proves the local-blocks
    # claim where it matters. bs=8 divides the 16-row padded shards.
    res_bj = sharded_cg_solve(
        Ad, bd, x0d, mesh=mesh, n=n, precondition="block_jacobi",
        pc_block_size=8,
    )
    x_bj = np.asarray(
        multihost_utils.process_allgather(res_bj.x, tiled=True)
    )
    if pid == 0:
        np.save(os.path.join(workdir, "x_cheb.npy"), x_ch)
        np.save(os.path.join(workdir, "x_block.npy"), x_blk)
        np.save(os.path.join(workdir, "x_bj.npy"), x_bj)
        with open(os.path.join(workdir, "meta_arms.json"), "w") as f:
            json.dump(
                {
                    "cheb_converged": bool(res_ch.converged),
                    "cheb_iterations": int(res_ch.iterations),
                    "block_converged": bool(
                        np.asarray(res_blk.converged).all()
                    ),
                    "block_iterations": int(res_blk.iterations),
                    "bj_converged": bool(res_bj.converged),
                },
                f,
            )

    with open(os.path.join(workdir, f"reads_{pid}.json"), "w") as f:
        json.dump(sorted(reads), f)
    print(f"worker {pid}/{nproc} done", flush=True)


if __name__ == "__main__":
    main()
