"""Multi-PROCESS distributed execution (VERDICT round 1, missing 1).

The reference is genuinely multi-process — P MPI ranks over an interconnect
(``MPI_Init``/``Comm_size``, ``parallel_cg.c:76-82``). tpucg's equivalent is
``jax.distributed``: here TWO OS processes (4 forced CPU devices each) form
one 8-device mesh via a localhost coordinator, each host-loads ONLY its own
matrix shards, and the sharded solve must match the serial oracle. This is
the same code path a real multi-host GPU cluster takes; the per-process
read ledger proves the
rank-0-reads-everything ceiling is gone.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

NPROC = 2
DEVICES_PER_PROC = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    """Run the 2-process solve once; tests assert on its artifacts."""
    import tpucg
    from tpucg.io.textio import save_array

    workdir = str(tmp_path_factory.mktemp("mp"))
    n = 72  # not divisible by 8: pad rows live on the last process
    A, b, x0 = tpucg.generate_spd_system(n, seed=8)
    save_array(os.path.join(workdir, "A.txt"), A, fmt="%r")
    save_array(os.path.join(workdir, "b.txt"), b, fmt="%r")
    save_array(os.path.join(workdir, "x0.txt"), x0, fmt="%r")

    coord = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVICES_PER_PROC}",
        PYTHONPATH=(
            repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
        ).rstrip(os.pathsep),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(NPROC), str(pid), workdir],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(NPROC)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return workdir, (A, b, x0, n)


def test_multiprocess_solve_matches_oracle(mp_run):
    from tpucg.solver.oracle import oracle_cg

    workdir, (A, b, x0, n) = mp_run
    ox, oiters, _ = oracle_cg(A, b, x0)
    for strategy in ("allgather", "overlap"):
        x = np.load(os.path.join(workdir, f"x_{strategy}.npy"))
        with open(os.path.join(workdir, f"meta_{strategy}.json")) as f:
            meta = json.load(f)
        assert meta["converged"], strategy
        assert abs(meta["iterations"] - oiters) <= 1, strategy
        assert x.shape == (n,)
        np.testing.assert_allclose(x, ox, rtol=1e-4, atol=1e-5)


def test_multiprocess_checkpoint_resume(mp_run):
    """Interrupted (maxiter-capped) checkpointed solve resumed across the
    same 2-process topology: per-process row-block files, torn-write guard,
    and a resumed trajectory BIT-IDENTICAL to the uninterrupted solve (both
    run the same segment executable on exact f32 state)."""
    from tpucg.solver.oracle import oracle_cg

    workdir, (A, b, x0, n) = mp_run
    ox, oiters, _ = oracle_cg(A, b, x0)
    x_ck = np.load(os.path.join(workdir, "x_ckpt.npy"))
    x_plain = np.load(os.path.join(workdir, "x_ckpt_plain.npy"))
    with open(os.path.join(workdir, "meta_ckpt.json")) as f:
        meta = json.load(f)
    assert meta["converged"]
    assert meta["iterations"] == meta["plain_iterations"]
    assert abs(meta["iterations"] - oiters) <= 1
    np.testing.assert_array_equal(x_ck, x_plain)
    np.testing.assert_allclose(x_ck, ox, rtol=1e-4, atol=1e-5)


def test_multiprocess_round2_arms(mp_run):
    """Chebyshev (zero-psum laps) and TRUE block CG (CholeskyQR2 Gram
    psums) across the same 2-OS-process mesh: both must recover the
    oracle solutions through the cross-process collectives."""
    from tpucg.solver.oracle import oracle_cg

    workdir, (A, b, x0, n) = mp_run
    with open(os.path.join(workdir, "meta_arms.json")) as f:
        meta = json.load(f)
    assert meta["cheb_converged"] and meta["block_converged"]
    ox, _, _ = oracle_cg(A, b, x0)
    x_ch = np.load(os.path.join(workdir, "x_cheb.npy"))
    np.testing.assert_allclose(x_ch, ox, rtol=1e-3, atol=1e-4)
    x_blk = np.load(os.path.join(workdir, "x_block.npy"))
    rngB = np.random.default_rng(3)
    Bk = rngB.standard_normal((n, 3)).astype(np.float32)
    assert x_blk.shape == (n, 3)
    for j in range(3):
        xj, _, _ = oracle_cg(A, Bk[:, j], np.zeros(n, np.float32))
        np.testing.assert_allclose(x_blk[:, j], xj, rtol=1e-4, atol=1e-5)
    # Block-Jacobi PCG (shard-local block inverses, zero extra
    # collectives) must also recover the oracle solution cross-process.
    assert meta["bj_converged"]
    x_bj = np.load(os.path.join(workdir, "x_bj.npy"))
    np.testing.assert_allclose(x_bj, ox, rtol=1e-3, atol=1e-4)


def test_multiprocess_loading_is_host_sharded(mp_run):
    """Each process's file reads cover EXACTLY its own half of the padded
    rows — no process materializes all of A (SURVEY.md §7 hard part d)."""
    from tpucg.io.partitioner import RowPartition

    workdir, (_, _, _, n) = mp_run
    npad = RowPartition(
        n=n, num_shards=NPROC * DEVICES_PER_PROC, align=8
    ).n_padded
    half = npad // NPROC
    all_reads = []
    for pid in range(NPROC):
        with open(os.path.join(workdir, f"reads_{pid}.json")) as f:
            reads = json.load(f)
        assert reads, f"process {pid} read nothing"
        lo = min(r0 for r0, _ in reads)
        hi = max(r1 for _, r1 in reads)
        assert lo >= pid * half and hi <= (pid + 1) * half, (pid, reads)
        all_reads += reads
    covered = set()
    for r0, r1 in all_reads:
        covered.update(range(r0, r1))
    assert covered == set(range(n)), "every logical row read exactly once"


# --- P in {4, 8}: the reference's wider rank counts, on the OPERATOR arms.
# 4 procs x 2 devices and 8 procs x 1 device (parallel_cg.c:81-83); the
# heavy dense battery stays at P=2, these arms prove the wider topologies
# + the sparse halos.


@pytest.fixture(scope="module", params=[(4, 2), (8, 1)],
                ids=["p4x2", "p8x1"])
def mp_run_wide(request, tmp_path_factory):
    nproc, devices_per = request.param
    workdir = str(tmp_path_factory.mktemp(f"mp{nproc}"))
    # Host-sharded .mtx arm input: an indexed general-format file the
    # workers byte-range-read per shard (round 5).
    import tpucg
    from tpucg.io.generator import random_geometric_spd
    from tpucg.io.mmio import expand_matrix_market

    Am, bm, _ = random_geometric_spd(2048, seed=9, avg_degree=8.0)
    sym = os.path.join(workdir, "G_sym.mtx")
    tpucg.save_matrix_market(sym, Am.to_coo(), symmetric=True)
    expand_matrix_market(sym, os.path.join(workdir, "G.mtx"))
    np.save(os.path.join(workdir, "gb.npy"), bm)
    coord = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={devices_per}"
        ),
        PYTHONPATH=(
            repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
        ).rstrip(os.pathsep),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(nproc), str(pid), workdir,
             "operator"],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"p{nproc} worker failed:\n{out[-3000:]}"
    return workdir, nproc


def test_multiprocess_wide_operator_arms(mp_run_wide):
    """Slab-halo Poisson and band-halo DIA solved across 4 and 8 OS
    processes must match the serial oracle on the assembled system."""
    import tpucg
    from tpucg.solver.oracle import oracle_cg

    workdir, nproc = mp_run_wide
    m = 8
    n = m ** 3
    A = np.asarray(tpucg.poisson3d_csr(m).to_dense(), np.float32)
    b = np.ones(n, np.float32)
    tol = 1.0e-5 * float(np.linalg.norm(b))
    ox, oiters, _ = oracle_cg(A, b, np.zeros(n, np.float32), tol=tol)
    with open(os.path.join(workdir, "meta_op.json")) as f:
        meta = json.load(f)
    assert meta["nproc"] == nproc
    for arm in ("poisson", "dia"):
        assert meta[f"{arm}_converged"], arm
        assert abs(meta[f"{arm}_iterations"] - oiters) <= 1, arm
        x = np.load(os.path.join(workdir, f"x_op_{arm}.npy"))[:n]
        np.testing.assert_allclose(x, ox, rtol=1e-4, atol=1e-5,
                                   err_msg=arm)
    # WELL + two-level across OS processes: oracle parity on the
    # assembled irregular system (round 4 — the coarse space's
    # (nc,)-all_gather rides the cross-process mesh).
    import tpucg as _t
    from tpucg.io.generator import random_geometric_spd

    Aw, bw, _ = random_geometric_spd(1024, seed=5, avg_degree=8.0)
    tol_w = 1e-5 * float(np.linalg.norm(bw))
    oxw, oiw, _ = oracle_cg(
        np.asarray(Aw.to_dense(), np.float32), bw,
        np.zeros(1024, np.float32), tol=tol_w,
    )
    assert meta["well2l_converged"]
    xw = np.load(os.path.join(workdir, "x_op_well2l.npy"))[:1024]
    np.testing.assert_allclose(xw, oxw, rtol=2e-3, atol=2e-4)
    # Two-level lap counts quantize to the 16-lap true-residual check
    # cadence (round 5), which can exceed the tiny system's oracle count;
    # the solution-parity assert above is the correctness signal.
    assert meta["well2l_iterations"] <= oiw + 16


def test_multiprocess_mtx_loading_is_host_sharded(mp_run_wide):
    """The round-5 ceiling removal on the IRREGULAR path: every process's
    matrix bytes-read is bounded by ~its own share of the indexed .mtx
    file (the reference's rank 0 reads 100% of it,
    parallel_cg.c:100-108), and the host-sharded solve matches the serial
    oracle on the assembled system."""
    import tpucg
    from tpucg.io.generator import random_geometric_spd
    from tpucg.solver.oracle import oracle_cg

    workdir, nproc = mp_run_wide
    with open(os.path.join(workdir, "meta_op.json")) as f:
        meta = json.load(f)
    n = meta["mtx_n"]
    assert meta["mtx_converged"]

    Am, bm, _ = random_geometric_spd(2048, seed=9, avg_degree=8.0)
    tol = 1e-5 * float(np.linalg.norm(bm))
    ox, _, _ = oracle_cg(np.asarray(Am.to_dense(), np.float32), bm,
                         np.zeros(n, np.float32), tol=tol)
    x = np.load(os.path.join(workdir, "x_op_mtx.npy"))[:n]
    np.testing.assert_allclose(x, ox, rtol=2e-3, atol=2e-4)

    data_bytes = os.path.getsize(os.path.join(workdir, "G.mtx"))
    per = []
    for pid in range(nproc):
        with open(os.path.join(workdir, f"mtx_bytes_{pid}.json")) as f:
            per.append(json.load(f)["bytes_read"])
    assert all(b > 0 for b in per)
    assert sum(per) <= data_bytes
    # row-block nnz varies, so allow 60% headroom over the even share —
    # far below the reference's rank-0 100%.
    share = data_bytes / nproc
    for pid, br in enumerate(per):
        assert br <= 1.6 * share, (pid, br, share)
