"""Backend resolution, the device peak table and the compile-cache path.

No operator has a Pallas kernel: every solve runs XLA on every platform,
and ``kernel="pallas"`` is refused instead of being served by an
interpreter or another kernel. The tests that patch the backend to "gpu"
check that nothing on the solve path asks the platform for a kernel."""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpucg
from tpucg.bench import timing
from tpucg.kernels.dispatch import resolve_backend

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kernel,want", [("auto", "xla"), ("xla", "xla")])
def test_resolve_backend(kernel, want):
    assert resolve_backend(kernel) == want


@pytest.mark.parametrize("kernel", ["pallas", "mosaic", ""])
def test_resolve_backend_refuses(kernel):
    with pytest.raises(ValueError):
        resolve_backend(kernel)
    with pytest.raises(ValueError):
        tpucg.CGConfig(kernel=kernel)


@pytest.fixture
def as_gpu(monkeypatch):
    """Pretend the default backend is the GPU (the arrays stay on the
    CPU): code that branched on the platform would show it here."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _jaxpr(fn, *args) -> str:
    return str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("kind", ["dense", "dia", "poisson", "well"])
def test_gpu_solve_path_has_no_pallas_call(as_gpu, kind):
    from tpucg.io.generator import poisson3d_csr, poisson3d_dia
    from tpucg.solver.cg import _cg_jit
    from tpucg.solver.operators import (
        DenseOperator,
        DiaOperator,
        PoissonOperator,
        WellOperator,
    )

    assert resolve_backend("auto") == "xla"
    op = {
        "dense": lambda: DenseOperator.create(np.eye(64, dtype=np.float32)),
        "dia": lambda: DiaOperator.from_dia(poisson3d_dia(4)),
        "poisson": lambda: PoissonOperator(m=4),
        "well": lambda: WellOperator.from_csr(poisson3d_csr(4)),
    }[kind]()
    b = jnp.ones(op.padded_n, jnp.float32)
    text = _jaxpr(
        lambda o, v: _cg_jit(o, v, v, None, 1e-6, 8, True), op, b
    )
    assert "pallas_call" not in text
    assert "while" in text


@pytest.mark.parametrize("entry", [
    "cg_solve_dense", "cg_solve_dia", "poisson", "well", "batch",
    "banded_batch", "sharded", "sharded_operator", "minres",
])
def test_pallas_refused_on_gpu(as_gpu, entry):
    from tpucg.io.generator import poisson3d_csr, poisson3d_dia
    from tpucg.solver.operators import PoissonOperator, WellOperator

    A = np.eye(16, dtype=np.float32) * 2.0
    b = np.ones(16, np.float32)
    calls = {
        "cg_solve_dense": lambda: tpucg.cg_solve(A, b, kernel="pallas"),
        "cg_solve_dia": lambda: tpucg.cg_solve(
            poisson3d_dia(4), np.ones(64, np.float32), kernel="pallas"),
        "poisson": lambda: tpucg.cg_solve(
            PoissonOperator(m=4), np.ones(64, np.float32), kernel="pallas"),
        "well": lambda: tpucg.cg_solve(
            WellOperator.from_csr(poisson3d_csr(4)), np.ones(128, np.float32),
            kernel="pallas"),
        "batch": lambda: tpucg.cg_solve_batch(A[None], b[None],
                                              kernel="pallas"),
        "banded_batch": lambda: tpucg.cg_solve_batch_banded(
            np.ones((1, 1, 16), np.float32), (0,), b[None],
            kernel="pallas"),
        "sharded": lambda: tpucg.sharded_cg_solve(A, b, kernel="pallas"),
        "sharded_operator": lambda: tpucg.sharded_operator_cg_solve(
            PoissonOperator(m=4), np.ones(64, np.float32), kernel="pallas"),
        "minres": lambda: tpucg.minres_solve(A, b, kernel="pallas"),
    }
    with pytest.raises(ValueError, match="pallas"):
        calls[entry]()


def test_no_mosaic_kernel_module_is_imported():
    """No module of the package, the tests or the scripts imports the
    Mosaic Pallas backend of the earlier accelerator or uses its
    scoped-memory or scalar-prefetch APIs (the names are assembled here so
    this file does not match itself)."""
    acc = "t" + "pu"
    banned = ("pallas." + acc, "pl" + acc, "vmem_" + "limit",
              "PrefetchScalar" + "GridSpec")
    files = list((REPO / "tpucg").rglob("*.py"))
    files += list((REPO / "benchmarks").glob("*.py"))
    files += [REPO / "bench.py", REPO / "chip_smoke.py",
              REPO / "__graft_entry__.py"]
    here = pathlib.Path(__file__).resolve()
    files += [p for p in (REPO / "tests").glob("*.py") if p != here]
    for path in files:
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path.name} mentions {word}"


def test_peak_table_h100_row():
    row = timing.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    assert row["hbm_bytes_per_s"] == 3.35e12
    assert row["f32_flops_per_s"] == 67e12
    assert row["bf16_flops_per_s"] == 989e12

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    assert timing.has_peaks(Dev())
    assert timing.hbm_peak_bytes_per_s(Dev()) == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_raises(kind):
    class Dev:
        device_kind = kind

    assert not timing.has_peaks(Dev())
    with pytest.raises(ValueError, match="no published peaks"):
        timing.hbm_peak_bytes_per_s(Dev())


def test_bench_report_roofline_not_measured_off_table():
    rep = timing.BenchReport(
        n=64, iterations=3, residual_norm=1e-7, distribute_s=0.0,
        solve_s=1e-3, total_s=1e-3, matvec_s=1e-6,
    ).finalize()
    assert rep.matvec_gbps is not None
    assert rep.roofline_frac is None
    assert "roofline not measured" in rep.pretty()


def test_compile_cache_dir(monkeypatch):
    from tpucg import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.cache_dir() == "/some/where"


def test_compile_cache_stays_off_on_cpu(monkeypatch):
    from tpucg import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_on_gpu_sets_the_fixed_dir(as_gpu, monkeypatch):
    from tpucg import compile_cache

    seen = {}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    assert compile_cache.enable_compile_cache() == str(REPO / ".jax_cache")
    assert seen == {"jax_compilation_cache_dir": str(REPO / ".jax_cache")}
    # With the variable set, JAX reads it itself: no other dir is set.
    seen.clear()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.enable_compile_cache() == "/elsewhere"
    assert seen == {}


def test_gitignore_lists_cache_and_chip_output():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines and "chiprun_out/" in lines


@pytest.mark.gpu
def test_gpu_golden_canary(gpu):
    """On the card: the 4x4 golden at tol 1e-6 in exactly 4 laps, which
    TF32 products would break."""
    from tpucg.io.golden import GOLDEN_4X4 as g

    r = tpucg.cg_solve(g["A"], g["b"], g["x0"], tol=1e-6)
    assert int(r.iterations) == 4
    np.testing.assert_allclose(np.asarray(r.x), g["x_star"], atol=1e-6)
    assert os.environ.get("JAX_PLATFORMS", "") != "cpu"
