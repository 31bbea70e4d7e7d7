"""chip_smoke.py's phases at tiny sizes on the CPU, each against the plain
reference it uses on the card, and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_phase_goldens():
    row = cs.phase_goldens()
    assert row["laps"] == [2, 4]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_phase_dense(storage):
    row = cs.phase_dense(128, storage)
    assert row["size"] == "n=128" and row["laps"] >= 1


def test_phase_poisson():
    assert cs.phase_poisson(8)["laps"] > 1


def test_phase_dia():
    assert "ndiag=7" in cs.phase_dia(8)["size"]


def test_phase_irregular():
    rows = cs.phase_irregular(2000, agg_size=64)
    assert [r["phase"] for r in rows] == [
        "irregular f64 reference", "irregular jacobi",
        "irregular two_level(64)"]


def _small_fem():
    from tpucg.io.generator import fem_p1_system

    A, b, _ = fem_p1_system(1500, seed=0)
    return A, cs._scipy_csr(A), b


def test_f64_reference_matches_direct_solve():
    import scipy.sparse.linalg as sla

    A, A64, b = _small_fem()
    x, k = cs._f64_jacobi_cg(A, b, 1e-10, 20_000)
    assert x.dtype == np.float64 and 1 < k < 20_000
    x_direct = sla.spsolve(A64.tocsc(), np.asarray(b, np.float64))
    err = np.linalg.norm(x - x_direct) / np.linalg.norm(x_direct)
    assert err < 1e-7, err


def test_fem_reference_floor_is_float32_rounding():
    A, A64, b = _small_fem()
    ref = cs._fem_reference(A, A64, b)
    assert ref["rel"] <= cs.FEM_REF_RTOL * 10
    # rho: x* rounded to float32, a few eps times the |A||x| / |b| scale.
    scale = np.linalg.norm(abs(A64) @ np.abs(ref["x"])) / np.linalg.norm(b)
    assert 0 < ref["rho"] <= 2 * np.finfo(np.float32).eps * scale


@pytest.mark.parametrize("scale", [0.01, 0.998, 1.01])
def test_check_fem_rejects_a_scaled_solution(scale):
    A, A64, b = _small_fem()
    ref = cs._fem_reference(A, A64, b)
    cs._check_fem("exact", ref["x"].astype(np.float32), 100, A64, b, ref)
    with pytest.raises(cs.CheckFailed):
        cs._check_fem("scaled", scale * ref["x"], 100, A64, b, ref)


def test_phase_batch():
    assert cs.phase_batch(4, 32)["size"] == "4 x n=32"


def test_phase_multi_on_four_virtual_devices():
    assert len(jax.devices()) >= 4
    rows = cs.phase_multi(256, 8, 2000, ndev=4)
    assert len(rows) == 5
    assert all("on 4 devices" in r["size"] for r in rows)


def test_check_raises():
    cs.check(True, "fine")
    with pytest.raises(cs.CheckFailed, match="broken"):
        cs.check(False, "broken")


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_exits_nonzero_without_gpu(argv, capsys):
    assert cs.main(argv) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
