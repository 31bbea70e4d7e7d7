"""Test harness: force an 8-device CPU platform before JAX initializes.

This is the JAX analog of the reference's oversubscribed single-host
``mpiexec -np 8`` testing (report §6): the same shard_map code paths run on 8
virtual CPU devices here and on GPUs unmodified. Must run before any
``import jax`` in the test process.

Tests that need the card carry the ``gpu`` marker and the ``gpu`` fixture,
which skips them unless JAX's backend is the GPU. They run on the card with
``TPUCG_TESTS_ON_GPU=1 python -m pytest -m gpu -n 0 tests/``, which leaves
the platform to JAX instead of forcing the CPU (one process: a JAX process
reserves most of the card's memory).
"""

import os

ON_GPU = os.environ.get("TPUCG_TESTS_ON_GPU", "") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# The persistent compilation cache stays off for the suite: its wall time
# is compile-dominated and sensitive to concurrent load on the machine
# (identical 7-file subsets measured 81 s solo vs 1081 s under competing
# processes); run it solo.

import numpy as np
import pytest


# The reference's shipped golden systems (hand-checkable math facts,
# SURVEY.md §4.1) — single source of truth in tpucg.io.golden, shared with
# `python -m tpucg selftest`.
from tpucg.io.golden import GOLDEN_2X2, GOLDEN_4X4  # noqa: E402


@pytest.fixture
def golden_2x2():
    return GOLDEN_2X2


@pytest.fixture
def golden_4x4():
    return GOLDEN_4X4


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "TPUCG_TESTS_ON_GPU=1 python -m pytest -m gpu -n 0 tests/")
