"""Mesh construction.

The reference's process model is P MPI ranks over a single interconnect
(``MPI_Init``/``Comm_size``, ``parallel_cg.c:76-82``). tpucg's is a 1-D (or
2-D) ``jax.sharding.Mesh`` over ``jax.devices()``: on the GPUs of one host
XLA hands the collectives to NCCL over NVLink, where every card reaches
every other at the same rate, so the mesh follows the algorithm alone (no
topology shape). The same code runs on a forced multi-device CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``) — the analog of the
reference's oversubscribed single-host ``mpiexec -np N`` testing (report §6).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

ROWS_AXIS = "rows"
COLS_AXIS = "cols"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (one process per host on a pod slice).

    The reference's MPI_Init role (``parallel_cg.c:76``) for the multi-host
    case: after this, ``jax.devices()`` spans every process's devices and
    the same ``make_mesh``/``shard_map`` code runs across them. Pass
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly: nothing detects a cluster. No-op if already
    initialized.
    """
    import jax.distributed

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        # jax raises "distributed.initialize should only be called once."
        msg = str(e)
        if "already" not in msg and "once" not in msg:
            raise


def make_mesh2d(
    rows: int,
    cols: int,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_names=(ROWS_AXIS, COLS_AXIS),
) -> Mesh:
    """A (rows x cols) 2-D mesh for the block2d decomposition — the 2-D
    analog the reference never had (its only strategy is 1-D row striping,
    report §5.2); see ``tpucg.solver.sharded`` for the SUMMA-style GEMV."""
    if devices is None:
        devices = jax.devices()
    if rows * cols > len(devices):
        raise ValueError(
            f"requested {rows}x{cols} mesh, only {len(devices)} devices"
        )
    grid = np.asarray(devices[: rows * cols]).reshape(rows, cols)
    return Mesh(grid, axis_names)


def make_mesh(
    num_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_name: str = ROWS_AXIS,
) -> Mesh:
    """A 1-D mesh over ``num_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} present"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))
