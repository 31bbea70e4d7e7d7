"""tpucg — a conjugate-gradient solver library in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
C/MPI project ``mawunyega/conjugate_gradient`` (serial + parallel unpreconditioned
CG for dense/sparse SPD systems), running on NVIDIA GPUs:

- compute kernels (GEMV, dot, axpy, fused CG updates) as XLA operations at
  full f32 precision (reference: plain C loops,
  ``serialConjugate.c:109-177``);
- the CG iteration as a jit-compiled ``jax.lax.while_loop`` with the reference's
  float32 / ``sqrt(r.r) < 1e-6`` / <= n-iteration contract
  (reference: ``serialConjugate.c:180-259``);
- distribution as row-block sharding over a ``jax.sharding.Mesh`` with ``psum``
  scalar reductions (reference: ``MPI_Allreduce``, ``parallel_cg.c:287-313``) and
  two selectable communication strategies — ``allgather`` (reference:
  ``MPI_Allgather``, ``parallel_cg.c:290-291``) and ``overlap`` (a
  collective-permute ring with compute/comm overlap; the collective answer to
  the hand-rolled send/recv arm in ``point-to-point_cg.c:180-394``).
"""

from tpucg.config import CGConfig
from tpucg.solver.cg import (
    CGResult,
    cg_solve,
    cg_solve_batch,
    cg_solve_batch_banded,
    cg_solve_block,
    cg_solve_multi,
    spectral_interval,
)
from tpucg.solver.checkpoint import (
    cg_solve_checkpointed,
    sharded_cg_solve_checkpointed,
    sharded_operator_cg_solve_checkpointed,
)
from tpucg.solver.deflation import (
    DeflationBasis,
    RecyclingCG,
    build_deflation_basis,
    cg_solve_deflated,
    sharded_cg_solve_deflated,
)
from tpucg.solver.ir import cg_solve_ir, sharded_cg_solve_ir
from tpucg.solver.twolevel import TwoLevel, build_two_level
from tpucg.solver.minres import minres_solve, sharded_minres_solve
from tpucg.solver.sharded import (
    load_system_sharded,
    sharded_cg_solve,
    sharded_cg_solve_block,
    sharded_cg_solve_multi,
    sharded_operator_cg_solve,
)
from tpucg.solver.operators import (
    BsrOperator,
    best_sparse_operator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    WellOperator,
    LinearOperator,
    PoissonOperator,
)
from tpucg.io.textio import load_matrix, load_system, load_vector, save_array
from tpucg.io.mmio import load_matrix_market, save_matrix_market
from tpucg.io.generator import generate_spd_system, poisson3d_csr
from tpucg.comm.mesh import make_mesh, make_mesh2d

__version__ = "0.1.0"

__all__ = [
    "CGConfig",
    "CGResult",
    "cg_solve",
    "cg_solve_batch",
    "cg_solve_batch_banded",
    "cg_solve_block",
    "cg_solve_multi",
    "spectral_interval",
    "cg_solve_deflated",
    "sharded_cg_solve_deflated",
    "build_deflation_basis",
    "DeflationBasis",
    "RecyclingCG",
    "cg_solve_checkpointed",
    "sharded_cg_solve_checkpointed",
    "sharded_operator_cg_solve_checkpointed",
    "best_sparse_operator",
    "cg_solve_ir",
    "TwoLevel",
    "build_two_level",
    "minres_solve",
    "sharded_minres_solve",
    "sharded_cg_solve_ir",
    "sharded_cg_solve",
    "sharded_cg_solve_block",
    "sharded_cg_solve_multi",
    "sharded_operator_cg_solve",
    "load_system_sharded",
    "LinearOperator",
    "BsrOperator",
    "DenseOperator",
    "DiaOperator",
    "EllOperator",
    "WellOperator",
    "PoissonOperator",
    "load_matrix",
    "load_matrix_market",
    "load_system",
    "save_matrix_market",
    "load_vector",
    "save_array",
    "generate_spd_system",
    "poisson3d_csr",
    "make_mesh",
    "make_mesh2d",
]
