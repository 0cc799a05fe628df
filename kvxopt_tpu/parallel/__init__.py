"""Parallel scale-out: scenario batching (vmap/pjit over problem
instances) and sharded KKT linear algebra over a device mesh.

The reference has no distributed runtime (SURVEY.md section 2.3); its only
parallelism is BLAS threading.  The multi-device equivalent introduced here:

- `batch`: many independent IPMs at once — vmap over the pure coneqp core,
  sharded over a 'batch' mesh axis with jit.
- `sharded`: tensor-parallel KKT — G row-sharded over a 'kkt' axis, the
  normal-equations product formed with psum.
"""

from .batch import (  # noqa: F401
    make_qp_solver, batched_qp_solver, batched_qp_solver_mixed,
    batched_qp_solver_seq, make_lp_solver,
    batched_lp_solver, make_mesh)
from .sharded import sharded_kkt_factor, sharded_kkt_solver  # noqa: F401
from .arrow import arrow_kkt_factor  # noqa: F401
from .dist_chol import (  # noqa: F401
    dist_chol_factory, dist_cholesky, cyclic_pack, cyclic_unpack)
