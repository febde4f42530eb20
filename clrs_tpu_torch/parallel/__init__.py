"""Sharded solves over a ``torch.distributed`` mesh (see .api, .bigcluster,
.comm)."""

from .api import (BLOCK_AXIS, enable_row_sharding, make_mesh,
                  multi_cluster_test_problem, shard_device_sdp, shard_state)
from .bigcluster import (dist_cholesky, dist_pairs_schur,
                         dist_scalar_schur_rows, dist_solve_tril,
                         dist_solve_tril_t, row_shard_ok)

__all__ = ["BLOCK_AXIS", "enable_row_sharding", "make_mesh",
           "multi_cluster_test_problem", "shard_device_sdp", "shard_state",
           "dist_cholesky", "dist_pairs_schur", "dist_scalar_schur_rows",
           "dist_solve_tril", "dist_solve_tril_t", "row_shard_ok"]
