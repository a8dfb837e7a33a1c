"""Scenario batches over devices and processes: the mesh and its sharded
solves (sharding.py), process groups (distributed.py) and the closed loops
of many scenarios on the device (closed_loop.py)."""
from .sharding import (Mesh, ShardedTensor, batch_stats, convergence_stats,
                       make_mesh, on_device, replicate, shard_batch,
                       sharded_solve_fn)
from .closed_loop import (ClosedLoopEKFResult, ClosedLoopMHEResult,
                          ClosedLoopResult, fused_closed_loop_ekf_fn,
                          fused_closed_loop_fn, fused_closed_loop_mhe_fn)
from . import distributed

__all__ = ["Mesh", "ShardedTensor", "make_mesh", "shard_batch", "replicate",
           "batch_stats", "sharded_solve_fn", "convergence_stats", "on_device",
           "distributed", "ClosedLoopResult", "ClosedLoopMHEResult",
           "ClosedLoopEKFResult", "fused_closed_loop_fn", "fused_closed_loop_mhe_fn",
           "fused_closed_loop_ekf_fn"]
