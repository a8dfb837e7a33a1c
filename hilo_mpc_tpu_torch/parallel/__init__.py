"""Closed loops of many scenarios on the device (parallel/closed_loop.py).
Sharding and multi-device runs are not ported yet (ROADMAP.md §A.9)."""
from .closed_loop import (ClosedLoopEKFResult, ClosedLoopMHEResult,
                          ClosedLoopResult, fused_closed_loop_ekf_fn,
                          fused_closed_loop_fn, fused_closed_loop_mhe_fn)

__all__ = ["ClosedLoopResult", "ClosedLoopMHEResult", "ClosedLoopEKFResult",
           "fused_closed_loop_fn", "fused_closed_loop_mhe_fn",
           "fused_closed_loop_ekf_fn"]
