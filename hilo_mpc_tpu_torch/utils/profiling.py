"""Tracing and per-solve timing.

PyTorch port of ``hilo_mpc_tpu/utils/profiling.py``: ``trace`` records a
device trace of the enclosed block with ``torch.profiler`` (CPU and, where
PyTorch sees a card, CUDA activity) and writes it to ``log_dir`` as a Chrome
trace that TensorBoard's profiler plugin and ``chrome://tracing`` read; the
hand-written kernels appear under their ``__global__`` names and the
registered Riccati op under ``hilo_mpc_tpu_torch::riccati_lq``.
``SolveTimer`` keeps per-solve wall times, synchronising the card when the
measured result holds CUDA tensors.
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/hilo_trace"):
    """Capture a trace of the enclosed block into ``log_dir``; yields
    ``log_dir``. The profile itself is ``trace.last`` afterwards (for
    ``key_averages()`` and the events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"hilo_trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
    trace.last = prof


trace.last = None


def _sync(result) -> None:
    """Wait for the card if ``result`` (a tensor, or a tuple, list, dict
    or dataclass of them) holds CUDA tensors."""
    import dataclasses

    import torch

    stack = [result]
    while stack:
        v = stack.pop()
        if torch.is_tensor(v):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
                return
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            stack.extend(getattr(v, f.name) for f in dataclasses.fields(v))


class SolveTimer:
    """Accumulates per-solve wall times; exposes the reference's stats surface
    (p50/p99, count), with a device sync for honest timing."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result=None):
        """Time the enclosed block. ``result`` holds what the block fills
        (a list or dict the block writes its outputs into, or the outputs
        themselves); CUDA tensors in it are waited for before the clock
        stops."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            _sync(result)
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict:
        import numpy as np

        if not self.times:
            return {"n": 0}
        t = np.asarray(self.times)
        return {
            "n": int(t.size),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "mean_ms": float(t.mean() * 1e3),
            "total_s": float(t.sum()),
        }
