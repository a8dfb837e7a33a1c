"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of ``hilo_mpc_tpu/ops/pallas_kernels.py``. Each wrapper takes the
JAX kernel's public layout (batch first), checks device, dtype, contiguity and
shapes, allocates outputs and scratch with ``torch.empty``, launches on
PyTorch's current stream without synchronizing, and counts its launches in a
plain integer attribute (``<wrapper>.launches``) so a run can show that its
main path went through the kernel. For CPU tensors — and only for them — a
wrapper returns its plain version instead; for CUDA tensors it launches the
kernel or raises.

Sources live in ``hilo_mpc_tpu_torch/csrc/`` and are built by ``nvcc`` at first
use (ops/_build.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .riccati import solve_lq

# (nx, nu) pairs instantiated in csrc/riccati_lq.cu
RICCATI_LQ_SIZES = ((2, 1), (3, 2), (2, 3))


def riccati_lq_reference(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                         reg: float = 1e-8):
    """Plain PyTorch version of ``riccati_lq_cuda``: the batch-first Riccati
    sweeps of ops/riccati.py. Same arguments and returns."""
    return tuple(solve_lq(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg=reg))


def _riccati_fn(dtype):
    lib = _build.load("riccati_lq")
    fn = lib.riccati_lq_f32 if dtype == torch.float32 else lib.riccati_lq_f64
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 19
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def riccati_lq_cuda(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                    reg: float = 1e-8):
    """Batched stagewise LQ solve as ONE CUDA kernel (csrc/riccati_lq.cu),
    replacing ``hilo_mpc_tpu/ops/pallas_kernels.py:riccati_lq_pallas``.

    Shapes (Bt = batch): A (Bt,N,nx,nx), B (Bt,N,nx,nu), Q (Bt,N,nx,nx),
    S (Bt,N,nu,nx), R (Bt,N,nu,nu), q (Bt,N,nx), r (Bt,N,nu), c (Bt,N,nx),
    P_term (Bt,nx,nx), p_term (Bt,nx), dx0 (Bt,nx); float32 or float64, one
    dtype, contiguous, one CUDA device; (nx, nu) in ``RICCATI_LQ_SIZES``.
    Returns (dX (Bt,N+1,nx), dU (Bt,N,nu), lam (Bt,N,nx), K (Bt,N,nu,nx),
    kff (Bt,N,nu), cost_red (Bt,)).
    """
    args = (A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
    if not any(t.is_cuda for t in args):
        return riccati_lq_reference(*args, reg=reg)
    if A.dim() != 4 or B.dim() != 4:
        raise ValueError(f"A and B must be (Bt, N, nx, nx) / (Bt, N, nx, nu), "
                         f"got {tuple(A.shape)} and {tuple(B.shape)}")
    Bt, N, nx, nu = A.shape[0], A.shape[1], A.shape[2], B.shape[3]
    if (nx, nu) not in RICCATI_LQ_SIZES:
        raise ValueError(f"riccati_lq_cuda has no instantiation for nx={nx}, "
                         f"nu={nu}; built sizes: {RICCATI_LQ_SIZES}")
    if Bt < 1 or N < 1 or Bt >= 2 ** 31:
        raise ValueError(f"need 1 <= Bt < 2**31 and N >= 1, got Bt={Bt}, N={N}")
    expected = {
        "A": (Bt, N, nx, nx), "B": (Bt, N, nx, nu), "Q": (Bt, N, nx, nx),
        "S": (Bt, N, nu, nx), "R": (Bt, N, nu, nu), "q": (Bt, N, nx),
        "r": (Bt, N, nu), "c": (Bt, N, nx), "P_term": (Bt, nx, nx),
        "p_term": (Bt, nx), "dx0": (Bt, nx)}
    dtype, device = A.dtype, A.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"riccati_lq_cuda takes float32 or float64, got {dtype}")
    for (name, shape), t in zip(expected.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; all inputs must "
                             f"be {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    dX, dU, lam = empty(Bt, N + 1, nx), empty(Bt, N, nu), empty(Bt, N, nx)
    K, kff, dec = empty(Bt, N, nu, nx), empty(Bt, N, nu), empty(Bt)
    Pn, pn = empty(Bt, N, nx, nx), empty(Bt, N, nx)       # (P, p)_{k+1} stash
    fn = _riccati_fn(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(nx, nu, *[t.data_ptr() for t in args],
                *[t.data_ptr() for t in (dX, dU, lam, K, kff, dec, Pn, pn)],
                Bt, N, float(reg), stream)
    if rc != 0:
        raise RuntimeError(f"riccati_lq kernel launch failed: cudaError {rc}")
    riccati_lq_cuda.launches += 1
    return dX, dU, lam, K, kff, dec


riccati_lq_cuda.launches = 0
