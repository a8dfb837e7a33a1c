"""The whole-solve interior point as one CUDA kernel.

Counterpart of ``hilo_mpc_tpu/ops/pallas_ip.py``: ``solve_ocp_full_cuda``
replaces ``solve_ocp_pallas_full`` (line 143), whose ``pallas_call`` (line
842) runs the entire box-constrained pure-Newton interior point, dynamics
linearization included, in one kernel. Here ops/codegen_cuda.py writes the
problem (model, integrator, quadratic cost, active box rows) as C++, it is
compiled together with the solver template csrc/whole_ip.cuh by ``nvcc`` at
its first use (ops/_build.py, cached by the text's hash under
``_build/gen/``), and one launch solves every scenario of the batch, one
thread per scenario, until each has converged, diverged or reached
``max_iter``. ``whole_ip_supported`` is the gate (``pallas_full_supported``
plus an emittable model); ``NMPC.solve_batch_fn`` reads ``pallas_full`` and
takes this path for eligible problems.

The plain version, ``solve_ocp_full_reference``, is the port's ``solve_ocp``
with the kernel's options and the plain LQ sweeps, the counterpart of what
``tests/test_pallas_ip.py`` holds the JAX kernel against. The wrapper takes it
for CPU tensors and only for them. ``solve_ocp_full_host`` runs the kernel's
own per-scenario code, compiled for the host, on CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .codegen_cuda import MAX_ROWS, EmittedProblem, emit_problem, model_emit_error
from .ip_solver import IPOptions, OCPSolution, solve_ocp
from .riccati import make_plain_lq_solver


def whole_ip_supported(dims, bounds, options: IPOptions, fix_x0: bool,
                       model) -> bool:
    """True iff the whole-solve kernel covers this problem: the conditions of
    ``hilo_mpc_tpu/ops/pallas_ip.py:pallas_full_supported`` (box constraints
    only, fix_x0, pure Newton steps, no iterate recording or parallel
    Riccati, no pinned controls) and a model that ops/codegen_cuda.py can
    emit as C++."""
    if dims.n_h or dims.n_hN or dims.n_e or dims.n_eN:
        return False
    if not fix_x0:
        return False
    if options.mehrotra or options.convexify or options.n_linesearch > 1:
        return False
    if options.record_iterates or options.parallel_riccati:
        return False
    lbu = bounds.lbu.detach().cpu().double().numpy()
    ubu = bounds.ubu.detach().cpu().double().numpy()
    if (np.isfinite(lbu) & np.isfinite(ubu) & (ubu - lbu < 1e-9)).any():
        return False
    if 2 * dims.nu + 2 * dims.nx > MAX_ROWS:
        return False
    return model is not None and model_emit_error(model) is None


def whole_ip_problem(funcs, dims, bounds, n_theta: int,
                     options: IPOptions) -> EmittedProblem:
    """The problem as C++ and its numbers (ops/codegen_cuda.py)."""
    if funcs.source is None:
        raise NotImplementedError(
            "the whole-solve kernel needs the problem's source "
            "(OCPFunctions.source, which NMPC.setup attaches)")
    bnd = tuple(b.detach().cpu().double().numpy() for b in bounds)
    return emit_problem(funcs.source, dims, bnd, n_theta, options)


def solve_ocp_full_reference(funcs, dims, bounds, theta_B, x0_B, X_B, U_B,
                             options: IPOptions = IPOptions()) -> OCPSolution:
    """Plain PyTorch version of ``solve_ocp_full_cuda``: ``solve_ocp`` with the
    kernel's options, mu0 = ``options.mu_init`` and the plain LQ sweeps, on
    the device of its inputs. Same arguments and return."""
    return solve_ocp(funcs, dims, bounds, theta_B, x0_B, X_B, U_B,
                     options=options, fix_x0=True, mu0=options.mu_init,
                     lq_solver=make_plain_lq_solver)


def _check(dims, theta_B, x0_B, X_B, U_B):
    nx, nu, N = dims.nx, dims.nu, dims.N
    Bt = theta_B.shape[0]
    if theta_B.dim() != 3 or not 1 <= Bt < 2 ** 31:
        raise ValueError(f"theta_B must be (B, N+1, n_theta) with 1 <= B < 2**31, "
                         f"got {tuple(theta_B.shape)}")
    expected = {"theta_B": (Bt, N + 1, theta_B.shape[2]), "x0_B": (Bt, nx),
                "X_B": (Bt, N + 1, nx), "U_B": (Bt, N, nu)}
    dtype, device = theta_B.dtype, theta_B.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the whole-solve kernel takes float32 or float64, got {dtype}")
    for (name, shape), t in zip(expected.items(), (theta_B, x0_B, X_B, U_B)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; all inputs must "
                             f"be {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_double] + [ctypes.c_void_p] * 13 \
    + [ctypes.c_int]


def _bind(fn, stream: bool):
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + ([ctypes.c_void_p] if stream else [])
        fn.restype = ctypes.c_int
    return fn


def _run(fn, problem: EmittedProblem, dims, theta_B, x0_B, X_B, U_B, mu0,
         *stream):
    """Allocate the outputs, call one entry point of a built problem and
    return them: (X, U, lam, s rows, z rows, sN rows, zN rows, mu, kkt, obj,
    it, conv, div)."""
    nx, nu, N = dims.nx, dims.nu, dims.N
    Bt = theta_B.shape[0]
    dtype, device = theta_B.dtype, theta_B.device
    RS, RT = max(len(problem.stage_rows), 1), max(len(problem.term_rows), 1)
    prm = torch.as_tensor(problem.prm, dtype=dtype, device=device)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    out = (empty(Bt, N + 1, nx), empty(Bt, N, nu), empty(Bt, N, nx),
           empty(Bt, RS), empty(Bt, RS), empty(Bt, RT), empty(Bt, RT),
           empty(Bt), empty(Bt), empty(Bt), empty(Bt, dt=torch.int32),
           empty(Bt, dt=torch.bool), empty(Bt, dt=torch.bool))
    rc = fn(*[t.data_ptr() for t in (theta_B, x0_B, X_B, U_B, prm)], float(mu0),
            *[t.data_ptr() for t in out], Bt, *stream)
    if rc != 0:
        raise RuntimeError(f"whole_ip kernel launch failed: cudaError {rc}")
    return out


def _assemble(problem: EmittedProblem, dims, raw) -> OCPSolution:
    """The kernel's outputs as an OCPSolution: the active rows scattered into
    the full (N, 2nu+2nx) and (2nx,) slack/dual layout, masked rows at 1.0
    (hilo_mpc_tpu/ops/pallas_ip.py:864-895)."""
    X, U, lam, s_r, z_r, sN_r, zN_r, mu, kkt, obj, it, conv, div = raw
    nx, nu, N = dims.nx, dims.nu, dims.N
    Bt = X.shape[0]
    kw = dict(dtype=X.dtype, device=X.device)
    s = torch.ones(Bt, N, 2 * nu + 2 * nx, **kw)
    z = torch.ones_like(s)
    sN = torch.ones(Bt, 2 * nx, **kw)
    zN = torch.ones_like(sN)
    if problem.stage_rows:
        k_idx, c_idx = (torch.as_tensor(v, device=X.device)
                        for v in zip(*problem.stage_rows))
        R = len(problem.stage_rows)
        s[:, k_idx, c_idx] = s_r[:, :R]
        z[:, k_idx, c_idx] = z_r[:, :R]
    if problem.term_rows:
        t_idx = torch.as_tensor(problem.term_rows, device=X.device)
        R = len(problem.term_rows)
        sN[:, t_idx] = sN_r[:, :R]
        zN[:, t_idx] = zN_r[:, :R]
    status = torch.where(conv, 0, torch.where(div, 2, 1)).to(torch.int32)
    return OCPSolution(X=X, U=U, lam=lam, s=s, z=z, sN=sN, zN=zN, mu=mu,
                       kkt_error=kkt, objective=obj, iterations=it,
                       converged=conv, status=status)


def whole_ip_launch(problem: EmittedProblem, dims, theta_B, x0_B, X_B, U_B, mu0):
    """The bare launch behind ``solve_ocp_full_cuda``: inputs already checked,
    problem emitted; returns the raw outputs (active rows not scattered). Not
    counted; ``chip_smoke.py`` times the kernel alone through it."""
    lib = _build.load_source(problem.text)
    fn = _bind(lib.whole_ip_f32 if theta_B.dtype == torch.float32
               else lib.whole_ip_f64, stream=True)
    with torch.cuda.device(theta_B.device):
        stream = torch.cuda.current_stream(theta_B.device).cuda_stream
        return _run(fn, problem, dims, theta_B, x0_B, X_B, U_B, mu0, stream)


def solve_ocp_full_cuda(funcs, dims, bounds, theta_B, x0_B, X_B, U_B,
                        options: IPOptions = IPOptions()) -> OCPSolution:
    """Batched whole-solve interior point as ONE CUDA kernel
    (csrc/whole_ip.cuh with the problem's generated source), replacing
    ``hilo_mpc_tpu/ops/pallas_ip.py:solve_ocp_pallas_full``.

    Inputs: theta_B (B,N+1,nt), x0_B (B,nx), X_B (B,N+1,nx), U_B (B,N,nu);
    float32 or float64, one dtype, contiguous, one CUDA device; bounds shared
    by the batch; the initial barrier is ``options.mu_init``. Returns a
    batched OCPSolution (leading dim B) with the slacks and duals in the full
    row layout. The problem must pass ``whole_ip_supported`` and ``funcs``
    carry its source (``NMPC.setup`` attaches it). Launches on the current
    stream without synchronizing; the first call for a problem builds it
    (seconds, cached by the generated text)."""
    args = (theta_B, x0_B, X_B, U_B)
    if not any(t.is_cuda for t in args):
        return solve_ocp_full_reference(funcs, dims, bounds, *args, options)
    _check(dims, *args)
    model = funcs.source.model if funcs.source is not None else None
    if not whole_ip_supported(dims, bounds, options, True, model):
        raise ValueError("this problem is not eligible for the whole-solve kernel "
                         "(ops/whole_ip.py:whole_ip_supported)")
    problem = whole_ip_problem(funcs, dims, bounds, theta_B.shape[2], options)
    raw = whole_ip_launch(problem, dims, *args, options.mu_init)
    solve_ocp_full_cuda.launches += 1
    return _assemble(problem, dims, raw)


solve_ocp_full_cuda.launches = 0


def solve_ocp_full_host(funcs, dims, bounds, theta_B, x0_B, X_B, U_B,
                        options: IPOptions = IPOptions()) -> OCPSolution:
    """The kernel's own per-scenario solve, compiled with the host C++
    compiler, on CPU tensors (float32 or float64): the same code the card
    runs, in a loop over the batch. Same arguments and return as
    ``solve_ocp_full_cuda``."""
    _check(dims, theta_B, x0_B, X_B, U_B)
    problem = whole_ip_problem(funcs, dims, bounds, theta_B.shape[2], options)
    lib = _build.load_host(problem.text)
    fn = _bind(lib.whole_ip_host_f32 if theta_B.dtype == torch.float32
               else lib.whole_ip_host_f64, stream=False)
    raw = _run(fn, problem, dims, theta_B, x0_B, X_B, U_B, options.mu_init)
    return _assemble(problem, dims, raw)


def dyn_lin_host(funcs, dims, bounds, xs, us, th):
    """F and [A | B] of the emitted step by its dual-number pass, compiled
    for the host: xs (R, nx), us (R, nu), th (R, n_theta) float64 CPU
    tensors -> (F (R, nx), AB (R, nx, nx+nu))."""
    problem = whole_ip_problem(funcs, dims, bounds, th.shape[1], IPOptions())
    fn = _build.load_host(problem.text).dyn_lin_host_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
        fn.restype = ctypes.c_int
    xs, us, th = (t.to(torch.float64).contiguous() for t in (xs, us, th))
    prm = torch.as_tensor(problem.prm, dtype=torch.float64)
    R, nx, nu = xs.shape[0], dims.nx, dims.nu
    F = torch.empty(R, nx, dtype=torch.float64)
    AB = torch.empty(R, nx, nx + nu, dtype=torch.float64)
    fn(xs.data_ptr(), us.data_ptr(), th.data_ptr(), prm.data_ptr(),
       F.data_ptr(), AB.data_ptr(), R)
    return F, AB
