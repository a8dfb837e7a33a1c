"""The whole-solve interior point as one CUDA kernel.

Counterpart of ``hilo_mpc_tpu/ops/pallas_ip.py``: ``solve_ocp_full_cuda``
replaces ``solve_ocp_pallas_full`` (line 143), whose ``pallas_call`` (line
842) runs the entire box-constrained pure-Newton interior point, dynamics
linearization included, in one kernel. Here the problem (model, integrator,
cost, active box rows) is written as C++: by ops/codegen_cuda.py for a
model in the equation DSL or by state-space matrices with quadratic terms
and soft state bounds, and otherwise (a callable model, a generic cost, a
measurement term, a soft generic constraint, a path-following reference)
by ops/codegen_fx.py from a ``torch.fx`` trace of the problem functions. It
is compiled together with the solver template csrc/whole_ip.cuh by ``nvcc``
at its first use (ops/_build.py, cached by the text's hash under
``_build/gen/``), and one launch solves every scenario of the batch, one
thread per scenario, until each has converged, diverged or reached
``max_iter``. ``whole_ip_gate`` is the gate (``pallas_full_supported`` and
an emission: no free final time, a Newton of at most ``NEWTON_MAX``
unknowns in an implicit step, no op outside the trace's table);
``NMPC.solve_batch_fn`` reads
``pallas_full`` and takes this path for eligible problems, through a
``WholeIPLaunch`` it prepares once per controller, dtype and device.

The plain version, ``solve_ocp_full_reference``, is the port's ``solve_ocp``
with the kernel's options and the plain LQ sweeps, the counterpart of what
``tests/test_pallas_ip.py`` holds the JAX kernel against. The wrapper takes it
for CPU tensors and only for them. ``solve_ocp_full_host`` runs the kernel's
own per-scenario code, compiled for the host, on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .codegen_cuda import WIP_TB, EmittedProblem, emit_problem
from .ip_solver import IPOptions, OCPSolution, solve_ocp
from .riccati import make_plain_lq_solver


def _options_decline(dims, bounds, options: IPOptions, fix_x0: bool) -> Optional[str]:
    """Why ``hilo_mpc_tpu/ops/pallas_ip.py:pallas_full_supported`` declines
    this problem, or None: hard generic or equality rows, a free x0, other
    than pure Newton steps, iterate recording or parallel Riccati, pinned
    controls."""
    if dims.n_h or dims.n_hN:
        return "hard generic inequality rows"
    if dims.n_e or dims.n_eN:
        return "equality rows"
    if not fix_x0:
        return "a free initial state"
    if options.mehrotra:
        return "Mehrotra steps (mehrotra)"
    if options.convexify:
        return "convexified Hessians (convexify)"
    if options.n_linesearch > 1:
        return "a line search of more than one candidate (n_linesearch)"
    if options.record_iterates or options.parallel_riccati:
        return "record_iterates or parallel_riccati"
    lbu = bounds.lbu.detach().cpu().double().numpy()
    ubu = bounds.ubu.detach().cpu().double().numpy()
    if (np.isfinite(lbu) & np.isfinite(ubu) & (ubu - lbu < 1e-9)).any():
        return "pinned controls (lbu = ubu)"
    return None


def whole_ip_gate(funcs, dims, bounds, options: IPOptions, fix_x0: bool,
                  n_theta: Optional[int] = None):
    """(the emitted problem, None) if the whole-solve kernel takes this
    problem, else (None, why). What neither emitter can write is checked
    first (``OCPSource.cost_error``), then the conditions of
    ``pallas_full_supported``, then the emission itself, DSL or traced
    (ops/codegen_cuda.py:emit_problem), for ``n_theta`` (default: the
    problem's own theta width); a refused op, a branch on a value in the
    trace or a step's Newton above ``NEWTON_MAX`` unknowns is named in
    ``why``. Nothing is compiled."""
    src = funcs.source
    if src is None:
        return None, "no problem source (OCPFunctions.source, which NMPC.setup attaches)"
    if src.cost_error is not None:
        return None, src.cost_error
    why = _options_decline(dims, bounds, options, fix_x0)
    if why is not None:
        return None, why
    try:
        return whole_ip_problem(funcs, dims, bounds, n_theta or src.n_theta,
                                options), None
    except NotImplementedError as e:
        return None, str(e)


def whole_ip_problem(funcs, dims, bounds, n_theta: int,
                     options: IPOptions) -> EmittedProblem:
    """The problem as C++ and its numbers (ops/codegen_cuda.py, or the trace
    of ops/codegen_fx.py)."""
    if funcs.source is None:
        raise NotImplementedError(
            "the whole-solve kernel needs the problem's source "
            "(OCPFunctions.source, which NMPC.setup attaches)")
    bnd = tuple(b.detach().cpu().double().numpy() for b in bounds)
    return emit_problem(funcs.source, dims, bnd, n_theta, options, funcs)


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


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_double] + [ctypes.c_void_p] * 14 \
    + [ctypes.c_int]


class WholeIPLaunch:
    """The whole-solve launch of one emitted problem for one dtype and
    device, prepared once: the built and bound entry point (nvcc on a CUDA
    device, the host C++ compiler on the CPU) and ``prm`` on the device.
    Each call then allocates the outputs and the kernel's scratch and makes
    one ctypes call. ``NMPC`` keeps one per controller, dtype and device;
    ``solve_ocp_full_cuda`` builds one per call."""

    def __init__(self, problem: EmittedProblem, dims, dtype, device):
        self.problem, self.dims = problem, dims
        self.dtype, self.device = dtype, torch.device(device)
        self.host = self.device.type == "cpu"
        self.prm = torch.as_tensor(problem.prm, dtype=dtype, device=self.device)
        nx, nu, N = dims.nx, dims.nu, dims.N
        M = 2 * nu + 2 * nx
        # the float outputs per scenario, in one allocation: X, U, lam, s, z
        # (the full row layout, which the kernel writes), sN, zN, mu, kkt,
        # objective
        self.shapes = ((N + 1, nx), (N, nu), (N, nx), (N, M), (N, M), (2 * nx,),
                       (2 * nx,), (), (), ())
        self.sizes = [int(np.prod(shape)) for shape in self.shapes]
        self._fn = None

    def entry(self):
        """The entry point, built and bound at its first use."""
        if self._fn is None:
            suffix = "f32" if self.dtype == torch.float32 else "f64"
            if self.host:
                fn = getattr(_build.load_host(self.problem.text), f"whole_ip_host_{suffix}")
            else:
                fn = getattr(_build.load_source(self.problem.text), f"whole_ip_{suffix}")
            fn.argtypes = _ARGTYPES + ([] if self.host else [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, theta_B, x0_B, X_B, U_B, mu0):
        """One launch on checked inputs; returns the OCPSolution, the slacks
        and duals in the full (N, 2nu+2nx) and (2nx,) row layout with the
        masked rows at 1.0 (hilo_mpc_tpu/ops/pallas_ip.py:864-895), as the
        kernel writes them. Not counted; ``chip_smoke.py`` times the kernel
        alone through it."""
        fn = self.entry()
        Bt = theta_B.shape[0]
        kw = dict(dtype=self.dtype, device=self.device)
        flat = torch.empty(Bt * sum(self.sizes), **kw)
        outs = [t.view(Bt, *shape) for t, shape in
                zip(flat.split([Bt * n for n in self.sizes]), self.shapes)]
        ints = torch.empty((2, Bt), dtype=torch.int32, device=self.device)
        conv = torch.empty(Bt, dtype=torch.bool, device=self.device)
        # the tiles' state regions (csrc/whole_ip.cuh:WipLay)
        scratch = torch.empty(-(-Bt // WIP_TB) * WIP_TB * self.problem.region, **kw)
        sol = OCPSolution(*outs, iterations=ints[0], converged=conv, status=ints[1])
        args = [t.data_ptr() for t in (theta_B, x0_B, X_B, U_B, self.prm)]
        ptrs = [t.data_ptr() for t in sol]
        if self.host:
            rc = fn(*args, float(mu0), *ptrs, scratch.data_ptr(), Bt)
        else:
            with torch.cuda.device(self.device):
                rc = fn(*args, float(mu0), *ptrs, scratch.data_ptr(), Bt,
                        torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"whole_ip kernel launch failed: cudaError {rc}")
        return sol

    def __call__(self, theta_B, x0_B, X_B, U_B, mu0) -> OCPSolution:
        """Check the inputs and launch once (counted on the card by
        ``solve_ocp_full_cuda.launches``)."""
        _check(self.dims, theta_B, x0_B, X_B, U_B)
        if theta_B.dtype != self.dtype or theta_B.device != self.device:
            raise ValueError(f"this launch was prepared for {self.dtype} on "
                             f"{self.device}, got {theta_B.dtype} on {theta_B.device}")
        sol = self.launch(theta_B, x0_B, X_B, U_B, mu0)
        if not self.host:
            solve_ocp_full_cuda.launches += 1
        return sol


def solve_ocp_full_cuda(funcs, dims, bounds, theta_B, x0_B, X_B, U_B,
                        options: IPOptions = IPOptions()) -> OCPSolution:
    """Batched whole-solve interior point as ONE CUDA kernel
    (csrc/whole_ip.cuh with the problem's generated source), replacing
    ``hilo_mpc_tpu/ops/pallas_ip.py:solve_ocp_pallas_full``.

    Inputs: theta_B (B,N+1,nt), x0_B (B,nx), X_B (B,N+1,nx), U_B (B,N,nu);
    float32 or float64, one dtype, contiguous, one CUDA device; bounds shared
    by the batch; the initial barrier is ``options.mu_init``. Returns a
    batched OCPSolution (leading dim B) with the slacks and duals in the full
    row layout. The problem must pass ``whole_ip_gate`` and ``funcs``
    carry its source (``NMPC.setup`` attaches it). Launches on the current
    stream without synchronizing; the first call for a problem builds it
    (seconds, cached by the generated text). Each call gates, emits and
    prepares the launch anew; ``NMPC`` prepares it once per controller."""
    args = (theta_B, x0_B, X_B, U_B)
    if not any(t.is_cuda for t in args):
        return solve_ocp_full_reference(funcs, dims, bounds, *args, options)
    _check(dims, *args)
    problem, why = whole_ip_gate(funcs, dims, bounds, options, True, theta_B.shape[2])
    if problem is None:
        raise ValueError(f"this problem is not eligible for the whole-solve kernel: "
                         f"{why} (ops/whole_ip.py:whole_ip_gate)")
    return WholeIPLaunch(problem, dims, theta_B.dtype, theta_B.device)(
        *args, options.mu_init)


solve_ocp_full_cuda.launches = 0


def solve_ocp_full_host(funcs, dims, bounds, theta_B, x0_B, X_B, U_B,
                        options: IPOptions = IPOptions()) -> OCPSolution:
    """The kernel's own block schedule, compiled with the host C++ compiler,
    on CPU tensors (float32 or float64): the same code the card runs, tile
    by tile with the threads in a loop. Same arguments and return as
    ``solve_ocp_full_cuda``."""
    _check(dims, theta_B, x0_B, X_B, U_B)
    if theta_B.device.type != "cpu":
        raise ValueError(f"solve_ocp_full_host takes CPU tensors, got {theta_B.device}")
    problem = whole_ip_problem(funcs, dims, bounds, theta_B.shape[2], options)
    return WholeIPLaunch(problem, dims, theta_B.dtype, "cpu")(
        theta_B, x0_B, X_B, U_B, options.mu_init)


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


def cost_derivs_host(funcs, dims, bounds, xs, us, th):
    """The stage and terminal costs' gradients and Hessians as the emitted
    problem computes them, compiled for the host: xs (R, nx), us (R, nu),
    th (R, n_theta) float64 CPU tensors -> (g (R, nx+nu), H (R, nx+nu,
    nx+nu), gN (R, nx), HN (R, nx, nx)) over the solver-scaled variables
    (the x-u block is zero where the problem has no CROSS)."""
    problem = whole_ip_problem(funcs, dims, bounds, th.shape[1], IPOptions())
    fn = _build.load_host(problem.text).cost_derivs_host_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
        fn.restype = ctypes.c_int
    xs, us, th = (t.to(torch.float64).contiguous() for t in (xs, us, th))
    prm = torch.as_tensor(problem.prm, dtype=torch.float64)
    R, nx, D = xs.shape[0], dims.nx, dims.nx + dims.nu
    out = [torch.empty(shape, dtype=torch.float64)
           for shape in ((R, D), (R, D, D), (R, nx), (R, nx, nx))]
    fn(xs.data_ptr(), us.data_ptr(), th.data_ptr(), prm.data_ptr(),
       *[t.data_ptr() for t in out], R)
    return tuple(out)
