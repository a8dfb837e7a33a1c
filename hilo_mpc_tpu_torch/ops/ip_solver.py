"""Stagewise nonlinear primal-dual interior-point solver for optimal control.

PyTorch port of ``hilo_mpc_tpu/ops/ip_solver.py``. The multiple-shooting
structure is kept stagewise: each IP iteration linearizes dynamics and costs
along the horizon, condenses the barrier terms into the stage Hessians and
solves the block-banded KKT system with a Riccati sweep — on CUDA tensors
always the hand-written kernel ``ops/cuda_kernels.py:riccati_lq_cuda``
(ops/riccati.py:make_lq_solver), one launch per Newton step, a free initial
state included (the kernel's free-x0 mode solves for dx_0 itself).

Batch-first instead of ``vmap``: every array carries a leading scenario axis B
(theta (B, N+1, n_theta), x0 (B, nx), X (B, N+1, nx), U (B, N, nu)); scalars of
the JAX solver (mu, the merit penalty, KKT error, iteration count, flags) are
(B,) tensors. Derivatives come from ``torch.func``: Jacobians as ``jvp`` pushed
along the nx+nu basis tangents under ``vmap`` (the counterpart of
``jax.linearize`` + ``vmap(jvp)``), gradients as ``grad`` of the batch sum
(scenarios and stages are independent), Hessians as ``jvp`` of that gradient.
The iteration loop is a Python loop with per-scenario convergence masks:
finished scenarios are frozen exactly as the JAX ``while_loop`` freezes them,
and with ``early_exit`` the loop stops once every scenario is finished (one
host synchronization per iteration).

Problem form (per scenario):

    min   Σ_{k=0}^{N-1} l(x_k, u_k, θ_k)  +  lN(x_N, θ_N)
    s.t.  x_{k+1} = F(x_k, u_k, θ_k)                    k = 0..N-1
          lbu ≤ u_k ≤ ubu,  lbx ≤ x_k ≤ ubx             (±inf allowed)
          h(x_k, u_k, θ_k) ≤ 0,   hN(x_N, θ_N) ≤ 0
          e(x_k, u_k, θ_k) = 0,   eN(x_N, θ_N) = 0
          x_0 = x̂  (fix_x0=True)  or  x_0 free (MHE arrival)

The generic rows h, hN follow the box rows, always valid; their Jacobians
(B, N, n_h, nx|nu) come by ``_jacobian`` each iteration and enter the
condensation as terms of their own beside the box rows' constant selectors,
so a problem without them runs no extra operation. Equalities enter through
an augmented Lagrangian on the costs, with multipliers Y, yN and penalty rho
per scenario, updated at barrier-subproblem solves (the LANCELOT rule).

Every option of the JAX IPOptions is taken. ``record_iterates`` keeps a
per-iteration history and makes ``solve_ocp`` return ``(solution, history)``
as the JAX solver does. ``parallel_riccati`` solves each LQ step by the
log-depth scans of ``ops/riccati.py:solve_lq_parallel``, plain batched
PyTorch: the caller asked for that solver, so on CUDA tensors those steps
launch no Riccati kernel, just as the JAX solver bypasses its Pallas kernel
under the option. ``lin_storage_dtype`` (float32 only) rounds the
linearization's Jacobian and Hessian blocks to that dtype and promotes them
back at once, so the Riccati kernel still receives float32; float64 ignores
it. The JAX solver keeps the blocks in bf16 to cut its memory traffic; here
the option only reproduces that rounding and saves no memory or traffic. As in the JAX package,
``solve_ocp`` ignores ``pallas_full``: only ``NMPC.solve_batch_fn`` reads it
and routes eligible problems to the whole-solve kernel (ops/whole_ip.py).
``riccati_unroll``, ``pallas_riccati``, ``pallas_pack``, ``pallas_tile``,
``pallas_full_pack`` and ``pallas_vmem_mb`` are TPU layout knobs: accepted,
and without effect here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, jvp, vmap

from .riccati import make_lq_solver, solve_lq_parallel


class OCPFunctions(NamedTuple):
    """Batch-first problem functions: x (..., nx), u (..., nu), theta (..., n_theta)."""
    dyn: Callable                    # F(x, u, theta) -> (..., nx)
    stage_cost: Callable             # l(x, u, theta) -> (...)
    term_cost: Callable              # lN(x, thetaN) -> (...)
    stage_ineq: Optional[Callable] = None
    term_ineq: Optional[Callable] = None
    stage_eq: Optional[Callable] = None
    term_eq: Optional[Callable] = None
    # the problem as ops/codegen_cuda.py emits it for the whole-solve kernel
    # (an OCPSource; NMPC.setup attaches it)
    source: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class OCPDims:
    nx: int
    nu: int
    N: int
    n_h: int = 0
    n_hN: int = 0
    n_e: int = 0
    n_eN: int = 0


class OCPBounds(NamedTuple):
    """±inf-padded box bounds. Shapes: lbx/ubx (N+1, nx), shared by every
    scenario; lbu/ubu (N, nu), shared, or (B, N, nu), one set per scenario
    (the candidates of a mixed-integer step pin different inputs)."""
    lbx: torch.Tensor
    ubx: torch.Tensor
    lbu: torch.Tensor
    ubu: torch.Tensor


def default_bounds(dims: OCPDims, dtype=torch.float32, device="cuda") -> OCPBounds:
    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    inf = float("inf")
    return OCPBounds(lbx=full((dims.N + 1, dims.nx), -inf),
                     ubx=full((dims.N + 1, dims.nx), inf),
                     lbu=full((dims.N, dims.nu), -inf),
                     ubu=full((dims.N, dims.nu), inf))


@dataclasses.dataclass(frozen=True)
class IPOptions:
    """Same fields and defaults as the JAX package's IPOptions."""
    max_iter: int = 40
    tol: float = 1e-6
    mu_init: float = 1e-1
    mu_min: float = 1e-9
    kappa_mu: float = 0.2        # linear mu reduction factor
    theta_mu: float = 1.5        # superlinear mu reduction exponent
    kappa_eps: float = 10.0      # barrier-subproblem tolerance = kappa_eps * mu
    tau_min: float = 0.99        # fraction-to-boundary
    n_linesearch: int = 6        # backtracking candidates (halvings)
    reg: float = 1e-8            # Riccati control-Schur regularization
    convexify: bool = True       # eigenvalue-clip indefinite cost Hessians
    min_eig: float = 1e-6
    s_min: float = 1e-2          # slack floor at init (IPOPT's bound_push analogue)
    early_exit: bool = True      # stop once every scenario is finished
    rho_eq: float = 1e2
    rho_eq_max: float = 1e7
    record_iterates: bool = False
    parallel_riccati: bool = False
    pallas_riccati: bool = False  # TPU layout knob; no effect here
    pallas_pack: int = 8          # TPU layout knob; no effect here
    pallas_full: bool = False
    pallas_tile: int = 256        # TPU layout knob; no effect here
    pallas_full_pack: int = 1     # TPU layout knob; no effect here
    pallas_vmem_mb: Optional[float] = None  # TPU layout knob; no effect here
    mehrotra: bool = False       # predictor-corrector with adaptive centering
    riccati_unroll: int = 1      # TPU layout knob; no effect here
    # treat the cost Hessian blocks as constant (exact for quadratic costs):
    # evaluated once at the initial point instead of every iteration
    const_cost_hessian: bool = False
    lin_storage_dtype: Optional[str] = None


class OCPSolution(NamedTuple):
    X: torch.Tensor          # (B, N+1, nx)
    U: torch.Tensor          # (B, N, nu)
    lam: torch.Tensor        # (B, N, nx)
    s: torch.Tensor          # (B, N, m)
    z: torch.Tensor          # (B, N, m)
    sN: torch.Tensor         # (B, mN)
    zN: torch.Tensor         # (B, mN)
    mu: torch.Tensor         # (B,)
    kkt_error: torch.Tensor  # (B,)
    objective: torch.Tensor  # (B,)
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool
    status: torch.Tensor     # (B,) int32: 0 ok, 1 max_iter, 2 diverged/NaN


class _Carry(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    sN: torch.Tensor
    zN: torch.Tensor
    mu: torch.Tensor
    nu_pen: torch.Tensor
    kkt: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
    # the augmented Lagrangian's state, None without equality rows
    Y: Optional[torch.Tensor] = None     # (B, N, n_e) stage multipliers
    yN: Optional[torch.Tensor] = None    # (B, n_eN) terminal multipliers
    rho: Optional[torch.Tensor] = None   # (B,) penalty
    eqv: Optional[torch.Tensor] = None   # (B,) last accepted max violation


def _check_supported(funcs: OCPFunctions, dims: OCPDims, opt: IPOptions):
    if opt.lin_storage_dtype is not None and not isinstance(
            getattr(torch, str(opt.lin_storage_dtype), None), torch.dtype):
        raise ValueError(f"lin_storage_dtype {opt.lin_storage_dtype!r} is not a "
                         f"torch dtype name")
    for n, fn, what in ((dims.n_h, funcs.stage_ineq, "stage_ineq"),
                        (dims.n_hN, funcs.term_ineq, "term_ineq"),
                        (dims.n_e, funcs.stage_eq, "stage_eq"),
                        (dims.n_eN, funcs.term_eq, "term_eq")):
        if n and fn is None:
            raise ValueError(f"OCPDims counts {n} rows of {what}, but "
                             f"OCPFunctions.{what} is None")


# ---------------------------------------------------------------------------
# batch-first derivatives
# ---------------------------------------------------------------------------


def _basis_tangents(args):
    """One-hot tangents over the concatenated trailing dims of ``args``:
    a list of (n, *arg.shape) tensors, n = Σ arg.shape[-1]."""
    n = sum(a.shape[-1] for a in args)
    eye = torch.eye(n, dtype=args[0].dtype, device=args[0].device)
    out, off = [], 0
    for a in args:
        k = a.shape[-1]
        t = eye[:, off:off + k].reshape((n,) + (1,) * (a.dim() - 1) + (k,))
        out.append(t.expand((n,) + tuple(a.shape)))
        off += k
    return out


def _jacobian(f, args):
    """d f / d(args) for a batch-first f: (..., n_out, Σ n_arg)."""
    J = vmap(lambda *t: jvp(f, tuple(args), tuple(t))[1])(*_basis_tangents(args))
    return J.movedim(0, -1)


def _batch_grad(f, args):
    """Per-element gradients of a batch-first scalar-valued f, as the
    gradient of its batch sum (the elements are independent)."""
    return grad(lambda *a: f(*a).sum(), argnums=tuple(range(len(args))))(*args)


def _grad_and_hessian(f, args):
    """(gradient tuple, full Hessian (..., n, n)) with H[..., a, b] = d g_a / d v_b."""
    g = _batch_grad(f, args)
    H = _jacobian(lambda *a: torch.cat(_batch_grad(f, a), dim=-1), args)
    return g, H


# cuSOLVER's batched eigh (torch 2.11, CUDA 12.8, H100) refuses a batch of
# 32768 or more 3 x 3 matrices with CUSOLVER_STATUS_INVALID_VALUE, in float32
# and float64 alike (16384 pass), so CUDA batches go in chunks of this size
EIGH_CHUNK = 1 << 14


def _eigh(M, chunk=EIGH_CHUNK):
    """torch.linalg.eigh of (..., n, n), at most ``chunk`` matrices per call.

    A diagonal matrix (a zero Hessian block among them) is its own
    decomposition: its sorted diagonal and the permutation that sorts it.
    cuSOLVER's batched eigh (torch 2.11, CUDA 12.8, H100) has returned NaN
    for all-zero 6 x 6 float32 matrices in a process whose allocator hands
    out reused memory, and a clean one on a fresh process."""
    batch, n = M.shape[:-2], M.shape[-1]
    flat = M.reshape(-1, n, n)
    if flat.shape[0] <= chunk:
        w, V = torch.linalg.eigh(M)
    else:
        parts = [torch.linalg.eigh(c) for c in flat.split(chunk)]
        w = torch.cat([w for w, _ in parts]).reshape(*batch, n)
        V = torch.cat([V for _, V in parts]).reshape(M.shape)
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    diag = (M == torch.diag_embed(d)).all(-1).all(-1)
    wd, order = torch.sort(d, dim=-1, stable=True)
    Vd = torch.nn.functional.one_hot(order, n).transpose(-1, -2).to(M.dtype)
    return (torch.where(diag[..., None], wd, w),
            torch.where(diag[..., None, None], Vd, V))


def _convexify(M, min_eig):
    """Eigenvalue-clip symmetric matrices (..., n, n) to be positive definite."""
    M = 0.5 * (M + M.transpose(-1, -2))
    w, V = _eigh(M) if M.is_cuda else torch.linalg.eigh(M)
    w = torch.clamp(w, min=min_eig)
    return (V * w[..., None, :]) @ V.transpose(-1, -2)


def _maxabs(t):
    """Per-scenario max |t| over all trailing dims (0 for empty rows)."""
    t = t.abs().flatten(1)
    if t.shape[1] == 0:
        return torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    return t.amax(dim=1)


def _step_cap(v, dv, msk, tau=None):
    """Largest step in (0, 1] keeping v + a*dv >= (1 - tau) v on masked rows
    (tau=None: the plain ratio test of the Mehrotra predictor)."""
    num = -v if tau is None else -tau * v
    ratio = torch.where((dv < 0) & msk, num / torch.clamp(dv, max=-1e-30), 1.0)
    return torch.clamp(ratio.flatten(1).amin(dim=1), max=1.0)


# ---------------------------------------------------------------------------
# main solver
# ---------------------------------------------------------------------------


def solve_ocp(funcs: OCPFunctions, dims: OCPDims, bounds: OCPBounds,
              theta: torch.Tensor, x0: torch.Tensor, X_init: torch.Tensor,
              U_init: torch.Tensor, options: IPOptions = IPOptions(),
              fix_x0: bool = True, mu0: Optional[float] = None,
              lq_solver: Callable = make_lq_solver):
    """Solve B OCP instances at once (batch-first, see the module docstring).
    Returns an ``OCPSolution``; with ``options.record_iterates`` the pair
    ``(OCPSolution, history)``, history a dict of the iterates before each
    iteration's update, zero past each scenario's last iteration:
    X (B, max_iter, N+1, nx), U (B, max_iter, N, nu), kkt, mu, objective
    (B, max_iter) and n (B,), the scenario's iteration count.

    ``mu0`` optionally overrides ``options.mu_init`` at call time: cold- and
    warm-start solves differ only in the initial barrier. ``lq_solver(reg)``
    builds the LQ step of every iteration: ``make_lq_solver`` (the default:
    a hand-written CUDA kernel on CUDA tensors) or
    ``ops/riccati.py:make_plain_lq_solver`` (the plain sweeps on any
    device); ``options.parallel_riccati`` replaces it by
    ``solve_lq_parallel``. ``fix_x0=False`` frees x_0 (``x0`` is then unused: X_init[:, 0]
    is its start, as in the JAX solver): its bound rows stay, its
    stationarity row joins the KKT test and each LQ step gets dx0=None."""
    return _run(funcs, dims, bounds, theta, x0, X_init, U_init, options, fix_x0,
                mu0, lq_solver, None)


def solve_ocp_carry(funcs: OCPFunctions, dims: OCPDims, bounds: OCPBounds,
                    theta: torch.Tensor, x0: torch.Tensor, X_init: torch.Tensor,
                    U_init: torch.Tensor, options: IPOptions = IPOptions(),
                    fix_x0: bool = True, carry: Optional[tuple] = None,
                    steps: int = 0, finish: bool = False):
    """``solve_ocp`` in pieces, for captured graphs (utils/aot.py): from
    ``carry`` (the solver state's tensors as this function returns them;
    None: the cold start of ``solve_ocp``), run ``steps`` iterations, the
    finished scenarios frozen as in ``solve_ocp``, and return the state's
    tensors, or with ``finish`` the ``OCPSolution``. The cold start, then
    ``max_iter`` single steps, then ``finish`` give the X and U of
    ``solve_ocp``, without its early exit (``options.early_exit`` and
    ``record_iterates`` are not read)."""
    return _run(funcs, dims, bounds, theta, x0, X_init, U_init, options, fix_x0,
                None, make_lq_solver, (carry, steps, finish))


def _run(funcs, dims, bounds, theta, x0, X_init, U_init, options, fix_x0, mu0,
         lq_solver, resume):
    _check_supported(funcs, dims, options)
    if (bounds.lbx.dim() != 2 or bounds.ubx.dim() != 2 or bounds.lbu.dim() not in (2, 3)
            or bounds.ubu.shape != bounds.lbu.shape
            or (bounds.lbu.dim() == 3 and bounds.lbu.shape[0] != X_init.shape[0])):
        raise ValueError("lbx/ubx are shared by all scenarios, (N+1, nx); lbu/ubu "
                         "are (N, nu), or (B, N, nu) with one set per scenario")
    # the Riccati/Newton arithmetic needs full float32 products: the JAX
    # solver measured batch convergence falling to 12% with reduced-precision
    # matmuls, so TF32 is off for every product the solver issues, and the
    # caller's settings come back after it (the reference scopes "highest"
    # precision to the solve, hilo_mpc_tpu/ops/ip_solver.py:250-255)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _solve_ocp_impl(funcs, dims, bounds, theta, x0, X_init, U_init,
                               options, fix_x0, mu0, lq_solver, resume)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _solve_ocp_impl(funcs, dims, bounds, theta, x0, X_init, U_init, opt,
                    fix_x0, mu0_dyn, make_lq, resume) -> OCPSolution:
    nx, nu, N = dims.nx, dims.nu, dims.N
    n_h, n_hN = dims.n_h, dims.n_hN
    m_box, mN_box = 2 * nu + 2 * nx, 2 * nx
    m = m_box + n_h
    mN = mN_box + n_hN
    dtype, device = X_init.dtype, X_init.device
    Bn = X_init.shape[0]
    kw = dict(dtype=dtype, device=device)
    # equality rows enter through augmented-Lagrangian terms on the costs
    has_eq, has_eqN = dims.n_e > 0, dims.n_eN > 0
    has_al = has_eq or has_eqN

    def safe_b(b):
        return torch.clamp(torch.nan_to_num(b, posinf=1e20, neginf=-1e20),
                           -1e20, 1e20)

    lbx_c, ubx_c = safe_b(bounds.lbx[:-1]), safe_b(bounds.ubx[:-1])
    lbu_c, ubu_c = safe_b(bounds.lbu), safe_b(bounds.ubu)
    lbxN_c, ubxN_c = safe_b(bounds.lbx[-1]), safe_b(bounds.ubx[-1])

    # pinned (equality-bounded) controls: removed from the barrier, held by a
    # stiff quadratic in the Riccati blocks and excluded from the stationarity
    # test; with input bounds per scenario the pins, and the stage masks below,
    # are per scenario too: (B, N, ·) in place of (N, ·)
    per_scenario = bounds.lbu.dim() == 3
    pin = (torch.isfinite(bounds.ubu) & torch.isfinite(bounds.lbu)
           & (bounds.ubu - bounds.lbu < 1e-9))
    pin_f = pin.to(dtype)
    free_u_f = 1.0 - pin_f
    pin_val = 0.5 * (lbu_c + ubu_c) * pin_f
    w_pin = 1e7 if dtype == torch.float64 else 1e5

    # validity masks of the rows [u-ubu; lbu-u; x-ubx; lbx-x; h] (stage) and
    # [x-ubx; lbx-x; hN] (terminal); a fixed x_0 is not a decision variable,
    # so its bound rows are meaningless; the generic rows are always valid
    m_x = torch.isfinite(bounds.ubx[:-1]).clone()
    m_lx = torch.isfinite(bounds.lbx[:-1]).clone()
    if fix_x0:
        m_x[0] = False
        m_lx[0] = False
    shared = [m_x, m_lx] + ([torch.ones(N, n_h, dtype=torch.bool, device=device)]
                            if n_h else [])
    if per_scenario:
        shared = [m.expand((Bn,) + tuple(m.shape)) for m in shared]
    mask = torch.cat([torch.isfinite(bounds.ubu) & ~pin,
                      torch.isfinite(bounds.lbu) & ~pin] + shared, dim=-1)
    maskN = torch.cat([torch.isfinite(bounds.ubx[-1]), torch.isfinite(bounds.lbx[-1])]
                      + ([torch.ones(n_hN, dtype=torch.bool, device=device)]
                         if n_hN else []))
    mask_f = mask.to(dtype)
    maskN_f = maskN.to(dtype)

    # the box rows have constant ±selector jacobians; masked rows are zeroed.
    # They meet only vectors that are zero on masked rows (sigma, the
    # multipliers) or results masked afterwards (the slack step), so with
    # per-scenario masks a row valid in any scenario keeps its selector
    mask_C = (mask.any(dim=0) if per_scenario else mask).to(dtype)
    eye_x = torch.eye(nx, **kw)
    eye_u = torch.eye(nu, **kw)
    Cx = (torch.cat([torch.zeros(2 * nu, nx, **kw), eye_x, -eye_x])
          * mask_C[:, :m_box, None])
    Cu = (torch.cat([eye_u, -eye_u, torch.zeros(2 * nx, nu, **kw)])
          * mask_C[:, :m_box, None])
    CxN = torch.cat([eye_x, -eye_x]) * maskN_f[:mN_box, None]

    th_s, th_N = theta[:, :-1], theta[:, -1]

    def stage_c(X, U, th):
        Xs = X[..., :-1, :]
        rows = [U - ubu_c, lbu_c - U, Xs - ubx_c, lbx_c - Xs]
        if n_h:
            rows.append(funcs.stage_ineq(Xs, U, th[..., :-1, :]))
        return torch.where(mask, torch.cat(rows, dim=-1), -1.0)

    def term_c(X, th):
        xN = X[..., -1, :]
        rows = [xN - ubxN_c, lbxN_c - xN]
        if n_hN:
            rows.append(funcs.term_ineq(xN, th[..., -1, :]))
        return torch.where(maskN, torch.cat(rows, dim=-1), -1.0)

    def box_h(t, n_box):
        """(box rows, generic rows) of a row tensor (..., n_box + n)."""
        return t[..., :n_box], t[..., n_box:]

    def objective(X, U, th):
        stage = funcs.stage_cost(X[..., :-1, :], U, th[..., :-1, :])
        return stage.sum(dim=-1) + funcs.term_cost(X[..., -1, :], th[..., -1, :])

    def dyn_defect(X, U, th):
        return funcs.dyn(X[..., :-1, :], U, th[..., :-1, :]) - X[..., 1:, :]

    # the costs with the augmented-Lagrangian terms of the equality rows
    def stage_cost_aug(xx, uu, al):
        c = funcs.stage_cost(xx, uu, th_s)
        if has_eq:
            Y, rho = al[0], al[2]
            h = funcs.stage_eq(xx, uu, th_s)
            c = c + (Y * h).sum(dim=-1) + 0.5 * rho[:, None] * (h * h).sum(dim=-1)
        return c

    def term_cost_aug(xx, al):
        c = funcs.term_cost(xx, th_N)
        if has_eqN:
            yN, rho = al[1], al[2]
            h = funcs.term_eq(xx, th_N)
            c = c + (yN * h).sum(dim=-1) + 0.5 * rho * (h * h).sum(dim=-1)
        return c

    def eq_rows(X, U, th):
        """(stage equality rows (..., N, n_e) or None, terminal (..., n_eN) or None)."""
        h = funcs.stage_eq(X[..., :-1, :], U, th[..., :-1, :]) if has_eq else None
        hN = funcs.term_eq(X[..., -1, :], th[..., -1, :]) if has_eqN else None
        return h, hN

    def cost_terms(Xs, U, al):
        """Stage gradients and (optionally convexified) Hessian blocks."""
        (gx, gu), H = _grad_and_hessian(lambda xx, uu: stage_cost_aug(xx, uu, al),
                                        (Xs, U))
        if opt.convexify:
            H = _convexify(H, opt.min_eig)
        return gx, gu, H[..., :nx, :nx], H[..., nx:, :nx], H[..., nx:, nx:]

    def term_terms(xN, al):
        (g,), H = _grad_and_hessian(lambda xx: term_cost_aug(xx, al), (xN,))
        if opt.convexify:
            H = _convexify(H, opt.min_eig)
        return g, H

    # -- init ---------------------------------------------------------------
    X = X_init.clone()
    if fix_x0:
        X[:, 0] = x0
    U = torch.where(pin, pin_val, U_init)
    mu0 = torch.full((Bn,), opt.mu_init if mu0_dyn is None else float(mu0_dyn), **kw)
    # |c| (not -c): a constraint VIOLATED at the initial point still gets a
    # slack at its own scale
    s = torch.clamp(stage_c(X, U, theta).abs(), min=opt.s_min)
    sN = torch.clamp(term_c(X, theta).abs(), min=opt.s_min)
    z = mu0[:, None, None] / s * mask_f + (1.0 - mask_f)
    zN = mu0[:, None] / sN * maskN_f + (1.0 - maskN_f)
    al0 = None
    if has_al:
        al0 = (torch.zeros(Bn, N, dims.n_e, **kw), torch.zeros(Bn, dims.n_eN, **kw),
               torch.full((Bn,), opt.rho_eq, **kw))

    # the AL terms change the Hessian with rho: never constant with equalities
    const_H = opt.const_cost_hessian and not has_al
    if const_H:
        # quadratic costs: Hessian blocks are point-independent — evaluate once
        # (at copies: make_fx's forward-mode derivatives refuse a view of
        # a graph input as the primal, utils/aot.py)
        _, _, Hxx_c, Hux_c, Huu_c = cost_terms(X_init[:, :-1].clone(), U_init, al0)
        _, HN_c = term_terms(X_init[:, -1].clone(), al0)

    store_dtype = (getattr(torch, opt.lin_storage_dtype)
                   if opt.lin_storage_dtype is not None and dtype == torch.float32
                   else None)

    def linearize(X, U, al):
        """One full linearization of dynamics/costs/constraints along the horizon."""
        Xs = X[:, :-1]
        f = lambda xx, uu: funcs.dyn(xx, uu, th_s)
        F = f(Xs, U)
        J = _jacobian(f, (Xs, U))
        A, Bm = J[..., :nx], J[..., nx:]
        if const_H:
            gx, gu = _batch_grad(lambda xx, uu: stage_cost_aug(xx, uu, al), (Xs, U))
            Hxx, Hux, Huu = Hxx_c, Hux_c, Huu_c
            (gN,) = _batch_grad(lambda xx: term_cost_aug(xx, al), (X[:, -1],))
            HN = HN_c
        else:
            gx, gu, Hxx, Hux, Huu = cost_terms(Xs, U, al)
            gN, HN = term_terms(X[:, -1], al)
        # the generic rows' jacobians (B, N, n_h, nx|nu) and (B, n_hN, nx)
        Hj = HjN = None
        if n_h:
            Jh = _jacobian(lambda xx, uu: funcs.stage_ineq(xx, uu, th_s), (Xs, U))
            Hj = (Jh[..., :nx], Jh[..., nx:])
        if n_hN:
            HjN = _jacobian(lambda xx: funcs.term_ineq(xx, th_N), (X[:, -1],))
        if store_dtype is not None:
            # the Jacobian and Hessian blocks are rounded to the narrow dtype
            # (values and gradients stay float32); the box rows' ±1
            # selectors are exact in it, so only the generic rows' Jacobians
            # round
            A, Bm, Hxx, Hux, Huu, HN = (t.to(store_dtype)
                                        for t in (A, Bm, Hxx, Hux, Huu, HN))
            Hj = None if Hj is None else tuple(t.to(store_dtype) for t in Hj)
            HjN = None if HjN is None else HjN.to(store_dtype)
        return (F, A, Bm, gx, gu, Hxx, Hux, Huu, gN, HN, stage_c(X, U, theta),
                term_c(X, theta), Hj, HjN)

    def promote(lin):
        """The linearization with its rounded blocks back in the solve dtype."""
        if store_dtype is None:
            return lin

        def up(t):
            if t is None:
                return None
            return tuple(up(a) for a in t) if isinstance(t, tuple) else t.to(dtype)
        return tuple(up(t) for t in lin)

    def rows_T(v, vN, Hj, HjN):
        """Cᵀv for the stage rows (x and u parts) and CNᵀvN for the terminal ones."""
        if n_h:
            vb, vh = box_h(v, m_box)
        else:
            vb = v
        tx = torch.einsum("kmi,bkm->bki", Cx, vb)
        tu = torch.einsum("kmi,bkm->bki", Cu, vb)
        if n_h:
            tx = tx + torch.einsum("bkmi,bkm->bki", Hj[0], vh)
            tu = tu + torch.einsum("bkmi,bkm->bki", Hj[1], vh)
        if n_hN:
            vNb, vNh = box_h(vN, mN_box)
            tN = (torch.einsum("mi,bm->bi", CxN, vNb)
                  + torch.einsum("bmi,bm->bi", HjN, vNh))
        else:
            tN = torch.einsum("mi,bm->bi", CxN, vN)
        return tx, tu, tN

    def kkt_errors(lin, X, lam, s, z, sN, zN, mu):
        """(err at mu=0, err at current mu) from an existing linearization."""
        F, A, Bm, gx, gu, _, _, _, gN, _, c, cN, Hj, HjN = lin
        zm = z * mask_f
        zNm = zN * maskN_f
        tx, tu, tN = rows_T(zm, zNm, Hj, HjN)
        r_x = gx + torch.einsum("bkij,bki->bkj", A, lam) + tx
        r_xN = gN - lam[:, -1] + tN
        r_u = (gu + torch.einsum("bkij,bki->bkj", Bm, lam) + tu) * free_u_f
        r_dyn = F - X[:, 1:]
        r_ineq = (c + s) * mask_f
        r_ineqN = (cN + sN) * maskN_f
        sz = s * z * mask_f
        szN = sN * zN * maskN_f
        stat_terms = [_maxabs(r_u), _maxabs(r_xN)]
        if not fix_x0:
            stat_terms.append(_maxabs(r_x[:, 0]))
        if N > 1:
            stat_terms.append(_maxabs(r_x[:, 1:] - lam[:, :-1]))
        # scale stationarity like IPOPT's s_d to tolerate large multipliers
        s_d = torch.clamp((lam.abs().sum(dim=(1, 2)) + zm.abs().sum(dim=(1, 2))
                           + zNm.abs().sum(dim=1)) / (N * nx + N * m + mN), min=1.0)
        e_stat = torch.stack(stat_terms).amax(dim=0) / s_d
        e_feas = torch.maximum(_maxabs(r_dyn), torch.maximum(_maxabs(r_ineq),
                                                             _maxabs(r_ineqN)))

        def comp_err(mu_val):
            return torch.maximum(_maxabs(sz - mu_val[:, None, None] * mask_f),
                                 _maxabs(szN - mu_val[:, None] * maskN_f)) / s_d

        base = torch.maximum(e_stat, e_feas)
        return (torch.maximum(base, comp_err(torch.zeros_like(mu))),
                torch.maximum(base, comp_err(mu)))

    def merit(X, U, s, sN, mu, nu_p, th, al):
        """l1 barrier merit; inputs may carry extra leading dims before B."""
        f = objective(X, U, th)
        if has_al:
            Y, yN, rho = al
            h, hN = eq_rows(X, U, th)
            if has_eq:
                f = (f + (Y * h).sum(dim=(-2, -1))
                     + 0.5 * rho * (h * h).sum(dim=(-2, -1)))
            if has_eqN:
                f = f + (yN * hN).sum(dim=-1) + 0.5 * rho * (hN * hN).sum(dim=-1)
        bar = -mu * ((torch.log(torch.clamp(s, min=1e-30)) * mask_f).sum(dim=(-2, -1))
                     + (torch.log(torch.clamp(sN, min=1e-30)) * maskN_f).sum(dim=-1))
        viol = (dyn_defect(X, U, th).abs().sum(dim=(-2, -1))
                + ((stage_c(X, U, th) + s) * mask_f).abs().sum(dim=(-2, -1))
                + ((term_c(X, th) + sN) * maskN_f).abs().sum(dim=-1))
        return f + bar + nu_p * viol

    if opt.parallel_riccati:
        def lq_solver(*blocks):
            return solve_lq_parallel(*blocks, reg=opt.reg)
    else:
        lq_solver = make_lq(reg=opt.reg)
    # a free x_0: the LQ solve picks dx_0 from its own stage-0 value function
    dx0 = torch.zeros(Bn, nx, **kw) if fix_x0 else None

    def iteration(cr: _Carry) -> _Carry:
        X, U, lam, s, z, sN, zN, mu, nu_p = cr[:9]
        al = (cr.Y, cr.yN, cr.rho) if has_al else None
        lin = promote(linearize(X, U, al))
        F, A, Bm, gx, gu, Hxx, Hux, Huu, gN, HN, c, cN, Hj, HjN = lin

        # convergence / barrier bookkeeping on the CURRENT iterate
        err0, err_mu = kkt_errors(lin, X, lam, s, z, sN, zN, mu)
        converged = err0 <= opt.tol
        if has_al:
            h_cur, hN_cur = eq_rows(X, U, theta)
            zero = torch.zeros(Bn, **kw)
            eq_v = torch.maximum(_maxabs(h_cur) if has_eq else zero,
                                 _maxabs(hN_cur) if has_eqN else zero)
            converged = converged & (eq_v <= opt.tol)
        subproblem_done = err_mu <= opt.kappa_eps * mu
        mu = torch.where(
            subproblem_done,
            torch.clamp(torch.minimum(opt.kappa_mu * mu, mu ** opt.theta_mu),
                        min=opt.tol / 10.0),
            mu)
        eqv_new = cr.eqv
        if has_al:
            # augmented-Lagrangian outer update at barrier-subproblem solves.
            # LANCELOT rule: a first-order multiplier step only when the
            # violation dropped enough, else escalate rho; multipliers bounded
            Y, yN, rho = al
            good = subproblem_done & (eq_v <= 0.25 * cr.eqv)
            bad_up = subproblem_done & ~good & (eq_v > opt.tol)
            y_max = 1e5
            if has_eq:
                Y = _select(good, torch.clamp(Y + rho[:, None, None] * h_cur,
                                              -y_max, y_max), Y)
            if has_eqN:
                yN = _select(good, torch.clamp(yN + rho[:, None] * hN_cur,
                                               -y_max, y_max), yN)
            rho = torch.where(bad_up, torch.clamp(rho * 10.0, max=opt.rho_eq_max), rho)
            eqv_new = torch.where(good, eq_v, cr.eqv)
            al = (Y, yN, rho)

        sigma = torch.where(mask, z / s, 0.0)
        sigmaN = torch.where(maskN, zN / sN, 0.0)
        r_ineq = (c + s) * mask_f
        r_ineqN = (cN + sN) * maskN_f

        # barrier-condensed Hessian blocks (shared by predictor and corrector)
        sg = box_h(sigma, m_box)[0] if n_h else sigma
        Qb = Hxx + torch.einsum("kmi,bkm,kmj->bkij", Cx, sg, Cx)
        Rb = (Huu + torch.einsum("kmi,bkm,kmj->bkij", Cu, sg, Cu)
              + torch.einsum("...km,mn->...kmn", w_pin * pin_f, eye_u))
        Sb = Hux + torch.einsum("kmi,bkm,kmj->bkij", Cu, sg, Cx)
        if n_h:
            Hx, Hu = Hj
            sh = box_h(sigma, m_box)[1]
            Qb = Qb + torch.einsum("bkmi,bkm,bkmj->bkij", Hx, sh, Hx)
            Rb = Rb + torch.einsum("bkmi,bkm,bkmj->bkij", Hu, sh, Hu)
            Sb = Sb + torch.einsum("bkmi,bkm,bkmj->bkij", Hu, sh, Hx)
        if n_hN:
            sNb, sNh = box_h(sigmaN, mN_box)
            P_term = (HN + torch.einsum("mi,bm,mj->bij", CxN, sNb, CxN)
                      + torch.einsum("bmi,bm,bmj->bij", HjN, sNh, HjN))
        else:
            P_term = HN + torch.einsum("mi,bm,mj->bij", CxN, sigmaN, CxN)
        r_dyn = F - X[:, 1:]

        def newton_step(mu_t, corr, corrN):
            """One barrier-Newton solve targeting complementarity mu_t with an
            optional second-order correction term (Mehrotra)."""
            mu3, mu2 = mu_t[:, None, None], mu_t[:, None]
            zh = torch.where(mask, (mu3 + z * r_ineq - corr) / s, 0.0)
            zhN = torch.where(maskN, (mu2 + zN * r_ineqN - corrN) / sN, 0.0)
            tx, tu, tN = rows_T(zh, zhN, Hj, HjN)
            qb = gx + tx
            rb = gu + tu + w_pin * pin_f * (U - pin_val)
            p_term = gN + tN
            sol = lq_solver(A, Bm, Qb, Sb, Rb, qb, rb, r_dyn, P_term, p_term, dx0)
            dC = (torch.einsum("kmi,bki->bkm", Cx, sol.dX[:, :-1])
                  + torch.einsum("kmi,bki->bkm", Cu, sol.dU))
            dCN = torch.einsum("mi,bi->bm", CxN, sol.dX[:, -1])
            if n_h:
                dC = torch.cat([dC, torch.einsum("bkmi,bki->bkm", Hj[0], sol.dX[:, :-1])
                                + torch.einsum("bkmi,bki->bkm", Hj[1], sol.dU)], dim=-1)
            if n_hN:
                dCN = torch.cat([dCN, torch.einsum("bmi,bi->bm", HjN, sol.dX[:, -1])],
                                dim=-1)
            ds_ = torch.where(mask, -r_ineq - dC, 0.0)
            dsN_ = torch.where(maskN, -r_ineqN - dCN, 0.0)
            dz_ = torch.where(mask, (mu3 - s * z - z * ds_ - corr) / s, 0.0)
            dzN_ = torch.where(maskN, (mu2 - sN * zN - zN * dsN_ - corrN) / sN, 0.0)
            return sol, ds_, dz_, dsN_, dzN_

        # Mehrotra's fast gap collapse fights the augmented-Lagrangian outer
        # loop (its multiplier updates key off the monotone barrier schedule):
        # the predictor-corrector runs only without equality rows
        if opt.mehrotra and not has_al:
            # affine predictor (target 0 complementarity)
            _, ds_a, dz_a, dsN_a, dzN_a = newton_step(torch.zeros_like(mu), 0.0, 0.0)
            a_p = torch.minimum(_step_cap(s, ds_a, mask), _step_cap(sN, dsN_a, maskN))
            a_d = torch.minimum(_step_cap(z, dz_a, mask), _step_cap(zN, dzN_a, maskN))
            # the rows of each scenario (its own pins with per-scenario bounds)
            m_tot = torch.clamp((mask_f.sum(dim=(-2, -1)) if per_scenario
                                 else mask_f.sum()) + maskN_f.sum(), min=1.0)
            gap = ((s * z * mask_f).sum(dim=(1, 2))
                   + (sN * zN * maskN_f).sum(dim=1)) / m_tot
            a_p3, a_d3 = a_p[:, None, None], a_d[:, None, None]
            a_p2, a_d2 = a_p[:, None], a_d[:, None]
            gap_aff = ((((s + a_p3 * ds_a) * (z + a_d3 * dz_a)) * mask_f).sum(dim=(1, 2))
                       + (((sN + a_p2 * dsN_a) * (zN + a_d2 * dzN_a))
                          * maskN_f).sum(dim=1)) / m_tot
            sig_m = torch.clamp((gap_aff / torch.clamp(gap, min=1e-30)) ** 3, 0.0, 1.0)
            mu = torch.clamp(sig_m * gap, min=opt.tol / 10.0)
            sol, ds, dz, dsN, dzN = newton_step(mu, ds_a * dz_a * mask_f,
                                                dsN_a * dzN_a * maskN_f)
        else:
            sol, ds, dz, dsN, dzN = newton_step(mu, 0.0, 0.0)
        dX, dU, lam_new = sol.dX, sol.dU, sol.lam

        # fraction-to-boundary
        tau = torch.clamp(1.0 - mu, min=opt.tau_min)
        a_s = torch.minimum(_step_cap(s, ds, mask, tau[:, None, None]),
                            _step_cap(sN, dsN, maskN, tau[:, None]))
        a_z = torch.minimum(_step_cap(z, dz, mask, tau[:, None, None]),
                            _step_cap(zN, dzN, maskN, tau[:, None]))

        # penalty update from new multipliers
        lam_inf = _maxabs(lam_new)
        z_inf = torch.maximum(_maxabs(z + dz), _maxabs(zN + dzN))
        nu_new = torch.maximum(nu_p, 1.5 * torch.maximum(lam_inf, z_inf) + 1.0)

        # backtracking line search on the l1 barrier merit; the candidates are
        # evaluated together along a leading candidate axis
        if opt.n_linesearch <= 1:
            alpha = a_s
        else:
            halv = 0.5 ** torch.arange(opt.n_linesearch, **kw)
            alphas = a_s[None, :] * halv[:, None]                   # (C, B)
            a4, a3 = alphas[..., None, None], alphas[..., None]
            th_c = theta.expand((opt.n_linesearch,) + tuple(theta.shape))
            phis = merit(X + a4 * dX, U + a4 * dU, s + a4 * ds, sN + a3 * dsN,
                         mu, nu_new, th_c, al)
            phi0 = merit(X, U, s, sN, mu, nu_new, theta, al)
            # accept the largest step that does not increase the merit (up to
            # roundoff); otherwise take the best trial
            ok = (phis <= phi0 + 1e-12 * (1.0 + phi0.abs())) & torch.isfinite(phis)
            first_ok = ok.to(torch.int8).argmax(dim=0)
            best = torch.where(torch.isfinite(phis), phis, float("inf")).argmin(dim=0)
            pick = torch.where(ok.any(dim=0), first_ok, best)
            alpha = alphas.gather(0, pick[None])[0]

        al3, al2 = alpha[:, None, None], alpha[:, None]
        az3, az2 = a_z[:, None, None], a_z[:, None]
        X_new = X + al3 * dX
        U_new = U + al3 * dU
        s_new = torch.clamp(torch.where(mask, s + al3 * ds, 1.0), min=1e-30)
        sN_new = torch.clamp(torch.where(maskN, sN + al2 * dsN, 1.0), min=1e-30)
        z_new = torch.clamp(torch.where(mask, z + az3 * dz, 1.0), min=1e-30)
        zN_new = torch.clamp(torch.where(maskN, zN + az2 * dzN, 1.0), min=1e-30)

        # IPOPT-style dual safeguard: keep z within kappa_Sigma of mu/s
        kap = 1e10
        mu3, mu2 = mu[:, None, None], mu[:, None]
        z_new = torch.clamp(z_new, min=mu3 / (kap * s_new), max=kap * mu3 / s_new)
        zN_new = torch.clamp(zN_new, min=mu2 / (kap * sN_new), max=kap * mu2 / sN_new)

        finite = (torch.isfinite(X_new).flatten(1).all(dim=1)
                  & torch.isfinite(U_new).flatten(1).all(dim=1)
                  & torch.isfinite(z_new).flatten(1).all(dim=1))
        bad = ~finite
        # no update when the current iterate already satisfies the KKT
        # conditions (or the step produced NaNs)
        keep = converged | bad
        new = (X_new, U_new, lam_new, s_new, z_new, sN_new, zN_new)
        old = (X, U, lam, s, z, sN, zN)
        return _Carry(*[_select(keep, a, b) for a, b in zip(old, new)],
                      mu=mu, nu_pen=nu_new, kkt=err0, it=cr.it + 1,
                      converged=converged, diverged=cr.diverged | bad,
                      **(dict(Y=al[0], yN=al[1], rho=al[2], eqv=eqv_new)
                         if has_al else {}))

    carry = _Carry(X=X, U=U, lam=torch.zeros(Bn, N, nx, **kw), s=s, z=z, sN=sN,
                   zN=zN, mu=mu0, nu_pen=torch.full((Bn,), 10.0, **kw),
                   kkt=torch.full((Bn,), float("inf"), **kw),
                   it=torch.zeros(Bn, dtype=torch.int32, device=device),
                   converged=torch.zeros(Bn, dtype=torch.bool, device=device),
                   diverged=torch.zeros(Bn, dtype=torch.bool, device=device),
                   **(dict(Y=al0[0], yN=al0[1], rho=al0[2],
                           eqv=torch.full((Bn,), float("inf"), **kw))
                      if has_al else {}))

    n_loop, record = opt.max_iter, opt.record_iterates
    if resume is not None:
        # solve_ocp_carry: the given state, a given number of steps
        vals, n_loop, finish = resume
        record = False
        if vals is not None:
            carry = _Carry(*vals)
    if record:
        # the per-iteration history ring of the JAX solver, batch-first
        hist = {"X": torch.zeros(Bn, opt.max_iter, N + 1, nx, **kw),
                "U": torch.zeros(Bn, opt.max_iter, N, nu, **kw),
                "kkt": torch.zeros(Bn, opt.max_iter, **kw),
                "mu": torch.zeros(Bn, opt.max_iter, **kw),
                "objective": torch.zeros(Bn, opt.max_iter, **kw)}

    for i in range(n_loop):
        # finished scenarios freeze themselves, as in the JAX while_loop
        done = carry.converged | carry.diverged
        if opt.early_exit and resume is None and bool(done.all()):
            break
        new = iteration(carry)
        if record:
            # a scenario still running is at its own iteration i: its
            # iterate before the update, the KKT error of that iterate and
            # the barrier it started from
            rec = {"X": carry.X, "U": carry.U, "kkt": new.kkt, "mu": carry.mu,
                   "objective": objective(carry.X, carry.U, theta)}
            for k, v in rec.items():
                hist[k][:, i] = _select(done, hist[k][:, i], v)
        carry = _Carry(*[None if a is None else _select(done, a, b)
                         for a, b in zip(carry, new)])

    if resume is not None and not finish:
        return tuple(v for v in carry if v is not None)
    obj = objective(carry.X, carry.U, theta)
    status = torch.where(carry.converged, 0, torch.where(carry.diverged, 2, 1))
    sol = OCPSolution(
        X=carry.X, U=carry.U, lam=carry.lam, s=carry.s, z=carry.z, sN=carry.sN,
        zN=carry.zN, mu=carry.mu, kkt_error=carry.kkt, objective=obj,
        iterations=carry.it, converged=carry.converged,
        status=status.to(torch.int32))
    if record:
        return sol, {**hist, "n": carry.it}
    return sol


def _select(keep, a, b):
    """Per-scenario where(keep, a, b) for a (B, ...) pair."""
    return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)), a, b)
