"""Riccati block elimination for stagewise (block-banded) KKT systems.

PyTorch port of ``hilo_mpc_tpu/ops/riccati.py``. Batch-first: every block
carries leading batch dims, the horizon recursion is a Python loop over the
stage axis, and each per-stage operation is the same unrolled small-matrix
algebra as the JAX sweeps (ops/smallalg.py). These sweeps are the plain
version of the CUDA kernel ``ops/cuda_kernels.py:riccati_lq_cuda``
(``make_plain_lq_solver``); ``solve_lq_parallel`` solves the same problem by
log-depth scans over the stages (the interior point's ``parallel_riccati``
option); ``lqr_backward`` and ``dare_solve`` give the LQR gains.

Equality-constrained LQ problem solved here (per scenario):

    min  Σ_{k=0}^{N-1} [ ½ dxᵀQ_k dx + duᵀS_k dx + ½ duᵀR_k du + q_kᵀdx + r_kᵀdu ]
         + ½ dx_Nᵀ P_term dx_N + p_termᵀ dx_N
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 given (or free).

Stage blocks: Q (..., N, nx, nx), R (..., N, nu, nu), S (..., N, nu, nx),
q (..., N, nx), r (..., N, nu), A (..., N, nx, nx), B (..., N, nx, nu),
c (..., N, nx); terminal P_term (..., nx, nx), p_term (..., nx); dx0 (..., nx),
or None for a free initial state: dx_0 then minimizes the stage-0 value
function, dx_0 = −(P_0 + reg·I)⁻¹ p_0 (the free-x0 step of
hilo_mpc_tpu/ops/ip_solver.py:633-642).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .smallalg import (mm_small as _mm, mv_small as _mv, solve_psd_small,
                       tmm_small as _tmm, tmv_small as _tmv)


class LQSolution(NamedTuple):
    dX: torch.Tensor      # (..., N+1, nx)
    dU: torch.Tensor      # (..., N, nu)
    lam: torch.Tensor     # (..., N, nx) multipliers of the dynamics rows (x_1..x_N)
    K: torch.Tensor       # (..., N, nu, nx) feedback gains
    kff: torch.Tensor     # (..., N, nu) feedforward
    cost_red: torch.Tensor  # (...,) predicted objective reduction


def _batch_shape(A, B, Q, S, R, q, r, c, P_term, p_term, dx0=None):
    """Broadcast batch shape of the LQ blocks (leading dims before the block dims)."""
    shapes = [A.shape[:-3], B.shape[:-3], Q.shape[:-3], S.shape[:-3],
              R.shape[:-3], q.shape[:-2], r.shape[:-2], c.shape[:-2],
              P_term.shape[:-2], p_term.shape[:-1]]
    if dx0 is not None:
        shapes.append(dx0.shape[:-1])
    return torch.broadcast_shapes(*shapes)


def backward_sweep(A, B, Q, S, R, q, r, c, P_term, p_term, reg: float = 1e-9):
    """Backward Riccati recursion. Returns (K, kff, P_0, p_0, Ps_next, ps_next,
    cost_red) with Ps_next[..., k] = P_{k+1} (what the forward pass needs)."""
    N, nx = A.shape[-3], A.shape[-1]
    nu = B.shape[-1]
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    batch = _batch_shape(A, B, Q, S, R, q, r, c, P_term, p_term)
    P, p = P_term.expand(*batch, nx, nx), p_term.expand(*batch, nx)
    Ks, kffs, Pns, pns, decs = [None] * N, [None] * N, [None] * N, [None] * N, []
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        Pc_p = _mv(P, c[..., k, :]) + p                       # (..., nx)
        PA = _mm(P, A_k)                                      # (..., nx, nx)
        PB = _mm(P, B_k)                                      # (..., nx, nu)
        G = R[..., k, :, :] + _tmm(B_k, PB)                   # (..., nu, nu)
        G = 0.5 * (G + G.transpose(-1, -2)) + reg * eye_u
        H_ux = S[..., k, :, :] + _tmm(B_k, PA)                # (..., nu, nx)
        g_u = r[..., k, :] + _tmv(B_k, Pc_p)                  # (..., nu)
        sol = -solve_psd_small(G, torch.cat([H_ux, g_u[..., None]], dim=-1))
        K_k, kff_k = sol[..., :-1], sol[..., -1]
        Ks[k], kffs[k], Pns[k], pns[k] = K_k, kff_k, P, p
        P_k = Q[..., k, :, :] + _tmm(A_k, PA) + _tmm(H_ux, K_k)
        P = 0.5 * (P_k + P_k.transpose(-1, -2))
        p = q[..., k, :] + _tmv(A_k, Pc_p) + _tmv(H_ux, kff_k)
        # predicted decrease contribution: -½ kffᵀ g_u
        decs.append(-0.5 * (kff_k * g_u).sum(dim=-1))
    # the JAX scan sums the per-stage decrements in stage order 0..N-1
    dec = torch.stack(decs[::-1], dim=-1).sum(dim=-1)
    return (torch.stack(Ks, dim=-3), torch.stack(kffs, dim=-2), P, p,
            torch.stack(Pns, dim=-3), torch.stack(pns, dim=-2), dec)


def forward_sweep(A, B, c, K, kff, dx0, Ps_next, ps_next):
    """Forward rollout of the affine policy; also recovers dynamics multipliers."""
    N = A.shape[-3]
    dx = dx0.expand(*torch.broadcast_shapes(dx0.shape[:-1], K.shape[:-3]),
                    dx0.shape[-1])
    dXs, dUs, lams = [dx], [], []
    for k in range(N):
        du = _mv(K[..., k, :, :], dx) + kff[..., k, :]
        dx = (_mv(A[..., k, :, :], dx) + _mv(B[..., k, :, :], du)
              + c[..., k, :])
        lams.append(_mv(Ps_next[..., k, :, :], dx) + ps_next[..., k, :])
        dXs.append(dx)
        dUs.append(du)
    return (torch.stack(dXs, dim=-2), torch.stack(dUs, dim=-2),
            torch.stack(lams, dim=-2))


def solve_lq(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
             reg: float = 1e-9) -> LQSolution:
    """Solve the stagewise equality-constrained LQ problem by Riccati
    elimination; ``dx0=None`` frees the initial state (the JAX composite
    backward sweep → ``linalg.solve`` → LQ solve, in one sweep pair)."""
    K, kff, P0, p0, Ps_next, ps_next, dec = backward_sweep(
        A, B, Q, S, R, q, r, c, P_term, p_term, reg)
    if dx0 is None:
        eye = torch.eye(P0.shape[-1], dtype=P0.dtype, device=P0.device)
        dx0 = -torch.linalg.solve(P0 + reg * eye, p0[..., None])[..., 0]
    dX, dU, lam = forward_sweep(A, B, c, K, kff, dx0, Ps_next, ps_next)
    return LQSolution(dX=dX, dU=dU, lam=lam, K=K, kff=kff, cost_red=dec)


def _suffix_scan(combine, elems, axes):
    """Inclusive suffix scan by doubling: element k of the stage axis
    becomes combine(e_k, combine(e_{k+1}, ... e_{n-1})) for an associative
    ``combine(earlier, later)`` on tuples of tensors; ``axes`` gives each
    entry's stage axis (-3 for matrices, -2 for vectors). Any length n, in
    ceil(log2 n) rounds."""
    n = elems[0].shape[axes[0]]
    d = 1
    while d < n:
        head = combine(tuple(e.narrow(a, 0, n - d) for e, a in zip(elems, axes)),
                       tuple(e.narrow(a, d, n - d) for e, a in zip(elems, axes)))
        elems = tuple(torch.cat([h, e.narrow(a, n - d, d)], dim=a)
                      for h, e, a in zip(head, elems, axes))
        d *= 2
    return elems


def _prefix_scan(combine, elems, axes):
    """Inclusive prefix scan by doubling: element k becomes
    combine(... combine(e_0, e_1) ..., e_k); as ``_suffix_scan``."""
    n = elems[0].shape[axes[0]]
    d = 1
    while d < n:
        tail = combine(tuple(e.narrow(a, 0, n - d) for e, a in zip(elems, axes)),
                       tuple(e.narrow(a, d, n - d) for e, a in zip(elems, axes)))
        elems = tuple(torch.cat([e.narrow(a, 0, d), t], dim=a)
                      for t, e, a in zip(tail, elems, axes))
        d *= 2
    return elems


def solve_lq_parallel(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                      reg: float = 1e-9) -> LQSolution:
    """Temporal-parallel LQ solve of ``hilo_mpc_tpu/ops/riccati.py:99``:
    the same problem and result as ``solve_lq`` (a given dx0), but both
    recursions run as log-depth associative scans over the stage axis.

    Per stage the control's cross and linear terms are eliminated by
    completing the square (u = ũ − R⁻¹(S dx + r)); the stages become
    conditional value-function elements (A, b, C, η, J) composed by the
    standard rule, and a suffix scan gives (P_k, p_k) = (J_k, −η_k) for
    every k at once. The gains follow stagewise, and the forward rollout
    is a prefix scan over affine-map composition. The JAX function uses
    ``lax.associative_scan``; here each scan is a hand-written doubling
    scan (``_suffix_scan``, ``_prefix_scan``): ceil(log2 n) rounds of
    batched small-matrix composes, any n. Plain batched PyTorch on any
    device, so on CUDA tensors this solve launches no Riccati kernel (the
    JAX solver likewise bypasses its Pallas kernel under
    ``parallel_riccati``). Leading batch dims broadcast as in ``solve_lq``.
    ``dx0=None`` frees the initial state as the JAX solver does before
    this solve: a plain backward sweep gives P_0 and p_0, and
    dx_0 = −(P_0 + reg·I)⁻¹ p_0."""
    N, nx, nu = A.shape[-3], A.shape[-1], B.shape[-1]
    dtype, device = A.dtype, A.device
    if dx0 is None:
        _, _, P0, p0, _, _, _ = backward_sweep(A, B, Q, S, R, q, r, c, P_term,
                                               p_term, reg)
        eye = torch.eye(nx, dtype=dtype, device=device)
        dx0 = -torch.linalg.solve(P0 + reg * eye, p0[..., None])[..., 0]
    batch = _batch_shape(A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
    A, B, Q, S, R = (M.expand(*batch, *M.shape[-3:]) for M in (A, B, Q, S, R))
    q, r, c = (v.expand(*batch, *v.shape[-2:]) for v in (q, r, c))
    P_term, p_term = P_term.expand(*batch, nx, nx), p_term.expand(*batch, nx)
    dx0 = dx0.expand(*batch, nx)
    I_nu = torch.eye(nu, dtype=dtype, device=device)
    I_nx = torch.eye(nx, dtype=dtype, device=device)
    mm = torch.matmul

    def mv(M, v):
        return mm(M, v[..., None])[..., 0]

    # eliminate the control's cross and linear terms per stage
    R_reg = R + reg * I_nu
    Rinv = torch.linalg.inv(0.5 * (R_reg + R_reg.transpose(-1, -2)))
    RiS = mm(Rinv, S)                                   # R⁻¹S
    Rir = mv(Rinv, r)                                   # R⁻¹r
    A_t = A - mm(B, RiS)                                # A − B R⁻¹ S
    c_t = c - mv(B, Rir)                                # c − B R⁻¹ r
    St = S.transpose(-1, -2)
    Q_t = Q - mm(St, RiS)
    q_t = q - mv(St, Rir)
    C_t = mm(mm(B, Rinv), B.transpose(-1, -2))          # B R⁻¹ Bᵀ

    # elements: stages 0..N-1, then the terminal boundary element
    zM = torch.zeros(*batch, 1, nx, nx, dtype=dtype, device=device)
    zv = torch.zeros(*batch, 1, nx, dtype=dtype, device=device)
    Ae = torch.cat([A_t, zM], dim=-3)
    be = torch.cat([c_t, zv], dim=-2)
    Ce = torch.cat([C_t, zM], dim=-3)
    etae = torch.cat([-q_t, -p_term[..., None, :]], dim=-2)
    Je = torch.cat([Q_t, P_term[..., None, :, :]], dim=-3)

    def combine(ei, ej):
        """ei spans [k, m] (earlier), ej spans [m, l] (later)."""
        Ai, bi, Ci, etai, Ji = ei
        Aj, bj, Cj, etaj, Jj = ej
        M = torch.linalg.inv(I_nx + mm(Ci, Jj))
        AjM = mm(Aj, M)
        A_new = mm(AjM, Ai)
        b_new = mv(AjM, bi + mv(Ci, etaj)) + bj
        C_new = mm(mm(AjM, Ci), Aj.transpose(-1, -2)) + Cj
        Mt = torch.linalg.inv(I_nx + mm(Jj, Ci))
        AiT_Mt = mm(Ai.transpose(-1, -2), Mt)
        eta_new = mv(AiT_Mt, etaj - mv(Jj, bi)) + etai
        J_new = mm(mm(AiT_Mt, Jj), Ai) + Ji
        return A_new, b_new, C_new, eta_new, J_new

    _, _, _, eta_all, J_all = _suffix_scan(combine, (Ae, be, Ce, etae, Je),
                                           (-3, -2, -3, -2, -3))
    Ps, ps = J_all, -eta_all                            # P_k, p_k for k = 0..N

    # gains from (P_{k+1}, p_{k+1}) for every stage at once
    P_next, p_next = Ps[..., 1:, :, :], ps[..., 1:, :]
    Bt = B.transpose(-1, -2)
    G = R + mm(Bt, mm(P_next, B))                       # R + BᵀP'B
    G = 0.5 * (G + G.transpose(-1, -2)) + reg * I_nu
    H_ux = S + mm(mm(Bt, P_next), A)
    g_u = r + mv(Bt, mv(P_next, c) + p_next)
    Ginv = torch.linalg.inv(G)
    K = -mm(Ginv, H_ux)
    kff = -mv(Ginv, g_u)

    # the forward affine rollout as a prefix scan over (M, v) composition
    Mcl = A + mm(B, K)
    vcl = mv(B, kff) + c

    def affine_compose(f, g):
        """f then g: x -> Mg (Mf x + vf) + vg."""
        Mf, vf = f
        Mg, vg = g
        return mm(Mg, Mf), mv(Mg, vf) + vg

    Mscan, vscan = _prefix_scan(affine_compose, (Mcl, vcl), (-3, -2))
    dX_tail = mv(Mscan, dx0[..., None, :].expand(*batch, N, nx)) + vscan
    dX = torch.cat([dx0[..., None, :], dX_tail], dim=-2)
    dU = mv(K, dX[..., :-1, :]) + kff
    lam = mv(P_next, dX[..., 1:, :]) + p_next
    dec = -0.5 * (kff * g_u).sum(dim=(-2, -1))
    return LQSolution(dX=dX, dU=dU, lam=lam, K=K, kff=kff, cost_red=dec)


def make_lq_solver(reg: float = 1e-9):
    """The batched LQ solve used by every interior-point iteration; the
    counterpart of ``hilo_mpc_tpu/ops/riccati.py:make_lq_solver_pallas``.

    Every call runs a registered Riccati operator
    (``ops/cuda_kernels.py:riccati_lq_op``, ``riccati_lq_wide_op``), whose
    kernel the dispatcher picks by the tensors' device: CPU tensors go to the
    plain sweeps above, CUDA tensors ALWAYS to a hand-written kernel, in
    float32 and float64 alike: (nx, nu) up to (8, 4) to the tiled
    ``riccati_lq_cuda``, larger sizes to ``riccati_lq_wide_cuda`` (a group
    of warps per scenario, up to (32, 16)). Unlike the JAX dispatcher there
    is no dtype or shape exit to the plain path; the kernel raises on what it
    does not take. ``dx0=None`` (a free initial state) goes to the kernels'
    free-x0 mode, which solves for dx_0 from its own P_0 and p_0. The blocks
    are broadcast to one batch shape (flattened to one batch axis) and made
    contiguous first, because the kernel reads dense batch-first arrays. The
    live solve and the solve that utils/aot.py exports are thus one code,
    the operator a node of the exported graph. Nothing differentiates or
    ``torch.func``-transforms through this step (the RTI gain and LQR run
    ``backward_sweep`` itself), so the operators register no autograd or
    vmap rule."""
    factory_reg = reg

    def solve(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg=None):
        if reg is not None and reg != factory_reg:
            raise ValueError(
                f"make_lq_solver was built with reg={factory_reg}; per-call "
                f"reg={reg} is not supported — rebuild the solver")
        from .cuda_kernels import (riccati_lq_cuda, riccati_lq_tiled_fits,
                                   riccati_lq_wide_cuda)

        N, nx, nu = A.shape[-3], A.shape[-1], B.shape[-1]
        kernel = riccati_lq_cuda if riccati_lq_tiled_fits(nx, nu) else riccati_lq_wide_cuda
        batch = _batch_shape(A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
        Bt = 1
        for d in batch:
            Bt *= d

        def dense(x, tail):
            return x.expand(*batch, *tail).reshape(Bt, *tail).contiguous()

        out = kernel(
            dense(A, (N, nx, nx)), dense(B, (N, nx, nu)), dense(Q, (N, nx, nx)),
            dense(S, (N, nu, nx)), dense(R, (N, nu, nu)), dense(q, (N, nx)),
            dense(r, (N, nu)), dense(c, (N, nx)), dense(P_term, (nx, nx)),
            dense(p_term, (nx,)), None if dx0 is None else dense(dx0, (nx,)),
            reg=factory_reg)
        return LQSolution(*[o.reshape(*batch, *o.shape[1:]) for o in out])

    return solve


def make_plain_lq_solver(reg: float = 1e-9):
    """The plain sweeps above as the LQ step of ``ops/ip_solver.py:solve_ocp``
    on any device (its ``lq_solver`` argument): the plain version of the
    kernel that ``make_lq_solver`` launches on CUDA tensors."""
    return functools.partial(solve_lq, reg=reg)


def lqr_backward(A, B, Q, R, S=None, P_term=None, horizon: int = None):
    """Finite-horizon time-invariant LQR: gains K_0..K_{N-1} (N, nu, nx) of the
    policy du = K dx, and P_0, by the backward sweep above with every stage
    block repeated N times."""
    nx, nu = A.shape[-1], B.shape[-1]
    kw = dict(dtype=A.dtype, device=A.device)
    if S is None:
        S = torch.zeros((nu, nx), **kw)
    if P_term is None:
        P_term = Q
    N = horizon

    def rep(M):
        return M.expand((N,) + tuple(M.shape))

    K, _, P0, _, _, _, _ = backward_sweep(
        rep(A), rep(B), rep(Q), rep(S), rep(R), torch.zeros((N, nx), **kw),
        torch.zeros((N, nu), **kw), torch.zeros((N, nx), **kw), P_term,
        torch.zeros(nx, **kw))
    return K, P0


def dare_solve(A, B, Q, R, iters: int = 200):
    """Infinite-horizon discrete algebraic Riccati equation by ``iters``
    fixed-point iterations from P = Q. Returns (K, P) with u = -K x."""
    P = Q
    for _ in range(iters):
        G = R + B.T @ P @ B
        K = solve_psd_small(G, B.T @ P @ A)
        P_new = Q + A.T @ P @ (A - B @ K)
        P = 0.5 * (P_new + P_new.T)
    K = solve_psd_small(R + B.T @ P @ B, B.T @ P @ A)
    return K, P
