"""Linear MPC.

PyTorch port of ``hilo_mpc_tpu/control/lmpc.py``. Q/R/P are set as matrices
and installed as quadratic cost terms of the NMPC engine, whose stagewise
interior point solves the linear-quadratic problem exactly in a handful of
iterations (``optimize``, ``optimize_batch``; the Riccati step is the CUDA
kernel on CUDA tensors). ``optimize_batch_fgm`` is the condensed fast path:
the problem is condensed onto the input sequence on the host
(``condense_lmpc``, once per configuration) and B box-QPs are solved by the
projected fast gradient method, one CUDA kernel
(``ops/cuda_kernels.py:fgm_boxqp_cuda``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.model import Model
from ..ops.cuda_kernels import (fgm_boxqp_cuda, fgm_boxqp_reference,
                                fgm_constants)
from .nmpc import NMPC


def condense_lmpc(A, B, Q, R, P, N):
    """Condense the LTI MPC QP onto the input sequence: J = ½ Uᵀ H U + x0ᵀ Gᵀ U,
    in float64 numpy.

    Prediction: X = Φ x0 + Γ U (Γ lower block triangular of A^i B) over
    x_1..x_N; H = Γᵀ Q̄ Γ + R̄, G = Γᵀ Q̄ Φ, with Q̄ = blkdiag(Q, ..., Q, P)
    (the last block is Q when P is None). The port's copy of
    ``hilo_mpc_tpu/embedded/codegen.py:condense_lmpc``.
    """
    A = np.asarray(A, dtype=float)
    B = np.asarray(B, dtype=float)
    nx, nu = B.shape
    Phi = np.zeros((N * nx, nx))
    Gamma = np.zeros((N * nx, N * nu))
    pows = [np.eye(nx)]
    for _ in range(N):
        pows.append(A @ pows[-1])
    for i in range(N):
        Phi[i * nx:(i + 1) * nx] = pows[i + 1]
        for j in range(i + 1):
            Gamma[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = pows[i - j] @ B
    Qbar = np.kron(np.eye(N), np.asarray(Q, dtype=float))
    Qbar[-nx:, -nx:] = np.asarray(P if P is not None else Q, dtype=float)
    Rbar = np.kron(np.eye(N), np.asarray(R, dtype=float))
    H = Gamma.T @ Qbar @ Gamma + Rbar
    G = Gamma.T @ Qbar @ Phi
    return H, G


def _check_weight(val, n, name):
    M = np.asarray(val, dtype=float)
    if M.ndim == 0:
        M = np.eye(n) * float(M)
    elif M.ndim == 1:
        M = np.diag(M)
    if M.shape != (n, n):
        raise ValueError(f"{name} shape {M.shape}, expected {(n, n)}")
    if not np.allclose(M, M.T, atol=1e-10):
        raise ValueError(f"{name} must be symmetric")
    if np.any(np.linalg.eigvalsh(M) < -1e-10):
        raise ValueError(f"{name} must be positive semi-definite")
    return M


class LMPC(NMPC):
    """Discrete-time linear MPC with matrix-weight API."""

    _controller_type = "LMPC"

    def __init__(self, model: Model, **kwargs):
        if not model.is_linear:
            raise ValueError("LMPC requires a linear model; use NMPC instead")
        super().__init__(model, **kwargs)
        nx, nu = model.n_x, model.n_u
        self._Q_mat = np.eye(nx)
        self._R_mat = np.eye(nu)
        self._P_mat: Optional[np.ndarray] = None
        self._x_ref: Optional[np.ndarray] = None
        self._u_ref: Optional[np.ndarray] = None
        # the FGM path's problem on the device, with the key it was built for
        self._fgm_key = None
        self._fgm_qp = None

    @property
    def Q(self):
        return np.array(self._Q_mat)

    @Q.setter
    def Q(self, val):
        self._Q_mat = _check_weight(val, self._model.n_x, "Q")

    @property
    def R(self):
        return np.array(self._R_mat)

    @R.setter
    def R(self, val):
        R = _check_weight(val, self._model.n_u, "R")
        if np.any(np.linalg.eigvalsh(R) <= 0):
            raise ValueError("R must be positive definite")
        self._R_mat = R

    @property
    def P(self):
        return None if self._P_mat is None else np.array(self._P_mat)

    @P.setter
    def P(self, val):
        self._P_mat = _check_weight(val, self._model.n_x, "P")

    def set_reference(self, x_ref=None, u_ref=None):
        if x_ref is not None:
            self._x_ref = np.asarray(x_ref, dtype=float).ravel()
        if u_ref is not None:
            self._u_ref = np.asarray(u_ref, dtype=float).ravel()
        return self

    def setup(self, options: Optional[dict] = None, device="cuda",
              dtype=torch.float32, **kwargs):
        """Install the matrix weights as cost terms, then ``NMPC.setup`` on
        ``device`` in ``dtype`` (``device="cpu"`` runs on the CPU)."""
        self.quad_stage_cost.terms = [
            t for t in self.quad_stage_cost.terms
            if t.kind not in ("states", "inputs")]
        self.quad_stage_cost.add_states(weights=self._Q_mat, ref=self._x_ref)
        if self._model.n_u:
            self.quad_stage_cost.add_inputs(weights=self._R_mat, ref=self._u_ref)
        self.quad_terminal_cost.terms = []
        if self._P_mat is not None:
            self.quad_terminal_cost.add_states(weights=self._P_mat,
                                               ref=self._x_ref)
        options = dict(options or {})
        if self._model.discrete:
            options.setdefault("integration_method", "discrete")
        return super().setup(options=options, device=device, dtype=dtype,
                             **kwargs)

    # -- condensed-QP fast path -------------------------------------------------
    def condensed_qp(self):
        """(H, G, lb, ub) of the condensed input-sequence QP, float64 numpy
        (factor 2: the MPC cost is xᵀQx, the QP's ½UᵀHU). Only the input
        bounds enter: state bounds are not part of this QP."""
        model = self._model
        A, B = model.A, model.B
        if A is None:
            A, B = (j.cpu().numpy() for j in model.jacobians(
                np.zeros(model.n_x), np.zeros(model.n_u)))
        if not model.discrete:
            raise ValueError("condensed fast path requires a discrete-time model")
        N = self.horizon
        H, G = condense_lmpc(A, B, 2 * self.Q, 2 * self.R,
                             2 * self.P if self.P is not None else None, N)
        lb = np.tile(self._u_lb, N)
        ub = np.tile(self._u_ub, N)
        return H, G, lb, ub

    def _fgm_problem(self):
        """(H, G, lb, ub) of ``condensed_qp`` as float32 tensors on this
        controller's device, and (1/L, β) from the float64 H, built once per
        configuration: the key holds everything they depend on (Q, R, P, the
        horizon, the input bounds, the model's matrices, the device and the
        dtype), so a change of any of them builds them anew."""
        model = self._model
        key = tuple(None if a is None else np.asarray(a, dtype=float).tobytes()
                    for a in (self._Q_mat, self._R_mat, self._P_mat, self._u_lb,
                              self._u_ub, model.A, model.B))
        key += (self.horizon, model.discrete, str(self._device), self._dtype)
        if key != self._fgm_key:
            qp = self.condensed_qp()
            # 1/L and β from the float64 H, as the JAX twin takes them; the
            # kernel then never waits for a copy of H back from the card
            constants = fgm_constants(qp[0])
            kw = dict(dtype=torch.float32, device=self._device)
            self._fgm_qp = tuple(torch.as_tensor(a, **kw) for a in qp) + (constants,)
            self._fgm_key = key
        return self._fgm_qp

    def _fgm_x0(self, x0_batch):
        """x0 as a (B, n_x) float32 tensor on this controller's device: one
        cast to float32 on the host (torch's, which uses every core; numpy's
        ``astype`` is single-threaded), then one copy."""
        x = np.ascontiguousarray(np.atleast_2d(x0_batch), dtype=np.float64)
        return torch.tensor(x, dtype=torch.float32).to(self._device)

    def optimize_batch_fgm(self, x0_batch, iters: int = 100, backend: str = "auto"):
        """First control moves (B, n_u) of B regulation problems, by ``iters``
        fast-gradient steps on the condensed QP in float32 on this
        controller's device: the CUDA kernel on the card, its plain version
        on the CPU. ``backend="xla"`` (the JAX API's switch to the plain
        twin) asks for the plain PyTorch version on any device. The
        condensed QP, its constants and their copies on the device are built
        once per configuration (``_fgm_problem``)."""
        if backend not in ("auto", "xla"):
            raise ValueError(f"backend must be 'auto' or 'xla', got {backend!r}")
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._x_ref is not None or self._u_ref is not None:
            raise NotImplementedError("fgm fast path currently solves the "
                                      "regulation problem (no references)")
        H, G, lb, ub, constants = self._fgm_problem()
        x0 = self._fgm_x0(x0_batch)
        solve = fgm_boxqp_reference if backend == "xla" else fgm_boxqp_cuda
        U = solve(H, G, x0, lb, ub, iters, constants=constants)
        return U[:, :self._model.n_u].cpu().numpy()
