"""PyTorch port: the whole-solve kernel on more than 32 candidate box rows per
stage (CPU). The row masks are 32-bit words (ops/codegen_cuda.py:
_struct_head, csrc/whole_ip.cuh:RowMask).

The model is tests/chain_model.py's chain of 8 masses (nx = 17, nu = 1: 36
candidate rows per stage and 34 at the terminal stage, in the equation DSL,
so both packages build it from one text), lower velocity bounds on v_5..v_8
(stage rows 31..34, terminal rows 29..32), those of v_5 and v_6 binding:

- the emitted row words against the masks the emitter computes;
- the gate: pallas_full takes it with no warning, the whole-solve path's
  plain version bit for bit on the CPU, no Riccati launch;
- the host build (csrc/whole_ip.cuh compiled for the CPU) against the plain
  version in float64: equal iterations, U/X, the slacks, duals and
  multipliers to 1e-9;
- the plain version against JAX's general path (vmapped ``solve_ocp``) at
  the same pure-Newton options: equal iterations, U/X to 1e-8.
The card's build of this problem is timed by chip_smoke.py (phase 1,
whole_ip_wide_rows, and phase 19).
"""
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

import hilo_mpc_tpu.ops.ip_solver as jip
from chain_model import (DT, N_MASS, P_REF, W_P, W_U, W_V, chain_bounds,
                         chain_equations, chain_x0s)
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.ops import codegen_cuda
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64
N = 16
# scenarios of chain_x0s(256) whose v_5 (row 31) or v_6 (row 32) bound binds
PICK = [1, 4, 13, 24, 97, 125, 146, 162]
# pure Newton steps, a tight tolerance for the float64 comparisons
OPTS = {"dt": DT, "tol": 1e-8, "max_iter": 30, "convexify": False,
        "n_linesearch": 1, "mu_init": 1e-2, "mehrotra": False}


def chain_nmpc(cls, model_cls, options=None, **setup_kw):
    m = model_cls(name="chain")
    m.set_equations(chain_equations())
    nmpc = cls(m)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(names=[f"p_{i}" for i in range(1, N_MASS + 1)],
                                    weights=[W_P] * N_MASS, ref=[P_REF] * N_MASS)
    nmpc.quad_stage_cost.add_states(names=[f"v_{i}" for i in range(1, N_MASS + 1)],
                                    weights=[W_V] * N_MASS, ref=[0.0] * N_MASS)
    nmpc.quad_stage_cost.add_inputs(weights=W_U)
    x_lb, x_ub, u_lb, u_ub = chain_bounds()
    nmpc.set_box_constraints(x_lb=x_lb, x_ub=x_ub, u_lb=u_lb, u_ub=u_ub)
    nmpc.setup(options={**OPTS, **(options or {})}, **setup_kw)
    return nmpc


def x0s():
    return chain_x0s(256)[PICK]


@pytest.fixture(scope="module")
def chain():
    """The port's controller (float64, CPU, pallas_full), its inputs and
    its plain solution."""
    tn = chain_nmpc(NMPC, Model, {"pallas_full": True}, device=CPU, dtype=F64)
    args = tn.prepare_batch(x0s())
    plain = W.solve_ocp_full_reference(tn._funcs, tn._dims, tn._bounds, *args,
                                       tn._ip_opts)
    return tn, args, plain


def test_row_words_match_the_masks(chain):
    """36 candidate rows per stage and 34 terminal ones: two words each; word
    w of stage k is bits 32w..32w+31 of the emitter's mask, and the rows the
    problem lists are exactly the set bits."""
    tn, args, _ = chain
    nx, nu = tn._dims.nx, tn._dims.nu
    assert (nx, nu, 2 * nu + 2 * nx) == (17, 1, 36)
    bnd = tuple(b.double().numpy() for b in tn._bounds)
    masks, offs, tmask, toffs = codegen_cuda._rows(bnd, N, nx, nu)
    assert all(m >> 32 for m in masks[1:]) and tmask >> 32 and tmask >> 31 & 1
    problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                                 tn._ip_opts)
    assert "RW = 2, RTW = 2;" in problem.text and "MAX_ROWS" not in problem.text
    for m in set(masks):
        lo, hi = codegen_cuda._words(m, 36)
        assert lo | hi << 32 == m and f"if (w == 0) return {lo}u; return {hi}u;" \
            in problem.text
    lo, hi = codegen_cuda._words(tmask, 34)
    assert f"if (w == 0) return {lo}u; return {hi}u;" in problem.text
    assert problem.stage_rows == tuple((k, r) for k, m in enumerate(masks)
                                       for r in range(36) if m >> r & 1)
    assert problem.term_rows == tuple(t for t in range(34) if tmask >> t & 1)
    assert len(offs) == len(problem.stage_rows) and len(toffs) == len(problem.term_rows)


def test_gate_takes_the_chain(chain):
    """pallas_full: no warning, eligible, the plain version's bits on CPU
    tensors, no Riccati launch."""
    tn, args, plain = chain
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is not None and why is None, why
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    assert tn._wip["eligible"]
    for a, b in zip(fn(*args), plain):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric


def test_host_kernel_matches_plain_f64(chain):
    """The kernel's per-scenario solve on the host: equal iterations, U/X
    to 1e-9; the lower bounds of v_5 and v_6, stage rows 31 and 32 on either
    side of the word boundary, bind (slack below 1e-5) in the plain
    solution."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")
    tn, args, r = chain
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-9)
    for name in ("s", "z", "sN", "zN", "lam", "objective", "kkt_error", "mu"):
        torch.testing.assert_close(getattr(k, name), getattr(r, name), rtol=0,
                                   atol=1e-9, msg=name)
    stage = set(torch.nonzero(r.s[:, 1:] < 1e-5)[:, 2].tolist())
    assert {31, 32} <= stage, stage


def test_plain_matches_jax_general_path(chain):
    """JAX's general path (float64) on the same DSL text and options: equal
    iterations, U/X to 1e-8."""
    tn, _, _ = chain
    jn = chain_nmpc(JaxNMPC, JaxModel)
    args = jn.prepare_batch(x0s())
    jsol = jax.jit(jax.vmap(lambda th, x0, Xi, Ui: jip.solve_ocp(
        jn._funcs, jn._dims, jn._bounds, th, x0, Xi, Ui, options=jn._ip_opts,
        fix_x0=True)))(*args)
    targs = to_torch(args, device=CPU)
    sol = to_numpy(W.solve_ocp_full_reference(tn._funcs, tn._dims, tn._bounds, *targs,
                                              tn._ip_opts))
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_array_equal(sol.converged, np.asarray(jsol.converged))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol.X, np.asarray(jsol.X), rtol=0, atol=1e-8)
