"""PyTorch port: the whole-solve kernel's cost cross block (``CROSS``), which
the Δu-augmented problem needs (CPU; the JAX kernel in interpret mode).

Under the Δu augmentation an input term weighs e = u_prev + Δu, with u_prev
in the solver state: the stage Hessian gains the block Hux = d²l/du dx, and
the JAX kernel carries it into its Riccati step (hilo_mpc_tpu/ops/
pallas_ip.py:571, Huxk = Hux + BᵀPA). ``ops/codegen_cuda.py`` emits it when
the cost has one (``CROSS = true``), and csrc/whole_ip.cuh adds it there.

- The augmented model's emitted step: F and [A | B] against ``torch.func``
  Jacobians of the controller's dyn (float64, 1e-12).
- The CROSS build compiled for the host against the plain version in
  float64 (equal iterations, U and X to 1e-12), on a ragged batch of 70
  (a full tile of 64 and a ragged one).
- The plain version against the JAX kernel in interpret mode (float32
  there): equal iterations, U to 5e-4, as tests/test_torch_whole_ip.py does;
  the host build in float32 against it too.
- A problem without a cross term emits ``CROSS = false`` and, that line
  taken out, the text it emitted before the block existed (its SHA-256),
  for the four row patterns of ``chip_smoke.py``; an input-change term
  alone needs no cross block.
- The gates: a Δu problem with Nc = N is eligible in both packages and
  NMPC routes it to the kernel's path; with Nc < N Δu is pinned, and both
  decline it.
- ``cuda``: the CROSS kernel against the plain version on the card.
"""
import hashlib
import re
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from golden_configs import CSTR_P, CSTR_REF
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import pallas_full_supported, solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import codegen_cuda
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
# the whole-solve options of tests/test_pallas_ip.py:_flagship
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 10,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}


def _du_nmpc(cls, model, N, options=None, inputs=True, **setup_kw):
    """The flagship CSTR with golden du_tracking's Δu term (0.5) and Δu
    bounds ±0.5, in either package; ``inputs=False`` drops the input term
    (then no cost couples u_prev with Δu)."""
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    if inputs:
        nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.quad_stage_cost.add_inputs_change(weights=0.5)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0], du_lb=[-0.5], du_ub=[0.5])
    nmpc.set_parameters(CSTR_P)
    nmpc.setup(options={**KERNEL_OPTS, **(options or {})}, **setup_kw)
    return nmpc


def _port(N, dtype=F64, device=CPU, **kw):
    return _du_nmpc(NMPC, cstr_schaffner_and_zeitz(), N, device=device, dtype=dtype, **kw)


def _inputs(B, seed):
    """x0 = [0.2, 0.1] + 0.05·N(0,1) and u_prev = 0.5·N(0,1) clipped to ±5."""
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(seed).standard_normal((B, 2))
    u_prev = np.clip(0.5 * np.random.default_rng(seed + 1).standard_normal((B, 1)), -5, 5)
    return x0s, u_prev


def _args(nmpc, B, seed):
    x0s, u_prev = _inputs(B, seed)
    return nmpc.prepare_batch(x0s, u_prev=u_prev)


def _plain(nmpc, args):
    return W.solve_ocp_full_reference(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                      nmpc._ip_opts)


def _host(nmpc, args):
    return W.solve_ocp_full_host(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                 nmpc._ip_opts)


def _problem(nmpc, n_theta):
    return W.whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds, n_theta,
                              nmpc._ip_opts)


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def test_cross_problem_is_emitted_with_the_block():
    tn = _port(6)
    p = _problem(tn, _args(tn, 1, 0)[0].shape[2])
    assert "static constexpr bool CROSS = true;" in p.text
    assert "T* Hux)" in p.text and "Hux[2] = Hux[2] + prm[" in p.text
    # u = u_prev + Δu into the model, u/su out
    assert "u[j] = x[2 + j] + u[j];" in p.text and "out[2 + j] = u[j] /" in p.text
    # the rows: Δu bounds at every stage, u bounds on u_prev from stage 1
    # (8 candidate rows, MAX_ROWS holds) and at the terminal stage
    assert p.stage_rows[:2] == ((0, 0), (0, 1))
    assert {r for k, r in p.stage_rows if k >= 1} == {0, 1, 4, 7}
    assert p.term_rows == (2, 5)
    # the cross block's operations are counted in the bound
    base = codegen_cuda._iteration_flops(3, 1, 6, 0, 0, 0, 0, 0, 0, 0)
    assert codegen_cuda._iteration_flops(3, 1, 6, 0, 0, 0, 0, 0, 0, 0, True) == \
        base + 6 * 4 * 1 * 3


def test_augmented_step_matches_autodiff():
    _need_cxx()
    tn = _port(4)
    theta, xs0, X, U = _args(tn, 5, 1)
    xs, us, th = X[:, 1], U[:, 1] + 0.1, theta[:, 1]
    F, AB = W.dyn_lin_host(tn._funcs, tn._dims, tn._bounds, xs, us, th)
    dyn = tn._funcs.dyn
    J = vmap(jacfwd(lambda x, u, t: dyn(x, u, t), argnums=(0, 1)))(xs, us, th)
    torch.testing.assert_close(F, dyn(xs, us, th), rtol=0, atol=1e-12)
    torch.testing.assert_close(AB, torch.cat(J, dim=-1), rtol=0, atol=1e-12)


def test_cross_host_build_matches_plain():
    """The kernel's own code with the cross block, host-compiled, against
    the plain version: float64, B = 70 (a ragged second tile), N = 6."""
    _need_cxx()
    tn = _port(6)
    args = _args(tn, 70, 2)
    ref, host = to_numpy(_plain(tn, args)), to_numpy(_host(tn, args))
    assert ref.converged.mean() >= 0.95
    np.testing.assert_array_equal(host.iterations, ref.iterations)
    np.testing.assert_array_equal(host.converged, ref.converged)
    np.testing.assert_allclose(host.U, ref.U, rtol=0, atol=1e-12)
    np.testing.assert_allclose(host.X, ref.X, rtol=0, atol=1e-12)
    np.testing.assert_allclose(host.lam, ref.lam, rtol=0, atol=1e-10)
    np.testing.assert_allclose(host.objective, ref.objective, rtol=1e-12)


@pytest.fixture(scope="module")
def pallas_case():
    """The JAX kernel on 7 Δu scenarios with their u_prev, N=4."""
    jn = _du_nmpc(JaxNMPC, jax_cstr(), 4)
    assert pallas_full_supported(jn._dims, jn._bounds, jn._ip_opts, True)
    x0s, u_prev = _inputs(7, 3)
    args = jn.prepare_batch(x0s, u_prev=u_prev)
    sol = solve_ocp_pallas_full(jn._funcs, jn._dims, jn._bounds, *args,
                                options=jn._ip_opts, tile_b=8)
    return to_torch(args, device=CPU), jax.tree.map(np.asarray, sol)


def test_plain_matches_pallas_interpret(pallas_case):
    args, jsol = pallas_case
    sol = to_numpy(_plain(_port(4), args))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, atol=5e-4)
    np.testing.assert_allclose(sol.objective, jsol.objective, rtol=1e-4)


def test_host_build_matches_pallas_interpret(pallas_case):
    """The port's kernel code in float32 against the JAX kernel (float32)."""
    _need_cxx()
    args, jsol = pallas_case
    tn = _port(4, dtype=torch.float32)
    sol = to_numpy(_host(tn, [a.float() for a in args]))
    assert sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)


# the SHA-256 (first 16 hex digits) of each chip_smoke.py row pattern's
# emitted text at N=20 as it was before the cross block existed; the
# problems without a cross term emit it still, with the line
# "CROSS = false" added and the row masks written as 32-bit words (one
# word here: _one_word_as_before maps them back to the single-mask text)
NO_CROSS_TEXT = {
    "flagship": (dict(u_lb=[-5.0], u_ub=[5.0]), "98526e642d3b5cfe"),
    "state_terminal_bounds": (dict(u_lb=[-5.0], u_ub=[5.0], x_lb=[0.0, 0.0],
                                   x_ub=[0.29, 0.8]), "63d2ca4a4d1cf87c"),
    "unconstrained": ({}, "084dc7b04d55e1b0"),
    "softcon_active": (dict(u_lb=[-5.0], u_ub=[5.0], x_ub=[0.27, float("inf")],
                            x_soft=True, soft_weight=500.0), "f2ba5611cc680635"),
}


def _one_word_as_before(text):
    """A one-word problem's text with its row words written as the single
    masks of the text before them (RW = RTW = 1: row_mask(k, 0) is the
    stage's mask, term_mask(0) the terminal one); any other difference
    stays."""
    assert text.count("RW = 1, RTW = 1;") == 1
    text = text.replace(", RW = 1, RTW = 1;", ";")
    term = re.search(r"  HM_HD static constexpr unsigned term_mask\(int w\) \{\n"
                     r"    \(void\)w; return (\d+u);\n  \}\n", text)
    text = text.replace(term.group(0), "")
    text = text.replace("  static constexpr bool CROSS",
                        f"  static constexpr unsigned TERM_MASK = {term.group(1)};\n"
                        "  static constexpr bool CROSS")
    text = text.replace(
        "  // word w of the active candidate rows [u-ub; lb-u; x-ub; lb-x] of stage\n"
        "  // k (row r is bit r & 31 of word r >> 5), and the slot of the first of\n"
        "  // them; word w of the terminal rows [x-ub; lb-x]\n",
        "  // active candidate rows [u-ub; lb-u; x-ub; lb-x] of stage k, and the slot\n"
        "  // of the first of them\n")
    text = text.replace("row_mask(int k, int w) {\n    (void)w;\n", "row_mask(int k) {\n")
    return re.sub(r"    if \(k < (\d+)\) \{ return (\d+u); \}", r"    if (k < \1) return \2;",
                  text)


@pytest.mark.parametrize("case", sorted(NO_CROSS_TEXT))
def test_problems_without_cross_terms_emit_the_same_text(case):
    bounds, digest = NO_CROSS_TEXT[case]
    tn = NMPC(cstr_schaffner_and_zeitz())
    tn.horizon = 20
    tn.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    tn.quad_stage_cost.add_inputs(weights=0.1)
    tn.set_box_constraints(**bounds)
    tn.set_parameters(CSTR_P)
    tn.setup(options={**KERNEL_OPTS, "max_iter": 25}, device=CPU, dtype=torch.float32)
    text = _one_word_as_before(
        _problem(tn, tn.prepare_batch([[0.2, 0.1]])[0].shape[2]).text)
    line = "  static constexpr bool CROSS = false;\n"
    assert text.count(line) == 1 and "Hux" not in text
    assert hashlib.sha256(text.replace(line, "").encode()).hexdigest()[:16] == digest


def test_input_change_alone_needs_no_cross_block():
    _need_cxx()
    tn = _port(5, inputs=False)
    assert tn._augment_du and (tn._dims.nx, tn._dims.nu) == (3, 1)
    args = _args(tn, 6, 4)
    assert "CROSS = false" in _problem(tn, args[0].shape[2]).text
    ref, host = to_numpy(_plain(tn, args)), to_numpy(_host(tn, args))
    np.testing.assert_array_equal(host.iterations, ref.iterations)
    np.testing.assert_allclose(host.U, ref.U, rtol=0, atol=1e-12)


def test_nmpc_routes_du_problems_to_the_kernel():
    """pallas_full with Nc = N: no warning, the kernel's path (on CPU
    tensors its plain version), no Riccati launch."""
    tn = _port(5, options={"pallas_full": True})
    assert tn._whole_ip_cache()["eligible"]
    args = _args(tn, 4, 5)
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sol = tn.solve_batch_fn()(*args)
    for a, b in zip(sol, _plain(tn, args)):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric


def test_control_horizon_pins_du_and_both_gates_decline():
    jn = _du_nmpc(JaxNMPC, jax_cstr(), 6)
    jn.control_horizon = 3
    jn.setup(options=KERNEL_OPTS)
    assert not pallas_full_supported(jn._dims, jn._bounds, jn._ip_opts, True)
    tn = NMPC(cstr_schaffner_and_zeitz())
    tn.horizon = 6
    tn.control_horizon = 3
    tn.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    tn.quad_stage_cost.add_inputs(weights=0.1)
    tn.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    tn.set_parameters(CSTR_P)
    tn.setup(options={**KERNEL_OPTS, "pallas_full": True}, device=CPU, dtype=F64)
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is None and why == "pinned controls (lbu = ubu)"
    args = _args(tn, 3, 6)
    with pytest.warns(UserWarning, match="pallas_full"):
        fn = tn.solve_batch_fn()
    for a, b in zip(fn(*args), tn._solve(*args, tn._mu_cold)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cross_kernel_matches_plain_on_card(dtype):
    """The CROSS kernel against its plain version at N=20, B=1024: float64
    equal iterations and U to 1e-12; float32 U to 5e-4 on the jointly
    converged scenarios."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    tn = _port(20, dtype=dt, device="cuda", options={"max_iter": 25})
    args = _args(tn, 1024, 7)
    k = W.solve_ocp_full_cuda(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    both = k.converged & r.converged
    assert float(both.float().mean()) >= 0.95
    if dt == torch.float64:
        assert torch.equal(k.iterations, r.iterations)
        assert float((k.U - r.U).abs().max()) <= 1e-12
    else:
        assert float((k.U - r.U).abs()[both].max()) <= 5e-4
