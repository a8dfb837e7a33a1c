"""PyTorch port: the whole-solve interior point (ops/whole_ip.py) against the
JAX package, and its generated C++ compiled on the host (CPU).

- The plain version (``solve_ocp_full_reference``) against the JAX kernel
  ``solve_ocp_pallas_full`` run in interpret mode, as tests/test_pallas_ip.py
  runs it (one interpret-mode call): the kernel computes in float32, the
  plain version here in float64, so iterations are equal and U/X agree to
  5e-4, the objective to rtol 1e-4 (tests/test_pallas_ip.py:57-65).
- The plain version against the vmapped JAX ``solve_ocp`` (both float64):
  equal iterations, U/X to 1e-6 (tests/test_torch_ip_solver.py's tolerance).
- The gate against ``pallas_full_supported``, and NMPC's routing.
- The kernel's own C++ (model, dual numbers, solver template), built with the
  host C++ compiler: F, A, B against ``torch.func`` Jacobians to 1e-12
  (float64), and the per-scenario solve against the plain version in float64
  (equal iterations, U/X to 1e-9) and float32 (U to 5e-4 on the jointly
  converged scenarios). Skipped where there is no host C++ compiler.
- ``cuda`` tests: the kernel, built by nvcc, against the plain version on the
  card for the flagship and the host cases' models and costs.
"""
import dataclasses
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import hilo_mpc_tpu.ops.ip_solver as jip
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import pallas_full_supported, solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import codegen_cuda
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch
from hilo_mpc_tpu_torch.utils.parsing import _MATH_ENV

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
# the option set of tests/test_pallas_ip.py:_flagship
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 10,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}
STATE_BOUNDS = dict(x_lb=[0.0, 0.0], x_ub=[0.29, 0.8])


def _nmpc(cls, model, N, options=None, bounds=None, p=(1.0,) * 6, **setup_kw):
    """The flagship CSTR controller of tests/test_pallas_ip.py in either
    package; ``bounds`` replaces |u| <= 5 (an empty dict clears every bound)."""
    nmpc = cls(model)
    nmpc.horizon = N
    nx = model.n_x
    nmpc.quad_stage_cost.add_states(weights=[10.0] * nx,
                                    ref=[0.3, 0.18055, 0.2][:nx])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    if bounds is None:
        nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    else:
        nmpc.set_box_constraints(**bounds)
    nmpc.set_parameters(list(p))
    nmpc.setup(options={**KERNEL_OPTS, **(options or {})}, **setup_kw)
    return nmpc


def _port(N, options=None, bounds=None, dtype=F64, model=None, device=CPU, **kw):
    return _nmpc(NMPC, model or cstr_schaffner_and_zeitz(), N, options, bounds,
                 device=device, dtype=dtype, **kw)


def _x0s(B, seed):
    rng = np.random.default_rng(seed)
    return np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2))


def _plain(nmpc, args):
    return W.solve_ocp_full_reference(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                      nmpc._ip_opts)


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


# -- against the JAX kernel in interpret mode ----------------------------------

@pytest.fixture(scope="module")
def pallas_case():
    """The JAX kernel on 7 flagship scenarios, N=5 (B not a multiple of the
    tile: covers the lane padding), and the port's inputs for the same."""
    jn = _nmpc(JaxNMPC, jax_cstr(), 5)
    args = jn.prepare_batch(_x0s(7, 0))
    sol = solve_ocp_pallas_full(jn._funcs, jn._dims, jn._bounds, *args,
                                options=jn._ip_opts, tile_b=8)
    return to_torch(args, device=CPU), jax.tree.map(np.asarray, sol)


def test_plain_matches_pallas_interpret(pallas_case):
    args, jsol = pallas_case
    tn = _port(5)
    sol = to_numpy(_plain(tn, args))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, atol=5e-4)
    np.testing.assert_allclose(sol.objective, jsol.objective, rtol=1e-4)
    # the full (N, 2nu+2nx) layout: x rows are masked (fix_x0 at k=0, no x
    # bounds), so they read 1.0 in both
    assert sol.s.shape == jsol.s.shape == (7, 5, 6)
    for name in ("s", "z"):
        a, b = getattr(sol, name), getattr(jsol, name)
        np.testing.assert_array_equal(a[:, :, 2:], 1.0)
        np.testing.assert_array_equal(b[:, :, 2:], 1.0)
        np.testing.assert_allclose(a[:, :, :2], b[:, :, :2], atol=5e-4)


def test_host_kernel_matches_pallas_interpret(pallas_case):
    """The port's kernel code in float32 (built for the host) against the
    JAX kernel in float32."""
    _need_cxx()
    args, jsol = pallas_case
    tn = _port(5, dtype=torch.float32)
    sol = to_numpy(W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds,
                                         *[a.float() for a in args], tn._ip_opts))
    assert sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)
    np.testing.assert_allclose(sol.objective, jsol.objective, rtol=1e-4)


# -- against the vmapped JAX interior point -------------------------------------

GENERAL_CASES = {
    # state box + terminal rows active: x-row condensation and the terminal
    # slack/dual block (tests/test_pallas_ip.py:77-96)
    "state_terminal_bounds": dict(N=4, bounds=dict(u_lb=[-5.0], u_ub=[5.0],
                                                   **STATE_BOUNDS),
                                  options={"max_iter": 12}, B=5, seed=3),
    # no finite bound anywhere: no rows at all (tests/test_pallas_ip.py:155-168)
    "unconstrained": dict(N=5, bounds={}, options={}, B=4, seed=4),
}


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_plain_matches_general_path(case):
    c = GENERAL_CASES[case]
    jn = _nmpc(JaxNMPC, jax_cstr(), c["N"], c["options"], c["bounds"])
    args = jn.prepare_batch(_x0s(c["B"], c["seed"]))
    jsol = jax.jit(jax.vmap(lambda th, x0, Xi, Ui: jip.solve_ocp(
        jn._funcs, jn._dims, jn._bounds, th, x0, Xi, Ui, options=jn._ip_opts,
        fix_x0=True)))(*args)
    tn = _port(c["N"], c["options"], c["bounds"])
    sol = to_numpy(_plain(tn, to_torch(args, device=CPU)))
    np.testing.assert_array_equal(sol.converged, np.asarray(jsol.converged))
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), atol=1e-6)
    np.testing.assert_allclose(sol.X, np.asarray(jsol.X), atol=1e-6)
    if case == "state_terminal_bounds":
        conv = sol.converged
        assert conv.mean() > 0.7
        assert sol.X[conv, 1:, 0].max() <= 0.29 + 1e-3


# -- the gate ---------------------------------------------------------------------

def _pinned(b):
    lbu, ubu = b.lbu.clone(), b.ubu.clone()
    lbu[2], ubu[2] = 0.1, 0.1
    return b._replace(lbu=lbu, ubu=ubu)


GATE_CASES = {
    # name: (options, dims change, fix_x0, bounds change, the reason the
    # port's gate gives, None where both gates take the problem)
    "flagship": ({}, {}, True, None, None),
    "mehrotra": ({"mehrotra": True}, {}, True, None, "Mehrotra steps"),
    "n_linesearch": ({"n_linesearch": 6}, {}, True, None, "n_linesearch"),
    "convexify": ({"convexify": True}, {}, True, None, "convexify"),
    "generic_rows": ({}, {"n_h": 1}, True, None, "hard generic inequality rows"),
    "equality_rows": ({}, {"n_e": 1}, True, None, "equality rows"),
    "free_x0": ({}, {}, False, None, "a free initial state"),
    "pinned_controls": ({}, {}, True, _pinned, "pinned controls"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_supported_gate(case):
    opts, dims_kw, fix_x0, bnd_fn, reason = GATE_CASES[case]
    tn = _port(4, opts)
    jn = _nmpc(JaxNMPC, jax_cstr(), 4, opts)
    tdims = dataclasses.replace(tn._dims, **dims_kw)
    jdims = dataclasses.replace(jn._dims, **dims_kw)
    tb = tn._bounds if bnd_fn is None else bnd_fn(tn._bounds)
    jb = jn._bounds if bnd_fn is None else jip.OCPBounds(
        *[jnp.asarray(v) for v in to_numpy(tuple(tb))])
    problem, why = W.whole_ip_gate(tn._funcs, tdims, tb, tn._ip_opts, fix_x0)
    if reason is None:
        assert problem is not None and why is None, why
    else:
        assert problem is None and reason in why, why
    assert pallas_full_supported(jdims, jb, jn._ip_opts, fix_x0) is (reason is None)


@pytest.mark.parametrize("option", ["record_iterates", "parallel_riccati"])
def test_supported_gate_options(option):
    tn = _port(4)
    opts = dataclasses.replace(tn._ip_opts, **{option: True})
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, opts, True)
    assert problem is None and why == "record_iterates or parallel_riccati"


def _callable_cstr():
    m = Model(name="CSTR")
    m.set_dynamical_states(["x_1", "x_2"]).set_inputs("u")
    m.set_parameters(["a_1", "b_1", "a_2", "b_2", "g", "E"])

    def ode(x, u, p):
        r = (1 - x[..., 0]) * torch.exp(-p[..., 5] / (1 + x[..., 1]))
        return [-p[..., 0] * x[..., 0] + p[..., 1] * r,
                -p[..., 2] * x[..., 1] + p[..., 3] * r + p[..., 4] * u[..., 0]]
    return m.set_dynamical_equations(ode)


def _dsl(text):
    return Model().set_equations(text)


UNEMITTABLE = {
    "callable": _callable_cstr,
    "unknown_function": lambda: _dsl("dx/dt = foo(x(t)) + u(k)"),
    "comparison": lambda: _dsl("dx/dt = (x(t) > 0) * u(k)"),
    "modulo": lambda: _dsl("dx/dt = x(t) % 2 + u(k)"),
}


@pytest.mark.parametrize("case", sorted(UNEMITTABLE))
def test_unemittable_models(case):
    """The DSL emitter refuses these models; the gate takes the callable one
    through the trace (ops/codegen_fx.py)."""
    model = UNEMITTABLE[case]()
    with pytest.raises(NotImplementedError):
        codegen_cuda.emit_model(model)
    assert codegen_cuda.model_emit_error(model)
    if case == "callable":
        tn = _port(4, model=model)
        problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts,
                                       True)
        assert problem is not None and "codegen_fx.py" in problem.text, why
        problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, 8, tn._ip_opts)
        assert "codegen_fx.py" in problem.text


def test_dsl_table_is_covered():
    """Every function of the DSL table has a C++ counterpart in dual.cuh."""
    funcs = {n for n, v in _MATH_ENV.items() if callable(v)}
    assert funcs == set(codegen_cuda._FUNCS)


def test_numbers_share_one_build():
    """Controllers that differ only in numbers (weights, bounds, scaling,
    references, IP constants) emit the same source and other prm values."""
    a = _port(4)
    b = _nmpc(NMPC, cstr_schaffner_and_zeitz(), 4, {"tol": 1e-5},
              dict(u_lb=[-2.0], u_ub=[3.0]), device=CPU, dtype=F64)
    b.quad_stage_cost.terms[0].W[:] = np.diag([4.0, 7.0])
    b.set_scaling(u_scaling=2.0).setup(options={**KERNEL_OPTS, "tol": 1e-5},
                                       device=CPU, dtype=F64)
    pa, pb = (W.whole_ip_problem(n._funcs, n._dims, n._bounds, 8, n._ip_opts)
              for n in (a, b))
    assert pa.text == pb.text
    assert pa.prm.shape == pb.prm.shape and not np.array_equal(pa.prm, pb.prm)
    c = _port(4, bounds=dict(u_lb=[-5.0], u_ub=[5.0], **STATE_BOUNDS))
    pc = W.whole_ip_problem(c._funcs, c._dims, c._bounds, 8, c._ip_opts)
    assert pc.text != pa.text            # another row pattern is structure


# -- NMPC routing -------------------------------------------------------------------

def test_solve_batch_fn_warns_on_ineligible_problem():
    tn = _port(4, {"pallas_full": True, "mehrotra": True})
    args = tn.prepare_batch(_x0s(3, 5))
    with pytest.warns(UserWarning, match="pallas_full"):
        fn = tn.solve_batch_fn()
    ref = _port(4, {"mehrotra": True})
    for a, b in zip(fn(*args), ref.solve_batch_fn()(*args)):
        assert torch.equal(a, b)


def test_solve_batch_fn_routes_pallas_full():
    """pallas_full=True on an eligible problem: the whole-solve path (on CPU
    tensors its plain version, in the controller's dtype); no Riccati
    kernel, no general path; warm iterations <= cold."""
    tn = _port(4, {"pallas_full": True, "pallas_tile": 8})
    args = tn.prepare_batch(_x0s(4, 2))
    n_ric, n_full = riccati_lq_cuda.launches, W.solve_ocp_full_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sol = tn.solve_batch_fn()(*args)
    assert sol.U.dtype == F64 and bool(sol.converged.all())
    ref = _plain(tn, args)
    for a, b in zip(sol, ref):
        assert torch.equal(a, b)
    X_w = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
    X_w[:, 0] = args[1]
    U_w = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)
    sol_w = tn.solve_batch_fn(warm=True)(args[0], args[1], X_w, U_w)
    assert bool(sol_w.converged.all())
    assert bool((sol_w.iterations <= sol.iterations).all())
    assert riccati_lq_cuda.launches == n_ric
    assert W.solve_ocp_full_cuda.launches == n_full


def test_cpu_tensors_take_the_plain_version():
    tn = _port(4)
    args = tn.prepare_batch(_x0s(3, 1))
    n0 = W.solve_ocp_full_cuda.launches
    out = W.solve_ocp_full_cuda(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    ref = _plain(tn, args)
    assert W.solve_ocp_full_cuda.launches == n0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


# -- the generated C++ on the host --------------------------------------------------

ALL_FUNCTIONS = """
dx_1/dt = exp(-a*x_1(t)) + log(2 + x_2(t)**2) + ln(3 + x_3(t)) + log10(4 + x_1(t)*x_1(t)) + sqrt(1 + x_2(t)**2) + sin(x_1(t))*cos(x_2(t)) + tan(0.3*x_3(t)) + w*u(k)
dx_2/dt = asin(0.5*tanh(x_1(t))) + arcsin(0.2*x_2(t)) + acos(0.3*sin(x_3(t))) + arccos(0.1*x_1(t)) + atan(x_2(t)) + arctan(x_3(t)*u(k)) + atan2(x_1(t), 2 + x_2(t)**2) + arctan2(1.5, 2 + x_3(t)) - c
dx_3/dt = sinh(0.5*x_1(t)) + cosh(0.3*x_2(t)) + tanh(x_3(t)) + asinh(x_1(t)) + arsinh(u(k)) + acosh(2 + x_2(t)**2) + arcosh(3 + x_3(t)**2) + atanh(0.5*tanh(x_1(t))) + artanh(0.2*tanh(u(k))) + abs(x_1(t) - x_2(t)) + fabs(u(k)) + sign(x_3(t))*x_3(t) + fmin(x_1(t), x_2(t)) + fmax(x_2(t), 0.1) + minimum(x_3(t), u(k)) + maximum(0.2, x_1(t)) + floor(x_1(t)) + ceil(x_2(t)) + erf(x_3(t)) + pi*r + x_1(t)**3 + (1 + x_2(t)**2)**0.5 + (2 + x_3(t))**(-1) + 2**x_1(t) + (2 + x_1(t)**2)**(0.5*u(k)) + 0.01*t + fmin(x_2(t), inf)
r = x_1(t)*x_2(t) - c
c = 0.25
"""


def _discrete_pendulum():
    m = Model(discrete=True)
    return m.set_equations("x_1(k+1) = x_1(k) + 0.1*x_2(k)\n"
                           "x_2(k+1) = x_2(k) + 0.1*(u(k) - a*sin(x_1(k)))")


JACOBIAN_MODELS = {
    "cstr": (cstr_schaffner_and_zeitz, (1.0,) * 6, {}),
    "all_functions": (lambda: _dsl(ALL_FUNCTIONS), (0.7, 1.3), {}),
    "discrete": (_discrete_pendulum, (1.0,), {"integration_method": "discrete"}),
    "state_space": (lambda: Model(discrete=True).set_state_space(
        A=[[1.0, 0.1], [0.0, 1.0]], B=[[0.005], [0.1]]), (),
        {"integration_method": "discrete"}),
    "rk38_substeps": (cstr_schaffner_and_zeitz, (1.0,) * 6,
                      {"integration_method": "rk38", "substeps": 3}),
}


@pytest.mark.parametrize("case", sorted(JACOBIAN_MODELS))
def test_dual_jacobians_match_torch_func(case):
    """F and [A | B] of the emitted step (one dual-number pass) against the
    port's own step and its torch.func Jacobians, float64, to 1e-12."""
    _need_cxx()
    make, p, opts = JACOBIAN_MODELS[case]
    model = make()
    tn = _port(3, opts, bounds=dict(u_lb=[-1.0], u_ub=[1.0]), model=model, p=p)
    nx, nu, R = model.n_x, model.n_u, 16
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.uniform(-0.8, 0.8, (R, nx)))
    us = torch.as_tensor(rng.uniform(-0.8, 0.8, (R, nu)))
    th = torch.as_tensor(np.tile(np.r_[0.3, 0.1, p], (R, 1)))
    F, AB = W.dyn_lin_host(tn._funcs, tn._dims, tn._bounds, xs, us, th)
    dyn = tn._funcs.dyn
    JA, JB = vmap(jacfwd(dyn, argnums=(0, 1)))(xs, us, th)
    torch.testing.assert_close(F, dyn(xs, us, th), rtol=0, atol=1e-12)
    torch.testing.assert_close(AB[..., :nx], JA, rtol=0, atol=1e-12)
    torch.testing.assert_close(AB[..., nx:], JB, rtol=0, atol=1e-12)


HOST_CASES = {
    "flagship": dict(N=5, B=6, seed=0),
    "state_terminal_bounds": dict(N=4, B=5, seed=3, options={"max_iter": 12},
                                  bounds=dict(u_lb=[-5.0], u_ub=[5.0], **STATE_BOUNDS)),
    "unconstrained": dict(N=5, B=4, seed=4, bounds={}),
    # scaling, a full weight matrix with a runtime reference, a terminal cost
    # with an input term (seen at u = 0), another tableau with substeps
    "scaled_tracking_rk38": dict(N=4, B=4, seed=6, scaled=True,
                                 options={"integration_method": "rk38",
                                          "substeps": 2}),
}


def _host_case(c, dtype, device=CPU):
    tn = _port(c["N"], c.get("options"), c.get("bounds"), dtype=dtype,
               device=device)
    ref = None
    if c.get("scaled"):
        tn.quad_stage_cost.terms[0].W[:] = [[10.0, 1.0], [0.5, 10.0]]
        tn.quad_stage_cost.terms[0].trajectory_tracking = True
        tn.quad_stage_cost.terms[0].ref = None
        tn.quad_terminal_cost.add_states(weights=[5.0, 3.0], ref=[0.3, 0.18])
        tn.quad_terminal_cost.add_inputs(weights=0.2, ref=[0.1])
        tn.set_scaling(x_scaling=[0.5, 0.2], u_scaling=2.0)
        tn.set_box_constraints(x_lb=[0.0, -1.0], x_ub=[0.4, 1.0])
        tn.setup(options={**KERNEL_OPTS, **c["options"]}, device=device, dtype=dtype)
        ref = [0.3, 0.18055]
    return tn, tn.prepare_batch(_x0s(c["B"], c["seed"]), ref=ref)


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_kernel_matches_plain_f64(case):
    """The kernel's per-scenario solve (csrc/whole_ip.cuh with the emitted
    problem) against the plain version in float64: equal iterations and
    flags, U/X to 1e-9, slacks and duals of the converged scenarios to
    1e-9 relative."""
    _need_cxx()
    tn, args = _host_case(HOST_CASES[case], F64)
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    assert torch.equal(k.iterations, r.iterations)
    assert torch.equal(k.converged, r.converged) and torch.equal(k.status, r.status)
    assert bool(r.converged.float().mean() > 0.7)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-9)
    c = r.converged
    for name in ("s", "z", "sN", "zN", "lam", "objective", "kkt_error", "mu"):
        torch.testing.assert_close(getattr(k, name)[c], getattr(r, name)[c],
                                   rtol=1e-9, atol=1e-12, msg=name)


@pytest.mark.parametrize("case", ["flagship", "state_terminal_bounds"])
def test_host_kernel_matches_plain_f32(case):
    _need_cxx()
    tn, args = _host_case(HOST_CASES[case], torch.float32)
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    both = k.converged & r.converged
    assert bool(both.float().mean() > 0.7)
    torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=5e-4)


# -- on the card --------------------------------------------------------------------

def _card_case(case, dtype):
    """(controller, inputs) of one card check, on the card."""
    if case == "flagship":
        tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), 20, device="cuda", dtype=dtype)
        return tn, tn.prepare_batch(_x0s(1024, 0))
    if case in HOST_CASES:
        return _host_case(HOST_CASES[case], dtype, device="cuda")
    make, p, opts = JACOBIAN_MODELS[case]
    model = make()
    # two iterations: the step already depends on every emitted derivative
    tn = _port(3, {**opts, "max_iter": 2}, bounds=dict(u_lb=[-1.0], u_ub=[1.0]),
               model=model, p=p, dtype=dtype, device="cuda")
    x0 = np.random.default_rng(2).uniform(-0.5, 0.5, (64, model.n_x))
    return tn, tn.prepare_batch(x0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    ("flagship", "float32"), ("flagship", "float64"),
    ("state_terminal_bounds", "float64"), ("scaled_tracking_rk38", "float64"),
    ("all_functions", "float64"), ("state_space", "float64"),
    ("discrete", "float64")])
def test_kernel_matches_plain_on_card(case, dtype):
    """The kernel (built by nvcc for each problem) against its plain version:
    float64 equal iterations and U to 1e-9; float32 U to 5e-4 on the jointly
    converged scenarios."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    tn, args = _card_case(case, dt)
    n0 = W.solve_ocp_full_cuda.launches
    k = W.solve_ocp_full_cuda(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    torch.cuda.synchronize()
    assert W.solve_ocp_full_cuda.launches == n0 + 1
    both = k.converged & r.converged
    if dt == F64:
        assert torch.equal(k.iterations, r.iterations)
        # a scenario stopped by max_iter far from its solution can amplify
        # the card's fused multiply-adds: compare those of the two-iteration
        # cases and the converged ones of the others
        sel = slice(None) if case in JACOBIAN_MODELS else both
        torch.testing.assert_close(k.U[sel], r.U[sel], rtol=0, atol=1e-9)
        torch.testing.assert_close(k.X[sel], r.X[sel], rtol=0, atol=1e-9)
    else:
        assert bool(both.float().mean() >= 0.97)
        torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=5e-4)
