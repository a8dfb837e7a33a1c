"""PyTorch port: the whole-solve kernel on traced problems (CPU, float64).

A problem that ops/codegen_cuda.py cannot write (a model given as a Python
callable, a generic cost, a measurement term, a soft generic constraint, a
path-following reference) is traced with ``make_fx`` by ops/codegen_fx.py
and written as C++ for csrc/whole_ip.cuh; csrc/traced.cuh takes the costs'
derivatives by nested dual numbers. Here the kernel's own code runs on the
CPU through its host build (``solve_ocp_full_host``, ``dyn_lin_host``,
``cost_derivs_host``):

- one model and cost that trace to every op of the emitter's table
  (``codegen_fx.OPS``, an in-place write among them): F and [A | B], and
  the stage and terminal costs' gradients and Hessians (an x-u cross block
  among them), against ``torch.func`` on the same functions, to 1e-12;
- the msd of tools/tpu_validation.py:55-80 as a callable with its soft box,
  the CSTR with a generic cost and a terminal measurement term, and golden
  pathfollow_soft's controller: the host kernel against the plain version
  (equal iterations, 1e-12), and the golden's 25 steps replayed through the
  host kernel (< 1e-4);
- the plain version against the JAX kernel ``solve_ocp_pallas_full`` in
  interpret mode (float32 there: 5e-4, equal iterations) on the msd and the
  generic-cost CSTR;
- the flagship through both emitters (1e-12, equal iterations) and their
  operation counts (within 6%); numbers share one emitted text;
- refusals: an op outside the table (``torch.linalg.solve``) and a branch
  on a value decline with a warning naming the cause, and the answer is the
  general path's bits;
- ``cuda``: the msd kernel against its plain version on the card.
"""
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd

from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import pallas_full_supported, solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import codegen_fx
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch
from test_torch_path_following import GOLDEN as GOLDEN_PF
from test_torch_path_following import port_pathfollow_soft

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
# pure Newton steps, as the whole-solve kernel takes them
# (tests/test_pallas_ip.py:_flagship)
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 20,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}
TIGHT = {**KERNEL_OPTS, "tol": 1e-8, "max_iter": 40}
PF_NEWTON = {"dt": 0.1, "max_iter": 80, "convexify": False, "n_linesearch": 1,
             "mehrotra": False}


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


# -- the problems ----------------------------------------------------------------

def msd(jx, N, options=TIGHT, device=CPU, dtype=F64):
    """tools/tpu_validation.py:55-80's mass-spring-damper (a callable model)
    with its soft |pos| <= 1 and without its hard row."""
    m = (JaxModel if jx else Model)(name="msd")
    m.set_dynamical_states(["pos", "vel"])
    m.set_inputs("f")
    if jx:
        m.set_dynamical_equations(
            lambda x, u: jnp.array([x[1], -0.5 * x[0] - 0.2 * x[1] + u[0]]))
    else:
        m.set_dynamical_equations(lambda x, u: torch.stack(
            [x[..., 1], -0.5 * x[..., 0] - 0.2 * x[..., 1] + u[..., 0]], dim=-1))
    nmpc = (JaxNMPC if jx else NMPC)(m)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[4.0, 1.0], ref=[0.9, 0.0])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-3.0], u_ub=[3.0], x_ub=[1.0, np.inf],
                             x_lb=[-1.0, -np.inf], x_soft=True)
    if jx:
        nmpc.setup(options=options)
    else:
        nmpc.setup(options=options, device=device, dtype=dtype)
    return nmpc


def cstr_generic(jx, N, options=TIGHT, weight=1.0, target=0.3):
    """The flagship CSTR with a generic stage cost (x_1 - target)^4 and a
    terminal measurement term (y = x_2 against 0.18)."""
    nmpc = (JaxNMPC if jx else NMPC)((jax_cstr if jx else cstr_schaffner_and_zeitz)())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    if jx:
        nmpc.stage_cost.cost = lambda x: (x[0] - target) ** 4
    else:
        nmpc.stage_cost.cost = lambda x: (x[..., 0] - target) ** 4
    nmpc.quad_terminal_cost.add_measurements(weights=weight, ref=[0.18])
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    if jx:
        nmpc.setup(options=options)
    else:
        nmpc.setup(options=options, device=CPU, dtype=F64)
    return nmpc


def flagship(N):
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0], x_ub=[0.29, 0.8],
                             x_lb=[0.0, 0.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options=TIGHT, device=CPU, dtype=F64)
    return nmpc


def _cstr_x0s(B, seed):
    return np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(seed).standard_normal((B, 2))


PROBLEMS = {
    "msd": (lambda: msd(False, 10), lambda: 0.6 + 0.3 * np.random.default_rng(1)
            .standard_normal((4, 2))),
    "cstr_generic": (lambda: cstr_generic(False, 8), lambda: _cstr_x0s(3, 2)),
    "pathfollow_soft": (lambda: port_pathfollow_soft(options={**PF_NEWTON, "tol": 1e-9}),
                        lambda: 0.1 * np.random.default_rng(3).standard_normal((3, 2))),
}


@pytest.fixture(scope="module")
def problems():
    return {name: build() for name, (build, _) in PROBLEMS.items()}


def _plain(nmpc, args):
    return W.solve_ocp_full_reference(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                      nmpc._ip_opts)


def _host(nmpc, args):
    return W.solve_ocp_full_host(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                 nmpc._ip_opts)


# -- every op of the table ------------------------------------------------------------

_W = torch.tensor([[0.3, -0.2, 0.1], [0.05, 0.4, -0.3]], dtype=F64)
_T = torch.tensor([[2.0, 0.3, -0.1], [0.2, 1.5, 0.4], [-0.3, 0.1, 1.8]], dtype=F64)


def _triangular_ops(x):
    """The ops the SMPC surrogate's trace adds (control/smpc.py): triangular
    solves in every form (a factor that depends on x among them), the
    identity, both triangles, scalar tensors, the raw view and zeros."""
    lo = torch.tril(_T.to(x.dtype), diagonal=-1) + 2.0 * torch.eye(3, dtype=x.dtype)
    up = torch.triu(_T.to(x.dtype))
    lo_x = lo * (1 + 0.1 * x[..., :1, None] ** 2)
    row = x[..., None, :]                                   # (..., 1, 3)
    col = x[..., :, None]                                   # (..., 3, 1)
    parts = [
        torch.linalg.solve_triangular(up, row, upper=True, left=False),
        torch.linalg.solve_triangular(lo, row, upper=False, left=False).mT,
        torch.linalg.solve_triangular(lo_x, col, upper=False),
        torch.linalg.solve_triangular(up, col, upper=True, unitriangular=True),
    ]
    s = torch.cat([p.reshape(p.shape[:-2] + (3,)) for p in parts], -1)
    flat = torch.ops.aten._unsafe_view(s.contiguous(), s.shape[:-1] + (4, 3))
    zero = torch.ops.aten._efficientzerotensor([3], dtype=x.dtype)
    return (flat.sum(-2) * torch.scalar_tensor(0.25, dtype=x.dtype)
            * torch.scalar_tensor(2.0, dtype=x.dtype) + zero.clone())


def _all_ops_ode(x, u, p):
    x1, x2, x3, u1 = x[..., 0], x[..., 1], x[..., 2], u[..., 0]
    a = (torch.exp(-0.5 * x1) + torch.log(2 + x2 ** 2) + torch.log10(3 + x3 ** 2)
         + torch.sqrt(1 + x1 ** 2))
    b = (torch.sin(x1) * torch.cos(x2) + torch.tan(0.3 * x3)
         + torch.asin(0.5 * torch.tanh(x1)) + torch.acos(0.3 * torch.sin(x2)))
    c = (torch.atan(x3) + torch.sinh(0.5 * x1) + torch.cosh(0.3 * x2) + torch.asinh(x3)
         + torch.acosh(2 + x1 ** 2) + torch.atanh(0.5 * torch.tanh(x2)))
    d = (torch.abs(x1 - x2) + torch.sign(x3) * x3 + torch.floor(x1) + torch.ceil(x2)
         + torch.erf(x3))
    e = torch.maximum(x1, x2) + torch.minimum(x3, u1) + torch.atan2(x1, 2 + x2 ** 2)
    f = (torch.pow(2 + x1 ** 2, 0.5 * u1) + 2.0 ** x2 + torch.reciprocal(2 + x3 ** 2)
         + torch.rsqrt(3 + x1 ** 2))
    g = (torch.where((x1 > 0) & (x2 <= 0.5) | ~(x3 < -1), x1 * x2, -x3)
         + torch.where(x1 >= x2, 0.1 * x1, 0.2 * x2))
    y = x @ _W.T                                                    # mm
    y = y + torch.nn.functional.linear(x, _W, torch.tensor([0.01, -0.02], dtype=x.dtype))
    y = y + torch.bmm(x.reshape(1, 1, 3), _W.transpose(0, 1).unsqueeze(0)).squeeze(1)
    h = (y.sum(-1) + y.mean(-1) + 0.1 * torch.mv(_W, x[0]).sum()
         + 0.1 * torch.dot(_W[0], x[0])
         + (torch.tensor([0.5, 0.25], dtype=torch.float32).to(x.dtype) * x[..., :2]).sum(-1))
    k = torch.where(torch.logical_and(x1 == x2, torch.logical_not(x3 != 0))
                    | torch.logical_or(x1 > 1, x2 < -1), 1 - x1, x2)
    out = torch.stack([a + b - 0.1 * c + p[..., 0] * u1,
                       0.1 * d - e + 0.05 * f + h,
                       g + 0.01 * torch.cat([x, u], -1).sum(-1)], -1)
    z = out.clone()
    z[..., 1] = z[..., 1] * 0.5                           # in place: select_scatter
    z[..., :1] = z[..., :1] - 0.1 * x[..., 2:3]           # slice_scatter
    z = z + 0.01 * k.unsqueeze(-1) + 0.01 * _triangular_ops(x)
    return (z / torch.ones_like(z) + torch.zeros(3, dtype=x.dtype)
            + torch.full((3,), 0.0, dtype=x.dtype) + torch.ones(3, dtype=x.dtype)
            - torch.full_like(z, 1.0) + x.new_zeros(3) + x.new_ones(3)
            - x.new_full((3,), 1.0))


@pytest.fixture(scope="module")
def all_ops():
    m = Model(name="all_ops")
    m.set_dynamical_states(["x1", "x2", "x3"])
    m.set_inputs("u")
    m.set_parameters("p")
    m.set_dynamical_equations(_all_ops_ode)
    nmpc = NMPC(m)
    nmpc.horizon = 3
    nmpc.quad_stage_cost.add_states(weights=[1.0, 2.0, 3.0], ref=[0.1, 0.2, 0.3])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    # x-u coupled: the traced problem sets CROSS
    nmpc.stage_cost.cost = lambda x, u: (0.1 * torch.exp(x[..., 0] * u[..., 0])
                                         + (x[..., 1] - 0.3) ** 4)
    nmpc.terminal_cost.cost = lambda x: torch.sin(x[..., 0] * x[..., 2])
    nmpc.set_box_constraints(u_lb=[-1.0], u_ub=[1.0])
    nmpc.set_parameters([0.7])
    # one explicit Euler stage keeps the host build small
    nmpc.setup(options={**KERNEL_OPTS, "integration_method": "euler"}, device=CPU,
               dtype=F64)
    return nmpc


def test_every_op_of_the_table_is_traced(all_ops):
    f, nt = all_ops._funcs, all_ops._funcs.source.n_theta
    x, u, th = torch.zeros(1, 3, dtype=F64), torch.zeros(1, 1, dtype=F64), \
        torch.zeros(1, nt, dtype=F64)
    seen = set()
    for fn, args in ((f.dyn, (x, u, th)), (f.stage_cost, (x, u, th)),
                     (f.term_cost, (x, th))):
        gm = codegen_fx.trace(fn, *args)
        seen |= {codegen_fx._op_name(n.target) for n in gm.graph.nodes
                 if n.op == "call_function"}
    assert seen == set(codegen_fx.OPS)
    problem = W.whole_ip_problem(f, all_ops._dims, all_ops._bounds, nt, all_ops._ip_opts)
    assert "codegen_fx.py" in problem.text
    assert "static constexpr bool CROSS = true;" in problem.text


def test_all_ops_derivatives_match_torch_func(all_ops):
    """F, [A | B] and the costs' g and H of the emitted problem against
    torch.func on the controller's own functions, at seeded points away
    from the kinks, float64, 1e-12."""
    _need_cxx()
    f, d, b = all_ops._funcs, all_ops._dims, all_ops._bounds
    R, nt = 8, f.source.n_theta
    rng = np.random.default_rng(5)
    xs = torch.as_tensor(rng.uniform(-0.8, 0.8, (R, 3)))
    us = torch.as_tensor(rng.uniform(-0.8, 0.8, (R, 1)))
    th = torch.as_tensor(np.concatenate([rng.uniform(0, 1, (R, 1)), np.full((R, 1), 0.1),
                                         np.full((R, 1), 0.7)], axis=1))
    assert th.shape[1] == nt
    F, AB = W.dyn_lin_host(f, d, b, xs, us, th)
    g, H, gN, HN = W.cost_derivs_host(f, d, b, xs, us, th)
    for r in range(R):
        x, u, t = xs[r], us[r], th[r]

        def dyn(z):
            return f.dyn(z[None, :3], z[None, 3:], t[None])[0]

        def stage(z):
            return f.stage_cost(z[None, :3], z[None, 3:], t[None])[0]

        def term(z):
            return f.term_cost(z[None], t[None])[0]
        z = torch.cat([x, u])
        torch.testing.assert_close(F[r], dyn(z), rtol=0, atol=1e-12)
        torch.testing.assert_close(AB[r], jacfwd(dyn)(z), rtol=0, atol=1e-12)
        torch.testing.assert_close(g[r], grad(stage)(z), rtol=0, atol=1e-12)
        torch.testing.assert_close(H[r], hessian(stage)(z), rtol=0, atol=1e-12)
        torch.testing.assert_close(gN[r], grad(term)(x), rtol=0, atol=1e-12)
        torch.testing.assert_close(HN[r], hessian(term)(x), rtol=0, atol=1e-12)
    assert float(H[:, 3, :3].abs().max()) > 1e-3            # the cross block


# -- the host kernel against the plain version ---------------------------------------

@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_host_kernel_matches_plain(problems, name):
    _need_cxx()
    nmpc = problems[name]
    args = nmpc.prepare_batch(PROBLEMS[name][1]())
    ok, why = W.whole_ip_gate(nmpc._funcs, nmpc._dims, nmpc._bounds, nmpc._ip_opts, True)
    assert ok is not None and "codegen_fx.py" in ok.text, why
    k, r = _host(nmpc, args), _plain(nmpc, args)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations)
    assert torch.equal(k.converged, r.converged) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.objective, r.objective, rtol=1e-12, atol=0)
    if name == "msd":
        assert bool((r.X[:, 1:, 0] > 1.0).any())          # the soft bound is active


def test_golden_pathfollow_soft_replays_through_the_host_kernel(problems):
    """tests/golden/pathfollow_soft.npz, every solve through the host build
    of the kernel (float64, pure Newton steps): max|u - u_gold| < 1e-4."""
    _need_cxx()
    tn = port_pathfollow_soft(options={**PF_NEWTON, "tol": 1e-9})
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is not None, why
    launch = W.WholeIPLaunch(problem, tn._dims, F64, CPU)
    tn._solve = lambda th, x0, X, U, mu0, options=None: launch(th, x0, X, U, mu0)
    data = np.load(GOLDEN_PF)
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = tn.optimize(data["X_meas"][k])
        assert tn.stats["converged"], (k, tn.stats)
        devs.append(np.abs(u - data["U_gold"][k]).max())
    assert max(devs) < 1e-4, devs


# -- the plain version against the JAX kernel -------------------------------------------

JAX_CASES = {
    "msd": (lambda jx: msd(jx, 3, KERNEL_OPTS),
            lambda: 0.6 + 0.2 * np.random.default_rng(1).standard_normal((4, 2))),
    "cstr_generic": (lambda jx: cstr_generic(jx, 3, KERNEL_OPTS), lambda: _cstr_x0s(4, 0)),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_plain_matches_pallas_interpret(name):
    """The JAX kernel runs its traced model and cost in interpret mode
    (float32); the port's plain version in float64: equal iterations, U and
    X to 5e-4 (tests/test_pallas_ip.py:57-65)."""
    build, x0s = JAX_CASES[name]
    jn, tn = build(True), build(False)
    assert pallas_full_supported(jn._dims, jn._bounds, jn._ip_opts, True)
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is not None, why
    args = jn.prepare_batch(x0s())
    jsol = jax.tree.map(np.asarray, solve_ocp_pallas_full(
        jn._funcs, jn._dims, jn._bounds, *args, options=jn._ip_opts, tile_b=8))
    sol = to_numpy(_plain(tn, to_torch(args, device=CPU)))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, atol=5e-4)


# -- the two emitters and numbers ------------------------------------------------------

def test_flagship_through_both_emitters():
    """The flagship (with state and terminal bounds) from the DSL emitter and
    from the trace: equal iterations, U and X to 1e-12 on the host build."""
    _need_cxx()
    nmpc = flagship(6)
    args = nmpc.prepare_batch(_cstr_x0s(5, 3))
    nt = args[0].shape[2]
    bnd = tuple(b.numpy() for b in nmpc._bounds)
    dsl = W.whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds, nt, nmpc._ip_opts)
    traced = codegen_fx.emit_fx_problem(nmpc._funcs, nmpc._dims, bnd, nt, nmpc._ip_opts)
    assert "codegen_cuda.py" in dsl.text and "codegen_fx.py" in traced.text
    assert dsl.stage_rows == traced.stage_rows and dsl.term_rows == traced.term_rows
    a, b = (W.WholeIPLaunch(p, nmpc._dims, F64, CPU)(*args, nmpc._ip_opts.mu_init)
            for p in (dsl, traced))
    assert torch.equal(a.converged, b.converged) and torch.equal(a.iterations, b.iterations)
    assert int(a.converged.sum()) >= 4
    torch.testing.assert_close(a.U, b.U, rtol=0, atol=1e-12)
    torch.testing.assert_close(a.X, b.X, rtol=0, atol=1e-12)


def test_numbers_share_one_text():
    """Controllers that differ only in a cost constant, a weight or a bound
    emit one text with other numbers in prm."""
    def emit(n):
        return W.whole_ip_problem(n._funcs, n._dims, n._bounds, n._funcs.source.n_theta,
                                  n._ip_opts)
    a = emit(cstr_generic(False, 4))
    b = emit(cstr_generic(False, 4, weight=3.0, target=0.25))
    assert a.text == b.text and not np.array_equal(a.prm, b.prm)
    c, d = emit(msd(False, 4)), emit(msd(False, 4, options={**TIGHT, "tol": 1e-6}))
    assert c.text == d.text and not np.array_equal(c.prm, d.prm)


@pytest.mark.parametrize("N", [6, 20])
def test_operation_count_agrees_with_the_dsl_route(N):
    """The flagship's operations per scenario-iteration (the bound of
    chip_smoke.py's whole_ip_traced row) counted from the trace lie within
    6% of the DSL route's count of the same problem: the step and the costs
    over the derivative lanes they carry, not over the dense passes the
    kernel runs (5.0% above at N = 20: the costs' derivatives by lanes
    against the DSL's closed form)."""
    nmpc = flagship(N)
    nt = nmpc._funcs.source.n_theta
    bnd = tuple(b.numpy() for b in nmpc._bounds)
    dsl = W.whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds, nt, nmpc._ip_opts)
    traced = codegen_fx.emit_fx_problem(nmpc._funcs, nmpc._dims, bnd, nt, nmpc._ip_opts)
    assert "codegen_cuda.py" in dsl.text and "codegen_fx.py" in traced.text
    assert abs(traced.flops / dsl.flops - 1.0) <= 0.06, (traced.flops, dsl.flops)


# -- refusals ---------------------------------------------------------------------------

def _solve_model(x, u):
    A = torch.stack([torch.stack([1.0 + x[..., 0] ** 2, x[..., 1]], -1),
                     torch.stack([torch.zeros_like(x[..., 0]),
                                  torch.ones_like(x[..., 0])], -1)], -2)
    return torch.linalg.solve(A, torch.stack([x[..., 1], u[..., 0]], -1))


def _branch_model(x, u):
    if float(x[..., 0].sum()) > 0:
        return torch.stack([x[..., 1], u[..., 0]], -1)
    return torch.stack([-x[..., 1], u[..., 0]], -1)


REFUSED = {"linalg_solve": (_solve_model, "linalg_solve"),
           "value_branch": (_branch_model, "_local_scalar_dense")}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_traces_take_the_general_path(case):
    fn, why = REFUSED[case]

    def build(options):
        m = Model(name=case)
        m.set_dynamical_states(["a", "b"])
        m.set_inputs("u")
        m.set_dynamical_equations(fn)
        nmpc = NMPC(m)
        nmpc.horizon = 3
        nmpc.quad_stage_cost.add_states(weights=[1.0, 1.0], ref=[0.2, 0.0])
        nmpc.quad_stage_cost.add_inputs(weights=0.1)
        nmpc.set_box_constraints(u_lb=[-1.0], u_ub=[1.0])
        nmpc.setup(options=options, device=CPU, dtype=F64)
        return nmpc
    whole, general = build({**KERNEL_OPTS, "pallas_full": True}), build(KERNEL_OPTS)
    args = general.prepare_batch(np.array([[0.3, 0.1], [0.5, -0.2]]))
    n_ric = riccati_lq_cuda.launches
    with pytest.warns(UserWarning, match=why):
        fn_whole = whole.solve_batch_fn()
    for a, b in zip(fn_whole(*args), general.solve_batch_fn()(*args)):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric              # CPU: no launch at all
    with pytest.raises(NotImplementedError, match=why):
        W.whole_ip_problem(whole._funcs, whole._dims, whole._bounds,
                           whole._funcs.source.n_theta, whole._ip_opts)


# -- on the card ------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_traced_kernel_matches_plain_on_card(dtype):
    """The msd through pallas_full on the card (one whole-solve launch, no
    Riccati launch, no warning) against its plain version, N=20, B=1024:
    float64 equal iterations and U to 1e-9, float32 U to 5e-4 on the jointly
    converged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    opts = {**KERNEL_OPTS, "max_iter": 25}
    whole = msd(False, 20, {**opts, "pallas_full": True}, device="cuda", dtype=dt)
    args = whole.prepare_batch(0.2 * np.random.default_rng(1).standard_normal((1024, 2)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = whole.solve_batch_fn()
    n_full, n_ric = W.solve_ocp_full_cuda.launches, riccati_lq_cuda.launches
    k = fn(*args)
    assert (W.solve_ocp_full_cuda.launches - n_full, riccati_lq_cuda.launches - n_ric) \
        == (1, 0)
    problem = whole._wip["problem"]
    launch = W.WholeIPLaunch(problem, whole._dims, dt, args[0].device)
    k = launch(*args, whole._mu_cold)
    r = W.solve_ocp_full_reference(whole._funcs, whole._dims, whole._bounds, *args,
                                   whole._ip_opts)
    torch.cuda.synchronize()
    both = k.converged & r.converged
    assert float(both.float().mean()) >= 0.97
    if dt == torch.float64:
        assert torch.equal(k.iterations, r.iterations)
        assert float((k.U - r.U).abs().max()) <= 1e-9
    else:
        assert float((k.U - r.U).abs()[both].max()) <= 5e-4
