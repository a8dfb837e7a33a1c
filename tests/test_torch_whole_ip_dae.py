"""PyTorch port: the whole-solve interior point on DAE models (CPU).

A model given as callables takes the traced route (ops/codegen_fx.py): the
model's own ``ode`` and ``alg`` are traced and wrapped in the emitted step
(ops/codegen_cuda.py:_emit_step, csrc/implicit.cuh); a DAE in the equation
DSL takes the DSL route, its algebraic equations emitted as ``alg``.

- Golden ``dae_colloc``'s model (x' = -x + z + u, 0 = z - 0.5 x - α z²)
  under Radau collocation d=3: the float32 host build against the JAX
  kernel ``solve_ocp_pallas_full`` in interpret mode (N=4, B=3, one call for
  the module): equal iterations, U/X to 5e-4, objective rtol 1e-4.
- Collocation d=3, RK4 with its stage Newton (two substeps: z carried to
  the next substep by a Newton at x_next), a discrete map with algebraic
  states (two substeps: the Newton's z with its tangents enters the next
  substep's map) and the DSL DAE: the float64 host build against the plain
  version, equal iterations and U/X to 1e-9; F and [A | B] against
  ``torch.func.jacfwd`` of the port's ``dyn`` to 1e-10.
- The gate: ``pallas_full`` takes each without a warning and without a
  Riccati launch, a path parameter with an implicit step too (emitted
  around the wrapped step); it declines a free final time, naming it.
The card tests of these builds are tests/test_torch_card_implicit.py.
"""
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from golden_configs import DAE_ALPHA
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.ops.pallas_ip import solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
# pure Newton steps at the kernel's float32 tolerance
KERNEL_OPTS = {"dt": 0.1, "tol": 1e-4, "max_iter": 25, "convexify": False,
               "n_linesearch": 1, "mu_init": 1e-2, "mehrotra": False}
COLLOC3 = {"integration_method": "collocation", "degree": 3}
CASES = {
    "collocation": ("callable", COLLOC3),
    "rk4_stage_newton": ("callable", {"integration_method": "rk4", "substeps": 2}),
    "discrete": ("discrete", {"integration_method": "discrete", "substeps": 2}),
    "dsl_collocation": ("dsl", {**COLLOC3, "degree": 2}),
}


def dae_model(kind="callable", lib=torch):
    """golden_configs.build_dae_colloc's model; "discrete": its explicit
    Euler map at dt = 0.1; "dsl": the same equations in the DSL."""
    if kind == "dsl":
        return Model(name="dae").set_equations(f"""
            dx/dt = -x(t) + z(t) + u(k)
            0 = z(t) - 0.5*x(t) - {DAE_ALPHA}*z(t)**2
            """)
    m = (JaxModel(name="dae") if lib is jnp else
         Model(name="dae", discrete=kind == "discrete"))
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_inputs("u")
    if kind == "discrete":
        m.set_dynamical_equations(lambda x, z, u: x + 0.1 * (-x + z + u))
    else:
        m.set_dynamical_equations(lambda x, z, u: -x + z + u)
    m.set_algebraic_equations(lambda x, z: z - 0.5 * x - DAE_ALPHA * z ** 2)
    return m


def _nmpc(cls, model, N, options, configure=None, **setup_kw):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0], ref=[0.5])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    if configure is not None:
        configure(nmpc)
    nmpc.setup(options={**KERNEL_OPTS, **options}, **setup_kw)
    return nmpc


def _port(N, case, dtype=F64, device=CPU, options=None, configure=None):
    kind, opts = CASES[case]
    return _nmpc(NMPC, dae_model(kind), N, {**opts, **(options or {})}, configure,
                 device=device, dtype=dtype)


def _x0s(B, seed):
    return 0.1 + 0.2 * np.random.default_rng(seed).standard_normal((B, 1))


def _plain(nmpc, args):
    return W.solve_ocp_full_reference(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                      nmpc._ip_opts)


def _host(nmpc, args):
    return W.solve_ocp_full_host(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                 nmpc._ip_opts)


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


@pytest.fixture(scope="module")
def pallas_dae():
    """The JAX kernel in interpret mode on the collocation DAE (N=4, B=3)."""
    jn = _nmpc(JaxNMPC, dae_model(lib=jnp), 4, COLLOC3)
    args = jn.prepare_batch(_x0s(3, 4))
    sol = solve_ocp_pallas_full(jn._funcs, jn._dims, jn._bounds, *args,
                                options=jn._ip_opts, tile_b=8)
    return to_torch(args, device=CPU), jax.tree.map(np.asarray, sol)


def test_host_kernel_matches_pallas_interpret(pallas_dae):
    """The traced DAE build in float32 against the JAX kernel, whose dyn runs
    the collocation Newton through custom_root."""
    _need_cxx()
    args, jsol = pallas_dae
    tn = _port(4, "collocation", dtype=torch.float32)
    sol = to_numpy(_host(tn, [a.float() for a in args]))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, rtol=0, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, rtol=0, atol=5e-4)
    np.testing.assert_allclose(sol.objective, jsol.objective, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_kernel_matches_plain_f64(case):
    _need_cxx()
    tn = _port(5, case)
    args = tn.prepare_batch(_x0s(3, 1))
    k, r = _host(tn, args), _plain(tn, args)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations)
    assert torch.equal(k.converged, r.converged) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-9)
    route = "codegen_cuda.py" if case.startswith("dsl") else "codegen_fx.py"
    assert route in W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds,
                                       args[0].shape[2], tn._ip_opts).text


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_pass_is_the_implicit_derivative(case):
    _need_cxx()
    tn = _port(3, case)
    rng = np.random.default_rng(9)
    R = 6
    xs = torch.as_tensor(rng.uniform(-0.5, 1.0, (R, 1)))
    us = torch.as_tensor(rng.uniform(-1.5, 1.5, (R, 1)))
    th = torch.as_tensor(np.tile([0.3, 0.1], (R, 1)))
    F, AB = W.dyn_lin_host(tn._funcs, tn._dims, tn._bounds, xs, us, th)
    dyn = tn._funcs.dyn
    JA, JB = vmap(jacfwd(dyn, argnums=(0, 1)))(xs, us, th)
    torch.testing.assert_close(F, dyn(xs, us, th), rtol=0, atol=1e-10)
    torch.testing.assert_close(AB[..., :1], JA, rtol=0, atol=1e-10)
    torch.testing.assert_close(AB[..., 1:], JB, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_takes_dae_models(case):
    """pallas_full on a DAE model: no warning, the whole-solve path (its
    plain version on CPU tensors, bit for bit), no Riccati launch."""
    tn = _port(3, case, options={"pallas_full": True})
    args = tn.prepare_batch(_x0s(2, 2))
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    assert tn._wip["eligible"]
    for a, b in zip(fn(*args), _plain(tn, args)):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric


DECLINES = {
    "free_final_time": (lambda n: n.minimize_final_time(weight=1.0, dt_min=0.05,
                                                        dt_max=0.5),
                        "a free final time"),
    # taken since the path state is emitted around the implicit step (why =
    # None): the whole-solve path's plain version, no Riccati launch
    "path_parameter": (lambda n: n.create_path_variable(u_pf_lb=0.0, u_pf_ub=2.0,
                                                        speed_ref=1.0,
                                                        speed_weight=1.0),
                       None),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_gate_declines_naming_the_reason(case):
    """A free final time: pallas_full warns naming it and gives the general
    path's bits. A path parameter under collocation: taken without a
    warning, the whole-solve path's plain version bit for bit, no Riccati
    launch."""
    configure, why = DECLINES[case]
    tn = _port(3, "collocation", options={"pallas_full": True}, configure=configure)
    args = tn.prepare_batch(_x0s(2, 3))
    if why is None:
        n_ric = riccati_lq_cuda.launches
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            fn = tn.solve_batch_fn()
        assert tn._wip["eligible"]
        for a, b in zip(fn(*args), _plain(tn, args)):
            assert torch.equal(a, b)
        assert riccati_lq_cuda.launches == n_ric
        return
    with pytest.warns(UserWarning, match=why):
        fn = tn.solve_batch_fn()
    ref = _port(3, "collocation", configure=configure)
    for a, b in zip(fn(*args), ref.solve_batch_fn()(*args)):
        assert torch.equal(a, b)
