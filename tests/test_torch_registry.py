"""PyTorch port: the cross-instance registry (utils/trace_cache.py and the
setup hooks of control/nmpc.py and estimation/mhe.py), held against the JAX
package's registry on the same sequences of configurations (the entry counts
equal), mirroring tests/test_trace_registry.py: same-configuration
controllers share their canonical objects and give identical U (bitwise),
every configuration that differs in something baked into the problem adds
an entry, and the whole-solve route's emitted problem is shared. JAX's
setups here compile nothing (its jits are lazy), so no JAX solve runs."""
import numpy as np
import pytest
import torch

import hilo_mpc_tpu as jx
from hilo_mpc_tpu.utils import trace_cache as jax_registry
from hilo_mpc_tpu_torch import MHE, NMPC, Model, clear_trace_registry, trace_registry_stats
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr

P_CSTR = [1.0] * 6
F64 = torch.float64
X0 = [0.2, 0.1]


def _nmpc(cls, model, weights=(10.0, 10.0), horizon=8, dt=0.1, ref=(0.3, 0.18055),
          u_w=0.1, scaling=None, **opts):
    n = cls(model)
    n.horizon = horizon
    n.quad_stage_cost.add_states(weights=list(weights), ref=list(ref))
    n.quad_stage_cost.add_inputs(weights=u_w)
    n.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    n.set_parameters(P_CSTR)
    if scaling is not None:
        n.set_scaling(x_scaling=scaling)
    return n, {"dt": dt, **opts}


def build(**kw):
    """The port's controller of tests/test_trace_registry.py:_build_nmpc."""
    n, opts = _nmpc(NMPC, cstr_schaffner_and_zeitz(), **kw)
    return n.setup(options=opts, device="cpu", dtype=F64)


def build_jax(**kw):
    n, opts = _nmpc(jx.NMPC, jax_cstr(), **kw)
    return n.setup(options=opts)


def counts():
    return trace_registry_stats()["entries"], jax_registry.trace_registry_stats()["entries"]


@pytest.fixture
def fresh():
    clear_trace_registry()
    jax_registry.clear_trace_registry()
    yield
    clear_trace_registry()
    jax_registry.clear_trace_registry()


def test_same_config_shares_objects_and_solution(fresh):
    n1, n2 = build(), build()
    build_jax(), build_jax()
    assert counts() == (1, 1)
    assert n1._funcs is n2._funcs and n1._dims is n2._dims and n1._ip_opts is n2._ip_opts
    u1, u2 = n1.optimize(X0), n2.optimize(X0)
    np.testing.assert_array_equal(u1, u2)


@pytest.fixture(scope="module")
def base_solved():
    clear_trace_registry()
    jax_registry.clear_trace_registry()
    base = build()
    build_jax()
    return np.asarray(base.optimize(X0))


@pytest.mark.parametrize("variant", [
    dict(weights=(20.0, 10.0)),
    dict(horizon=9),
    dict(dt=0.05),
    dict(ref=(0.25, 0.15)),
    dict(u_w=0.2),
    dict(integration_method="euler"),
    dict(max_iter=17),
    dict(tol=3e-5),
    dict(mu_init=5e-2),
])
def test_no_collision_across_configs(variant, base_solved):
    """Each of JAX's nine variants adds an entry in both registries; the
    cost variants' solutions differ from the base's."""
    before = counts()
    other = build(**variant)
    build_jax(**variant)
    assert counts() == (before[0] + 1, before[1] + 1)
    if set(variant) & {"weights", "ref", "u_w"}:
        assert not np.allclose(base_solved, other.optimize(X0))


def test_sequence_of_configurations_matches_jax(fresh):
    """Scaling, state-space models by content, device and dtype: the same
    sequence gives the same counts (the port's device and dtype are keys of
    its own: the JAX package has one of each per process)."""
    seq = []
    build(), build_jax()
    seq.append(counts())
    build(scaling=[2.0, 1.0]), build_jax(scaling=[2.0, 1.0])
    seq.append(counts())
    A, B = [[0.0, 1.0], [-1.0, -0.4]], [[0.0], [1.0]]

    def ss(cls, a, **setup):
        m = (Model if cls is NMPC else jx.Model)()
        m.set_state_space(A=a, B=B)
        n = cls(m)
        n.horizon = 6
        n.quad_stage_cost.add_states(weights=[1.0, 1.0])
        n.quad_stage_cost.add_inputs(weights=0.1)
        return n.setup(options={"dt": 0.1}, **setup)

    for a in (A, A, [[0.0, 1.0], [-2.0, -0.4]]):
        ss(NMPC, a, device="cpu", dtype=F64), ss(jx.NMPC, a)
        seq.append(counts())
    assert seq == [(1, 1), (2, 2), (3, 3), (3, 3), (4, 4)]
    build()
    assert counts()[0] == 4
    n, opts = _nmpc(NMPC, cstr_schaffner_and_zeitz())
    n.setup(options=opts, device="cpu", dtype=torch.float32)
    assert counts()[0] == 5


def test_callable_models_do_not_false_share(fresh):
    def make(cls, k):
        m = cls()
        if cls is Model:
            m.set_dynamical_equations(lambda x, u: k * -x + u)
        else:
            m.set_dynamical_equations(lambda x, u: np.float64(k) * -x + u)
        m._x.add(1, prefix="x")
        m._u.add(1, prefix="u")
        return m

    sols = []
    for k in (1.0, 3.0):
        for cls, nm in ((Model, NMPC), (jx.Model, jx.NMPC)):
            n = nm(make(cls, k))
            n.horizon = 5
            n.quad_stage_cost.add_states(weights=[1.0], ref=[0.5])
            n.quad_stage_cost.add_inputs(weights=0.1)
            if nm is NMPC:
                n.setup(options={"dt": 0.1}, device="cpu", dtype=F64)
                sols.append(n.optimize([0.0]))
            else:
                n.setup(options={"dt": 0.1})
    assert counts() == (2, 2)
    assert not np.allclose(sols[0], sols[1])


def test_mhe_shares_and_respects_weights(fresh):
    def build_mhe(cls, model, wm, **setup):
        mhe = cls(model, **({} if setup else {"plot_backend": None}))
        mhe.horizon = 5
        mhe.quad_stage_cost.add_measurements(weights=wm)
        mhe.quad_stage_cost.add_state_noise(weights=10.0)
        mhe.quad_arrival_cost.W_arrival_x = np.eye(2)
        mhe.set_initial_guess([0.2, 0.1])
        mhe.set_initial_parameter_values(P_CSTR)
        mhe.setup(dt=0.1, **setup)
        return mhe

    seq, mhes = [], []
    for wm in (5.0, 5.0, 7.0):
        mhes.append(build_mhe(MHE, cstr_schaffner_and_zeitz(), wm, device="cpu", dtype=F64))
        build_mhe(jx.MHE, jax_cstr(), wm)
        seq.append(counts())
    assert seq == [(1, 1), (1, 1), (2, 2)]
    assert mhes[0]._funcs is mhes[1]._funcs and mhes[0]._funcs is not mhes[2]._funcs


def test_generic_cost_and_discrete_inputs_opt_out(fresh):
    """Fresh lambdas as generic costs key on their ids (two entries, the
    same U to 1e-10 as in JAX); discrete inputs are never shared."""
    def econ(cls, model):
        n = cls(model)
        n.horizon = 5
        n.stage_cost.cost = lambda x, u: (x[..., 0] - 0.3) ** 2 + 0.1 * u[..., 0] ** 2
        n.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
        n.set_parameters(P_CSTR)
        return n

    us = []
    for _ in range(2):
        us.append(econ(NMPC, cstr_schaffner_and_zeitz()).setup(
            options={"dt": 0.1}, device="cpu", dtype=F64).optimize(X0))
        econ(jx.NMPC, jax_cstr()).setup(options={"dt": 0.1})
    assert counts() == (2, 2)
    np.testing.assert_allclose(us[0], us[1], atol=1e-10)
    for cls, model, setup in ((NMPC, cstr_schaffner_and_zeitz(),
                               dict(device="cpu", dtype=F64)), (jx.NMPC, jax_cstr(), {})):
        n, opts = _nmpc(cls, model, horizon=3)
        n.set_discrete_inputs([0], levels=[-1.0, 0.0, 1.0])
        n.setup(options=opts, **setup)
    assert counts() == (2, 2)


def test_whole_solve_route_shares_its_problem(fresh):
    """Two pallas_full controllers of one configuration share the gate's
    result, the emitted problem and its launch table, and give the same U
    (bitwise; CPU tensors run the kernel's plain version); other bound
    values get their own emission under the same entry."""
    newton = dict(pallas_full=True, convexify=False, mehrotra=False, n_linesearch=1)
    x = np.array([[0.2, 0.1], [0.25, 0.12], [0.18, 0.09]])
    c, d = build(**newton), build(**newton)
    s1 = c.solve_batch_fn()(*c.prepare_batch(x))
    s2 = d.solve_batch_fn()(*d.prepare_batch(x))
    assert c._wip["eligible"] and c._wip["problem"] is d._wip["problem"]
    assert c._wip["launch"] is d._wip["launch"]
    assert torch.equal(s1.U, s2.U) and torch.equal(s1.X, s2.X)
    assert counts()[0] == 1 and trace_registry_stats()["sites"] == 1
    e, opts = _nmpc(NMPC, cstr_schaffner_and_zeitz(), **newton)
    e.set_box_constraints(u_lb=[-4.0], u_ub=[4.0])
    e.setup(options=opts, device="cpu", dtype=F64)
    e.solve_batch_fn()
    assert e._funcs is c._funcs and e._wip["problem"] is not c._wip["problem"]
