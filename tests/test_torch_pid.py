"""PyTorch port: the PID controller against the JAX package (CPU).

The cases of tests/test_pid_parity.py on the port (default tunings, derived
k_i / k_d, diagonal-only matrices, set-point dimension checks, not-set-up
errors), ``call`` against the JAX ``call`` over a closed loop, and the
batch-first ``step_fn`` against the JAX ``step_fn`` to 1e-12 in float64 for
every option combination, with output limits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import PID as JaxPID
from hilo_mpc_tpu_torch import PID
from hilo_mpc_tpu_torch.utils.interop import pid_from


def test_initial_tunings():
    pid = PID()
    np.testing.assert_equal(pid.k_p, np.ones(1))
    np.testing.assert_equal(pid.t_i, np.full(1, np.inf))
    np.testing.assert_equal(pid.k_i, np.zeros(1))
    np.testing.assert_equal(pid.t_d, np.zeros(1))
    np.testing.assert_equal(pid.k_d, np.zeros(1))
    np.testing.assert_allclose(pid.set_point, np.zeros(1))


def test_initial_multi_loop_and_setup():
    pid = PID(n_set_points=3)
    assert pid.n_set_points == 3
    np.testing.assert_equal(pid.k_p, np.ones(3))
    np.testing.assert_allclose(pid.set_point, np.zeros(3))
    assert not pid.is_setup()
    pid.setup(dt=0.01)
    assert pid.is_setup()


@pytest.mark.parametrize("attr,value,derived,expect", [
    ("k_p", 2, None, None), ("t_i", 0.1, "k_i", 10.0), ("t_d", 10.0, "k_d", 10.0)])
def test_tuning_setters(attr, value, derived, expect):
    pid = PID()
    setattr(pid, attr, value)
    np.testing.assert_equal(getattr(pid, attr), np.array([float(value)]))
    if derived:
        np.testing.assert_allclose(getattr(pid, derived), np.array([expect]))


@pytest.mark.parametrize("attr", ["k_p", "t_i", "t_d"])
def test_coupled_matrix_rejected(attr):
    pid = PID(n_set_points=2)
    with pytest.raises(ValueError, match="diagonal"):
        setattr(pid, attr, np.array([[1.0, 0.5], [0.0, 1.0]]))


@pytest.mark.parametrize("attr", ["k_p", "t_i", "t_d"])
def test_diagonal_matrix_accepted(attr):
    pid = PID(n_set_points=2)
    setattr(pid, attr, np.diag([2.0, 3.0]))
    np.testing.assert_equal(getattr(pid, attr), np.array([2.0, 3.0]))


def test_scalar_broadcast_and_tunings_tuple():
    pid = PID(n_set_points=2)
    pid.k_p = 2.0
    np.testing.assert_equal(pid.k_p, np.array([2.0, 2.0]))
    pid = PID()
    pid.tunings = (2.0, 4.0, 0.5)
    np.testing.assert_allclose(pid.k_i, np.array([0.5]))
    np.testing.assert_allclose(pid.k_d, np.array([1.0]))
    with pytest.raises(ValueError, match="diagonal"):
        PID(n_set_points=2, k_p=[[1.0, 0.5], [0.0, 1.0]])


@pytest.mark.parametrize("n,value,expect", [
    (1, 1.0, [1.0]), (3, 1.0, [1.0] * 3), (2, [1.0, 2.0], [1.0, 2.0])])
def test_set_points(n, value, expect):
    pid = PID(n_set_points=n)
    pid.setup(dt=0.01)
    pid.set_point = value
    np.testing.assert_allclose(pid.set_point, np.array(expect))


def test_wrong_set_point_dimension_and_not_set_up():
    pid = PID(n_set_points=4)
    pid.setup(dt=0.01)
    with pytest.raises(ValueError, match="3x1.*4x1"):
        pid.set_point = [1.0, 1.0, 1.0]
    with pytest.raises(RuntimeError, match="setup"):
        PID().call(pv=0.0)


def test_first_moves_and_limits():
    pid = PID(k_p=2.0)
    pid.setup(dt=0.1)
    pid.set_point = 1.0
    np.testing.assert_allclose(pid.call(pv=0.0), [2.0])
    pid = PID(n_set_points=2, k_p=[1.0, 10.0])
    pid.setup(dt=0.1)
    pid.set_point = [1.0, 1.0]
    np.testing.assert_allclose(pid.call(pv=[0.0, 0.0]), [1.0, 10.0])
    pid = PID(k_p=100.0)
    pid.set_output_limits(-1.0, 1.0)
    pid.setup(dt=0.1)
    pid.set_point = [10.0]
    assert abs(pid.call([0.0])[0]) <= 1.0
    # the velocity form: a set-point step kicks once, a constant error holds
    pid = PID(k_p=2.0, t_i=np.inf, t_d=0.0)
    pid.setup(dt=0.1)
    pid.set_point = [1.0]
    np.testing.assert_allclose([pid.call([0.0]), pid.call([0.0]), pid.call([-1.0])],
                               [[2.0], [2.0], [4.0]])


# option combinations: (k_p, t_i, t_d, P on PV, D on PV, output limits)
CASES = {
    "p": (2.0, np.inf, 0.0, False, False, (-np.inf, np.inf)),
    "pi": (1.0, 0.5, 0.0, False, False, (-np.inf, np.inf)),
    "pid": ([1.0, 2.0], [0.5, 0.8], [0.05, 0.1], False, False, (-np.inf, np.inf)),
    "p_on_pv": ([1.0, 2.0], [0.5, 0.8], [0.05, 0.1], True, False, (-np.inf, np.inf)),
    "d_on_pv": ([1.0, 2.0], [0.5, 0.8], [0.05, 0.1], False, True, (-np.inf, np.inf)),
    "both_on_pv_limited": ([1.0, 2.0], [0.5, 0.8], [0.05, 0.1], True, True, (-0.3, 0.4)),
}


def _pids(case):
    k_p, t_i, t_d, p_pv, d_pv, lim = CASES[case]
    n = np.size(k_p)
    jp = JaxPID(n_set_points=n, k_p=k_p, t_i=t_i, t_d=t_d,
                proportional_on_process_value=p_pv, derivative_on_process_value=d_pv)
    jp.set_output_limits(*lim)
    jp.setup(dt=0.1)
    return jp, pid_from(jp), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_call_matches_jax(case):
    """Forty updates with set-point steps: the port's numpy call and the
    JAX call give the same bits."""
    jp, tp, n = _pids(case)
    rng = np.random.default_rng(0)
    for k in range(40):
        if k % 10 == 0:
            sp = rng.standard_normal(n)
            jp.set_point, tp.set_point = sp, sp
        pv = rng.standard_normal(n)
        np.testing.assert_array_equal(tp.call(pv), jp.call(pv))
    np.testing.assert_array_equal(np.asarray(tp.solution["u"]), np.asarray(jp.solution["u"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_fn_matches_jax(case):
    """The batch-first step over B = 6 scenarios against the JAX step per
    scenario, 30 steps, float64, to 1e-12."""
    jp, tp, n = _pids(case)
    jstep, tstep = jp.step_fn(), tp.step_fn()
    B = 6
    rng = np.random.default_rng(1)
    PV = rng.standard_normal((30, B, n))
    SP = np.repeat(rng.standard_normal((3, B, n)), 10, axis=0)
    tc = tuple(torch.zeros(B, n, dtype=torch.float64) for _ in range(5))
    jcs = [tuple(jnp.zeros(n) for _ in range(5)) for _ in range(B)]
    for k in range(30):
        tc, tu = tstep(tc, torch.as_tensor(PV[k]), torch.as_tensor(SP[k]))
        for b in range(B):
            jcs[b], ju = jstep(jcs[b], jnp.asarray(PV[k, b]), jnp.asarray(SP[k, b]))
            np.testing.assert_allclose(tu[b].numpy(), np.asarray(ju), rtol=0, atol=1e-12)


def test_step_fn_matches_call():
    """One scenario's step_fn follows the stateful call exactly."""
    _, tp, n = _pids("pid")
    step = tp.step_fn()
    carry = tuple(torch.zeros(n, dtype=torch.float64) for _ in range(5))
    tp.set_point = [0.5, -0.2]
    rng = np.random.default_rng(2)
    for _ in range(20):
        pv = rng.standard_normal(n)
        carry, u = step(carry, torch.as_tensor(pv), torch.as_tensor(tp.set_point))
        np.testing.assert_allclose(u.numpy(), tp.call(pv), rtol=0, atol=1e-12)


def test_pid_from_carries_everything():
    jp, tp, _ = _pids("both_on_pv_limited")
    jp.set_point = [0.3, 0.1]
    tp = pid_from(jp)
    for a in ("k_p", "t_i", "t_d", "set_point", "n_set_points"):
        np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
    assert tp._u_bounds == jp._u_bounds and tp._dt == jp._dt and tp.is_setup()
    assert (tp._p_on_pv, tp._d_on_pv) == (True, True)


@pytest.mark.cuda
def test_step_fn_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _, tp, n = _pids("both_on_pv_limited")
    step = tp.step_fn()
    rng = np.random.default_rng(3)
    PV = torch.as_tensor(rng.standard_normal((10, 4096, n)))
    out = []
    for device in ("cpu", "cuda"):
        carry = tuple(torch.zeros(4096, n, dtype=torch.float64, device=device)
                      for _ in range(5))
        for k in range(10):
            carry, u = step(carry, PV[k].to(device), torch.zeros_like(PV[k]).to(device))
        out.append(u.cpu().numpy())
    np.testing.assert_allclose(out[1], out[0], atol=1e-12)
