"""PyTorch port: learned MPC (tests/test_learned_mpc.py's flow: distil an
NMPC policy into an ANN and run the ANN as the controller) and an ANN
policy in ``SimpleControlLoop`` against the JAX package (CPU, float64)."""
import jax.numpy as jnp
import numpy as np
import torch

from hilo_mpc_tpu import SimpleControlLoop as JaxLoop
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ml import nn as jnn
from hilo_mpc_tpu_torch import ANN, NMPC, Dense, SimpleControlLoop
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.utils.interop import ann_from

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
CSTR_P = [1.0] * 6
EQ = [0.3, 0.18055]


def plant(jx, x0):
    m = jax_cstr() if jx else cstr_schaffner_and_zeitz()
    if jx:
        m.setup(dt=0.1, integration_method="rk4")
        m._dtype = jnp.float64
    else:
        m.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    m.set_initial_conditions(x0)
    return m.set_initial_parameter_values(CSTR_P)


def test_ann_policy_loop_matches_jax():
    """The same network (a 2-8-1 tanh policy with feature and label
    scalers) drives each package's loop through ``predict``: states and
    moves to 1e-12 over 15 steps."""
    ja = jnn.ArtificialNeuralNetwork(["x_1", "x_2"], ["u"], seed=5)
    ja.add_layers([jnn.Dense(8, "tanh")])
    ja.setup()
    ja._scaler_mean, ja._scaler_scale = np.array(EQ), np.array([0.1, 0.05])
    ja._label_mean, ja._label_scale = np.array([-0.12]), np.array([0.3])
    loops = [JaxLoop(plant(True, [0.25, 0.12]), ja),
             SimpleControlLoop(plant(False, [0.25, 0.12]), ann_from(ja, device=CPU))]
    sj, st = (loop.run(15) for loop in loops)
    for k in ("x", "u"):
        np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=1e-12)
    assert np.abs(st["u"]).max() > 1e-3


def test_ann_imitates_nmpc_policy():
    """tests/test_learned_mpc.py's distillation and bars on the port: the
    teacher's batched solves, the student trained on them (median imitation
    error < 0.05 on held-out states) and the student closing the loop
    (final |x - x_eq| < 0.02)."""
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 10
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=EQ)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(CSTR_P)
    nmpc.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
    rng = np.random.default_rng(0)
    X_train = np.array(EQ) + rng.uniform(-0.15, 0.15, size=(256, 2))
    U_train, sol = nmpc.optimize_batch(X_train)
    assert float(sol.converged.double().mean()) > 0.98

    ann = ANN(["x_1", "x_2"], ["u"])
    ann.add_layers([Dense(32, activation="tanh"), Dense(32, activation="tanh")])
    ann.setup(device=CPU, dtype=F64)
    ann.train(batch_size=64, epochs=150, X=X_train, y=U_train, patience=60)

    X_test = np.array(EQ) + rng.uniform(-0.1, 0.1, size=(16, 2))
    U_teacher, _ = nmpc.optimize_batch(X_test)
    assert np.median(np.abs(ann.predict(X_test) - U_teacher)) < 0.05

    p = plant(False, [0.25, 0.12])
    SimpleControlLoop(p, ann).run(40)
    assert np.linalg.norm(p.solution["x:f"] - EQ) < 0.02
