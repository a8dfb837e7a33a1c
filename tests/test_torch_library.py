"""PyTorch port: the five library models against the JAX package (CPU,
float64): structure, the right-hand sides and measurements at random points
(batch-first against JAX per point, 1e-12), and ``simulate`` (the twins of
tests/test_library.py, Seborg's CSTR under Radau collocation among them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hilo_mpc_tpu.library as jlib
import hilo_mpc_tpu_torch.library as tlib

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
TOL = dict(rtol=1e-12, atol=1e-12)
SEBORG_P = {"q_0": 100.0, "V": 100.0, "C_Af": 1.0, "k_0": 7.2e10, "E": 72750.0,
            "T_f": 350.0, "DeltaH_r": -5e4, "rho": 1000.0, "C_p": 0.239, "UA": 5e4,
            "tau": 2.0}

# name: (factory, factory args, state point, parameter values or None,
#        setup options, inputs held over the run, steps)
MODELS = {
    "cstr_schaffner_and_zeitz": ("cstr_schaffner_and_zeitz", (), [0.2, 0.1], [1.0] * 6,
                                 dict(dt=0.1, integration_method="rk4"), [0.3], 10),
    "cstr_seborg": ("cstr_seborg", (), [0.5, 350.0, 300.0], SEBORG_P,
                    dict(dt=0.05, integration_method="collocation", degree=3), [300.0],
                    20),
    "ecoli_simple": ("ecoli_D1210_conti", ("simple",), [0.1, 40.0, 0.0, 0.0],
                     [100.0, 4.0, 0.2, 0.4, 0.05], dict(dt=0.1, integration_method="rk4"),
                     [0.0, 0.0], 10),
    "ecoli_complex": ("ecoli_D1210_conti", ("complex",), [0.1, 40.0, 0.0, 1.0, 1.0, 0.0],
                      [100.0, 4.0], dict(dt=0.05, integration_method="rk4"), [0.05, 0.05],
                      10),
    "ecoli_fedbatch": ("ecoli_D1210_fedbatch", (), [0.1, 40.0, 0.0, 1.0, 1.0, 0.0, 1.0],
                       None, dict(dt=0.05, integration_method="rk4"), [0.01, 0.01], 10),
    "scerevisiae": ("scerevisiae_SEY2102_fedbatch", (), [1.0, 0.5, 0.0, 0.0, 1.0], None,
                    dict(dt=0.05, integration_method="rk4"), [0.02], 10),
}


def _pair(name):
    fn, args, x0, p, opts, u, steps = MODELS[name]
    mj, mt = getattr(jlib, fn)(*args), getattr(tlib, fn)(*args)
    if isinstance(p, dict):
        p = [p[k] for k in mt.parameters]
    return mj, mt, np.asarray(x0), (None if p is None else np.asarray(p)), opts, u, steps


@pytest.mark.parametrize("name", sorted(MODELS))
def test_structure_matches_jax(name):
    mj, mt, *_ = _pair(name)
    for attr in ("name", "dynamical_states", "algebraic_states", "inputs", "parameters",
                 "measurements", "discrete"):
        assert getattr(mt, attr) == getattr(mj, attr), attr
    assert mt._x.units == mj._x.units


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rhs_and_measurements_match_jax(name):
    """Eight random points around the model's operating point, one
    batch-first call in the port against JAX point by point."""
    mj, mt, x0, p, *_ = _pair(name)
    rng = np.random.default_rng(sorted(MODELS).index(name))
    X = x0 * (1.0 + 0.1 * rng.standard_normal((8, x0.size))) + 0.01 * rng.random((8, x0.size))
    U = rng.uniform(0.0, 0.1, (8, mt.n_u)) + (300.0 if name == "cstr_seborg" else 0.0)
    P = np.tile(p if p is not None else np.zeros(0), (8, 1))
    z = np.zeros((8, 0))
    for fj, ft in ((mj.ode_fn(), mt.ode_fn()), (mj.meas_fn(), mt.meas_fn())):
        out_t = ft(*[torch.as_tensor(a, dtype=F64) for a in (X, z, U, P)], 0.0).numpy()
        for i in range(8):
            out_j = np.asarray(fj(*[jnp.asarray(a[i]) for a in (X, z, U, P)], 0.0))
            np.testing.assert_allclose(out_t[i], out_j, **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_simulate_matches_jax(name):
    mj, mt, x0, p, opts, u, steps = _pair(name)
    mj._dtype = jnp.float64
    mj.setup(**opts)
    mt.setup(**opts, device=CPU, dtype=F64)
    for m in (mj, mt):
        m.set_initial_conditions(x0)
        if p is not None:
            m.set_initial_parameter_values(p)
    U = np.tile(u, (steps, 1))
    out_t, out_j = mt.simulate(u=U, steps=steps), mj.simulate(u=U, steps=steps)
    for k in ("x", "y"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), err_msg=k, **TOL)
    assert np.all(np.isfinite(out_t["x"]))
    if name == "cstr_seborg":
        assert out_t["x"][-1, 0] > 0


def test_seborg_fleet_is_batch_first():
    """Seborg's CSTR under collocation: one batched simulate equals the
    scenarios one by one, float32 stays float32."""
    _, mt, x0, p, opts, u, _ = _pair("cstr_seborg")
    mt.setup(**opts, device=CPU, dtype=F64)
    mt.set_initial_parameter_values(p)
    x0s = x0 + np.array([0.05, 2.0, 2.0]) * np.random.default_rng(5).standard_normal((3, 3))
    U = np.full((5, 1), 300.0)
    many = mt.simulate(x0=x0s, u=U, steps=5)
    for i in range(3):
        np.testing.assert_allclose(many["x"][i], mt.simulate(x0=x0s[i:i + 1], u=U,
                                                             steps=5)["x"][0], atol=1e-12)
    m32 = tlib.cstr_seborg().setup(**opts, device=CPU, dtype=torch.float32)
    m32.set_initial_parameter_values(p)
    out = m32.rollout_fn()(torch.as_tensor(x0s, dtype=torch.float32),
                           torch.zeros(3, 0), torch.full((3, 5, 1), 300.0),
                           torch.as_tensor(np.tile(p, (3, 5, 1)), dtype=torch.float32))
    assert out["x"].dtype == torch.float32
    np.testing.assert_allclose(out["x"].numpy(), many["x"], rtol=1e-4)


@pytest.mark.cuda
def test_seborg_fleet_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, x0, p, opts, u, _ = _pair("cstr_seborg")
    x0s = x0 + np.array([0.05, 2.0, 2.0]) * np.random.default_rng(5).standard_normal((16, 3))
    outs = []
    for device in ("cpu", "cuda"):
        m = tlib.cstr_seborg().setup(**opts, device=device, dtype=F64)
        m.set_initial_parameter_values(p)
        outs.append(m.simulate(x0=x0s, u=np.full((10, 1), 300.0), steps=10)["x"])
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-9)
