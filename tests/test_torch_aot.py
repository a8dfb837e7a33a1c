"""PyTorch port: the export of functions, model steps and the NMPC solve
(utils/aot.py), held against the JAX package's exports on the same inputs,
mirroring tests/test_aux_utils.py:28-50 and tests/test_programs_data.py:
209-249. The exported solve is reloaded in a child process that imports
the port and builds no controller; it equals the live early-exit solve to
the bit (CPU), the JAX package's exported solve and ``optimize`` to 1e-8
(float64)."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hilo_mpc_tpu as jx
from hilo_mpc_tpu.utils import aot as jax_aot
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.utils.aot import (export_function, export_model_step,
                                          export_nmpc_solver, load_function)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, F64 = torch.float32, torch.float64

# the child: load the exported solve, run it on the saved inputs, write the
# outputs; no model code, no controller
CHILD = """
import sys, numpy as np, torch
from hilo_mpc_tpu_torch.utils.aot import load_function
fn = load_function(sys.argv[1])
args = [torch.as_tensor(a) for a in np.load(sys.argv[2]).values()]
X, U, conv, kkt = fn(*args)
np.savez(sys.argv[3], X=X.numpy(), U=U.numpy(), conv=conv.numpy(), kkt=kkt.numpy())
import gc
from hilo_mpc_tpu_torch import NMPC, Model
print(sum(isinstance(o, (NMPC, Model)) for o in gc.get_objects()))
"""


def test_export_and_reload_function(tmp_path):
    x = np.random.default_rng(0).standard_normal(3)
    path = export_function(lambda a: 2.0 * a + 1.0, (torch.zeros(3),),
                           str(tmp_path / "fn.pt2"))
    got = load_function(path)(torch.as_tensor(x, dtype=F32))
    jpath = jax_aot.export_function(lambda a: 2.0 * a + 1.0, (jnp.zeros(3, jnp.float32),),
                                    str(tmp_path / "fn.hlo"))
    want = jax_aot.load_function(jpath)(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _pendulum(jax_side):
    m = (jx.Model if jax_side else Model)(name="pend")
    m.set_dynamical_states(["th", "om"])
    m.set_inputs("tau")
    m.set_measurements(["y_th"])
    if jax_side:
        m.set_dynamical_equations(
            lambda x, u: jnp.array([x[1], -jnp.sin(x[0]) - 0.3 * x[1] + u[0]]))
        m.set_measurement_equations(lambda x: x[:1])
    else:
        m.set_dynamical_equations(lambda x, u: torch.stack(
            [x[..., 1], -torch.sin(x[..., 0]) - 0.3 * x[..., 1] + u[..., 0]], dim=-1))
        m.set_measurement_equations(lambda x: x[..., :1])
    return m


@pytest.mark.parametrize("batch", [0, 5])
def test_export_model_step_roundtrip(tmp_path, batch):
    """The pendulum's exported rk4 step against JAX's exported step on the
    same states and inputs (float32, 1e-6), and against ``simulate``."""
    rng = np.random.default_rng(1)
    lead = (batch,) if batch else ()
    x, u = rng.standard_normal(lead + (2,)), rng.standard_normal(lead + (1,))
    m = _pendulum(False)
    m.setup(dt=0.1, integration_method="rk4", device="cpu", dtype=F32)
    fn = load_function(export_model_step(m, str(tmp_path / "step.pt2"), batch=batch))
    z, p = torch.zeros(lead + (0,)), torch.zeros(lead + (0,))
    x1, _, y1, _ = fn(torch.as_tensor(x, dtype=F32), z, torch.as_tensor(u, dtype=F32), p)
    jm = _pendulum(True)
    jm.setup(dt=0.1, integration_method="rk4")
    jfn = jax_aot.load_function(jax_aot.export_model_step(jm, str(tmp_path / "j.hlo"),
                                                          batch=batch))
    dt = jm.dtype
    jz = jnp.zeros(lead + (0,), dt)
    jx1, _, jy1, _ = jfn(jnp.asarray(x, dt), jz, jnp.asarray(u, dt), jz)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=1e-6)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), atol=1e-6)
    if not batch:
        m.set_initial_conditions(x)
        ref = m.simulate(u=u[None], steps=1)["x"][-1]
        np.testing.assert_allclose(x1.numpy(), ref, atol=1e-6)


def _nmpc(cls, m):
    m.set_dynamical_states("x")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: -x + u)
    nmpc = cls(m)
    nmpc.horizon = 5
    nmpc.quad_stage_cost.add_states(weights=1.0, ref=[1.0])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    return nmpc


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The port's exported solve of tests/test_programs_data.py's problem
    (x' = -x + u, N=5, dt 0.2, float64), run in a child process; the JAX
    package's export of the same controller, run here."""
    d = tmp_path_factory.mktemp("aot")
    nmpc = _nmpc(NMPC, Model()).setup(options={"dt": 0.2}, device="cpu", dtype=F64)
    theta = nmpc._assemble_theta(None, None)
    inputs = dict(theta=theta, xs0=np.zeros(1), X=np.zeros((6, 1)), U=np.zeros((5, 1)))
    path = export_nmpc_solver(nmpc, str(d / "solver.zip"))
    np.savez(d / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", CHILD, path, str(d / "inputs.npz"),
                           str(d / "out.npz")], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(d))
    assert proc.returncode == 0, proc.stderr[-3000:]
    jn = _nmpc(jx.NMPC, jx.Model())
    jn.setup(options={"dt": 0.2})
    jfn = jax_aot.load_function(jax_aot.export_nmpc_solver(jn, str(d / "solver.bin")))
    dt = jn._solver_dtype
    jout = jfn(*(jnp.asarray(v, dt) for v in inputs.values()))
    return dict(nmpc=nmpc, inputs=inputs, out=dict(np.load(d / "out.npz")),
                jax=[np.asarray(o) for o in jout], child=proc.stdout, path=path)


def test_exported_solve_matches_jax_and_optimize(exported):
    out, (jX, jU, jconv, _) = exported["out"], exported["jax"]
    assert bool(out["conv"]) and bool(jconv)
    np.testing.assert_allclose(out["U"], jU, atol=1e-8)
    np.testing.assert_allclose(out["X"], jX, atol=1e-8)
    u_live = exported["nmpc"].optimize([0.0])
    np.testing.assert_allclose(out["U"][0], u_live, atol=1e-8)


def test_exported_fixed_loop_equals_early_exit(exported):
    """The exported solve runs all max_iter iterations (no host sync);
    the finished scenario stays frozen, so X and U equal the early-exit
    solve's to the bit."""
    n = exported["nmpc"]
    args = [torch.as_tensor(v)[None] for v in exported["inputs"].values()]
    sol = n._solve(*args, n._mu_cold)
    assert int(sol.iterations[0]) < n._ip_opts.max_iter
    np.testing.assert_array_equal(exported["out"]["U"], sol.U[0].numpy())
    np.testing.assert_array_equal(exported["out"]["X"], sol.X[0].numpy())


def test_reload_in_a_process_without_a_controller(exported):
    """The child loaded and ran the artifact without a model or a
    controller object, and the archive holds the three programs and the
    iteration count."""
    import zipfile
    assert exported["child"].strip() == "0", exported["child"]
    with zipfile.ZipFile(exported["path"]) as z:
        names = set(z.namelist())
        meta = json.loads(z.read("hilo_mpc_solver.json"))
    assert {"init.pt2", "step.pt2", "finish.pt2"} <= names
    assert meta == {"max_iter": exported["nmpc"]._ip_opts.max_iter}
