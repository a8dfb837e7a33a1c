"""PyTorch port: the embedded NMPC C export (embedded/nmpc_codegen.py) on
the CPU.

The twins of tests/test_embedded_nmpc.py on the port's NMPC (float64 on
the CPU): the DSL→C transpiler, the export's gates, the compiled
controller against ``NMPC.optimize`` on the CSTR (|Δu| < 2e-4, the JAX
test's bar), with active input bounds, on a discrete model, through
``setup_solver``, and the native closed loop. Emission parity: the same
controller built in both packages gives byte-identical C, for the
controller and for the closed-loop runner.
"""
import os

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.embedded.codegen import (compile_shared, find_c_compiler,
                                                 setup_solver)
from hilo_mpc_tpu_torch.embedded.nmpc_codegen import (_CExpr, generate_closed_loop_c,
                                                      generate_model_rhs_c,
                                                      generate_nmpc_c, load_closed_loop,
                                                      load_nmpc)
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz

P_CSTR = [1.0] * 6
KW = dict(device="cpu", dtype=torch.float64)


@pytest.fixture
def cc():
    try:
        find_c_compiler()
    except RuntimeError:
        pytest.skip("no C compiler")


def _cstr_nmpc(N=20, cls=NMPC, model=cstr_schaffner_and_zeitz, setup_kw=KW):
    nmpc = cls(model())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(P_CSTR)
    nmpc.setup(options={"dt": 0.1}, **setup_kw)
    return nmpc


def _plant():
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", **KW)
    plant.set_initial_conditions([0.2, 0.1])
    plant.set_initial_parameter_values(P_CSTR)
    return plant


class TestTranspiler:
    def test_cstr_rhs_emits_c(self):
        body = generate_model_rhs_c(cstr_schaffner_and_zeitz())
        assert "const double aux_r" in body
        assert "dx[0] =" in body and "dx[1] =" in body
        assert "exp(" in body

    def test_integer_power_unrolls(self):
        c = _CExpr({"x": "x[0]"}).emit("x**2 + x**3")
        assert "pow" not in c
        assert c.count("x[0]") == 5

    def test_unknown_name_raises(self):
        with pytest.raises(ValueError, match="unknown name"):
            _CExpr({"x": "x[0]"}).emit("x + zebra")

    def test_unknown_function_raises(self):
        with pytest.raises(ValueError, match="no C mapping"):
            _CExpr({"x": "x[0]"}).emit("besselj(x)")

    def test_callable_equations_rejected(self):
        m = Model()
        m.set_inputs("u")
        m.set_equations(lambda x, z, u, p, t: -x + u)
        with pytest.raises(ValueError, match="DSL"):
            generate_model_rhs_c(m)


class TestGates:
    def test_state_bounds_rejected(self, tmp_path):
        nmpc = _cstr_nmpc(N=6)
        nmpc.set_box_constraints(x_ub=[0.5, 0.5], u_lb=[-5.0], u_ub=[5.0])
        nmpc.setup(options={"dt": 0.1}, **KW)
        with pytest.raises(ValueError, match="input box"):
            generate_nmpc_c(nmpc, str(tmp_path / "should_not_exist.c"))

    def test_trajectory_reference_rejected(self, tmp_path):
        nmpc = NMPC(cstr_schaffner_and_zeitz())
        nmpc.horizon = 5
        nmpc.quad_stage_cost.add_states(weights=[1.0, 1.0], trajectory_tracking=True)
        nmpc.set_parameters(P_CSTR)
        with pytest.raises(ValueError, match="constant references"):
            generate_nmpc_c(nmpc, str(tmp_path / "should_not_exist.c"))

    def test_custom_constraints_rejected(self, tmp_path):
        nmpc = _cstr_nmpc(N=5)
        nmpc.add_stage_constraint(fn=lambda x, u, p, t: x[..., 0] * u[..., 0],
                                  ub=[1.0], n=1)
        nmpc.setup(options={"dt": 0.1}, **KW)
        with pytest.raises(ValueError, match="box input"):
            generate_nmpc_c(nmpc, str(tmp_path / "x.c"))


class TestClosedLoopParity:
    def test_matches_host_nmpc_on_cstr(self, tmp_path, cc):
        nmpc = _cstr_nmpc(N=20)
        src = generate_nmpc_c(nmpc, str(tmp_path / "nmpc_gen.c"))
        assert os.path.getsize(src) > 0
        cstep = load_nmpc(compile_shared(src), 2, 1)
        plant = _plant()
        x = np.array([0.2, 0.1])
        du_max = 0.0
        for _ in range(12):
            u_c = cstep(x)
            u_py = np.asarray(nmpc.optimize(x)).ravel()
            du_max = max(du_max, abs(float(u_c[0]) - float(u_py[0])))
            x = plant.simulate(u=u_py, steps=1)["x"][-1]
        assert du_max < 2e-4, du_max
        assert np.linalg.norm(x - [0.3, 0.18055]) < 2.5e-2

    def test_active_input_bounds_clip_identically(self, tmp_path, cc):
        nmpc = NMPC(cstr_schaffner_and_zeitz())
        nmpc.horizon = 10
        nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
        nmpc.quad_stage_cost.add_inputs(weights=0.01)
        nmpc.set_box_constraints(u_lb=[-0.05], u_ub=[0.05])  # tight: active
        nmpc.set_parameters(P_CSTR)
        nmpc.setup(options={"dt": 0.1}, **KW)
        src = generate_nmpc_c(nmpc, str(tmp_path / "nmpc_gen.c"))
        cstep = load_nmpc(compile_shared(src), 2, 1)
        u_c = cstep([0.1, 0.0])
        u_py = np.asarray(nmpc.optimize([0.1, 0.0])).ravel()
        assert abs(u_c[0]) <= 0.05 + 1e-12
        np.testing.assert_allclose(u_c, u_py, atol=2e-4)

    def test_discrete_model_export(self, tmp_path, cc):
        nmpc = _discrete_nmpc(NMPC, Model)
        src = generate_nmpc_c(nmpc, str(tmp_path / "nmpc_gen.c"))
        assert "k1[NX]" not in open(src).read()  # no RK4 for discrete maps
        cstep = load_nmpc(compile_shared(src), 2, 1)
        u_c = cstep([1.0, 0.5])
        u_py = np.asarray(nmpc.optimize([1.0, 0.5])).ravel()
        np.testing.assert_allclose(u_c, u_py, atol=2e-4)

    def test_setup_solver_dispatch(self, tmp_path, cc):
        nmpc = _cstr_nmpc(N=6)
        solver = setup_solver(nmpc, workdir=str(tmp_path))
        u_c = solver([0.2, 0.1])
        u_py = np.asarray(nmpc.optimize([0.2, 0.1])).ravel()
        np.testing.assert_allclose(u_c, u_py, atol=5e-4)


def _discrete_nmpc(cls, model_cls, setup_kw=KW):
    m = model_cls()
    m.set_inputs("u")
    m.set_equations("""
    s_0(k+1) = s_0 + 0.1*s_1
    s_1(k+1) = 0.9*s_1 + 0.1*u(k)
    """)
    nmpc = cls(m)
    nmpc.horizon = 8
    nmpc.quad_stage_cost.add_states(weights=[1.0, 1.0])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    nmpc.setup(options={"dt": 1.0, "integration_method": "discrete"}, **setup_kw)
    return nmpc


class TestNativeClosedLoop:
    def test_run_loop_matches_python_loop(self, tmp_path, cc):
        nmpc = _cstr_nmpc(N=20)
        src = generate_closed_loop_c(nmpc, str(tmp_path / "loop_gen.c"))
        run = load_closed_loop(compile_shared(src), 2, 1)
        xs, us = run([0.2, 0.1], 25)
        assert xs.shape == (26, 2) and us.shape == (25, 1)
        assert np.linalg.norm(xs[-1] - [0.3, 0.18055]) < 5e-3
        u_py = np.asarray(nmpc.optimize([0.2, 0.1])).ravel()
        np.testing.assert_allclose(us[0], u_py, atol=2e-4)

    def test_run_loop_respects_input_bounds(self, tmp_path, cc):
        nmpc = NMPC(cstr_schaffner_and_zeitz())
        nmpc.horizon = 8
        nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
        nmpc.quad_stage_cost.add_inputs(weights=0.001)
        nmpc.set_box_constraints(u_lb=[-0.1], u_ub=[0.1])
        nmpc.set_parameters(P_CSTR)
        nmpc.setup(options={"dt": 0.1}, **KW)
        src = generate_closed_loop_c(nmpc, str(tmp_path / "loop_gen.c"))
        run = load_closed_loop(compile_shared(src), 2, 1)
        _, us = run([0.1, 0.0], 10)
        assert np.all(np.abs(us) <= 0.1 + 1e-12)


class TestEmissionParity:
    """The same controller in both packages: byte-identical C."""

    def _jax(self):
        from hilo_mpc_tpu import NMPC as JaxNMPC
        from hilo_mpc_tpu import Model as JaxModel
        from hilo_mpc_tpu.embedded import nmpc_codegen as jc
        from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr

        return JaxNMPC, JaxModel, jc, jax_cstr

    def test_cstr_controller_and_loop_bytes_equal(self, tmp_path):
        JaxNMPC, _, jc, jax_cstr = self._jax()
        j = _cstr_nmpc(N=20, cls=JaxNMPC, model=jax_cstr, setup_kw={})
        t = _cstr_nmpc(N=20)
        for jgen, tgen in ((jc.generate_nmpc_c, generate_nmpc_c),
                           (jc.generate_closed_loop_c, generate_closed_loop_c)):
            a = open(jgen(j, str(tmp_path / "j.c"))).read()
            b = open(tgen(t, str(tmp_path / "t.c"))).read()
            assert a == b

    def test_discrete_controller_bytes_equal(self, tmp_path):
        JaxNMPC, JaxModel, jc, _ = self._jax()
        a = open(jc.generate_nmpc_c(_discrete_nmpc(JaxNMPC, JaxModel, setup_kw={}),
                                    str(tmp_path / "j.c"))).read()
        b = open(generate_nmpc_c(_discrete_nmpc(NMPC, Model), str(tmp_path / "t.c"))).read()
        assert a == b
