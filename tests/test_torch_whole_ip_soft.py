"""PyTorch port: soft state bounds in the whole-solve interior point
(ops/whole_ip.py, ops/codegen_cuda.py, csrc/whole_ip.cuh), and the gate that
sends every other non-quadratic cost to the general path (CPU).

- The soft-box problem (the CSTR with |u| <= 5 and soft 0 <= x_1 <= 0.27,
  0 <= x_2 <= 0.8, w = 500, started where the x_1 bound is violated): its
  plain version against the JAX kernel ``solve_ocp_pallas_full`` in
  interpret mode (small N and B; the kernel computes in float32, so U/X to
  5e-4 and equal iterations, tests/test_pallas_ip.py:57-65); its host build
  (the kernel's own code) against the plain version, float64 to 1e-12 with
  equal iterations, float32 to 5e-4.
- The emitted source: the flagship's Problem holds no soft code; the soft
  one's numbers sit in prm, so weights and bounds share one build.
- The gate: a generic cost, a measurement term and a soft callable
  constraint take the whole-solve path through the trace
  (ops/codegen_fx.py) without a warning, its host build against the plain
  version; a hard generic row warns under ``pallas_full`` and gives the
  general path's answer; soft state bounds take the whole-solve path, and
  the launch cache keys on their numbers.
- ``cuda``: the soft-box kernel against its plain version on the card.
"""
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
# the option set of tests/test_pallas_ip.py:_flagship
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 10,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}
SOFT = dict(u_lb=[-5.0], u_ub=[5.0], x_lb=[0.0, 0.0], x_ub=[0.27, 0.8],
            x_soft=True, soft_weight=500.0)


def _nmpc(cls, model, N, bounds, options=None, configure=None, **setup_kw):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(**bounds)
    nmpc.set_parameters([1.0] * 6)
    if configure is not None:
        configure(nmpc)
    nmpc.setup(options={**KERNEL_OPTS, **(options or {})}, **setup_kw)
    return nmpc


def _port(N, bounds=SOFT, dtype=F64, device=CPU, **kw):
    return _nmpc(NMPC, cstr_schaffner_and_zeitz(), N, bounds, device=device,
                 dtype=dtype, **kw)


def _x0s(B, seed):
    """Starts above the soft bound x_1 <= 0.27."""
    rng = np.random.default_rng(seed)
    return np.array([0.29, 0.17]) + 0.02 * rng.standard_normal((B, 2))


def _plain(nmpc, args):
    return W.solve_ocp_full_reference(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                      nmpc._ip_opts)


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def test_plain_matches_pallas_interpret():
    jn = _nmpc(JaxNMPC, jax_cstr(), 3, SOFT)
    args = jn.prepare_batch(_x0s(4, 0))
    jsol = jax.tree.map(np.asarray, solve_ocp_pallas_full(
        jn._funcs, jn._dims, jn._bounds, *args, options=jn._ip_opts, tile_b=8))
    tn = _port(3)
    assert not tn._ip_opts.const_cost_hessian and not jn._ip_opts.const_cost_hessian
    sol = to_numpy(_plain(tn, to_torch(args, device=CPU)))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, atol=5e-4)
    np.testing.assert_allclose(sol.objective, jsol.objective, rtol=1e-4)
    assert (sol.X[:, 1:, 0] > 0.27).any()          # the penalty is active


@pytest.mark.parametrize("N,B,seed", [(6, 5, 1), (12, 6, 2)])
def test_host_kernel_matches_plain_f64(N, B, seed):
    """The kernel's per-scenario solve with the emitted penalty against the
    plain version (autograd of the controller's own cost) in float64."""
    _need_cxx()
    tn = _port(N)
    args = tn.prepare_batch(_x0s(B, seed))
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations)
    assert torch.equal(k.converged, r.converged) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.objective, r.objective, rtol=1e-12, atol=0)
    assert bool((r.X[:, 1:, 0] > 0.27).any())


def test_host_kernel_matches_plain_f32():
    _need_cxx()
    tn = _port(12, dtype=torch.float32)
    args = tn.prepare_batch(_x0s(6, 2))
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    both = k.converged & r.converged
    assert bool(both.all())
    torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=5e-4)


# -- the emitted source ---------------------------------------------------------

def _problem(nmpc):
    return W.whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds, 8, nmpc._ip_opts)


def test_flagship_problem_has_no_soft_code():
    flag = _problem(_port(4, bounds=dict(u_lb=[-5.0], u_ub=[5.0])))
    soft = _problem(_port(4))
    for marker in ("sp = sp", "m_fmax(x[", "if (x["):
        assert marker not in flag.text and marker in soft.text
    # the flagship's Hessian functions read neither the point nor theta's rows
    body = flag.text[flag.text.index("stage_hess"):flag.text.index("term_cost")]
    assert "xs[" not in body and "us[" not in body


def test_soft_numbers_share_one_build():
    a = _problem(_port(4))
    b = _problem(_port(4, bounds={**SOFT, "x_ub": [0.26, 0.9], "soft_weight": 80.0}))
    assert a.text == b.text and not np.array_equal(a.prm, b.prm)
    c = _problem(_port(4, bounds={**SOFT, "x_lb": [-np.inf, -np.inf]}))
    assert c.text != a.text                 # which bounds exist is structure


# -- the gate -------------------------------------------------------------------

def _hard_row(n):
    n.add_stage_constraint(lambda x, u: x[..., 1] + 0.5 * u[..., 0], ub=0.5, n=1)


def _generic_cost(n):
    n.stage_cost.cost = lambda x: (x[..., 0] - 0.3) ** 4


def _measurement(n):
    n.quad_terminal_cost.add_measurements(weights=1.0, ref=[0.18])


def _soft_callable(n):
    n.add_terminal_constraint(lambda x: x[..., 0], ub=0.28, n=1, is_soft=True)


TRACED = {"generic_cost": _generic_cost, "measurement_term": _measurement,
          "soft_callable_constraint": _soft_callable}
GATE = {"hard_generic_row": _hard_row}


@pytest.mark.parametrize("case", sorted(TRACED))
def test_gate_takes_traced_costs_to_the_kernel(case):
    """pallas_full with a cost part the DSL emitter cannot write: no warning,
    the whole-solve path (on CPU its plain version, bit for bit; no Riccati
    launch), a traced build whose host run matches the plain version
    (float64, equal iterations, 1e-12)."""
    _need_cxx()
    tn = _port(4, bounds=dict(u_lb=[-5.0], u_ub=[5.0]), options={"pallas_full": True},
               configure=TRACED[case])
    args = tn.prepare_batch(_x0s(3, 5))
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    assert tn._wip["eligible"] and "codegen_fx.py" in tn._wip["problem"].text
    sol, r = fn(*args), _plain(tn, args)
    for a, b in zip(sol, r):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    assert bool(r.converged.all()) and torch.equal(k.iterations, r.iterations)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", sorted(GATE))
def test_gate_sends_other_costs_to_the_general_path(case):
    """A hard generic row: both gates decline it, the warning names it and
    the answer is the general path's."""
    configure = GATE[case]
    tn = _port(4, bounds=dict(u_lb=[-5.0], u_ub=[5.0]), options={"pallas_full": True},
               configure=configure)
    args = tn.prepare_batch(_x0s(3, 5))
    with pytest.warns(UserWarning, match="hard generic inequality rows"):
        fn = tn.solve_batch_fn()
    ref = _port(4, bounds=dict(u_lb=[-5.0], u_ub=[5.0]), configure=configure)
    for a, b in zip(fn(*args), ref.solve_batch_fn()(*args)):
        assert torch.equal(a, b)


def test_soft_bounds_take_the_whole_solve_path():
    tn = _port(4, options={"pallas_full": True})
    args = tn.prepare_batch(_x0s(4, 2))
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sol = tn.solve_batch_fn()(*args)
    for a, b in zip(sol, _plain(tn, args)):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric
    key = tn._weights_key()
    assert key[-1] == ((0.0, 0.0), (0.27, 0.8), 500.0)
    tn.set_box_constraints(**{**SOFT, "soft_weight": 50.0})
    tn.setup(options={**KERNEL_OPTS, "pallas_full": True}, device=CPU, dtype=F64)
    assert tn._weights_key() != key


# -- on the card ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_soft_kernel_matches_plain_on_card(dtype):
    """The soft-box kernel against its plain version at N=20, B=1024:
    float64 equal iterations and U to 1e-12; float32 U to 5e-4 on the
    jointly converged scenarios."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    tn = _port(20, dtype=dt, device="cuda")
    args = tn.prepare_batch(_x0s(1024, 0))
    n0 = W.solve_ocp_full_cuda.launches
    k = W.solve_ocp_full_cuda(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = _plain(tn, args)
    torch.cuda.synchronize()
    assert W.solve_ocp_full_cuda.launches == n0 + 1
    both = k.converged & r.converged
    assert bool(both.float().mean() >= 0.97)
    if dt == F64:
        assert torch.equal(k.iterations, r.iterations)
        torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-12)
    else:
        torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=5e-4)
