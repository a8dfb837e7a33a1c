"""PyTorch port: LMPC (condensing, the FGM box-QP kernel's plain version, the
fast path and the interior point), the golden lmpc_di replay and LQR against
the JAX package (CPU), plus the FGM kernel itself where a card is present."""
import os

import numpy as np
import pytest
import torch

from golden_configs import LMPC_A, LMPC_B, build_lmpc_di
from hilo_mpc_tpu import LMPC as JaxLMPC, LQR as JaxLQR, Model as JaxModel
from hilo_mpc_tpu.embedded.codegen import condense_lmpc as jax_condense
from hilo_mpc_tpu.ops.pallas_kernels import fgm_boxqp_batch, fgm_boxqp_batch_xla
from hilo_mpc_tpu_torch import LMPC, LQR, Model
from hilo_mpc_tpu_torch.control.lmpc import condense_lmpc
from hilo_mpc_tpu_torch.ops.cuda_kernels import (FGM_MAX_N, fgm_boxqp_cuda,
                                                 fgm_boxqp_reference, fgm_constants)
from hilo_mpc_tpu_torch.utils.interop import lmpc_from, lqr_from

torch.set_num_threads(1)
CPU = "cpu"
F32, F64 = torch.float32, torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lmpc_di.npz")


def make_qp(n=6, nx=2, seed=0):
    """The random box-QP generator of tests/test_pallas_kernels.py:12-19."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return M @ M.T + np.eye(n), rng.normal(size=(n, nx)), -np.ones(n), np.ones(n)


def _t(a, dtype=F32):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype)


def report(what, actual, desired):
    """Largest absolute deviation over the pairs of arrays, printed so that
    ``pytest -rP`` shows the sizes ROADMAP.md §C records."""
    dev = max(float(np.max(np.abs(np.asarray(a, float) - np.asarray(b, float)),
                           initial=0.0)) for a, b in zip(actual, desired))
    print(f"{what}: max abs deviation {dev:.3e}")
    return dev


def double_integrator(cls, dt=0.1, C=True):
    m = cls(discrete=True)
    m.set_state_space(A=[[1.0, dt], [0.0, 1.0]], B=[[0.5 * dt ** 2], [dt]],
                      C=[[1.0, 0.0]] if C else None)
    return m


@pytest.mark.parametrize("with_P", [True, False])
def test_condense_matches_jax(with_P):
    rng = np.random.default_rng(0)
    A = np.eye(3) + 0.1 * rng.standard_normal((3, 3))
    B = rng.standard_normal((3, 2))
    M = rng.standard_normal((3, 3))
    Q, R, P = np.diag([2.0, 1.0, 0.5]), np.diag([0.1, 0.3]), M @ M.T
    out = condense_lmpc(A, B, Q, R, P if with_P else None, 6)
    ref = jax_condense(A, B, Q, R, P if with_P else None, 6)
    report(f"condense_lmpc (H, G), P={with_P}", out, ref)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_condensed_qp_matches_jax():
    """The golden lmpc_di configuration (state bounds, N=15, P): the port's
    condensed QP is the JAX one; the state bounds do not enter it."""
    jl, _ = build_lmpc_di()
    tl = lmpc_from(jl)
    assert np.isfinite(tl._x_lb).any() or np.isfinite(tl._x_ub).any()
    report("LMPC.condensed_qp, golden lmpc_di", tl.condensed_qp(), jl.condensed_qp())
    for a, b in zip(tl.condensed_qp(), jl.condensed_qp()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("u0", [False, True])
@pytest.mark.parametrize("inf_bounds", [False, True])
def test_fgm_reference_matches_xla_twin(inf_bounds, u0):
    """fgm_boxqp_reference against fgm_boxqp_batch_xla (float32, 1e-5)."""
    H, G, lb, ub = make_qp()
    if inf_bounds:
        lb[::2], ub[1::3] = -np.inf, np.inf
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(17, 2))
    U0 = 0.1 * rng.normal(size=(17, 6)) if u0 else None
    ref = np.asarray(fgm_boxqp_batch_xla(H, G, x0, lb, ub, iters=200, u0_batch=U0))
    out = fgm_boxqp_reference(_t(H), _t(G), _t(x0), _t(lb), _t(ub), 200,
                              None if U0 is None else _t(U0))
    assert out.dtype == F32 and out.shape == (17, 6)
    report("fgm_boxqp_reference vs fgm_boxqp_batch_xla (float32)", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_fgm_reference_matches_pallas_interpret():
    """The plain version against the Pallas kernel in interpret mode, as
    tests/test_pallas_kernels.py:22-28 runs it (small tile_b, small n)."""
    H, G, lb, ub = make_qp(n=5, seed=3)
    x0 = np.random.default_rng(4).normal(size=(9, 2))
    ref = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=60, tile_b=8))
    out = fgm_boxqp_reference(_t(H), _t(G), _t(x0), _t(lb), _t(ub), 60)
    report("fgm_boxqp_reference vs Pallas interpret (float32)", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_fgm_closed_form_unconstrained():
    H, G, _, _ = make_qp()
    x0 = np.random.default_rng(2).normal(size=(4, 2)) * 0.1
    u = fgm_boxqp_reference(_t(H), _t(G), _t(x0), _t(-1e3 * np.ones(6)),
                            _t(1e3 * np.ones(6)), 400)
    np.testing.assert_allclose(u.numpy(), -(np.linalg.solve(H, G @ x0.T)).T, atol=1e-4)


def test_fgm_active_bounds():
    # the unconstrained optimum -G x0 = (-10, -10, 0) clips to the bounds
    u = fgm_boxqp_reference(_t(np.eye(3)), _t(np.eye(3)[:, :2] * 10.0),
                            _t([[1.0, 1.0]]), _t(-0.5 * np.ones(3)),
                            _t(0.5 * np.ones(3)), 100)
    np.testing.assert_allclose(u[0].numpy(), [-0.5, -0.5, 0.0], atol=1e-6)


def test_cpu_tensors_never_launch_the_fgm_kernel():
    H, G, lb, ub = (_t(a) for a in make_qp())
    x0 = _t(np.random.default_rng(5).normal(size=(3, 2)))
    fgm_boxqp_cuda.launches = 0
    out = fgm_boxqp_cuda(H, G, x0, lb, ub, 50)
    assert fgm_boxqp_cuda.launches == 0
    assert torch.equal(out, fgm_boxqp_reference(H, G, x0, lb, ub, 50))


@pytest.mark.parametrize("tf32", [False, True])
def test_fgm_reference_restores_the_tf32_setting(tf32):
    H, G, lb, ub = (_t(a) for a in make_qp())
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        fgm_boxqp_reference(H, G, _t(np.ones((2, 2))), lb, ub, 5)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_optimize_batch_fgm_takes_constants_of_the_float64_H():
    """The fast path hands the wrapper 1/L and β of the float64 condensed H
    (as the JAX twin computes them), not of its float32 copy."""
    _, tl = _fgm_pair()
    H, G, lb, ub = tl.condensed_qp()
    consts = fgm_constants(H)
    out = fgm_boxqp_reference(*(_t(a) for a in (H, G, X0S, lb, ub)), 200,
                              constants=consts)
    np.testing.assert_array_equal(tl.optimize_batch_fgm(X0S, iters=200),
                                  out[:, :1].numpy())
    assert consts == fgm_constants(np.asarray(H, dtype=float))
    assert consts != fgm_constants(_t(H))


def _fgm_pair(horizon=10, P=None, state_bounds=False):
    """The LMPC of tests/test_pallas_kernels.py:49-67 on both sides."""
    pair = []
    for cls, mcls in ((JaxLMPC, JaxModel), (LMPC, Model)):
        lmpc = cls(double_integrator(mcls))
        lmpc.horizon = horizon
        lmpc.Q = np.diag([5.0, 1.0])
        lmpc.R = np.array([[0.5]])
        if P is not None:
            lmpc.P = P
        lmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
        if state_bounds:
            lmpc.set_box_constraints(x_lb=[-np.inf, -1.2], x_ub=[np.inf, 1.2])
        pair.append(lmpc)
    jl, tl = pair
    jl.setup(options={"dt": 0.1, "tol": 1e-10})
    tl.setup(options={"dt": 0.1, "tol": 1e-10}, device=CPU, dtype=F64)
    return jl, tl


X0S = np.array([[1.0, 0.0], [2.0, -1.0], [-1.5, 0.5], [0.3, 0.3]])


def _count_condensing(monkeypatch):
    """Count the calls of condense_lmpc and fgm_constants made by LMPC."""
    from hilo_mpc_tpu_torch.control import lmpc as lmpc_module
    calls = {"condense": 0, "spectrum": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(lmpc_module, "condense_lmpc",
                        counted("condense", lmpc_module.condense_lmpc))
    monkeypatch.setattr(lmpc_module, "fgm_constants",
                        counted("spectrum", lmpc_module.fgm_constants))
    return calls


def test_fgm_path_condenses_once(monkeypatch):
    """A second call with the same configuration condenses nothing and takes
    no spectrum; its result is bit-equal to the first."""
    calls = _count_condensing(monkeypatch)
    _, tl = _fgm_pair()
    first = tl.optimize_batch_fgm(X0S, iters=50)
    second = tl.optimize_batch_fgm(X0S[::-1].copy(), iters=50)
    third = tl.optimize_batch_fgm(X0S, iters=50, backend="xla")
    assert calls == {"condense": 1, "spectrum": 1}
    np.testing.assert_array_equal(second, first[::-1])
    np.testing.assert_array_equal(third, first)


FGM_CHANGES = {
    "Q": lambda c: setattr(c, "Q", np.diag([4.0, 1.0])),
    "R": lambda c: setattr(c, "R", np.array([[0.3]])),
    "P": lambda c: setattr(c, "P", np.diag([8.0, 2.0])),
    "horizon": lambda c: setattr(c, "horizon", 7),
    "u_bounds": lambda c: c.set_box_constraints(u_lb=-0.05, u_ub=0.04),
}


@pytest.mark.parametrize("change", sorted(FGM_CHANGES))
def test_fgm_cache_follows_the_configuration(change, monkeypatch):
    """Changing Q, R, P, the horizon or the input bounds after a call builds
    the condensed QP anew: the next call gives what a controller set up with
    the new configuration from the start gives, bit for bit."""
    calls = _count_condensing(monkeypatch)
    x0s = 0.2 * X0S                   # first moves inside the bounds
    _, tl = _fgm_pair()
    before = tl.optimize_batch_fgm(x0s, iters=60)
    FGM_CHANGES[change](tl)
    after = tl.optimize_batch_fgm(x0s, iters=60)
    assert calls == {"condense": 2, "spectrum": 2}
    _, fresh = _fgm_pair()
    FGM_CHANGES[change](fresh)
    np.testing.assert_array_equal(after, fresh.optimize_batch_fgm(x0s, iters=60))
    assert not np.array_equal(after, before)


def test_fgm_cached_equals_uncached():
    """The cached path against the uncached computation it replaces: the
    condensed QP cast to float32 tensors, x0 cast from float64, the
    constants of the float64 H; bit-equal on the CPU, call after call."""
    _, tl = _fgm_pair(P=np.diag([8.0, 2.0]))
    x0s = np.random.default_rng(11).normal(size=(37, 2))
    H, G, lb, ub = tl.condensed_qp()
    kw = dict(dtype=F32)
    ref = fgm_boxqp_reference(*(torch.as_tensor(a, **kw) for a in (H, G, x0s, lb, ub)),
                              80, constants=fgm_constants(H))
    for _ in range(2):
        np.testing.assert_array_equal(tl.optimize_batch_fgm(x0s, iters=80),
                                      ref[:, :1].numpy())


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("state_bounds", [False, True])
def test_optimize_batch_fgm_matches_jax(state_bounds, backend):
    """Port and JAX take the same condensed QP; the state bounds are absent
    from the FGM path on both sides (the reference's behaviour)."""
    jl, tl = _fgm_pair(state_bounds=state_bounds)
    ref = jl.optimize_batch_fgm(X0S, iters=200, backend="xla")
    out = tl.optimize_batch_fgm(X0S, iters=200, backend=backend)
    assert out.shape == (4, 1)
    report("LMPC.optimize_batch_fgm vs JAX (float32)", [out], [ref])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if state_bounds:
        _, free = _fgm_pair()
        np.testing.assert_array_equal(out, free.optimize_batch_fgm(X0S, iters=200))


def test_fgm_matches_interior_point():
    """tests/test_pallas_kernels.py:49-67 in the port: the fast path against
    the port's own interior point (atol 5e-4)."""
    _, tl = _fgm_pair()
    u_fgm = tl.optimize_batch_fgm(X0S, iters=400)
    u_ip, sol = tl.optimize_batch(X0S)
    assert bool(sol.converged.all())
    report("optimize_batch_fgm (400 iters) vs the port's interior point",
           [u_fgm], [u_ip])
    np.testing.assert_allclose(u_fgm, u_ip, atol=5e-4)
    for i, x0 in enumerate(X0S):
        tl._warm = None
        np.testing.assert_allclose(u_fgm[i], tl.optimize(x0), atol=5e-4)


def test_interior_point_matches_jax():
    jl, tl = _fgm_pair(P=np.diag([8.0, 2.0]), state_bounds=True)
    uj, _ = jl.optimize_batch(X0S)
    ut, sol = tl.optimize_batch(X0S)
    assert bool(sol.converged.all())
    report("LMPC interior point vs JAX (state bounds, P)", [ut], [uj])
    np.testing.assert_allclose(ut, np.asarray(uj), rtol=0, atol=1e-9)


def test_fgm_entry_point_checks():
    _, tl = _fgm_pair()
    with pytest.raises(ValueError, match="backend"):
        tl.optimize_batch_fgm(X0S, backend="pallas")
    tl.set_reference(x_ref=[1.0, 0.0])
    with pytest.raises(NotImplementedError, match="regulation"):
        tl.optimize_batch_fgm(X0S)
    fresh = LMPC(double_integrator(Model))
    fresh.horizon = 5
    with pytest.raises(RuntimeError, match="setup"):
        fresh.optimize_batch_fgm(X0S)


def _nonlinear(cls):
    m = cls()
    m.set_dynamical_states("x")
    m.set_dynamical_equations(lambda x: -x ** 3)
    return m


WEIGHT_ERRORS = {
    "R_not_pd": lambda c: setattr(c, "R", np.zeros((1, 1))),
    "Q_not_symmetric": lambda c: setattr(c, "Q", [[1.0, 2.0], [0.0, 1.0]]),
    "Q_shape": lambda c: setattr(c, "Q", np.eye(3)),
    "P_not_psd": lambda c: setattr(c, "P", -np.eye(2)),
}


@pytest.mark.parametrize("case", sorted(WEIGHT_ERRORS))
def test_weight_validation_matches_jax(case):
    """tests/test_control_loop.py:21-37 on both sides."""
    for cls, mcls in ((JaxLMPC, JaxModel), (LMPC, Model)):
        with pytest.raises(ValueError):
            WEIGHT_ERRORS[case](cls(double_integrator(mcls)))


def test_requires_linear_model():
    for cls, mcls in ((JaxLMPC, JaxModel), (LMPC, Model), (JaxLQR, JaxModel),
                      (LQR, Model)):
        with pytest.raises(ValueError, match="linear"):
            cls(_nonlinear(mcls))


def test_golden_lmpc_di_replay():
    """tests/golden/lmpc_di.npz through the port's LMPC.optimize (float64,
    CPU): max|u - u_gold| < 1e-4 over every closed-loop step
    (tests/test_golden_parity.py:40-54)."""
    data = np.load(GOLDEN)
    jl, _ = build_lmpc_di()
    tl = lmpc_from(jl)
    tl.setup(options={"dt": 0.1, "tol": 1e-9, "max_iter": 80}, device=CPU, dtype=F64)
    X_meas, U_gold = data["X_meas"], data["U_gold"]
    assert U_gold.shape[0] >= 20
    devs = []
    for k in range(U_gold.shape[0]):
        u = tl.optimize(X_meas[k])
        assert tl.stats["converged"]
        devs.append(np.abs(u - U_gold[k]).max())
    print(f"golden lmpc_di replay: max|u - u_gold| {max(devs):.3e}")
    assert max(devs) < 1e-4, devs


@pytest.mark.parametrize("horizon", [None, 5, 30])
@pytest.mark.parametrize("continuous", [False, True])
def test_lqr_matches_jax(horizon, continuous):
    """Finite and infinite horizon K and P (float64, 1e-10); a continuous
    model is discretized by zero-order hold on both sides."""
    jm = JaxModel(discrete=not continuous)
    if continuous:
        jm.set_state_space(A=[[0.0, 1.0], [0.0, 0.0]], B=[[0.0], [1.0]])
    else:
        jm.set_state_space(A=LMPC_A, B=LMPC_B)
    jq = JaxLQR(jm)
    jq.horizon = horizon
    jq.Q = np.diag([5.0, 1.0])
    jq.R = np.array([[0.1]])
    jq.setup(dt=0.1)
    tq = lqr_from(jq)
    tq.setup(dt=0.1, device=CPU, dtype=F64)
    report("LQR K and P", [tq.K, tq.P], [jq.K, jq._P])
    np.testing.assert_allclose(tq.K, jq.K, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tq.P, jq._P, rtol=0, atol=1e-10)
    x = np.array([1.0, -0.5])
    np.testing.assert_allclose(tq(x), jq(x), rtol=0, atol=1e-10)
    if horizon is None and not continuous:
        import scipy.linalg
        P = scipy.linalg.solve_discrete_are(LMPC_A, LMPC_B, np.diag([5.0, 1.0]),
                                            np.array([[0.1]]))
        np.testing.assert_allclose(tq.P, P, rtol=0, atol=1e-8)


def test_lqr_entry_points():
    q = LQR(double_integrator(Model, C=False))
    with pytest.raises(RuntimeError, match="not set up"):
        q([1.0, 0.0])
    q.setup(device=CPU, dtype=F64)
    with pytest.raises(RuntimeError, match="Matrix Q"):
        q([1.0, 0.0])
    q.Q, q.R = np.eye(2), 0.1
    with pytest.raises(ValueError, match="state"):
        q.call()
    assert q([1.0, 0.0]).shape == (1,)
    with pytest.raises(ValueError, match="horizon"):
        q.horizon = 0


@pytest.mark.cuda
@pytest.mark.parametrize("u0", [False, True])
@pytest.mark.parametrize("n", [1, 6, 20, 64, FGM_MAX_N])
def test_fgm_kernel_matches_plain_on_card(n, u0):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    H, G, lb, ub = make_qp(n=n)
    lb[::2] = -np.inf
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(1000, 2))
    dev = dict(dtype=F32, device="cuda")
    args = [torch.as_tensor(a, **dev) for a in (H, G, x0, lb, ub)]
    U0 = torch.as_tensor(0.1 * rng.normal(size=(1000, n)), **dev) if u0 else None
    n0 = fgm_boxqp_cuda.launches
    out = fgm_boxqp_cuda(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    torch.cuda.synchronize()
    assert fgm_boxqp_cuda.launches == n0 + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_fgm_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    H, G, lb, ub = make_qp(n=FGM_MAX_N + 1)
    dev = dict(dtype=F32, device="cuda")
    args = [torch.as_tensor(a, **dev) for a in (H, G, np.zeros((4, 2)), lb, ub)]
    with pytest.raises(ValueError, match="FGM_MAX_N"):
        fgm_boxqp_cuda(*args, 10)
    args = [torch.as_tensor(a, **dev) for a in make_qp(n=6)]
    with pytest.raises(ValueError, match="float32"):
        fgm_boxqp_cuda(args[0].double(), args[1], torch.zeros(4, 2, **dev),
                       args[2], args[3], 10)
