"""PyTorch port: the interior point's three last options against the JAX
package (CPU).

- ``record_iterates``: the per-iteration history, batch-first, against the
  vmapped JAX history (float64, 1e-10, equal iteration counts; zeros past
  each scenario's last iteration), and through ``NMPC`` (``ipopt_debugger``).
- ``parallel_riccati``: ``ops/riccati.py:solve_lq_parallel`` against the JAX
  ``solve_lq_parallel`` and against the port's sequential ``solve_lq`` at
  N in {1, 3, 20, 37} (1e-10); ``solve_ocp(parallel_riccati=True)`` against
  the JAX solver (1e-9, equal iterations), the controller's and the MHE
  window's (free initial state).
- ``lin_storage_dtype="bfloat16"``: in float32 the port's U lies within the
  JAX bf16 route's own distance from its float32 route (measured here) plus
  1e-4 of JAX's bf16 answer; float64 ignores the option bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.estimation.mhe import MovingHorizonEstimator as JaxMHE
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops import riccati as jric
from hilo_mpc_tpu_torch import MHE, NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import ip_solver as tip
from hilo_mpc_tpu_torch.ops import riccati as tric
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
FLAGSHIP = {"tol": 1e-4, "max_iter": 25, "convexify": False, "n_linesearch": 1,
            "mu_init": 1e-2, "mehrotra": False}
DEFAULTS = {"tol": 1e-9, "max_iter": 60}     # Mehrotra, convexify, 10 candidates
OPTION_SETS = {"flagship": FLAGSHIP, "defaults": DEFAULTS,
               "fixed_iterations": {**FLAGSHIP, "early_exit": False, "max_iter": 8}}


def _nmpc(cls, model, options, N=10, **kw):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-0.5], u_ub=[0.5])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options}, **kw)
    return nmpc


def _pair(options, N=10):
    return (_nmpc(JaxNMPC, jax_cstr(), options, N),
            _nmpc(NMPC, cstr_schaffner_and_zeitz(), options, N, device=CPU, dtype=F64))


def _x0s(B=5, seed=5):
    return np.array([0.2, 0.1]) + 0.06 * np.random.default_rng(seed).standard_normal((B, 2))


# -- record_iterates ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_history_matches_jax(name):
    jn, tn = _pair({**OPTION_SETS[name], "ipopt_debugger": True})
    args = jn.prepare_batch(_x0s())
    jsol, jhist = jn.solve_batch_fn()(*args)
    tsol, thist = tn.solve_batch_fn()(*to_torch(args, device=CPU))
    th = {k: v.numpy() for k, v in thist.items()}
    np.testing.assert_array_equal(th["n"], np.asarray(jhist["n"]))
    np.testing.assert_array_equal(th["n"], tsol.iterations.numpy())
    max_iter = tn._ip_opts.max_iter
    assert th["X"].shape == (5, max_iter, 11, 2) and th["U"].shape == (5, max_iter, 10, 1)
    for k in ("X", "U", "kkt", "mu", "objective"):
        a, b = th[k], np.asarray(jhist[k])
        assert a.shape == b.shape, k
        # the KKT error of a scenario's first iterate may be huge: relative
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10, err_msg=k)
    for b, n in enumerate(th["n"]):
        for k in ("X", "U", "kkt", "mu", "objective"):
            assert not th[k][b, n:].any(), (k, b)
    np.testing.assert_allclose(tsol.U.numpy(), np.asarray(jsol.U), atol=1e-10)


def test_history_through_optimize():
    """NMPC(ipopt_debugger) keeps one scenario's history in
    iteration_history, as the JAX controller does; plot_iterations names
    the ROADMAP item for plotting."""
    jn, tn = _pair({**FLAGSHIP, "ipopt_debugger": True})
    with pytest.raises(RuntimeError, match="ipopt_debugger"):
        tn.plot_iterations()
    x0 = np.array([0.2, 0.1])
    for _ in range(2):            # cold, then warm
        uj, ut = jn.optimize(x0), tn.optimize(x0)
        np.testing.assert_allclose(ut, uj, atol=1e-10)
        jh, th = jn.iteration_history, tn.iteration_history
        assert set(th) == set(jh)
        assert int(th["n"]) == int(jh["n"]) == tn.stats["iterations"]
        for k in ("X", "U", "kkt", "mu", "objective"):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-10, atol=1e-10)
    # the recorded history draws as the JAX package's figure does
    import matplotlib
    matplotlib.use("Agg")
    fig, jfig = tn.plot_iterations(), jn.plot_iterations()
    assert len(fig.axes) == len(jfig.axes) == 3
    for a, b in zip(fig.axes, jfig.axes):
        assert len(a.get_lines()) == len(b.get_lines())
        for la, lb in zip(a.get_lines(), b.get_lines()):
            np.testing.assert_allclose(la.get_xydata(), lb.get_xydata(), atol=1e-10)


# -- the parallel Riccati scans --------------------------------------------------

def _lq(N, nx=3, nu=2, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.1 * rng.standard_normal(batch + (N, nx, nx))
    B = 0.3 * rng.standard_normal(batch + (N, nx, nu))
    L = rng.standard_normal(batch + (N, nx + nu, nx + nu))
    H = L @ np.swapaxes(L, -1, -2) / (nx + nu) + 0.5 * np.eye(nx + nu)
    q = rng.standard_normal(batch + (N, nx))
    r = rng.standard_normal(batch + (N, nu))
    c = 0.1 * rng.standard_normal(batch + (N, nx))
    P = 2.0 * np.eye(nx) + np.zeros(batch + (nx, nx))
    p = rng.standard_normal(batch + (nx,))
    dx0 = rng.standard_normal(batch + (nx,))
    return (A, B, H[..., :nx, :nx], H[..., nx:, :nx], H[..., nx:, nx:], q, r, c, P, p,
            dx0)


@pytest.mark.parametrize("N", [1, 3, 20, 37])
def test_solve_lq_parallel_matches_jax_and_sequential(N):
    blocks = _lq(N, seed=N)
    # jitted: one compile instead of an eager dispatch of every op of the
    # scans (the same bits)
    jsol = jax.jit(lambda *b: jric.solve_lq_parallel(*b, reg=1e-9))(
        *map(jnp.asarray, blocks))
    tblocks = [torch.as_tensor(b) for b in blocks]
    psol = tric.solve_lq_parallel(*tblocks, reg=1e-9)
    ssol = tric.solve_lq(*tblocks, reg=1e-9)
    for f in psol._fields:
        a = getattr(psol, f).numpy()
        np.testing.assert_allclose(a, np.asarray(getattr(jsol, f)), rtol=0, atol=1e-10,
                                   err_msg=f)
        np.testing.assert_allclose(a, getattr(ssol, f).numpy(), rtol=0, atol=1e-10,
                                   err_msg=f)


def test_solve_lq_parallel_batch_and_free_x0():
    """Leading batch dims (each scenario its own problem, the same as one at
    a time) and a free initial state (the plain solve's dx_0)."""
    blocks = [torch.as_tensor(b) for b in _lq(9, seed=3, batch=(4,))]
    sol = tric.solve_lq_parallel(*blocks, reg=1e-9)
    for b in range(4):
        one = tric.solve_lq_parallel(*[x[b] for x in blocks], reg=1e-9)
        np.testing.assert_allclose(sol.dX[b].numpy(), one.dX.numpy(), atol=1e-12)
    free = tric.solve_lq_parallel(*blocks[:-1], None, reg=1e-9)
    ref = tric.solve_lq(*blocks[:-1], None, reg=1e-9)
    for f in ("dX", "dU", "lam", "K", "kff"):
        np.testing.assert_allclose(getattr(free, f).numpy(), getattr(ref, f).numpy(),
                                   atol=1e-10, err_msg=f)


@pytest.mark.parametrize("name", ["flagship", "defaults"])
def test_parallel_riccati_solve_matches_jax(name):
    jn, tn = _pair({**OPTION_SETS[name], "parallel_riccati": True})
    assert tn._ip_opts.parallel_riccati
    args = jn.prepare_batch(_x0s())
    jsol = jn.solve_batch_fn()(*args)
    tsol = tn.solve_batch_fn()(*to_torch(args, device=CPU))
    assert bool(tsol.converged.all())
    np.testing.assert_array_equal(tsol.iterations.numpy(), np.asarray(jsol.iterations))
    np.testing.assert_allclose(tsol.U.numpy(), np.asarray(jsol.U), atol=1e-9)
    np.testing.assert_allclose(tsol.X.numpy(), np.asarray(jsol.X), atol=1e-9)
    # the sequential route's answer too, and no kernel launch on either
    assert riccati_lq_cuda.launches == 0
    seq = tip.solve_ocp(tn._funcs, tn._dims, tn._bounds, *to_torch(args, device=CPU),
                        options=dataclasses.replace(tn._ip_opts, parallel_riccati=False))
    np.testing.assert_allclose(tsol.U.numpy(), seq.U.numpy(), atol=1e-9)


def test_parallel_riccati_mhe_window_matches_jax():
    """A free initial state: the MHE window through the parallel scans."""
    def build(cls, model, **kw):
        m = cls(model)
        m.horizon = 8
        m.Q, m.R, m.P0 = 1e-3 * np.eye(2), np.array([[1e-3]]), 0.1 * np.eye(2)
        m.set_initial_parameter_values([1.0] * 6)
        m.setup(dt=0.1, options={"parallel_riccati": True}, **kw)
        return m

    jm = build(JaxMHE, jax_cstr())
    tm = build(MHE, cstr_schaffner_and_zeitz(), device=CPU, dtype=F64)
    assert tm._ip_opts.parallel_riccati
    rng = np.random.default_rng(2)
    Ys = 0.12 + 0.01 * rng.standard_normal((3, 9, 1))
    Us = np.zeros((3, 9, 1))
    xj, _ = jm.estimate_batch(Ys, Us)
    xt, sol = tm.estimate_batch(Ys, Us)
    assert bool(sol.converged.all())
    np.testing.assert_allclose(np.asarray(xt), np.asarray(xj), atol=1e-9)


# -- bfloat16 storage of the linearization ----------------------------------------

@pytest.fixture(scope="module")
def f32_runs():
    """JAX float32 with and without bf16 storage on one flagship batch."""
    out = {}
    with jax.enable_x64(False):
        for name, extra in (("f32", {}), ("bf16", {"lin_storage_dtype": "bfloat16"})):
            jn = _nmpc(JaxNMPC, jax_cstr(), {**FLAGSHIP, **extra})
            args = jn.prepare_batch(_x0s(6, 0))
            sol = jn.solve_batch_fn()(*args)
            out[name] = ([np.asarray(a) for a in args], jax.tree.map(np.asarray, sol))
    return out


def test_bf16_storage_matches_jax_by_distance(f32_runs):
    args, jbf = f32_runs["bf16"]
    spread = float(np.abs(jbf.U - f32_runs["f32"][1].U).max())
    assert 0 < spread < 1e-2       # the option changes JAX's float32 answer
    tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), {**FLAGSHIP, "lin_storage_dtype":
                                                  "bfloat16"},
               device=CPU, dtype=torch.float32)
    sol = to_numpy(tn.solve_batch_fn()(*to_torch(args, device=CPU, dtype=torch.float32)))
    assert sol.U.dtype == np.float32 and sol.converged.all()
    assert np.abs(sol.U - jbf.U).max() <= spread + 1e-4
    np.testing.assert_array_equal(sol.iterations, jbf.iterations)


def test_bf16_storage_rounds_the_blocks():
    """In float32 the stored blocks are rounded (a different answer from
    the float32 route, and the same as rounding them by hand); the Riccati
    step still receives float32."""
    tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), FLAGSHIP, device=CPU,
               dtype=torch.float32)
    args = tn.prepare_batch(_x0s(4, 1))
    seen = []

    def spy(reg):
        solve = tric.make_plain_lq_solver(reg)

        def run(*blocks):
            seen.append({b.dtype for b in blocks if b is not None})
            return solve(*blocks)
        return run

    opts = dataclasses.replace(tn._ip_opts, lin_storage_dtype="bfloat16")
    bf = tip.solve_ocp(tn._funcs, tn._dims, tn._bounds, *args, options=opts,
                       lq_solver=spy)
    f32 = tip.solve_ocp(tn._funcs, tn._dims, tn._bounds, *args, options=tn._ip_opts)
    assert seen and all(s == {torch.float32} for s in seen)
    assert bool(bf.converged.all())
    assert 0 < float((bf.U - f32.U).abs().max()) < 1e-2


def test_float64_ignores_bf16_storage():
    x0s = _x0s(4, 2)
    base = _nmpc(NMPC, cstr_schaffner_and_zeitz(), FLAGSHIP, device=CPU, dtype=F64)
    bf = _nmpc(NMPC, cstr_schaffner_and_zeitz(), {**FLAGSHIP, "lin_storage_dtype":
                                                  "bfloat16"}, device=CPU, dtype=F64)
    args = base.prepare_batch(x0s)
    for a, b in zip(base.solve_batch_fn()(*args), bf.solve_batch_fn()(*args)):
        assert torch.equal(a, b)


def test_unknown_storage_dtype_raises():
    with pytest.raises(ValueError, match="lin_storage_dtype"):
        _nmpc(NMPC, cstr_schaffner_and_zeitz(), {"lin_storage_dtype": "bfloat17"},
              device=CPU, dtype=F64)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_options_on_the_card():
    """The parallel route launches no Riccati kernel; bf16 storage and the
    history run through the kernel; each against the CPU in float64."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x0s = _x0s(64, 3)
    for extra, expect_launch in (({"parallel_riccati": True}, False),
                                 ({"lin_storage_dtype": "bfloat16"}, True),
                                 ({"ipopt_debugger": True}, True)):
        sols = []
        for device in (CPU, "cuda"):
            tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), {**FLAGSHIP, **extra},
                       device=device, dtype=F64)
            riccati_lq_cuda.launches = 0
            out = tn.solve_batch_fn()(*tn.prepare_batch(x0s))
            sols.append(out[0] if tn._ip_opts.record_iterates else out)
            if device == "cuda":
                assert (riccati_lq_cuda.launches > 0) == expect_launch, extra
        np.testing.assert_allclose(sols[1].U.cpu().numpy(), sols[0].U.numpy(),
                                   atol=1e-9)
