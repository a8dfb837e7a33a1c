"""PyTorch port on the card: stochastic MPC on the Riccati kernel (and the
convexification of its zero Hessian blocks), the GP hybrid CSTR through the
whole-solve kernel, and GPArray's batched fit
(``cuda``-marked; they skip without a card). This file imports no JAX: it
holds the card against the CPU and against the plain PyTorch versions; the
CPU tests against the JAX package are tests/test_torch_smpc.py,
tests/test_torch_gp_hybrid.py and tests/test_torch_gp_array.py."""
import warnings

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import GP, NMPC, SMPC, GPArray, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

F64 = torch.float64
# pure Newton steps at the flagship's tolerance, as the whole-solve kernel
# takes them
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 25,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def smpc(device):
    """Golden smpc_chance's controller (tests/golden_configs.py:315-341) with
    its 25-point GP, float64."""
    m = Model(name="lin")
    m.set_dynamical_states(["x1", "x2"])
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -0.5 * x[..., 0] - 0.4 * x[..., 1] + u[..., 0]], -1))
    rng = np.random.default_rng(3)
    X = np.linspace(-1.5, 1.5, 25)[:, None]
    y = 0.05 * np.sin(2 * X[:, 0]) + 0.02 * rng.standard_normal(25)
    gp = GP(["x1"], ["d"], noise_variance=0.02, device=device, dtype=F64)
    gp.set_training_data(X, y)
    c = SMPC(m, gps={"x2": gp.setup()}, dt=0.1)
    c.horizon = 10
    c.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0], ref=[0.85, 0.0])
    c.quad_stage_cost.add_inputs(weights=0.05)
    c.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    c.set_box_chance_constraints(x_ub=[0.9, np.inf], level=0.95)
    return c.setup(options={"dt": 0.1, "tol": 1e-9, "max_iter": 80}, device=device,
                   dtype=F64)


@pytest.mark.cuda
def test_smpc_on_the_riccati_kernel_matches_the_cpu():
    """Eight scenarios of golden smpc_chance's SMPC: every Newton step a
    (6, 1) Riccati launch on the card; card against CPU, equal iterations
    and U to 1e-9."""
    _need_card()
    x0s = np.concatenate([np.array([0.3, 0.0]) + 0.1 * np.random.default_rng(0)
                          .standard_normal((8, 2)), np.tile([1e-4, 0, 0, 1e-4], (8, 1))],
                         axis=1)
    card, cpu = smpc("cuda"), smpc("cpu")
    riccati_lq_cuda.launches = 0
    k = card.solve_batch_fn()(*card.prepare_batch(x0s))
    assert riccati_lq_cuda.launches > 0
    r = cpu.solve_batch_fn()(*cpu.prepare_batch(x0s))
    assert bool(r.converged.all()) and torch.equal(k.iterations.cpu(), r.iterations)
    assert float((k.U.cpu() - r.U).abs().max()) <= 1e-9


def gp_hybrid_nmpc(options, dtype):
    """The CSTR whose E is an exact SE GP's posterior mean (16 points)."""
    rng = np.random.default_rng(5)
    X = rng.uniform([0.0, 0.0], [0.6, 0.4], (16, 2))
    y = 1.0 + 0.1 * np.sin(4.0 * X[:, 0]) - 0.05 * X[:, 1]
    gp = GP(["x_1", "x_2"], ["E"], noise_variance=0.01, device="cuda", dtype=F64)
    gp.set_training_data(X, y)
    nmpc = NMPC(cstr_schaffner_and_zeitz() + gp.setup())
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 5)
    return nmpc.setup(options=options, device="cuda", dtype=dtype)


@pytest.mark.cuda
def test_convexify_of_zero_blocks_after_reused_memory():
    """The SMPC's zero terminal Hessian blocks through the convexification:
    cuSOLVER's batched eigh returned NaN for every all-zero 6 x 6 float32
    matrix once the allocator handed out memory that a NaN-filled tensor had
    held (and for 3 of phase 16's 4096 after earlier phases); ``_eigh``
    decomposes a diagonal matrix itself."""
    _need_card()
    from hilo_mpc_tpu_torch.ops import ip_solver
    junk = torch.full((1 << 28,), float("nan"), device="cuda")
    del junk
    Z = torch.zeros(4096, 6, 6, device="cuda")
    w, V = ip_solver._eigh(Z)
    assert bool((w == 0).all())
    assert torch.equal(V, torch.eye(6, device="cuda").expand_as(V))
    C = ip_solver._convexify(Z, 1e-6)
    assert torch.equal(C, 1e-6 * torch.eye(6, device="cuda").expand_as(C))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gp_hybrid_through_the_whole_solve_kernel_on_card(dtype):
    """Phase 16(d) in small: the GP hybrid CSTR (N=20, B=1024) through
    pallas_full is one whole-solve launch and no Riccati launch, with no
    warning; the problem's instance in ``dtype`` against its plain version
    (float64 equal iterations and U to 1e-9, float32 5e-4) and the general
    path (5e-4)."""
    _need_card()
    dt = getattr(torch, dtype)
    whole = gp_hybrid_nmpc({**KERNEL_OPTS, "pallas_full": True}, dt)
    general = gp_hybrid_nmpc(KERNEL_OPTS, dt)
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(0).standard_normal((1024, 2))
    args = whole.prepare_batch(x0s)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = whole.solve_batch_fn()
    n_full, n_ric = W.solve_ocp_full_cuda.launches, riccati_lq_cuda.launches
    fn(*args)
    assert (W.solve_ocp_full_cuda.launches - n_full, riccati_lq_cuda.launches - n_ric) \
        == (1, 0)
    g = general.solve_batch_fn()(*args)
    assert riccati_lq_cuda.launches > n_ric
    k = W.WholeIPLaunch(whole._wip["problem"], whole._dims, dt, args[0].device)(
        *args, whole._mu_cold)
    r = W.solve_ocp_full_reference(whole._funcs, whole._dims, whole._bounds, *args,
                                   whole._ip_opts)
    torch.cuda.synchronize()
    both = k.converged & r.converged & g.converged
    assert float(both.float().mean()) >= 0.97
    if dt == torch.float64:
        assert torch.equal(k.iterations, r.iterations)
        assert float((k.U - r.U).abs().max()) <= 1e-9
    else:
        assert float((k.U - r.U).abs()[both].max()) <= 5e-4
    assert float((k.U - g.U).abs()[both].max()) <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lbfgs", "adam"])
def test_batched_gp_fit_on_card_matches_the_cpu(solver):
    """GPArray.fit_model_batched (3 outputs x 64 points, 40 iterations,
    float64) on the card against the CPU: the final NLLs to 1e-8 relative
    and the predictions to 1e-6 (the line search branches on float64
    comparisons, so the iterates may part at the last digits on the way)."""
    _need_card()
    rng = np.random.default_rng(1)
    X = rng.uniform(-2.0, 2.0, (64, 2))
    ys = [np.sin((g + 1) * X[:, 0]) + 0.05 * rng.standard_normal(64) for g in range(3)]
    fits = {}
    for dev in ("cuda", "cpu"):
        arr = GPArray(3)
        for g, y in enumerate(ys):
            arr[g] = GP(["a", "b"], ["y"], noise_variance=0.3, device=dev, dtype=F64)
            arr[g].set_training_data(X, y)
        fits[dev] = arr.fit_model_batched(max_iter=40, solver=solver)
    card, cpu = fits["cuda"].last_fit_nll, fits["cpu"].last_fit_nll
    assert np.all(np.abs(card / cpu - 1.0) <= 1e-8), (card, cpu)
    Xq = rng.uniform(-2.0, 2.0, (32, 2))
    for pa, pb in zip(fits["cuda"].predict(Xq), fits["cpu"].predict(Xq)):
        assert np.abs(pa - pb).max() <= 1e-6, np.abs(pa - pb).max()
