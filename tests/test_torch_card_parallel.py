"""PyTorch port on the card: dense programs, the sharded solve and the
embedded NMPC export (``cuda``-marked; they skip without a card). This
file imports no JAX: it holds the card against the CPU; the CPU tests
against the JAX package are tests/test_torch_programs.py,
tests/test_torch_sharding.py and tests/test_torch_embedded_nmpc.py."""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import NLP, NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

F64 = torch.float64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _sweep_program(device):
    nlp = NLP()
    nlp.set_decision_variables(2).set_parameters(2)
    nlp.set_objective(lambda x, p: torch.sum((x - p) ** 2))
    nlp.set_constraints(lambda x: x[0] + x[1], lb=1.0)
    return nlp.setup(device=device)


@pytest.mark.cuda
def test_dense_program_sweep_card_matches_cpu():
    """256 programs of the parameter sweep: card against CPU, equal
    iterations and x to 1e-9."""
    _need_card()
    P = np.random.default_rng(17).uniform(-2.0, 2.0, (256, 2))
    sols = {d: _sweep_program(d).solve_batch(x0=np.zeros((256, 2)), p=P, lbx=[-5, -5],
                                             ubx=[5, 5]) for d in ("cpu", "cuda")}
    assert torch.equal(sols["cuda"].iterations.cpu(), sols["cpu"].iterations)
    assert bool(sols["cuda"].converged.all())
    assert float((sols["cuda"].x.cpu() - sols["cpu"].x).abs().max()) <= 1e-9


def _flagship(device, dtype):
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    return nmpc.setup(options={"dt": 0.1, "tol": 1e-8 if dtype == F64 else 1e-4},
                      device=device, dtype=dtype)


@pytest.mark.cuda
def test_sharded_solve_on_the_cards_matches_one_solve():
    """Every visible card as a mesh: the sharded solve launches the Riccati
    kernel and gives the unsharded solve's U (bits with one card)."""
    _need_card()
    from hilo_mpc_tpu_torch.parallel import convergence_stats, make_mesh, sharded_solve_fn

    mesh = make_mesh()
    B = 64 * mesh.size
    nmpc = _flagship("cuda", F64)
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(0).standard_normal((B, 2))
    args = nmpc.prepare_batch(x0s)
    one = nmpc.solve_batch_fn()(*args)
    riccati_lq_cuda.launches = 0
    sol, stats = sharded_solve_fn(nmpc, mesh, with_stats=True)(*args)
    assert riccati_lq_cuda.launches > 0
    U = torch.as_tensor(np.asarray(sol.U))
    if mesh.size == 1:
        assert torch.equal(U, one.U.cpu())
    assert float((U - one.U.cpu()).abs().max()) <= 1e-9
    host = convergence_stats(sol)
    assert int(stats["n_converged"]) == host["n_converged"] == B
    assert float(stats["kkt_max"]) == host["kkt_max"]


@pytest.mark.cuda
def test_embedded_nmpc_against_the_card(tmp_path):
    """The CSTR NMPC exported to C and compiled by the host's compiler,
    12 steps against NMPC.optimize on the card (float64): |du| < 2e-4."""
    _need_card()
    from hilo_mpc_tpu_torch.embedded import compile_shared, generate_nmpc_c, load_nmpc

    nmpc = _flagship("cuda", F64)
    cstep = load_nmpc(compile_shared(generate_nmpc_c(nmpc, str(tmp_path / "n.c"))), 2, 1)
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", device="cpu", dtype=F64)
    plant.set_initial_conditions([0.2, 0.1])
    plant.set_initial_parameter_values([1.0] * 6)
    x = np.array([0.2, 0.1])
    du = 0.0
    for _ in range(12):
        u_c = cstep(x)
        u_py = np.asarray(nmpc.optimize(x)).ravel()
        du = max(du, abs(float(u_c[0]) - float(u_py[0])))
        x = plant.simulate(u=u_py, steps=1)["x"][-1]
    assert du < 2e-4, du
