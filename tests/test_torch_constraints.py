"""PyTorch port: generic inequality rows and augmented-Lagrangian equalities
of ``solve_ocp``, and the constraint and cost building blocks of
``control/costs.py``, against the JAX package (CPU, float64).

- ``solve_ocp`` on the double integrator of tests/test_torch_ip_solver.py
  with generic stage and terminal inequality rows, and with stage or
  terminal equalities (the augmented-Lagrangian path): the same inputs
  through both solvers, U and X to 1e-10 and the same iteration counts on
  every scenario.
- ``GenericConstraint`` and ``make_constraint``: row counting on a probe
  batch, the (..., n) form of a one-row function, the hard and equality
  row split, and the penalty and its derivative (``torch.maximum`` splits
  it at a tie as ``jnp.maximum`` does) against the JAX classes.
- ``const_cost_hessian`` follows the JAX rule (``quad_cost_only``).
- ``cuda``: the constrained solve with the Riccati kernel against the plain
  LQ step on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import hilo_mpc_tpu.control.costs as jcosts
import hilo_mpc_tpu.ops.ip_solver as jip
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.control import costs as tcosts
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import ip_solver as tip
from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

from test_torch_ip_solver import AM, BM, QM, RM, _di_problem

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def _ineq(jf, tf):
    # x_1 + 0.3 u <= 0.4 and x_0 >= -1.2 at every stage; |x_N| <= 1
    return (jf._replace(
        stage_ineq=lambda x, u, th: jnp.array([x[1] + 0.3 * u[0] - 0.4, -x[0] - 1.2]),
        term_ineq=lambda x, th: jnp.array([x[0] ** 2 + x[1] ** 2 - 1.0])),
        tf._replace(
        stage_ineq=lambda x, u, th: torch.stack(
            [x[..., 1] + 0.3 * u[..., 0] - 0.4, -x[..., 0] - 1.2], dim=-1),
        term_ineq=lambda x, th: (x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0)[..., None]),
        dict(n_h=2, n_hN=1))


def _stage_eq(jf, tf):
    # a nonlinear feedback law held as an equality at every stage
    return (jf._replace(stage_eq=lambda x, u, th: jnp.array(
        [u[0] + 0.8 * x[0] + 1.2 * x[1] + 0.1 * x[0] ** 2])),
        tf._replace(stage_eq=lambda x, u, th: (
            u[..., 0] + 0.8 * x[..., 0] + 1.2 * x[..., 1] + 0.1 * x[..., 0] ** 2)[..., None]),
        dict(n_e=1))


def _term_eq(jf, tf):
    # x_N = (0.1, 0)
    return (jf._replace(term_eq=lambda x, th: jnp.array([x[0] - 0.1, x[1]])),
            tf._replace(term_eq=lambda x, th: torch.stack([x[..., 0] - 0.1, x[..., 1]],
                                                          dim=-1)),
            dict(n_eN=2))


# name: (rows, input bounds |u| <= 0.7, scenarios, Mehrotra requested);
# scenario 0 (x0 = (1.5, 0)) cannot meet |x_N| <= 1 or the feedback law
# within |u| <= 0.7, so the inequality case leaves it out and the equality
# cases run without input bounds
SOLVE_CASES = {
    "stage_terminal_ineq": (_ineq, True, slice(1, 4), False),
    "stage_terminal_ineq_mehrotra": (_ineq, True, slice(1, 4), True),
    "stage_eq": (_stage_eq, False, slice(0, 4), False),
    # Mehrotra requested: the solver turns it off with equality rows
    "terminal_eq_mehrotra": (_term_eq, False, slice(0, 4), True),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_ocp_generic_rows_match_jax(case):
    rows, bounded, sel, mehrotra = SOLVE_CASES[case]
    jf, tf, jd, td, bnd, args = _di_problem(bounded)
    jf, tf, n_rows = rows(jf, tf)
    jd, td = dataclasses.replace(jd, **n_rows), dataclasses.replace(td, **n_rows)
    args = tuple(a[sel] for a in args)
    opts = dict(max_iter=80, tol=1e-8, mehrotra=mehrotra)
    # jitted: one compile of the batched solve instead of an eager dispatch
    jsol = jax.tree.map(np.asarray, jax.jit(lambda b, *a: jip.solve_ocp_batched(
        jf, jd, b, *a, jip.IPOptions(**opts)))(
        jip.OCPBounds(*map(jnp.asarray, bnd)), *map(jnp.asarray, args)))
    tbnd = (tip.OCPBounds(*to_torch(bnd, device=CPU)) if bounded
            else tip.default_bounds(td, dtype=F64, device=CPU))
    tsol = to_numpy(tip.solve_ocp(tf, td, tbnd, *to_torch(args, device=CPU),
                                  tip.IPOptions(**opts)))
    assert tsol.converged.all() and jsol.converged.all()
    np.testing.assert_array_equal(tsol.iterations, jsol.iterations)
    np.testing.assert_allclose(tsol.U, jsol.U, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tsol.X, jsol.X, rtol=0, atol=1e-10)
    m = 2 * td.nu + 2 * td.nx + td.n_h
    assert tsol.s.shape == jsol.s.shape == (args[0].shape[0], td.N, m)
    np.testing.assert_allclose(tsol.z, jsol.z, rtol=1e-6, atol=1e-10)
    if td.n_e:
        law = tsol.U[..., 0] + 0.8 * tsol.X[:, :-1, 0] + 1.2 * tsol.X[:, :-1, 1] \
            + 0.1 * tsol.X[:, :-1, 0] ** 2
        assert np.abs(law).max() <= 1e-8
    if td.n_eN:
        np.testing.assert_allclose(tsol.X[:, -1], [[0.1, 0.0]] * 4, atol=1e-8)
    if td.n_h:
        assert (tsol.X[:, :-1, 1] + 0.3 * tsol.U[..., 0]).max() <= 0.4 + 1e-7
        assert (tsol.X[:, -1] ** 2).sum(-1).max() <= 1.0 + 1e-7


def test_chunked_eigh_matches_one_call():
    """The convexification's eigh in chunks (CUDA batches above
    ``EIGH_CHUNK`` matrices) gives one call's eigenpairs."""
    M = torch.as_tensor(np.random.default_rng(4).standard_normal((5, 7, 3, 3)))
    M = M + M.transpose(-1, -2)
    w, V = tip._eigh(M, chunk=4)
    w1, V1 = torch.linalg.eigh(M)
    assert w.shape == w1.shape and V.shape == V1.shape
    torch.testing.assert_close(w, w1, rtol=0, atol=1e-13)
    torch.testing.assert_close(V.abs(), V1.abs(), rtol=0, atol=1e-12)


def test_eigh_of_diagonal_matrices_is_exact():
    """A diagonal matrix (zero among them) decomposes as its sorted diagonal
    and the sorting permutation, in every chunk; the clip then gives
    diag(max(d, min_eig)) exactly. cuSOLVER's batched eigh returned NaN for
    zero 6 x 6 blocks on a card (tests/test_torch_card_implicit.py holds
    that case on the card)."""
    rng = np.random.default_rng(5)
    d = torch.as_tensor(rng.standard_normal((9, 6)))
    d[:3] = 0.0
    M = torch.diag_embed(d)
    M[-1, 0, 1] = M[-1, 1, 0] = 0.5              # one full matrix in the batch
    w, V = tip._eigh(M, chunk=4)
    w1, V1 = torch.linalg.eigh(M)
    torch.testing.assert_close(w, w1, rtol=0, atol=1e-14)
    torch.testing.assert_close(V.abs(), V1.abs(), rtol=0, atol=1e-14)
    assert torch.equal(w[:-1], torch.sort(d[:-1], dim=-1).values)
    assert torch.equal(V[:-1] @ torch.diag_embed(w[:-1]) @ V[:-1].mT, M[:-1])
    C = tip._convexify(M[:-1], 1e-3)
    assert torch.equal(C, torch.diag_embed(torch.clamp(d[:-1], min=1e-3)))


def test_rows_need_their_functions():
    _, tf, _, td, bnd, args = _di_problem(True)
    with pytest.raises(ValueError, match="stage_ineq"):
        tip.solve_ocp(tf, dataclasses.replace(td, n_h=1),
                      tip.OCPBounds(*to_torch(bnd, device=CPU)),
                      *to_torch(args, device=CPU))


# -- GenericConstraint / make_constraint ---------------------------------------

def _jax_torch_constraint(**kw):
    """(JAX, port) constraints over the same two rows g = (x0 + u, x1²)."""
    j = jcosts.make_constraint(lambda x, u: jnp.array([x[0] + u[0], x[1] ** 2]),
                               n=2, **kw)
    t = tcosts.make_constraint(lambda x, u: [x[..., 0] + u[..., 0], x[..., 1] ** 2],
                               n=2, **kw)
    return j, t


ROW_CASES = {
    "hard_two_sided": dict(lb=[-1.0, 0.0], ub=[1.0, 0.5]),
    "equality_and_upper": dict(lb=[0.2, -np.inf], ub=[0.2, 0.5]),
    "soft": dict(lb=[-1.0, -np.inf], ub=[1.0, 0.5], is_soft=True, weight=30.0),
    "soft_max_violation": dict(lb=[-1.0, -np.inf], ub=[1.0, 0.5], is_soft=True,
                               max_violation=[0.1, 0.2]),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_row_split_matches_jax(case):
    j, t = _jax_torch_constraint(**ROW_CASES[case])
    np.testing.assert_array_equal(t.equality_rows(), j.equality_rows())
    for a, b in zip(t.hard_rows(), j.hard_rows()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("linear_weight", [0.0, 5.0])
def test_penalty_and_its_derivative_match_jax(linear_weight):
    """Values on both sides of both bounds and exactly on them: the penalty
    and its gradient equal JAX's, also at a tie, where torch.maximum and
    jnp.maximum split the derivative in half (relu would not)."""
    j, t = _jax_torch_constraint(lb=[-1.0, -np.inf], ub=[1.0, 0.5], is_soft=True,
                                 weight=30.0)
    j.linear_weight = t.linear_weight = linear_weight
    G = np.array([[1.3, 0.2], [-1.0, 0.5], [1.0, 0.9], [-2.0, -4.0], [0.0, 0.5]])
    jv = np.asarray(jax.vmap(j.penalty)(jnp.asarray(G)))
    jg = np.asarray(jax.vmap(jax.grad(j.penalty))(jnp.asarray(G)))
    g_t = torch.as_tensor(G)
    np.testing.assert_allclose(t.penalty(g_t).numpy(), jv, rtol=1e-15, atol=0)
    tg = grad(lambda g: t.penalty(g).sum())(g_t).numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-15, atol=0)
    if linear_weight:
        assert tg[1, 0] == -0.5 * linear_weight      # g on lb: half the slope


ONE_ROW = {
    # a function of one row may return the batch shape itself, or (..., 1)
    "batch_shape": lambda x, u: x[..., 0] + u[..., 0],
    "trailing_one": lambda x, u: (x[..., 0] + u[..., 0])[..., None],
    "row_list": lambda x, u: [x[..., 0] + u[..., 0]],
}


@pytest.mark.parametrize("case", sorted(ONE_ROW))
@pytest.mark.parametrize("given_n", [True, False])
def test_one_row_constraint_takes_the_row_form(case, given_n):
    con = tcosts.make_constraint(ONE_ROW[case], ub=0.5, n=1 if given_n else None,
                                 probe_dims=(2, 1, 0))
    assert con.n == 1
    x = torch.tensor([[[0.1, 0.2], [0.3, 0.4]]], dtype=F64)       # (1, 2, 2)
    u = torch.tensor([[[1.0], [2.0]]], dtype=F64)
    g = con.fn(x, u, x[..., :0], x[..., 0])
    assert g.shape == (1, 2, 1)
    np.testing.assert_allclose(g[..., 0].numpy(), [[1.1, 2.3]])


def test_probe_counts_rows():
    con = tcosts.make_constraint(lambda x: [x[..., 0], x[..., 1], x[..., 0] * x[..., 1]],
                                 lb=0.0, probe_dims=(2, 0, 0))
    assert con.n == 3 and con.lb.shape == (3,)
    with pytest.raises(ValueError, match="n="):
        tcosts.make_constraint(lambda x: x[..., 0], ub=1.0)


def test_generic_cost_takes_any_row_form():
    cost = tcosts.GenericCost(None)
    assert cost.is_empty
    x = torch.tensor([[0.5, 2.0], [1.0, 3.0]], dtype=F64)
    for fn in (lambda x, u: x[..., 0] * u[..., 0],
               lambda x, u: (x[..., 0] * u[..., 0])[..., None],
               lambda x, u: [x[..., 0] * u[..., 0]]):
        cost.cost = fn
        assert not cost.is_empty
        c = cost(x, x[..., :1] + 1.0, x[..., :0], x[..., 0])
        assert c.shape == (2,)
        np.testing.assert_allclose(c.numpy(), [0.75, 2.0])
    cost.cost = lambda: 4.0 * torch.ones(())
    assert cost(x, x[..., :1], x[..., :0], x[..., 0]).shape == (2,)


# -- const_cost_hessian follows quad_cost_only ----------------------------------

def _setup_pair(configure, **extra):
    out = []
    for cls, model, jx in ((JaxNMPC, jax_cstr(), True),
                           (NMPC, cstr_schaffner_and_zeitz(), False)):
        n = cls(model)
        n.horizon = 5
        n.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
        n.quad_stage_cost.add_inputs(weights=0.1)
        n.set_parameters([1.0] * 6)
        configure(n, jx)
        opts = {"dt": 0.1, **extra}
        n.setup(options=opts, **({} if jx else dict(device=CPU, dtype=F64)))
        out.append(n)
    return out


HESSIAN_CASES = {
    "quadratic": (lambda n, jx: n.set_box_constraints(u_lb=[-5.0], u_ub=[5.0]), True),
    "hard_generic_row": (lambda n, jx: n.add_stage_constraint(
        (lambda x, u: x[1] + 0.5 * u[0]) if jx else
        (lambda x, u: x[..., 1] + 0.5 * u[..., 0]), ub=0.5, n=1), True),
    "soft_state_bounds": (lambda n, jx: n.set_box_constraints(
        x_ub=[0.27, np.inf], x_soft=True), False),
    "generic_cost": (lambda n, jx: setattr(n.stage_cost, "cost", (
        (lambda x: x[0] ** 4) if jx else (lambda x: x[..., 0] ** 4))), False),
    "terminal_generic_cost": (lambda n, jx: setattr(n.terminal_cost, "cost", (
        (lambda x: x[1] ** 4) if jx else (lambda x: x[..., 1] ** 4))), False),
    "soft_generic_constraint": (lambda n, jx: n.add_terminal_constraint(
        (lambda x: x[0]) if jx else (lambda x: x[..., 0]), ub=0.28, n=1,
        is_soft=True), False),
    "measurement_term": (lambda n, jx: n.quad_terminal_cost.add_measurements(
        weights=1.0), False),
}


@pytest.mark.parametrize("case", sorted(HESSIAN_CASES))
def test_const_cost_hessian_follows_quad_cost_only(case):
    configure, expected = HESSIAN_CASES[case]
    jn, tn = _setup_pair(configure)
    assert tn._ip_opts.const_cost_hessian is jn._ip_opts.const_cost_hessian is expected
    assert dataclasses.asdict(tn._dims) == dataclasses.asdict(jn._dims)
    # an explicit option wins in both packages
    jn, tn = _setup_pair(configure, const_cost_hessian=not expected)
    assert tn._ip_opts.const_cost_hessian is jn._ip_opts.const_cost_hessian \
        is (not expected)


def test_soft_state_bounds_leave_the_barrier_rows():
    """x_soft moves every finite state bound into the costs: lbx/ubx are
    ±inf, and the penalty appears in the stage cost (times h/dt) and in the
    terminal cost, as in the JAX controller."""
    configure = HESSIAN_CASES["soft_state_bounds"][0]
    jn, tn = _setup_pair(configure)
    assert torch.isinf(tn._bounds.ubx).all() and torch.isinf(tn._bounds.lbx).all()
    rng = np.random.default_rng(0)
    xs = 0.25 + 0.05 * rng.standard_normal((6, 2))
    us = rng.standard_normal((6, 1))
    th = np.tile(np.r_[0.0, 0.1, [1.0] * 6], (6, 1))
    jl = np.asarray(jax.vmap(jn._funcs.stage_cost)(*map(jnp.asarray, (xs, us, th))))
    jt = np.asarray(jax.vmap(jn._funcs.term_cost)(*map(jnp.asarray, (xs, th))))
    tl, tt = (tn._funcs.stage_cost(*to_torch((xs, us, th), device=CPU)),
              tn._funcs.term_cost(*to_torch((xs, th), device=CPU)))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-14)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-14)
    assert (tt.numpy() > 0).any()


# -- on the card ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stage_terminal_ineq", "terminal_eq_mehrotra"])
def test_generic_rows_kernel_route_on_card(case):
    """The constrained solve on CUDA tensors (one Riccati kernel launch per
    Newton step) against the same solve with the plain LQ step, float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    rows, bounded, sel, mehrotra = SOLVE_CASES[case]
    jf, tf, _, td, bnd, args = _di_problem(bounded)
    _, tf, n_rows = rows(jf, tf)
    # the double integrator's matrices on the card
    Am, Bm, Qm, Rm = (torch.as_tensor(a, device="cuda") for a in (AM, BM, QM, RM))
    tf = tf._replace(
        dyn=lambda x, u, th: x @ Am.T + u @ Bm.T,
        stage_cost=lambda x, u, th: ((x @ Qm) * x).sum(-1) + ((u @ Rm) * u).sum(-1),
        term_cost=lambda x, th: 5.0 * ((x @ Qm) * x).sum(-1))
    td = dataclasses.replace(td, **n_rows)
    args = to_torch(tuple(a[sel] for a in args), device="cuda")
    tbnd = (tip.OCPBounds(*to_torch(bnd, device="cuda")) if bounded
            else tip.default_bounds(td, dtype=F64, device="cuda"))
    opts = tip.IPOptions(max_iter=80, tol=1e-8, mehrotra=mehrotra)
    n0 = riccati_lq_cuda.launches
    k = tip.solve_ocp(tf, td, tbnd, *args, opts)
    launches = riccati_lq_cuda.launches - n0
    r = tip.solve_ocp(tf, td, tbnd, *args, opts, lq_solver=make_plain_lq_solver)
    assert launches == int(k.iterations.max()) * (2 if mehrotra and not td.n_eN else 1)
    assert torch.equal(k.iterations, r.iterations)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
