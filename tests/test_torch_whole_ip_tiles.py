"""PyTorch port: the whole-solve kernel's block schedule (csrc/whole_ip.cuh:
tiles of TB = 64 scenarios, the per-scenario region scenario-minor in a
global scratch) built for the host, and the controller's prepared launch
(control/nmpc.py:_whole_ip_cache, ops/whole_ip.py:WholeIPLaunch), on the CPU.

- The host build against the plain version in float64 for every row pattern
  of tests/test_torch_whole_ip.py, on a ragged tile and a full one: equal
  iterations and flags, U and X to 1e-14, the other fields to 1e-12
  relative (the host build keeps the plain version's order of operations:
  the differences measured are ~1e-16; on a scenario that stops at
  max_iter far from its solution they grow with the iterations, to 3e-13
  in the 71st of the state-bounds case);
- against the JAX kernel ``solve_ocp_pallas_full`` in interpret mode for the
  row patterns tests/test_torch_whole_ip.py does not already hold against it
  (float32 there: 5e-4, tests/test_pallas_ip.py:57-65);
- a long horizon (N=40, a region of 1450 values per scenario); a scenario's
  answer does not depend on its tile or its place in it, so the batches of
  several tiles give the bits of the one-tile batches above;
- the region's size and the tiles written into the source; the input checks;
- the prepared launch gives the bits of ``solve_ocp_full_host``; NMPC keeps
  one prepared path per problem, shared by cold and warm solves, and drops it
  when the bounds, the weights or the options change;
- ``cuda`` tests: the prepared path against ``solve_ocp_full_cuda`` (bits and
  launch counts), and the kernel against the plain version on the card.
Skipped where there is no host C++ compiler.
"""
import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

import jax
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import _build
from hilo_mpc_tpu_torch.ops import codegen_cuda as C
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.utils.interop import to_torch

from test_torch_whole_ip import (F64, HOST_CASES, KERNEL_OPTS, STATE_BOUNDS,
                                 _host_case, _nmpc, _plain, _port, _x0s)

torch.set_num_threads(1)
CPU = "cpu"


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def _host(tn, args):
    return W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)


def _assert_matches_plain(k, r):
    assert torch.equal(k.iterations, r.iterations)
    assert torch.equal(k.converged, r.converged) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-14)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-14)
    c = r.converged
    for name in ("s", "z", "sN", "zN", "lam", "objective", "kkt_error", "mu"):
        torch.testing.assert_close(getattr(k, name)[c], getattr(r, name)[c],
                                   rtol=1e-12, atol=1e-14, msg=name)


def _ragged(case, B=37):
    """A host case's controller on B scenarios."""
    c = dict(HOST_CASES[case], B=B)
    return _host_case(c, F64)


@pytest.mark.parametrize("B", [5, 37, C.WIP_TB], ids=["few", "ragged_tile", "full_tile"])
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_tiles_match_plain_f64(case, B):
    _need_cxx()
    tn, args = _ragged(case, B)
    _assert_matches_plain(_host(tn, args), _plain(tn, args))


PALLAS_CASES = {
    "state_terminal_bounds": dict(N=4, bounds=dict(u_lb=[-5.0], u_ub=[5.0],
                                                   **STATE_BOUNDS),
                                  options={"max_iter": 12}, B=5, seed=3),
    "unconstrained": dict(N=3, bounds={}, options={}, B=3, seed=4),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_host_tiles_match_pallas_interpret(case):
    """The port's kernel code (float64, host build) against the JAX kernel
    (float32, interpret mode) on the row patterns with state and terminal
    rows and with no rows at all."""
    _need_cxx()
    c = PALLAS_CASES[case]
    jn = _nmpc(JaxNMPC, jax_cstr(), c["N"], c["options"], c["bounds"])
    jargs = jn.prepare_batch(_x0s(c["B"], c["seed"]))
    jsol = jax.tree.map(np.asarray, solve_ocp_pallas_full(
        jn._funcs, jn._dims, jn._bounds, *jargs, options=jn._ip_opts, tile_b=8))
    tn = _port(c["N"], c["options"], c["bounds"])
    sol = _host(tn, to_torch(jargs, device=CPU))
    both = sol.converged.numpy() & jsol.converged
    assert both.mean() > 0.7
    np.testing.assert_array_equal(sol.iterations.numpy()[both], jsol.iterations[both])
    np.testing.assert_allclose(sol.U.numpy()[both], jsol.U[both], atol=5e-4)
    np.testing.assert_allclose(sol.X.numpy()[both], jsol.X[both], atol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_long_horizon_matches_plain(dtype):
    """N=40, twice the flagship's horizon: a region of 1450 values per
    scenario in the global scratch; the host build against the plain
    version."""
    _need_cxx()
    tn = _port(40, dtype=dtype)
    args = tn.prepare_batch(_x0s(5, 9))
    problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                                 tn._ip_opts)
    assert problem.region == 1450
    k, r = _host(tn, args), _plain(tn, args)
    if dtype == F64:
        _assert_matches_plain(k, r)
    else:
        both = k.converged & r.converged
        assert bool(both.float().mean() > 0.7)
        torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=5e-4)


def test_answer_does_not_depend_on_the_tile():
    """Scenario b's answer is the same bits whether it is solved in a batch
    of 140 (three tiles), from the 37th scenario on (so every scenario sits
    in another tile and lane), or alone."""
    _need_cxx()
    tn, args = _ragged("state_terminal_bounds", B=140)
    ref = _host(tn, args)
    for part in (slice(37, 140), slice(70, 71), slice(139, 140)):
        sub = [a[part].contiguous() for a in args]
        for name, a, b in zip(ref._fields, _host(tn, sub), ref):
            assert torch.equal(a, b[part]), (part, name)


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_region_size_is_written_into_the_source(case):
    """The emitted problem carries the tiles and the region's size; the
    build checks that size against csrc/whole_ip.cuh:WipLay (static_assert),
    and the host build compiles."""
    tn, args = _ragged(case, B=3)
    p = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                           tn._ip_opts)
    d = tn._dims
    assert p.region == C.whole_ip_region(d.nx, d.nu, d.N, args[0].shape[2],
                                         len(p.stage_rows), len(p.term_rows))
    assert (f"static constexpr int TB = {C.WIP_TB}, MINB_F32 = {C.WIP_MIN_BLOCKS[0]},\n"
            f"                       MINB_F64 = {C.WIP_MIN_BLOCKS[1]}, E = {p.region};"
            ) in p.text
    _need_cxx()
    assert W.WholeIPLaunch(p, d, F64, CPU).entry() is not None


def test_flagship_region():
    """The flagship (N=20, nx=2, nu=1, n_theta=8, |u| <= 5: 40 active rows)
    keeps 730 values per scenario: theta 168, X 42, U 20, lam 40, s and z
    80, the stash 140, the direction 60, the linearization 180."""
    assert C.whole_ip_region(2, 1, 20, 8, 40, 0) == 730
    assert C.WIP_TB % 32 == 0 and min(C.WIP_MIN_BLOCKS) >= 1


def _bad_inputs(kind, args):
    theta, x0, X, U = args
    if kind == "theta_rank":
        return theta[0], x0, X, U
    if kind == "x0_shape":
        return theta, x0[:, :1].contiguous(), X, U
    if kind == "U_horizon":
        return theta, x0, X, U[:, 1:].contiguous()
    if kind == "mixed_dtype":
        return theta, x0.float(), X, U
    if kind == "int_dtype":
        return tuple(a.to(torch.int32) for a in args)
    if kind == "not_contiguous":
        return theta, x0, X.transpose(0, 1).contiguous().transpose(0, 1), U
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["theta_rank", "x0_shape", "U_horizon",
                                  "mixed_dtype", "int_dtype", "not_contiguous"])
def test_bad_inputs_raise(kind):
    """The host build checks its inputs as the card's wrapper does, before
    anything is built or launched."""
    tn, args = _ragged("flagship", B=4)
    with pytest.raises((ValueError, TypeError)):
        _host(tn, _bad_inputs(kind, args))


# -- the prepared launch --------------------------------------------------------

def test_prepared_launch_gives_the_bits_of_the_host_solve():
    _need_cxx()
    tn, args = _ragged("flagship", B=9)
    problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                                 tn._ip_opts)
    launch = W.WholeIPLaunch(problem, tn._dims, F64, CPU)
    n0 = W.solve_ocp_full_cuda.launches
    for mu0 in (tn._ip_opts.mu_init, 1e-3):
        opts = dataclasses.replace(tn._ip_opts, mu_init=mu0)
        ref = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, opts)
        for name, a, b in zip(ref._fields, launch(*args, mu0), ref):
            assert torch.equal(a, b), name
    assert W.solve_ocp_full_cuda.launches == n0
    with pytest.raises(ValueError, match="prepared for"):
        launch(*[a.float() for a in args], 1e-2)


def test_controller_keeps_one_prepared_path():
    tn = _port(4, {"pallas_full": True})
    c = tn._whole_ip_cache()
    assert c["eligible"]
    args = tn.prepare_batch(_x0s(3, 1))
    cold, warm = tn.solve_batch_fn(), tn.solve_batch_fn(warm=True)
    cold(*args)
    warm(*args)
    assert tn._whole_ip_cache() is c
    # a weight edited in place reaches the solver through setup(), as in
    # JAX (the problem functions keep the terms of their setup): then the
    # emitted numbers change and the cache is dropped
    tn.quad_stage_cost.terms[0].W[0, 0] = 11.0
    assert tn._whole_ip_cache() is c
    tn.setup(options={**KERNEL_OPTS, "pallas_full": True}, device=CPU, dtype=F64)
    c2 = tn._whole_ip_cache()
    assert c2 is not c and tn._whole_ip_cache() is c2
    assert not np.array_equal(c2["problem"].prm, c["problem"].prm)
    # new bounds reach the solver through setup(): dropped
    tn.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    tn.setup(options={**KERNEL_OPTS, "pallas_full": True}, device=CPU, dtype=F64)
    c3 = tn._whole_ip_cache()
    assert c3 is not c2 and c3["bounds"] is tn._bounds
    # other options: dropped, and the gate is evaluated again
    tn.setup(options={**KERNEL_OPTS, "pallas_full": True, "mehrotra": True},
             device=CPU, dtype=F64)
    c4 = tn._whole_ip_cache()
    assert c4 is not c3 and not c4["eligible"]


def test_controller_path_follows_a_bound_change():
    """After new bounds and setup() the controller's path solves the new
    problem (the plain version's answer on CPU tensors)."""
    tn = _port(4, {"pallas_full": True})
    args = tn.prepare_batch(_x0s(3, 1))
    before = tn.solve_batch_fn()(*args)
    tn.set_box_constraints(u_lb=[-0.05], u_ub=[0.05])
    tn.setup(options={**KERNEL_OPTS, "pallas_full": True}, device=CPU, dtype=F64)
    after = tn.solve_batch_fn()(*args)
    assert float(after.U.abs().max()) <= 0.05 + 1e-9 < float(before.U.abs().max())
    for a, b in zip(after, _plain(tn, args)):
        assert torch.equal(a, b)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_prepared_path_matches_the_wrapper_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), 20, {"pallas_full": True},
               device="cuda", dtype=torch.float32)
    args = [a.to(dt) for a in tn.prepare_batch(_x0s(1000, 0))]
    n0 = W.solve_ocp_full_cuda.launches
    ref = W.solve_ocp_full_cuda(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    assert W.solve_ocp_full_cuda.launches == n0 + 1
    c = tn._whole_ip_cache()
    problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                                 tn._ip_opts)
    launch = W.WholeIPLaunch(problem, tn._dims, dt, args[0].device)
    out = launch(*args, tn._ip_opts.mu_init)
    assert W.solve_ocp_full_cuda.launches == n0 + 2
    if dt == torch.float32:
        out = tn.solve_batch_fn()(*args)
        assert W.solve_ocp_full_cuda.launches == n0 + 3
        assert tn._whole_ip_cache() is c and len(c["launch"]) == 1
    torch.cuda.synchronize()
    for name, a, b in zip(ref._fields, out, ref):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("N", [20, 40])
def test_kernel_matches_plain_on_card(N):
    """float64 on the card against the plain version at the flagship's
    horizon and twice it, on a batch that ends in a ragged tile; the
    libraries of several problems loaded in one process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), N, device="cuda", dtype=F64)
    args = tn.prepare_batch(_x0s(1001, 0))
    problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                                 tn._ip_opts)
    k = W.WholeIPLaunch(problem, tn._dims, F64, args[0].device)(*args,
                                                                tn._ip_opts.mu_init)
    r = _plain(tn, args)
    torch.cuda.synchronize()
    assert torch.equal(k.iterations, r.iterations)
    both = k.converged & r.converged
    torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=1e-12)
    torch.testing.assert_close(k.X[both], r.X[both], rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "state_terminal_bounds"])
def test_builds_do_not_spill_on_card(case):
    """ptxas spills no registers in either instance of the kernel at N=20
    (float64 asks for 4 blocks per SM for that)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    bounds = (dict(u_lb=[-5.0], u_ub=[5.0], **STATE_BOUNDS)
              if case == "state_terminal_bounds" else None)
    tn = _nmpc(NMPC, cstr_schaffner_and_zeitz(), 20, bounds=bounds, device="cuda",
               dtype=F64)
    args = tn.prepare_batch(_x0s(2, 0))
    problem = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                                 tn._ip_opts)
    with open(_build.source_library_path(problem.text) + ".log") as fh:
        stores = [int(n) for n in re.findall(r"(\d+) bytes spill stores", fh.read())]
    assert len(stores) == 2 and stores == [0, 0], stores
