"""PyTorch port: batches over a device mesh (parallel/sharding.py) on the
8-shard CPU mesh, against the JAX package on its 8 virtual CPU devices.

- The twins of tests/test_parallel.py::TestMesh/TestShardedSolve and of
  tests/test_distributed.py::TestInJitStats.
- Sharded against single: the sharded solve, ``estimate_batch(mesh=)`` and
  the three fused loops on a sharded x0 against the same calls without a
  mesh, float64 to 1e-12 with equal iterations; the sharded solve also
  against JAX's at the JAX test's 1e-8.
- ``batch_stats`` against JAX's ``batch_stats`` on the same arrays at an
  even B (the median of an even set), sharded and not.
- A batch the mesh does not divide is refused, as JAX refuses it.
- ``on_device``: the controller itself on its own device, and a copy set
  up on another device with the same arguments giving the same bits.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import EKF, MHE, NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.parallel import (ShardedTensor, batch_stats, convergence_stats,
                                         fused_closed_loop_ekf_fn, fused_closed_loop_fn,
                                         fused_closed_loop_mhe_fn, make_mesh, on_device,
                                         replicate, shard_batch, sharded_solve_fn)
from hilo_mpc_tpu_torch.parallel.sharding import CPU_SHARDS, replica_on

torch.set_num_threads(1)
KW = dict(device="cpu", dtype=torch.float64)
P = [1.0] * 6
X_EQ = [0.3, 0.18055]


def make_nmpc(N=8, **opts):
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=X_EQ)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_parameters(P)
    nmpc.setup(options={"dt": 0.1, **opts}, **KW)
    return nmpc


def x0_batch(B, seed=0, scale=0.04):
    return np.array([0.2, 0.1]) + scale * np.random.default_rng(seed).standard_normal((B, 2))


def assert_same_solution(sharded, single, tol=1e-12):
    for name in ("X", "U", "kkt_error"):
        np.testing.assert_allclose(np.asarray(getattr(sharded, name)),
                                   getattr(single, name).numpy(), atol=tol, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(np.asarray(sharded.iterations), single.iterations.numpy())
    np.testing.assert_array_equal(np.asarray(sharded.converged), single.converged.numpy())


class TestMesh:
    def test_make_mesh_all_devices(self):
        mesh = make_mesh(device="cpu")
        assert mesh.devices.size == CPU_SHARDS == mesh.size
        assert mesh.axis_names == ("dp",)

    def test_make_mesh_too_many_raises(self):
        with pytest.raises(ValueError):
            make_mesh(n_devices=10 ** 6, device="cpu")

    def test_cuda_mesh_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()

    def test_shard_batch_places_on_axis(self):
        mesh = make_mesh(8, device="cpu")
        x = shard_batch(torch.arange(64.0).reshape(16, 4), mesh)
        assert isinstance(x, ShardedTensor) and len(x.shards) == 8
        assert x.shape == (16, 4) and all(s.shape == (2, 4) for s in x.shards)
        np.testing.assert_array_equal(np.asarray(x), np.arange(64.0).reshape(16, 4))

    def test_shard_batch_keeps_the_tree(self):
        mesh = make_mesh(4, device="cpu")
        tree = {"a": np.zeros((8, 2)), "b": (np.ones(8), torch.zeros(8, 3, 1))}
        out = shard_batch(tree, mesh)
        assert out["a"].shape == (8, 2) and out["b"][1].shape == (8, 3, 1)
        assert len(out["b"][0].shards) == 4

    def test_replicate(self):
        mesh = make_mesh(8, device="cpu")
        x = replicate(torch.zeros(4, 4), mesh)
        assert len(x.copies) == 8 and all(c.shape == (4, 4) for c in x.copies)

    def test_indivisible_batch_refused_as_in_jax(self):
        import jax.numpy as jnp
        from hilo_mpc_tpu.parallel import make_mesh as jax_mesh
        from hilo_mpc_tpu.parallel import shard_batch as jax_shard

        with pytest.raises(ValueError, match="divisible"):
            jax_shard(jnp.zeros((10, 2)), jax_mesh(8))
        with pytest.raises(ValueError, match="divisible"):
            shard_batch(np.zeros((10, 2)), make_mesh(8, device="cpu"))
        # and the sharded solve refuses it too
        nmpc = make_nmpc(N=4)
        with pytest.raises(ValueError, match="divisible"):
            sharded_solve_fn(nmpc, make_mesh(8, device="cpu"))(
                *nmpc.prepare_batch(x0_batch(10)))


class TestShardedSolve:
    def test_sharded_matches_single_device(self):
        nmpc = make_nmpc()
        B = 16
        x0s = x0_batch(B)
        args = nmpc.prepare_batch(x0s)
        mesh = make_mesh(8, device="cpu")
        sol_sharded = sharded_solve_fn(nmpc, mesh)(*shard_batch(args, mesh))
        _, sol_single = nmpc.optimize_batch(x0s)
        assert isinstance(sol_sharded.U, ShardedTensor) and len(sol_sharded.U.shards) == 8
        assert_same_solution(sol_sharded, sol_single)
        assert convergence_stats(sol_sharded)["rate"] == 1.0

    def test_sharded_matches_jax_sharded(self):
        import jax.numpy as jnp
        from hilo_mpc_tpu import NMPC as JaxNMPC
        from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
        from hilo_mpc_tpu.parallel import make_mesh as jax_mesh
        from hilo_mpc_tpu.parallel import shard_batch as jax_shard
        from hilo_mpc_tpu.parallel import sharded_solve_fn as jax_sharded

        j = JaxNMPC(jax_cstr())
        j.horizon = 8
        j.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=X_EQ)
        j.quad_stage_cost.add_inputs(weights=0.1)
        j.set_parameters(P)
        j.setup(options={"dt": 0.1})
        x0s = x0_batch(16)
        jmesh = jax_mesh(8)
        jsol = jax_sharded(j, jmesh)(*jax_shard(j.prepare_batch(x0s), jmesh))
        nmpc = make_nmpc()
        mesh = make_mesh(8, device="cpu")
        tsol = sharded_solve_fn(nmpc, mesh)(*nmpc.prepare_batch(x0s))
        np.testing.assert_allclose(np.asarray(tsol.U), np.asarray(jsol.U), atol=1e-8)
        np.testing.assert_array_equal(np.asarray(tsol.iterations),
                                      np.asarray(jsol.iterations))
        assert jnp.asarray(jsol.converged).all()

    def test_stats_inside_match_host(self):
        nmpc = make_nmpc(N=4, tol=1e-6, max_iter=12)
        mesh = make_mesh(8, device="cpu")
        sol, stats = sharded_solve_fn(nmpc, mesh, with_stats=True)(
            *shard_batch(nmpc.prepare_batch(x0_batch(16)), mesh))
        host = convergence_stats(sol)
        assert int(stats["n_converged"]) == host["n_converged"]
        assert float(stats["rate"]) == pytest.approx(host["rate"])
        np.testing.assert_allclose(float(stats["kkt_max"]), host["kkt_max"], rtol=1e-6)
        np.testing.assert_allclose(float(stats["iterations_p50"]), host["iterations_p50"])
        assert int(stats["n"]) == 16

    def test_batch_stats_of_an_unsharded_solution(self):
        nmpc = make_nmpc(N=4, tol=1e-6, max_iter=12)
        _, sol = nmpc.optimize_batch(x0_batch(16))
        stats = batch_stats(sol)
        assert float(stats["rate"]) == 1.0
        assert all(torch.is_tensor(v) and v.dim() == 0 for v in stats.values())


class _Sol(NamedTuple):
    converged: object
    iterations: object
    kkt_error: object


@pytest.mark.parametrize("B", [16, 64])
def test_batch_stats_match_jax_at_an_even_batch(B):
    """Even B: the median is the mean of the two middle values (jnp.median),
    not torch.median's lower one; held on ties and distinct values, for a
    plain and a sharded solution."""
    import jax.numpy as jnp
    from hilo_mpc_tpu.parallel import batch_stats as jax_stats

    rng = np.random.default_rng(B)
    conv = rng.random(B) < 0.8
    iters = rng.integers(3, 9, B).astype(np.int32)
    iters[: B // 2] = np.sort(iters)[: B // 2]
    kkt = 10.0 ** rng.uniform(-10, -3, B)
    ref = jax_stats(_Sol(jnp.asarray(conv), jnp.asarray(iters), jnp.asarray(kkt)))
    plain = _Sol(torch.as_tensor(conv), torch.as_tensor(iters), torch.as_tensor(kkt))
    sharded = _Sol(*shard_batch(tuple(plain), make_mesh(8, device="cpu")))
    assert float(torch.median(plain.kkt_error)) != float(ref["kkt_p50"])
    for sol in (plain, sharded):
        got = batch_stats(sol)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].item() == np.asarray(v).item(), k
            assert str(got[k].dtype).split(".")[-1] == str(np.asarray(v).dtype), k


def _mhe(N=6):
    mhe = MHE(cstr_schaffner_and_zeitz())
    mhe.horizon = N
    mhe.Q, mhe.R, mhe.P0 = 1e-2 * np.eye(2), np.array([[1e-2]]), 0.1 * np.eye(2)
    mhe.set_initial_parameter_values(P)
    mhe.setup(dt=0.1, options={"tol": 1e-8, "max_iter": 25}, **KW)
    return mhe


def _windows(B, N, seed=6):
    rng = np.random.default_rng(seed)
    Ys = 0.12 + 0.005 * rng.standard_normal((B, N + 1, 1))
    Us = 0.02 * rng.standard_normal((B, N + 1, 1))
    x_arr = np.array([0.25, 0.12]) + 0.02 * rng.standard_normal((B, 2))
    return Ys, Us, x_arr


def test_estimate_batch_with_a_mesh_matches_no_mesh():
    mhe = _mhe()
    Ys, Us, x_arr = _windows(16, 6)
    x_one, sol_one = mhe.estimate_batch(Ys, Us, x_arrivals=x_arr)
    x_sh, sol_sh = mhe.estimate_batch(Ys, Us, x_arrivals=x_arr,
                                      mesh=make_mesh(8, device="cpu"))
    assert isinstance(sol_sh.X, ShardedTensor)
    np.testing.assert_allclose(x_sh, x_one, atol=1e-12, rtol=0)
    assert_same_solution(sol_sh, sol_one)
    assert bool(sol_one.converged.all())


def _plant():
    p = cstr_schaffner_and_zeitz()
    p.setup(dt=0.1, integration_method="rk4", **KW)
    return p


def _assert_same_loop(sharded, single):
    assert type(sharded) is type(single)
    for name, a, b in zip(single._fields, sharded, single):
        assert isinstance(a, ShardedTensor)
        if b.is_floating_point():
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-12, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_fused_loop_on_a_sharded_x0():
    mesh = make_mesh(4, device="cpu")
    run = fused_closed_loop_fn(make_nmpc(N=6), _plant(), steps=3, plant_p=np.ones(6))
    x0s = x0_batch(8, seed=1)
    single = run(x0s)
    sharded = run(shard_batch(torch.as_tensor(x0s), mesh))
    _assert_same_loop(sharded, single)
    assert float(np.asarray(sharded.converged).mean()) == 1.0


def test_fused_ekf_loop_on_a_sharded_x0():
    mesh = make_mesh(4, device="cpu")
    ekf = EKF(cstr_schaffner_and_zeitz())
    ekf.Q, ekf.R = 1e-4 * np.eye(2), np.array([[1e-4]])
    ekf.set_initial_parameter_values(P)
    ekf.setup(dt=0.1, **KW)
    run = fused_closed_loop_ekf_fn(make_nmpc(N=6), _plant(), ekf, steps=3,
                                   plant_p=np.ones(6))
    x0s = x0_batch(8, seed=2)
    x_est0 = x0s + 0.01
    single = run(x0s, x_est0, 0.05 * np.eye(2))
    sharded = run(shard_batch(torch.as_tensor(x0s), mesh), x_est0, 0.05 * np.eye(2))
    _assert_same_loop(sharded, single)


def test_fused_mhe_loop_on_a_sharded_x0():
    mesh = make_mesh(2, device="cpu")
    N = 4
    mhe = _mhe(N)
    run = fused_closed_loop_mhe_fn(make_nmpc(N=6), _plant(), mhe, steps=3,
                                   plant_p=np.ones(6))
    Ys, Us, x_arr = _windows(4, N, seed=3)
    x0 = x_arr + 0.01
    single = run(x0, Ys, Us, x_arr)
    sharded = run(shard_batch(torch.as_tensor(x0), mesh), Ys, Us, x_arr)
    _assert_same_loop(sharded, single)


def test_on_device_and_replicas():
    """The controller itself on its own device; a copy set up on a device
    with the same arguments solves with the same bits, and is kept until the
    controller is set up again."""
    nmpc = make_nmpc(N=4)
    assert on_device(nmpc, "cpu") is nmpc
    rep = replica_on(nmpc, torch.device("cpu"))
    # a copy of the same configuration on the same device shares the
    # registry's problem objects (utils/trace_cache.py)
    assert rep is not nmpc and rep._funcs is nmpc._funcs
    args = nmpc.prepare_batch(x0_batch(4))
    a = nmpc.solve_batch_fn()(*args)
    b = rep.solve_batch_fn()(*args)
    assert torch.equal(a.U, b.U) and torch.equal(a.iterations, b.iterations)
    # the original's state is untouched by the copy's setup
    assert nmpc._bounds is not rep._bounds and nmpc.solution is not rep.solution
    mhe = _mhe(4)
    rm = replica_on(mhe, torch.device("cpu"))
    Ys, Us, x_arr = _windows(2, 4)
    np.testing.assert_array_equal(rm.estimate_batch(Ys, Us, x_arrivals=x_arr)[0],
                                  mhe.estimate_batch(Ys, Us, x_arrivals=x_arr)[0])
