"""PyTorch port: process groups and global batches
(parallel/distributed.py) on the CPU.

- The twins of tests/test_distributed.py::TestDistributedHelpers
  (local_slice in one and in two processes, the global mesh and batch of
  one process, is_multi_process), and ``initialize()`` without arguments
  or environment setting up nothing.
- A two-process gloo group on a loopback port, spawned here with
  ``torch.multiprocessing``: each process solves its half of 16 flagship
  scenarios (N=4, float64) on its 8-shard CPU mesh; the all-reduced
  ``batch_stats`` and the all-gathered U equal the single-process solve
  (U to 1e-12, counts, iterations and medians exactly).
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from hilo_mpc_tpu_torch.parallel import distributed as dist

B_TWO = 16
N_TWO = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flagship(N):
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz

    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", "tol": 1e-6,
                        "max_iter": 12, "convexify": False, "n_linesearch": 1,
                        "mu_init": 1e-2, "mehrotra": False},
               device="cpu", dtype=torch.float64)
    return nmpc


def _x0s():
    rng = np.random.default_rng(0)
    return np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B_TWO, 2))


def _stats_np(stats):
    return {k: np.asarray(v.item()) for k, v in stats.items()}


def _worker(rank, port, out_dir):
    """One process of the two: its half of the scenarios, solved on its
    mesh; the global stats and U written by each process."""
    torch.set_num_threads(1)
    from hilo_mpc_tpu_torch.parallel import sharded_solve_fn
    from hilo_mpc_tpu_torch.parallel.distributed import all_gather_rows

    assert dist.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout_s=120)
    assert dist.initialize() is True          # idempotent
    try:
        mesh = dist.global_mesh()
        assert mesh.process_count == 2
        nmpc = _flagship(N_TWO)
        sl = dist.local_slice(B_TWO)
        args = dist.global_batch(nmpc.prepare_batch(_x0s()[sl]), mesh)
        assert args[1].offset == sl.start and args[1].global_rows == B_TWO
        sol, stats = sharded_solve_fn(nmpc, mesh, with_stats=True)(*args)
        U = all_gather_rows(sol.U.gather())
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), U=U.numpy(),
                 **_stats_np(stats))
    finally:
        torch.distributed.destroy_process_group()


def test_two_process_gloo_group(tmp_path):
    from hilo_mpc_tpu_torch.parallel import batch_stats

    mp.spawn(_worker, args=(_free_port(), str(tmp_path)), nprocs=2, join=True)
    _, single = _flagship(N_TWO).optimize_batch(_x0s())
    ref = _stats_np(batch_stats(single))
    assert ref["rate"] == 1.0
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_allclose(got["U"], single.U.numpy(), atol=1e-12, rtol=0)
        for k, v in ref.items():
            if k.startswith("kkt"):
                np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
            else:
                assert got[k] == v and got[k].dtype == v.dtype, k


class TestDistributedHelpers:
    def test_local_slice_single_process(self):
        assert dist.local_slice(16) == slice(0, 16)

    def test_local_slice_two_process(self, monkeypatch):
        monkeypatch.setattr(dist, "process_count", lambda: 2)
        monkeypatch.setattr(dist, "process_index", lambda: 1)
        assert dist.local_slice(16) == slice(8, 16)
        with pytest.raises(ValueError, match="divisible"):
            dist.local_slice(17)

    def test_global_mesh_and_batch_single_process(self):
        mesh = dist.global_mesh(device="cpu")
        assert mesh.devices.size == 8 and mesh.process_count == 1
        x = np.arange(32, dtype=np.float64).reshape(16, 2)
        gx = dist.global_batch(x, mesh)
        assert gx.shape == (16, 2) and gx.offset == 0 and not gx.distributed
        np.testing.assert_allclose(np.asarray(gx), x)

    def test_is_multi_process_false_here(self):
        assert dist.is_multi_process() is False

    def test_initialize_without_arguments_or_environment(self, monkeypatch):
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        assert dist.initialize() is False
        assert not torch.distributed.is_initialized()

    def test_initialize_needs_every_part(self, monkeypatch):
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="RANK"):
            dist.initialize(device="cpu")

    @pytest.mark.parametrize("env, given, count, expect", [
        ({}, None, 4, [0, 1, 2, 3]),                                 # every visible card
        ({}, [2], 4, [2]),                                           # asked for
        ({"LOCAL_RANK": "2"}, None, 4, [2]),                         # torchrun, one card each
        ({"LOCAL_RANK": "1"}, [0], 4, [0]),                          # ids win
    ])
    def test_local_card_ids(self, monkeypatch, env, given, count, expect):
        """The cards a CUDA group's process takes (no card is touched:
        the visible count is patched)."""
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert dist.local_card_ids(given) == expect

    @pytest.mark.parametrize("env, given, count", [
        ({"LOCAL_RANK": "2"}, None, 2),                              # rank beyond the cards
        ({}, [4], 4),
        ({}, None, 0),
    ])
    def test_local_card_ids_refused(self, monkeypatch, env, given, count):
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        with pytest.raises(ValueError):
            dist.local_card_ids(given)
