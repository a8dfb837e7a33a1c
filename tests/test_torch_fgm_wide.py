"""PyTorch port: the FGM kernel above n = 128 (csrc/fgm_boxqp.cu keeps H
resident there, split by rows over the blocks of a thread-block cluster), on
the CPU through its plain version, and on the card against it.

- ``fgm_boxqp_design`` names the design each n takes and raises outside
  1 <= n <= FGM_MAX_N (= 512); for every n in 129..512 its cluster is
  portable (at most 8 blocks), a block's shared memory fits 232,448 bytes
  and B = 1024 puts at least 128 blocks on the card;
- the plain version against the JAX Pallas kernel in interpret mode at
  n = 129 and 256 (the JAX kernel pads n to a multiple of 128), float32 to
  1e-5, and against the closed-form unconstrained optimum;
- ``cuda`` tests: the kernel against the plain version at n in {129, 160,
  256, 300, 512} with and without u0, and on a ragged batch at n = 160, 400
  and 512 (one n for each cluster design), to 1e-4
  (tests/test_torch_lmpc.py's tolerance), and LMPC's FGM path at n = 160.
"""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ops.pallas_kernels import fgm_boxqp_batch
from hilo_mpc_tpu_torch import LMPC, Model
from hilo_mpc_tpu_torch.ops.cuda_kernels import (
    FGM_CLUSTER_DESIGNS, FGM_MAX_N, FGM_NARROW_MAX_N, RICCATI_SMEM_MAX,
    fgm_boxqp_cluster_rows, fgm_boxqp_cluster_smem_bytes,
    fgm_boxqp_cuda, fgm_boxqp_design, fgm_boxqp_reference)

from test_torch_lmpc import _t, make_qp, report

torch.set_num_threads(1)


@pytest.mark.parametrize("n,design", [(1, ("registers", 1, 64)),
                                      (128, ("tensor", 1, 64)),
                                      (129, ("cluster", 4, 32)),
                                      (256, ("cluster", 4, 32)),
                                      (257, ("cluster", 4, 32)),
                                      (368, ("cluster", 4, 32)),
                                      (369, ("cluster", 8, 32)),
                                      (468, ("cluster", 8, 32)),
                                      (469, ("cluster", 8, 16)),
                                      (512, ("cluster", 8, 16))])
def test_design_by_size(n, design):
    assert FGM_MAX_N == 512 and FGM_NARROW_MAX_N == 128
    assert fgm_boxqp_design(n) == design


def test_cluster_design_for_every_n():
    """n = 129..512: a portable cluster (<= 8 blocks) whose blocks hold all
    n rows, within 232,448 bytes of shared memory and at most 1024 threads
    per block, with at least 128 blocks at B = 1024; every design of
    ``FGM_CLUSTER_DESIGNS`` is picked for some n."""
    assert RICCATI_SMEM_MAX == 232448
    picked = set()
    for n in range(FGM_NARROW_MAX_N + 1, FGM_MAX_N + 1):
        name, cluster, tile = fgm_boxqp_design(n)
        assert name == "cluster" and (cluster, tile) in FGM_CLUSTER_DESIGNS
        assert cluster <= 8
        picked.add((cluster, tile))
        rows = fgm_boxqp_cluster_rows(n, cluster)
        assert rows % 4 == 0 and cluster * rows >= n
        assert rows < -(-n // cluster) + 4
        assert fgm_boxqp_cluster_smem_bytes(n, cluster, tile) <= 232448
        assert (rows // 4) * (tile // 2) <= 1024
        assert cluster * -(-1024 // tile) >= 128
    assert picked == set(FGM_CLUSTER_DESIGNS)


@pytest.mark.parametrize("n", [0, FGM_MAX_N + 1, 1024])
def test_sizes_beyond_the_cap_raise(n):
    with pytest.raises(ValueError, match="FGM_MAX_N = 512"):
        fgm_boxqp_design(n)


@pytest.mark.parametrize("n", [129, 256])
def test_reference_matches_pallas_interpret_wide(n):
    H, G, lb, ub = make_qp(n=n, seed=7)
    H = H / n                                  # keep the spectrum moderate
    lb[::3] = -np.inf
    x0 = np.random.default_rng(8).normal(size=(9, 2))
    ref = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=40, tile_b=8))
    out = fgm_boxqp_reference(_t(H), _t(G), _t(x0), _t(lb), _t(ub), 40)
    report(f"fgm_boxqp_reference vs Pallas interpret n={n} (float32)", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [129, 256])
def test_reference_reaches_the_unconstrained_optimum_wide(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(n, n)) / np.sqrt(n)
    H = M @ M.T + np.eye(n)
    G = rng.normal(size=(n, 2))
    x0 = 0.1 * rng.normal(size=(3, 2))
    u = fgm_boxqp_reference(_t(H, torch.float64), _t(G, torch.float64),
                            _t(x0, torch.float64), _t(-1e3 * np.ones(n)),
                            _t(1e3 * np.ones(n)), 400)
    np.testing.assert_allclose(u.numpy(), -np.linalg.solve(H, G @ x0.T).T, atol=1e-4)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("u0", [False, True])
@pytest.mark.parametrize("n", [129, 160, 256, 300, FGM_MAX_N])
def test_fgm_column_blocks_match_plain_on_card(n, u0):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    H, G, lb, ub = make_qp(n=n)
    lb[::2] = -np.inf
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(1000, 2))
    dev = dict(dtype=torch.float32, device="cuda")
    args = [torch.as_tensor(a, **dev) for a in (H, G, x0, lb, ub)]
    U0 = torch.as_tensor(0.1 * rng.normal(size=(1000, n)), **dev) if u0 else None
    n0 = fgm_boxqp_cuda.launches
    out = fgm_boxqp_cuda(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    torch.cuda.synchronize()
    assert fgm_boxqp_cuda.launches == n0 + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("u0", [False, True])
@pytest.mark.parametrize("n", [160, 400, 512])
def test_every_cluster_design_matches_plain_on_card(n, u0):
    """One n for each cluster design the chooser picks ((4, 32), (8, 32),
    (8, 16)), on a ragged batch (B=1001)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    H, G, lb, ub = make_qp(n=n)
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(1001, 2))
    dev = dict(dtype=torch.float32, device="cuda")
    args = [torch.as_tensor(a, **dev) for a in (H, G, x0, lb, ub)]
    U0 = torch.as_tensor(0.1 * rng.normal(size=(1001, n)), **dev) if u0 else None
    out = fgm_boxqp_cuda(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_lmpc_fgm_path_at_n_160_on_card():
    """Eight decoupled double integrators, N=20: n = 160 through the
    cluster kernel, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    import scipy.linalg
    A = scipy.linalg.block_diag(*[np.array([[1.0, 0.1], [0.0, 1.0]])] * 8)
    B = scipy.linalg.block_diag(*[np.array([[0.005], [0.1]])] * 8)
    lmpc = LMPC(Model(discrete=True).set_state_space(A=A, B=B))
    lmpc.horizon = 20
    lmpc.Q = np.kron(np.eye(8), np.diag([2.0, 0.5]))
    lmpc.R = 0.1 * np.eye(8)
    lmpc.P = lmpc.Q
    lmpc.set_box_constraints(u_lb=[-1.0] * 8, u_ub=[1.0] * 8)
    lmpc.setup(options={"dt": 0.1}, device="cuda")
    x0s = np.random.default_rng(2).normal(size=(256, 16))
    n0 = fgm_boxqp_cuda.launches
    u = lmpc.optimize_batch_fgm(x0s, iters=100)
    assert fgm_boxqp_cuda.launches == n0 + 1
    ref = lmpc.optimize_batch_fgm(x0s, iters=100, backend="xla")
    np.testing.assert_allclose(u, ref, rtol=0, atol=1e-4)
