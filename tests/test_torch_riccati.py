"""PyTorch port: Riccati LQ sweeps and the CUDA kernel's plain version against
the JAX package (CPU), plus the kernel itself where a card is present."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ops.pallas_kernels import riccati_lq_pallas
from hilo_mpc_tpu.ops.riccati import solve_lq as jax_solve_lq
from hilo_mpc_tpu_torch.ops import smallalg
from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                 riccati_lq_reference,
                                                 riccati_lq_source)
from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver, solve_lq
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
SIZES = [(2, 1), (3, 2), (2, 3)]
# the kernel is instantiated for any size up to its cap at first use
CARD_SIZES = SIZES + [(4, 1), (8, 4)]
NAMES = ("dX", "dU", "lam", "K", "kff", "cost_red")


def lq_problem(Bt, N, nx, nu, seed=0):
    """The random stagewise LQ generator of tests/test_pallas_kernels.py:71-85."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((Bt, N, nx, nx))
    B = 0.3 * rng.standard_normal((Bt, N, nx, nu))
    Q = np.tile(np.eye(nx), (Bt, N, 1, 1))
    S = 0.1 * rng.standard_normal((Bt, N, nu, nx))
    R = np.tile(0.5 * np.eye(nu), (Bt, N, 1, 1))
    q = rng.standard_normal((Bt, N, nx))
    r = rng.standard_normal((Bt, N, nu))
    c = 0.1 * rng.standard_normal((Bt, N, nx))
    Pt = np.tile(np.eye(nx), (Bt, 1, 1))
    pt = rng.standard_normal((Bt, nx))
    dx0 = rng.standard_normal((Bt, nx))
    return (A, B, Q, S, R, q, r, c, Pt, pt, dx0)


def _tol(name, f32):
    # f32: tests/test_pallas_kernels.py:94-101 (lam carries more roundoff)
    if f32:
        return dict(rtol=1e-4, atol=1e-3 if name in ("lam", "cost_red") else 1e-4)
    return dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx,nu", SIZES)
def test_solve_lq_matches_jax(nx, nu, dtype):
    arrs = lq_problem(5, 6, nx, nu)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    ref = jax.vmap(lambda *a: jax_solve_lq(*a, reg=1e-8))(
        *[jnp.asarray(a, jdt) for a in arrs])
    out = solve_lq(*to_torch(arrs, device="cpu", dtype=getattr(torch, dtype)), reg=1e-8)
    for name, a, b in zip(NAMES, out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=name, **_tol(name, dtype == "float32"))


@pytest.mark.parametrize("nx,nu", SIZES)
def test_reference_matches_pallas_interpret(nx, nu):
    """The CUDA kernel's plain version against the Pallas kernel run in
    interpret mode, as tests/test_pallas_kernels.py runs it (f32)."""
    arrs = lq_problem(5, 5, nx, nu, seed=1)
    out_pl = riccati_lq_pallas(*[jnp.asarray(a, jnp.float32) for a in arrs],
                               tile_b=8)
    out = riccati_lq_reference(*to_torch(arrs, device="cpu", dtype=torch.float32), reg=1e-8)
    for name, a, b in zip(NAMES, out, out_pl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **_tol(name, True))


def test_cpu_tensors_never_launch_the_kernel():
    arrs = to_torch(lq_problem(3, 4, 2, 1), device="cpu")
    riccati_lq_cuda.launches = 0
    out = riccati_lq_cuda(*arrs, reg=1e-8)
    sol = make_lq_solver(reg=1e-8)(*arrs)
    ref = riccati_lq_reference(*arrs, reg=1e-8)
    assert riccati_lq_cuda.launches == 0
    for a, b, c in zip(out, sol, ref):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_lq_solver_rejects_another_reg():
    arrs = to_torch(lq_problem(2, 3, 2, 1), device="cpu")
    with pytest.raises(ValueError, match="reg"):
        make_lq_solver(reg=1e-8)(*arrs, reg=1e-6)


def test_lq_solver_broadcasts_shared_blocks():
    """Blocks without a batch axis (shared by all scenarios) give the same
    solution as their explicit per-scenario copies."""
    A, B, Q, S, R, q, r, c, Pt, pt, dx0 = to_torch(lq_problem(4, 5, 2, 1), device="cpu")
    shared = make_lq_solver(1e-8)(A, B, Q[0], S, R[0], q, r, c, Pt[0], pt, dx0)
    full = make_lq_solver(1e-8)(A, B, Q, S, R, q, r, c, Pt, pt, dx0)
    for a, b in zip(shared, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_smallalg_solves(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((4, n, n))
    G = M @ np.swapaxes(M, 1, 2) + n * np.eye(n)
    rhs = rng.standard_normal((4, n, 3))
    X = smallalg.solve_psd_small(torch.as_tensor(G), torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(X, np.linalg.solve(G, rhs), rtol=1e-10, atol=1e-12)
    L = smallalg.chol_small(torch.as_tensor(G)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(G), rtol=1e-10, atol=1e-12)
    x = smallalg.solve_small(torch.as_tensor(G), torch.as_tensor(rhs[..., 0]))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(G, rhs[..., :1])[..., 0],
                               rtol=1e-10, atol=1e-12)


def test_interop_round_trip():
    from hilo_mpc_tpu.ops.riccati import LQSolution as JaxLQ
    arrs = lq_problem(2, 3, 2, 1)
    ref = jax.vmap(lambda *a: jax_solve_lq(*a, reg=1e-8))(
        *[jnp.asarray(a) for a in arrs])
    port = to_torch(ref, device="cpu")
    assert type(port).__name__ == "LQSolution" and torch.is_tensor(port.dX)
    back = JaxLQ(*to_numpy(port))
    for a, b in zip(back, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("nx,nu", [(9, 1), (2, 5), (0, 1)])
def test_sizes_beyond_the_cap_raise(nx, nu):
    with pytest.raises(ValueError, match="RICCATI_MAX_NX, RICCATI_MAX_NU"):
        riccati_lq_source(nx, nu)


def test_one_instantiation_per_size():
    """Each (nx, nu) is its own generated source over csrc/riccati_lq.cuh."""
    a, b = riccati_lq_source(2, 1), riccati_lq_source(4, 1)
    assert '#include "riccati_lq.cuh"' in a and "RICCATI_LQ_EXPORTS(4, 1)" in b
    assert a != b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx,nu", CARD_SIZES)
# ragged last tiles (Bt=1, 33, 1000) and horizons (N=64 runs many chunks,
# one stage each at (8, 4))
@pytest.mark.parametrize("Bt,N", [(1000, 20), (1, 1), (33, 7), (1000, 64), (1, 64)])
def test_kernel_matches_plain_on_card(nx, nu, dtype, Bt, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    arrs = to_torch(lq_problem(Bt, N, nx, nu), device="cuda", dtype=dt)
    n0 = riccati_lq_cuda.launches
    out = riccati_lq_cuda(*arrs, reg=1e-8)
    ref = riccati_lq_reference(*arrs, reg=1e-8)
    torch.cuda.synchronize()
    assert riccati_lq_cuda.launches == n0 + 1
    for name, a, b in zip(NAMES, out, ref):
        torch.testing.assert_close(a, b, **_tol(name, dt == torch.float32))
