"""PyTorch port: the wide Riccati variant (csrc/riccati_lq_wide.cuh, a group
of G warps per scenario, for the sizes above the tiled kernel's (8, 4)), its
group schedule compiled with the host C++ compiler, against the plain sweeps
(ops/riccati.py:solve_lq) and the vmapped JAX ``solve_lq`` on the CPU.

The host build runs the threads of the group in a loop in every phase and
the 32 lanes of warp 0 in the gain (registers as 32-wide arrays, shuffles as
reads of another lane's slot), so it runs the card's schedule and order of
operations (not its rounding bit for bit: the card fuses multiply-adds and
takes rsqrt where the host takes 1 / sqrt), ragged batches included, at
every group size the chooser can pick
(the outputs are bit-equal across group sizes: each output element is
computed by one thread whatever G deals it to). float64 agrees to 1e-12
(the plain sweeps use ``torch.linalg`` above nu = 6, another order of
operations); float32 takes the tolerances of tests/test_torch_riccati.py.
Skipped where there is no host C++ compiler.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ops.riccati import solve_lq as jax_solve_lq
from hilo_mpc_tpu_torch.ops import _build
from hilo_mpc_tpu_torch.ops.cuda_kernels import (
    RICCATI_SMEM_MAX, RICCATI_WIDE_GROUPS, RICCATI_WIDE_MAX_NU, RICCATI_WIDE_MAX_NX,
    riccati_lq_cuda, riccati_lq_reference, riccati_lq_tiled_fits,
    riccati_lq_wide_cuda, riccati_lq_wide_group, riccati_lq_wide_host,
    riccati_lq_wide_layout, riccati_lq_wide_smem_bytes, riccati_lq_wide_source,
    riccati_lq_wide_tiles)
from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver, solve_lq
from hilo_mpc_tpu_torch.utils.interop import to_torch

from test_torch_riccati import NAMES, _tol, lq_problem

torch.set_num_threads(1)
WIDE_SIZES = [(9, 2), (16, 4), (32, 16)]
# the sizes held at every group size: the smallest, phase 4's and the cap
GROUP_SIZES = [(9, 2), (16, 8), (32, 16)]
DTYPES = ["float64", "float32"]


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def _wide_tol(name, f32):
    return _tol(name, True) if f32 else dict(rtol=1e-12, atol=1e-12)


def _assert_close(out, ref, f32):
    for name, a, b in zip(NAMES, out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=name,
                                   **_wide_tol(name, f32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", WIDE_SIZES)
@pytest.mark.parametrize("Bt,N", [(1, 1), (3, 20), (9, 5)])
def test_wide_host_matches_plain(Bt, N, nx, nu, dtype):
    """Batches below, at and past one block's warps (ragged last block)."""
    _need_cxx()
    args = to_torch(lq_problem(Bt, N, nx, nu, seed=1), device="cpu",
                    dtype=getattr(torch, dtype))
    out = riccati_lq_wide_host(*args, reg=1e-8)
    assert [tuple(o.shape) for o in out] == [
        (Bt, N + 1, nx), (Bt, N, nu), (Bt, N, nx), (Bt, N, nu, nx), (Bt, N, nu),
        (Bt,)]
    _assert_close(out, solve_lq(*args, reg=1e-8), dtype == "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", WIDE_SIZES)
def test_wide_host_matches_jax(nx, nu, dtype):
    _need_cxx()
    arrs = lq_problem(5, 12, nx, nu, seed=2)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    ref = jax.vmap(lambda *a: jax_solve_lq(*a, reg=1e-8))(
        *[jnp.asarray(a, jdt) for a in arrs])
    out = riccati_lq_wide_host(*to_torch(arrs, device="cpu",
                                         dtype=getattr(torch, dtype)), reg=1e-8)
    _assert_close(out, ref, dtype == "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", GROUP_SIZES)
@pytest.mark.parametrize("group", RICCATI_WIDE_GROUPS)
def test_wide_host_every_group_matches_plain(group, nx, nu, dtype):
    """The host build at each group size on a ragged batch (B=7, N=9):
    against the plain sweeps, and bit-equal to the chooser's group size."""
    _need_cxx()
    args = to_torch(lq_problem(7, 9, nx, nu, seed=4), device="cpu",
                    dtype=getattr(torch, dtype))
    out = riccati_lq_wide_host(*args, reg=1e-8, group=group)
    _assert_close(out, solve_lq(*args, reg=1e-8), dtype == "float32")
    for a, b in zip(out, riccati_lq_wide_host(*args, reg=1e-8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", GROUP_SIZES)
@pytest.mark.parametrize("group", RICCATI_WIDE_GROUPS)
def test_wide_host_every_group_matches_jax(group, nx, nu, dtype):
    _need_cxx()
    arrs = lq_problem(3, 6, nx, nu, seed=6)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    ref = jax.vmap(lambda *a: jax_solve_lq(*a, reg=1e-8))(
        *[jnp.asarray(a, jdt) for a in arrs])
    out = riccati_lq_wide_host(*to_torch(arrs, device="cpu", dtype=getattr(torch, dtype)),
                               reg=1e-8, group=group)
    _assert_close(out, ref, dtype == "float32")


def test_wide_host_takes_a_nonsymmetric_terminal_weight():
    """P_term enters as given (the kernel keeps P transposed): a
    nonsymmetric P_term gives the plain sweeps' answer."""
    _need_cxx()
    arrs = list(lq_problem(4, 5, 9, 2, seed=8))
    arrs[8] = arrs[8] + 0.3 * np.random.default_rng(9).standard_normal(arrs[8].shape)
    args = to_torch(tuple(arrs), device="cpu")
    _assert_close(riccati_lq_wide_host(*args, reg=1e-8), solve_lq(*args, reg=1e-8),
                  False)


def test_wide_group_choice():
    """G is the fewest warps that deal the largest phase in at most 4 tiles
    per thread in float64 and 2 in float32, at most 4 and 2 warps: (9, 2)
    one warp, phase 4's (16, 8) one and two, the cap four and two (the
    fastest G of each, timed on an H100 at B=1024)."""
    assert riccati_lq_wide_tiles(9, 2) == 37
    assert riccati_lq_wide_tiles(16, 8) == 124
    assert riccati_lq_wide_tiles(32, 16) == 472
    assert [riccati_lq_wide_group(nx, nu, torch.float64) for nx, nu in GROUP_SIZES] == [1, 1, 4]
    assert [riccati_lq_wide_group(nx, nu, torch.float32) for nx, nu in GROUP_SIZES] == [1, 2, 2]
    assert {riccati_lq_wide_group(nx, nu, dt)
            for nx in range(1, RICCATI_WIDE_MAX_NX + 1)
            for nu in range(1, RICCATI_WIDE_MAX_NU + 1)
            for dt in (torch.float32, torch.float64)} == set(RICCATI_WIDE_GROUPS)
    for group in (3, 8):
        with pytest.raises(ValueError, match="groups"):
            riccati_lq_wide_source(9, 2, group=group)


@pytest.mark.parametrize("nx,nu", [(2, 1), (8, 4)])
def test_wide_matches_tiled_at_small_sizes(nx, nu):
    """Both kernels run the same recursion in the same order per element:
    the wide variant's host build gives the tiled one's outputs."""
    _need_cxx()
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_host
    args = to_torch(lq_problem(33, 7, nx, nu, seed=3), device="cpu")
    for a, b in zip(riccati_lq_wide_host(*args, reg=1e-8),
                    riccati_lq_host(*args, reg=1e-8)):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("nx,nu", [(RICCATI_WIDE_MAX_NX + 1, 1),
                                   (2, RICCATI_WIDE_MAX_NU + 1), (0, 1)])
def test_wide_sizes_beyond_the_cap_raise(nx, nu):
    with pytest.raises(ValueError, match="RICCATI_WIDE_MAX_NX, RICCATI_WIDE_MAX_NU"):
        riccati_lq_wide_source(nx, nu)
    args = to_torch(lq_problem(1, 2, max(nx, 1), nu), device="cpu")
    if nx > 0:
        with pytest.raises(ValueError, match="RICCATI_WIDE_MAX_NX"):
            riccati_lq_wide_host(*args)


@pytest.mark.parametrize("nx,nu,tiled", [(8, 4, True), (9, 2, False), (2, 5, False),
                                         (32, 16, False), (1, 1, True)])
def test_routing_by_size(nx, nu, tiled):
    """make_lq_solver sends (nx, nu) up to (8, 4) to the tiled kernel and
    larger sizes to the wide variant; on CPU tensors both give the sweeps."""
    assert riccati_lq_tiled_fits(nx, nu) is tiled
    args = to_torch(lq_problem(2, 3, nx, nu), device="cpu")
    n0, n1 = riccati_lq_cuda.launches, riccati_lq_wide_cuda.launches
    out = make_lq_solver(1e-8)(*args)
    assert (riccati_lq_cuda.launches, riccati_lq_wide_cuda.launches) == (n0, n1)
    for a, b in zip(out, riccati_lq_reference(*args, reg=1e-8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_warps_fit_shared_memory(dtype):
    """Every (nx, nu) up to the cap: the chooser's group is one of
    RICCATI_WIDE_GROUPS and the block's shared memory (one scenario, the
    same for every group) is within RICCATI_SMEM_MAX = 232,448 bytes."""
    for nx in range(1, RICCATI_WIDE_MAX_NX + 1):
        for nu in range(1, RICCATI_WIDE_MAX_NU + 1):
            assert riccati_lq_wide_group(nx, nu, dtype) in RICCATI_WIDE_GROUPS
            assert riccati_lq_wide_smem_bytes(nx, nu, dtype) <= RICCATI_SMEM_MAX


@pytest.mark.parametrize("nx,nu", [(9, 2), (32, 16)])
def test_wide_layout_matches_the_built_instance(nx, nu):
    _need_cxx()
    lib = _build.load_host(riccati_lq_wide_source(nx, nu))
    for dtype in (torch.float32, torch.float64):
        assert riccati_lq_wide_layout(lib, dtype) == (
            riccati_lq_wide_group(nx, nu, dtype),
            riccati_lq_wide_smem_bytes(nx, nu, dtype), nx * nx + nx + nu * nx + nu)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx,nu", WIDE_SIZES + [(16, 8)])
@pytest.mark.parametrize("Bt,N", [(1001, 20), (1, 1), (33, 7)])
def test_wide_kernel_matches_plain_on_card(nx, nu, dtype, Bt, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    arrs = to_torch(lq_problem(Bt, N, nx, nu), device="cuda", dtype=dt)
    n0 = riccati_lq_wide_cuda.launches
    out = riccati_lq_wide_cuda(*arrs, reg=1e-8)
    ref = riccati_lq_reference(*arrs, reg=1e-8)
    torch.cuda.synchronize()
    assert riccati_lq_wide_cuda.launches == n0 + 1
    for name, a, b in zip(NAMES, out, ref):
        torch.testing.assert_close(a, b, **_wide_tol(name, dt == torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx,nu", GROUP_SIZES)
@pytest.mark.parametrize("group", RICCATI_WIDE_GROUPS)
def test_wide_kernel_every_group_on_card(group, nx, nu, dtype):
    """Each group size on the card on a ragged batch (B=1001): against the
    plain sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    arrs = to_torch(lq_problem(1001, 20, nx, nu, seed=3), device="cuda", dtype=dt)
    out = riccati_lq_wide_cuda(*arrs, reg=1e-8, group=group)
    ref = riccati_lq_reference(*arrs, reg=1e-8)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, out, ref):
        torch.testing.assert_close(a, b, **_wide_tol(name, dt == torch.float32))


@pytest.mark.cuda
def test_lq_solver_routes_wide_sizes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    args = to_torch(lq_problem(64, 6, 9, 2), device="cuda", dtype=torch.float64)
    n0, n1 = riccati_lq_cuda.launches, riccati_lq_wide_cuda.launches
    out = make_lq_solver(1e-8)(*args)
    ref = riccati_lq_reference(*args, reg=1e-8)
    torch.cuda.synchronize()
    assert (riccati_lq_cuda.launches, riccati_lq_wide_cuda.launches) == (n0, n1 + 1)
    for name, a, b in zip(NAMES, out, ref):
        torch.testing.assert_close(a, b, **_wide_tol(name, False))
