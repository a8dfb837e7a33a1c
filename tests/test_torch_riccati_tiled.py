"""PyTorch port: the tiled Riccati kernel's own block schedule
(csrc/riccati_lq.cuh), compiled with the host C++ compiler, against the plain
sweeps (ops/riccati.py:solve_lq) and the vmapped JAX ``solve_lq`` on the CPU.

The host build runs every block and thread of the card's schedule in loops:
the tile and chunk index arithmetic, the ragged last tile and chunk, the
double buffers, the scenario-minor stash and the coalesced stores. Tolerances
are those of tests/test_torch_riccati.py (float32 from
tests/test_pallas_kernels.py:94-101). Skipped where there is no host C++
compiler.
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
    RICCATI_MAX_NU, RICCATI_MAX_NX, RICCATI_SMEM_MAX, riccati_lq_cuda,
    riccati_lq_host, riccati_lq_layout, riccati_lq_reference,
    riccati_lq_smem_bytes, riccati_lq_source, riccati_lq_tiling)
from hilo_mpc_tpu_torch.ops.riccati import solve_lq
from hilo_mpc_tpu_torch.utils.interop import to_torch

from test_torch_riccati import NAMES, SIZES, _tol, lq_problem

torch.set_num_threads(1)
DTYPES = ["float64", "float32"]


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def _inputs(Bt, N, nx, nu, dtype, seed=0):
    return to_torch(lq_problem(Bt, N, nx, nu, seed=seed), device="cpu",
                    dtype=getattr(torch, dtype))


def _assert_close(out, ref, f32):
    for name, a, b in zip(NAMES, out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=name,
                                   **_tol(name, f32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", SIZES)
@pytest.mark.parametrize("Bt,N", [(1, 1), (1, 20), (31, 2), (33, 7), (65, 20),
                                  (65, 1)])
def test_host_matches_plain(Bt, N, nx, nu, dtype):
    """Ragged batches (one tile, a tile plus one, two tiles plus one) and
    horizons with the default tiling."""
    _need_cxx()
    args = _inputs(Bt, N, nx, nu, dtype)
    out = riccati_lq_host(*args, reg=1e-8)
    assert [tuple(o.shape) for o in out] == [
        (Bt, N + 1, nx), (Bt, N, nu), (Bt, N, nx), (Bt, N, nu, nx), (Bt, N, nu),
        (Bt,)]
    _assert_close(out, solve_lq(*args, reg=1e-8), dtype == "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", SIZES)
def test_host_matches_jax(nx, nu, dtype):
    """Default tiling at N=20 (several chunks for every size here) against
    the vmapped JAX solve_lq."""
    _need_cxx()
    arrs = lq_problem(65, 20, nx, nu, seed=2)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    ref = jax.vmap(lambda *a: jax_solve_lq(*a, reg=1e-8))(
        *[jnp.asarray(a, jdt) for a in arrs])
    tb, kc = riccati_lq_tiling(nx, nu, getattr(torch, dtype))
    assert kc < 20
    out = riccati_lq_host(*to_torch(arrs, device="cpu", dtype=getattr(torch, dtype)),
                          reg=1e-8)
    _assert_close(out, ref, dtype == "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,nu", SIZES)
def test_forced_short_ragged_chunks(nx, nu, dtype):
    """(TB, KC) = (32, 3) at N=7: chunks of 3, 3 and a ragged 1, over a
    ragged second tile (Bt=33), against the plain sweeps and JAX."""
    _need_cxx()
    arrs = lq_problem(33, 7, nx, nu, seed=3)
    args = to_torch(arrs, device="cpu", dtype=getattr(torch, dtype))
    out = riccati_lq_host(*args, reg=1e-8, tiling=(32, 3))
    f32 = dtype == "float32"
    _assert_close(out, solve_lq(*args, reg=1e-8), f32)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    ref = jax.vmap(lambda *a: jax_solve_lq(*a, reg=1e-8))(
        *[jnp.asarray(a, jdt) for a in arrs])
    _assert_close(out, ref, f32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiling", [(32, 1), (32, 3), (32, 9), (64, 2), (96, 2),
                                    (128, 1)])
def test_tiling_does_not_change_the_arithmetic(tiling, dtype):
    """Every thread runs the same operations in the same order whatever the
    tiles, so any tiling gives the default's outputs bit for bit."""
    _need_cxx()
    args = _inputs(70, 9, 3, 2, dtype, seed=4)
    ref = riccati_lq_host(*args, reg=1e-8)
    out = riccati_lq_host(*args, reg=1e-8, tiling=tiling)
    for name, a, b in zip(NAMES, out, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_largest_size_forces_one_stage_chunks(dtype):
    """(8, 4), the cap: its default chunk is one stage, so N=5 runs five
    chunks, on a ragged second tile."""
    _need_cxx()
    assert riccati_lq_tiling(8, 4, getattr(torch, dtype))[1] < 5
    args = _inputs(33, 5, 8, 4, dtype, seed=5)
    _assert_close(riccati_lq_host(*args, reg=1e-8), solve_lq(*args, reg=1e-8),
                  dtype == "float32")


def test_unaligned_views():
    """Inputs that start one element into their storage (data_ptr not 16-byte
    aligned, as for a view such as A[1:]) give the same outputs."""
    _need_cxx()
    args = _inputs(33, 7, 2, 1, "float32", seed=6)
    views = []
    for t in args:
        base = torch.zeros(t.numel() + 1, dtype=t.dtype)
        v = base[1:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        views.append(v)
    for a, b in zip(riccati_lq_host(*views, reg=1e-8), riccati_lq_host(*args, reg=1e-8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tiling_fits_shared_memory(dtype):
    """Every (nx, nu) up to the cap gets TB a multiple of 32 and a block
    within Hopper's 227 KB of shared memory."""
    for nx in range(1, RICCATI_MAX_NX + 1):
        for nu in range(1, RICCATI_MAX_NU + 1):
            tb, kc = riccati_lq_tiling(nx, nu, dtype)
            assert tb % 32 == 0 and tb >= 32 and kc >= 1, (nx, nu)
            assert riccati_lq_smem_bytes(nx, nu, dtype, (tb, kc)) <= RICCATI_SMEM_MAX


@pytest.mark.parametrize("nx,nu", [(2, 1), (8, 4)])
def test_layout_matches_the_built_instance(nx, nu):
    """The instance reports the tiles the text asked for and the shared memory
    riccati_lq_smem_bytes computes."""
    _need_cxx()
    lib = _build.load_host(riccati_lq_source(nx, nu))
    for dtype in (torch.float32, torch.float64):
        tiles = riccati_lq_tiling(nx, nu, dtype)
        assert riccati_lq_layout(lib, dtype) == (
            *tiles, riccati_lq_smem_bytes(nx, nu, dtype, tiles))


@pytest.mark.parametrize("tiling", [(48, 2), (0, 1), (64, 0), (1056, 1), (64, 400)])
def test_bad_tilings_raise(tiling):
    with pytest.raises(ValueError, match="riccati_lq tiles"):
        riccati_lq_source(2, 1, tiling)


def test_tiles_are_written_into_the_source():
    text = riccati_lq_source(3, 2, (96, 2))
    assert "#define RICCATI_LQ_TILES_F32 96, 2" in text
    assert "#define RICCATI_LQ_TILES_F64 96, 2" in text
    assert text != riccati_lq_source(3, 2)


def test_host_build_checks_its_inputs():
    args = list(_inputs(2, 3, 2, 1, "float64"))
    args[3] = args[3].float()
    with pytest.raises(ValueError, match="S is torch.float32"):
        riccati_lq_host(*args)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_unaligned_views_on_card():
    """Views whose data_ptr is not 16-byte aligned go through the kernel and
    match the plain sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    for dt in (torch.float32, torch.float64):
        args = to_torch(lq_problem(1000, 7, 2, 1, seed=7), device="cuda", dtype=dt)
        views = []
        for t in args:
            v = torch.zeros(t.numel() + 1, dtype=dt, device="cuda")[1:].view(t.shape)
            v.copy_(t)
            assert v.data_ptr() % 16 != 0
            views.append(v)
        n0 = riccati_lq_cuda.launches
        out = riccati_lq_cuda(*views, reg=1e-8)
        ref = riccati_lq_reference(*args, reg=1e-8)
        torch.cuda.synchronize()
        assert riccati_lq_cuda.launches == n0 + 1
        for name, a, b in zip(NAMES, out, ref):
            torch.testing.assert_close(a, b, **_tol(name, dt == torch.float32))
