"""PyTorch port: the Riccati kernels' free-x0 mode (``dx0=None``: the kernel
solves dx0 = −(P0 + reg·I)⁻¹ p0 from its own backward pass) against the JAX
composite of a free-x0 Newton step (hilo_mpc_tpu/ops/ip_solver.py:633-642:
``backward_sweep``, then ``jnp.linalg.solve``, then ``solve_lq``), on the CPU.

The kernels run as their host builds (``riccati_lq_host``, the tiled block
schedule; ``riccati_lq_wide_host``, the wide group schedule at every group
size), the plain version as ``ops/riccati.py:solve_lq(..., dx0=None)``; float64
within 1e-12 (the kernels factor P0 by Cholesky where JAX takes LU). float32
holds the tiled host build against the composite with the Pallas kernel in
interpret mode at MHE's (2, 2) (interpret mode took 184 s at (4, 2), N=10,
so the other sizes take the XLA composite in float32), with the tolerances
of tests/test_torch_riccati.py. Skipped where there is no host C++ compiler;
the ``cuda`` twins run the kernels themselves.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ops.pallas_kernels import riccati_lq_pallas
from hilo_mpc_tpu.ops.riccati import backward_sweep as jax_backward_sweep
from hilo_mpc_tpu.ops.riccati import solve_lq as jax_solve_lq
from hilo_mpc_tpu_torch.ops.cuda_kernels import (RICCATI_WIDE_GROUPS,
                                                 riccati_lq_cuda, riccati_lq_host,
                                                 riccati_lq_reference,
                                                 riccati_lq_wide_cuda,
                                                 riccati_lq_wide_host)
from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver, solve_lq
from hilo_mpc_tpu_torch.utils.interop import to_torch

from test_torch_riccati import NAMES, _tol, lq_problem

torch.set_num_threads(1)
REG = 1e-8
TILED = [(2, 2), (4, 2), (8, 4)]
WIDE = [(9, 9), (16, 16)]
F64_TOL = dict(rtol=1e-12, atol=1e-12)


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def free_x0_problem(Bt, N, nx, nu, seed):
    """lq_problem with each stage's S scaled to spectral norm <= 0.5, so that
    every stage cost [[Q, Sᵀ], [S, R]] (Q = I, R = 0.5·I) is positive
    definite and so is P0, as in every MHE window. (lq_problem's S reaches
    ‖S‖₂ ≈ 0.8 at nu = 16, which makes some stage costs indefinite: the
    free-x0 solve of such a P0 is the deliberate difference the indefinite
    test below holds.)"""
    arrs = list(lq_problem(Bt, N, nx, nu, seed=seed))
    norm = np.linalg.norm(arrs[3], ord=2, axis=(-2, -1))
    arrs[3] = arrs[3] * np.minimum(1.0, 0.5 / norm)[..., None, None]
    return tuple(arrs)


def jax_free_x0(arrs, dtype, pallas=False):
    """The JAX composite: backward sweep, dx0 by LU, then the LQ solve (the
    Pallas kernel in interpret mode with ``pallas``)."""
    a = [jnp.asarray(x, dtype) for x in arrs[:10]]
    nx = a[0].shape[-1]

    def dx0_of(*blocks):
        _, _, P0, p0, _, _, _ = jax_backward_sweep(*blocks, REG)
        return -jnp.linalg.solve(P0 + REG * jnp.eye(nx, dtype=dtype), p0)

    dx0 = jax.vmap(dx0_of)(*a)
    if pallas:
        return riccati_lq_pallas(*a, dx0, reg=REG, tile_b=8, interpret=True)
    return jax.vmap(lambda *b: jax_solve_lq(*b, reg=REG))(*a, dx0)


def port_args(arrs, dtype):
    args = list(to_torch(arrs, device="cpu", dtype=dtype))
    args[-1] = None
    return args


def assert_close(out, ref, tol):
    for name, a, b in zip(NAMES, out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=name,
                                   **tol(name))


@pytest.mark.parametrize("Bt", [5, 33])
@pytest.mark.parametrize("nx,nu", TILED)
def test_tiled_host_matches_jax_f64(nx, nu, Bt):
    """A ragged second tile at Bt=33."""
    _need_cxx()
    arrs = free_x0_problem(Bt, 10, nx, nu, seed=11)
    out = riccati_lq_host(*port_args(arrs, torch.float64), reg=REG)
    assert_close(out, jax_free_x0(arrs, jnp.float64), lambda _: F64_TOL)


@pytest.mark.parametrize("group", RICCATI_WIDE_GROUPS)
@pytest.mark.parametrize("nx,nu", WIDE)
def test_wide_host_matches_jax_f64(nx, nu, group):
    _need_cxx()
    arrs = free_x0_problem(3, 8, nx, nu, seed=12)
    out = riccati_lq_wide_host(*port_args(arrs, torch.float64), reg=REG,
                               group=group)
    assert_close(out, jax_free_x0(arrs, jnp.float64), lambda _: F64_TOL)


@pytest.mark.parametrize("nx,nu", TILED + WIDE)
def test_plain_solve_matches_jax_f64(nx, nu):
    arrs = free_x0_problem(7, 10, nx, nu, seed=13)
    args = port_args(arrs, torch.float64)
    out = solve_lq(*args, reg=REG)
    ref = jax_free_x0(arrs, jnp.float64)
    assert_close(out, ref, lambda _: F64_TOL)
    # the kernel's plain version and the LQ step of the interior point
    for other in (riccati_lq_reference(*args, reg=REG), make_lq_solver(REG)(*args)):
        for a, b in zip(other, out):
            assert torch.equal(a, b)


def test_tiled_host_matches_pallas_interpret_f32():
    """MHE's CSTR shape, (2, 2), a ragged tile of the Pallas kernel (Bt=5
    against tile_b=8)."""
    _need_cxx()
    arrs = free_x0_problem(5, 6, 2, 2, seed=14)
    out = riccati_lq_host(*port_args(arrs, torch.float32), reg=REG)
    ref = jax_free_x0(arrs, jnp.float32, pallas=True)
    assert_close(out, ref, lambda name: _tol(name, True))


@pytest.mark.parametrize("nx,nu", TILED[1:] + WIDE)
def test_host_matches_jax_f32(nx, nu):
    _need_cxx()
    arrs = free_x0_problem(5, 6, nx, nu, seed=15)
    host = riccati_lq_host if (nx, nu) in TILED else riccati_lq_wide_host
    out = host(*port_args(arrs, torch.float32), reg=REG)
    assert_close(out, jax_free_x0(arrs, jnp.float32), lambda name: _tol(name, True))


def indefinite_problem(Bt, nx, nu):
    """Negative stage and terminal weights with small B: G = R + BᵀPB stays
    positive definite, P0 does not."""
    A, B, Q, S, R, q, r, c, Pt, pt, dx0 = free_x0_problem(Bt, 4, nx, nu, seed=16)
    return (A, 0.01 * B, -5.0 * Q, 0.0 * S, 2.0 * R, q, r, c, -5.0 * Pt, pt, dx0)


@pytest.mark.parametrize("nx,nu", [(2, 2), (9, 9)])
def test_indefinite_p0_gives_nan_on_the_kernel_route(nx, nu):
    """The kernels factor P0 + reg·I by Cholesky: a non-positive pivot makes
    dx0 (and the forward pass) NaN, which the interior point marks diverged;
    the gains stay finite. The plain version's LU solve, like JAX's, still
    returns a step (ROADMAP.md §C, a deliberate difference)."""
    _need_cxx()
    args = port_args(indefinite_problem(3, nx, nu), torch.float64)
    host = riccati_lq_host if (nx, nu) in TILED else riccati_lq_wide_host
    out = host(*args, reg=REG)
    plain = solve_lq(*args, reg=REG)
    assert torch.isnan(out[0][:, 0]).all() and torch.isnan(out[0]).all(dim=(1, 2)).all()
    assert torch.isfinite(out[3]).all() and torch.isfinite(out[4]).all()
    assert torch.isfinite(plain.dX).all()
    np.testing.assert_allclose(out[3].numpy(), plain.K.numpy(), **F64_TOL)


def test_host_refuses_missing_dx0_without_the_flag():
    """The C entry reads dx0 unless the free-x0 flag is set: the wrapper
    passes the flag exactly when dx0 is None, and a null dx0 without it is
    refused, not read."""
    _need_cxx()
    from hilo_mpc_tpu_torch.ops import cuda_kernels as ck
    args = list(to_torch(free_x0_problem(2, 3, 2, 2, seed=0), device="cpu",
                         dtype=torch.float64))
    fn, tb = ck._lq_entry(2, 2, torch.float64, True)
    bufs = ck._lq_buffers(args, 2, 3, 2, 2, tb)
    args[-1] = None
    assert fn(*ck._ptrs(args), *ck._ptrs(bufs), 2, 3, REG, 0) != 0
    assert fn(*ck._ptrs(args), *ck._ptrs(bufs), 2, 3, REG, 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nx,nu", TILED + WIDE)
def test_kernel_free_x0_on_card(nx, nu):
    """Both dtypes against the plain version on the card; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernel = riccati_lq_cuda if (nx, nu) in TILED else riccati_lq_wide_cuda
    for dt in (torch.float32, torch.float64):
        args = list(to_torch(free_x0_problem(1001, 10, nx, nu, seed=17), device="cuda",
                             dtype=dt))
        args[-1] = None
        n0 = kernel.launches
        out = kernel(*args, reg=REG)
        ref = riccati_lq_reference(*args, reg=REG)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1
        tol = ((lambda name: _tol(name, True)) if dt == torch.float32
               else (lambda _: F64_TOL))
        assert_close([o.cpu() for o in out], [r.cpu() for r in ref], tol)


@pytest.mark.cuda
def test_kernel_indefinite_p0_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for nx, nu in [(2, 2), (9, 9)]:
        args = list(to_torch(indefinite_problem(64, nx, nu), device="cuda"))
        args[-1] = None
        kernel = riccati_lq_cuda if (nx, nu) in TILED else riccati_lq_wide_cuda
        out = kernel(*args, reg=REG)
        torch.cuda.synchronize()
        assert torch.isnan(out[0][:, 0]).all() and torch.isfinite(out[3]).all()
