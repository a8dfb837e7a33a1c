"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of ``hilo_mpc_tpu/ops/pallas_kernels.py``. Each wrapper takes the
JAX kernel's public layout (batch first), checks device, dtype, contiguity and
shapes, allocates outputs and scratch with ``torch.empty``, launches on
PyTorch's current stream without synchronizing (``fgm_boxqp_cuda`` called
without its ``constants`` first reads H back), and counts its launches in a
plain integer attribute (``<wrapper>.launches``) so a run can show that its
main path went through the kernel (the Riccati wrappers also count their
free-x0 launches, ``<wrapper>.free_x0_launches``). For CPU tensors — and
only for them — a wrapper returns its plain version instead; for CUDA
tensors it launches the kernel or raises.

The two Riccati kernels are registered operators (``torch.library.custom_op``):
``hilo_mpc_tpu_torch::riccati_lq`` and ``hilo_mpc_tpu_torch::riccati_lq_wide``,
each with its CUDA kernel for CUDA tensors, its plain version for CPU tensors
(the dispatcher picks by the tensors' device) and a fake kernel that gives
the output shapes, so ``torch.export`` keeps them as nodes of an exported
graph (utils/aot.py). Their wrappers call the operators.

Sources live in ``hilo_mpc_tpu_torch/csrc/`` and are built by ``nvcc`` at first
use (ops/_build.py); the Riccati kernel is a template there, instantiated for
each (nx, nu) a caller needs: the tiled kernel up to (8, 4), a variant with a
group of warps per scenario above (``riccati_lq_wide_cuda``, up to
(32, 16)); the FGM kernel's register design is built per n, its tensor-core
design per n padded to 8. The whole-solve interior point is in ops/whole_ip.py.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .riccati import solve_lq

# the largest (nx, nu) riccati_lq_cuda instantiates (csrc/riccati_lq.cuh)
RICCATI_MAX_NX = 8
RICCATI_MAX_NU = 4
# the largest (nx, nu) riccati_lq_wide_cuda instantiates
# (csrc/riccati_lq_wide.cuh: a group of G warps per scenario), the group
# sizes G a build takes, and per dtype (float32, float64) what
# riccati_lq_wide_group allows: the most tiles per thread of the largest
# phase before it takes more warps, and the most warps
RICCATI_WIDE_MAX_NX = 32
RICCATI_WIDE_MAX_NU = 16
RICCATI_WIDE_GROUPS = (1, 2, 4)
RICCATI_WIDE_ROUNDS = (2, 4)
RICCATI_WIDE_MAX_GROUP = (2, 4)
# shared memory of one riccati_lq block: the most Hopper gives a block
# (227 KB), and the most riccati_lq_tiling aims for, so that five blocks fit
# on an SM; the tile (scenarios per block) and the chunks (stages per copy)
# it tries, in order
RICCATI_SMEM_MAX = 232448
RICCATI_SMEM_TARGET = 48 * 1024
RICCATI_TILE = 32
RICCATI_CHUNKS = (8, 4, 2, 1)
# largest QP size n of the FGM kernels (FGM_MAX_N), and the largest n whose
# H one block keeps in shared memory (FGM_NARROW_MAX_N): up to it the
# tensor-core design of csrc/fgm_boxqp_tc.cuh (3xTF32 wgmma with the
# iterate as the register A operand, H split into hi and lo tiles in shared
# memory; one build per n padded to FGM_TC_STEP, at most FGM_TC_MAX_WARPS
# warps per block within RICCATI_SMEM_MAX bytes); above it csrc/fgm_boxqp.cu splits H by rows over
# the blocks of a thread-block cluster: the (blocks per cluster, scenarios
# per tile) designs it builds, in the order fgm_boxqp_design tries them. Up
# to FGM_REG_MAX_N the register design of csrc/fgm_boxqp_reg.cuh (one
# scenario per thread, its iterate in registers, H in the constant bank)
# takes the place of the tensor-core one; that header builds for n up to
# FGM_REG_BUILD_MAX_N (chip_smoke.py times the two designs there), with
# FGM_REG_TPB threads per block
FGM_MAX_N = 512
FGM_NARROW_MAX_N = 128
FGM_CLUSTER_DESIGNS = ((4, 32), (8, 32), (8, 16))
FGM_REG_MAX_N = 19
FGM_REG_BUILD_MAX_N = 64
FGM_REG_TPB = 64
FGM_TC_STEP = 8
FGM_TC_MAX_WARPS = 8
# what an infinite FGM bound becomes (hilo_mpc_tpu/ops/pallas_kernels.py:67-68)
FGM_INF = 1e30


def riccati_lq_reference(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                         reg: float = 1e-8):
    """Plain PyTorch version of ``riccati_lq_cuda``: the batch-first Riccati
    sweeps of ops/riccati.py (``dx0=None``: the free initial state by
    ``torch.linalg.solve``). Same arguments and returns."""
    return tuple(solve_lq(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg=reg))


def riccati_lq_smem_bytes(nx: int, nu: int, dtype, tiling) -> int:
    """Dynamic shared memory of one block of the ``riccati_lq`` kernel with
    tiles ``tiling`` = (TB, KC): two input buffers of the eight per-stage
    fields and one output buffer, each KC stages of rows of TB+1 elements
    (csrc/riccati_lq.cuh:smem_elems)."""
    tb, kc = tiling
    f_in = 2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu
    f_out = max(nu * nx + nu, 2 * nx + nu)
    return (2 * f_in + f_out) * kc * (tb + 1) * (torch.finfo(dtype).bits // 8)


def riccati_lq_tiling(nx: int, nu: int, dtype) -> tuple:
    """(TB, KC) of the ``riccati_lq`` kernel for one (nx, nu, dtype): TB
    scenarios per block, KC stages per staged chunk. One warp per block and
    the longest chunk whose shared memory stays within
    ``RICCATI_SMEM_TARGET``; the sizes where none does take (32, 1), which
    fits ``RICCATI_SMEM_MAX`` up to (8, 4) in float64. At the flagship (2, 1)
    this gives (32, 8) in float32 and (32, 4) in float64, which ranked first
    among the tilings timed on an H100 (PERF.md §6)."""
    for kc in RICCATI_CHUNKS:
        if riccati_lq_smem_bytes(nx, nu, dtype, (RICCATI_TILE, kc)) <= RICCATI_SMEM_TARGET:
            return RICCATI_TILE, kc
    return RICCATI_TILE, 1


def _check_tiling(nx, nu, dtype, tiling):
    tb, kc = tiling
    if not (tb % 32 == 0 and 32 <= tb <= 1024 and kc >= 1):
        raise ValueError(f"riccati_lq tiles need TB a multiple of 32 in [32, 1024] "
                         f"and KC >= 1, got (TB, KC) = {tiling}")
    smem = riccati_lq_smem_bytes(nx, nu, dtype, tiling)
    if smem > RICCATI_SMEM_MAX:
        raise ValueError(f"riccati_lq tiles {tiling} for nx={nx}, nu={nu}, {dtype} "
                         f"need {smem} bytes of shared memory per block, more than "
                         f"RICCATI_SMEM_MAX = {RICCATI_SMEM_MAX}")
    return int(tb), int(kc)


def riccati_lq_tiled_fits(nx: int, nu: int) -> bool:
    """True iff the tiled kernel (``riccati_lq_cuda``) takes (nx, nu);
    ``ops/riccati.py:make_lq_solver`` sends larger sizes to
    ``riccati_lq_wide_cuda``."""
    return 1 <= nx <= RICCATI_MAX_NX and 1 <= nu <= RICCATI_MAX_NU


def _check_size(nx, nu):
    if not riccati_lq_tiled_fits(nx, nu):
        raise ValueError(f"riccati_lq_cuda takes 1 <= nx <= {RICCATI_MAX_NX} and "
                         f"1 <= nu <= {RICCATI_MAX_NU} (RICCATI_MAX_NX, "
                         f"RICCATI_MAX_NU), got nx={nx}, nu={nu}")


def _check_wide_size(nx, nu):
    if not (1 <= nx <= RICCATI_WIDE_MAX_NX and 1 <= nu <= RICCATI_WIDE_MAX_NU):
        raise ValueError(f"riccati_lq_wide_cuda takes 1 <= nx <= {RICCATI_WIDE_MAX_NX} "
                         f"and 1 <= nu <= {RICCATI_WIDE_MAX_NU} (RICCATI_WIDE_MAX_NX, "
                         f"RICCATI_WIDE_MAX_NU), got nx={nx}, nu={nu}")


def riccati_lq_source(nx: int, nu: int, tiling=None) -> str:
    """Source of the ``riccati_lq`` instantiation for one (nx, nu), from the
    template csrc/riccati_lq.cuh; built at first use. ``tiling`` (TB, KC)
    applies to both dtypes; by default each takes ``riccati_lq_tiling``."""
    _check_size(nx, nu)
    tiles = {dt: _check_tiling(nx, nu, dt, tiling or riccati_lq_tiling(nx, nu, dt))
             for dt in (torch.float32, torch.float64)}
    (t32, k32), (t64, k64) = tiles[torch.float32], tiles[torch.float64]
    return ('#include "riccati_lq.cuh"\n'
            f"#define RICCATI_LQ_TILES_F32 {t32}, {k32}\n"
            f"#define RICCATI_LQ_TILES_F64 {t64}, {k64}\n"
            f"RICCATI_LQ_EXPORTS({nx}, {nu})\n")


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


# the 18 pointers, Bt, N, reg and the free-x0 flag of both Riccati entries
# (csrc/riccati_lq.cuh:RLQ_ARGS, csrc/riccati_lq_wide.cuh:RLW_ARGS)
_LQ_ARGTYPES = ([ctypes.c_void_p] * 18
                + [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int])


@_build.per_build_dir
def _lq_entry(nx: int, nu: int, dtype, host: bool, tiling=None):
    """(entry point bound with ctypes, TB) of the instance for (nx, nu,
    dtype), built at first use: ``riccati_lq_f32`` / ``_f64`` on the card
    (last argument the stream), ``riccati_lq_host_*`` on the host."""
    text = riccati_lq_source(nx, nu, tiling)
    if host:
        fn = getattr(_build.load_host(text), f"riccati_lq_host_{_suffix(dtype)}")
    else:
        fn = getattr(_build.load_source(text), f"riccati_lq_{_suffix(dtype)}")
    fn.argtypes = _LQ_ARGTYPES + ([] if host else [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, (tiling or riccati_lq_tiling(nx, nu, dtype))[0]


def riccati_lq_layout(lib, dtype) -> tuple:
    """(TB, KC, dynamic shared memory bytes) of a built instance, as its
    ``riccati_lq_layout_f32`` / ``_f64`` entry point reports them."""
    out = (ctypes.c_int * 3)()
    getattr(lib, f"riccati_lq_layout_{_suffix(dtype)}")(out)
    return tuple(out)


def _check_lq(args, host: bool, check_size=_check_size):
    """Shapes, dtype, device and contiguity of the inputs (dx0 may be None:
    a free initial state); returns (Bt, N, nx, nu)."""
    A, B = args[0], args[1]
    if A.dim() != 4 or B.dim() != 4:
        raise ValueError(f"A and B must be (Bt, N, nx, nx) / (Bt, N, nx, nu), "
                         f"got {tuple(A.shape)} and {tuple(B.shape)}")
    Bt, N, nx, nu = A.shape[0], A.shape[1], A.shape[2], B.shape[3]
    check_size(nx, nu)
    if Bt < 1 or N < 1 or Bt >= 2 ** 31:
        raise ValueError(f"need 1 <= Bt < 2**31 and N >= 1, got Bt={Bt}, N={N}")
    expected = {
        "A": (Bt, N, nx, nx), "B": (Bt, N, nx, nu), "Q": (Bt, N, nx, nx),
        "S": (Bt, N, nu, nx), "R": (Bt, N, nu, nu), "q": (Bt, N, nx),
        "r": (Bt, N, nu), "c": (Bt, N, nx), "P_term": (Bt, nx, nx),
        "p_term": (Bt, nx), "dx0": (Bt, nx)}
    dtype, device = A.dtype, A.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"riccati_lq_cuda takes float32 or float64, got {dtype}")
    if host and device.type != "cpu":
        raise ValueError(f"riccati_lq_host takes CPU tensors, got {device}")
    for (name, shape), t in zip(expected.items(), args):
        if t is None and name == "dx0":
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; all inputs must "
                             f"be {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return Bt, N, nx, nu


def _lq_buffers(args, Bt, N, nx, nu, tb):
    """The outputs (dX, dU, lam, K, kff, cost_red) and the stash: (P, p, K,
    kff)_k per stage, scenario-minor within each tile of TB."""
    kw = dict(dtype=args[0].dtype, device=args[0].device)
    return (torch.empty((Bt, N + 1, nx), **kw), torch.empty((Bt, N, nu), **kw),
            torch.empty((Bt, N, nx), **kw), torch.empty((Bt, N, nu, nx), **kw),
            torch.empty((Bt, N, nu), **kw), torch.empty((Bt,), **kw),
            torch.empty((-(-Bt // tb), N, nx * nx + nx + nu * nx + nu, tb), **kw))


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


_LQ_OUT = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor, torch.Tensor]


def _lq_fake(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg):
    """The output shapes of both Riccati operators (dX, dU, lam, K, kff,
    cost_red) for ``torch.export`` and the other tracers."""
    Bt, N, nx, nu = A.shape[0], A.shape[1], A.shape[2], B.shape[3]
    return (A.new_empty((Bt, N + 1, nx)), A.new_empty((Bt, N, nu)),
            A.new_empty((Bt, N, nx)), A.new_empty((Bt, N, nu, nx)),
            A.new_empty((Bt, N, nu)), A.new_empty((Bt,)))


@torch.library.custom_op("hilo_mpc_tpu_torch::riccati_lq", mutates_args=(),
                         device_types="cpu")
def riccati_lq_op(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, S: torch.Tensor,
                  R: torch.Tensor, q: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                  P_term: torch.Tensor, p_term: torch.Tensor,
                  dx0: Optional[torch.Tensor], reg: float) -> _LQ_OUT:
    """The operator of ``riccati_lq_cuda``; on CPU tensors its plain
    version."""
    return riccati_lq_reference(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg=reg)


@riccati_lq_op.register_kernel("cuda")
def _riccati_lq_launch(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg):
    args = (A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
    Bt, N, nx, nu = _check_lq(args, host=False)
    fn, tb = _lq_entry(nx, nu, A.dtype, host=False)
    bufs = _lq_buffers(args, Bt, N, nx, nu, tb)
    with torch.cuda.device(A.device):
        rc = fn(*_ptrs(args), *_ptrs(bufs), Bt, N, float(reg), int(dx0 is None),
                torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"riccati_lq kernel launch failed: cudaError {rc}")
    riccati_lq_cuda.launches += 1
    riccati_lq_cuda.free_x0_launches += dx0 is None
    return bufs[:6]


riccati_lq_op.register_fake(_lq_fake)


def riccati_lq_cuda(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                    reg: float = 1e-8):
    """Batched stagewise LQ solve as ONE CUDA kernel (csrc/riccati_lq.cuh),
    replacing ``hilo_mpc_tpu/ops/pallas_kernels.py:riccati_lq_pallas``.

    Shapes (Bt = batch): A (Bt,N,nx,nx), B (Bt,N,nx,nu), Q (Bt,N,nx,nx),
    S (Bt,N,nu,nx), R (Bt,N,nu,nu), q (Bt,N,nx), r (Bt,N,nu), c (Bt,N,nx),
    P_term (Bt,nx,nx), p_term (Bt,nx), dx0 (Bt,nx) or None; float32 or
    float64, one dtype, contiguous, one CUDA device; nx <= ``RICCATI_MAX_NX``
    and nu <= ``RICCATI_MAX_NU`` (each size is built at its first use).
    ``dx0=None`` runs the free-x0 mode: the kernel solves dx0 =
    −(P0 + reg·I)⁻¹ p0 from its own backward pass (a Cholesky factor; NaN
    where P0 + reg·I is not positive definite), the free-x0 step of
    ``hilo_mpc_tpu/ops/ip_solver.py:633-642``.
    Returns (dX (Bt,N+1,nx), dU (Bt,N,nu), lam (Bt,N,nx), K (Bt,N,nu,nx),
    kff (Bt,N,nu), cost_red (Bt,)). Runs the operator
    ``hilo_mpc_tpu_torch::riccati_lq``.
    """
    return riccati_lq_op(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, float(reg))


riccati_lq_cuda.launches = riccati_lq_cuda.free_x0_launches = 0


def riccati_lq_host(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                    reg: float = 1e-8, tiling=None):
    """The kernel's own block schedule (csrc/riccati_lq.cuh), compiled with the
    host C++ compiler, on CPU tensors: every block and thread in a loop, plain
    copies in place of ``cp.async``. Same arguments and returns as
    ``riccati_lq_cuda``; ``tiling`` (TB, KC) overrides
    ``riccati_lq_tiling``."""
    args = (A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
    Bt, N, nx, nu = _check_lq(args, host=True)
    fn, tb = _lq_entry(nx, nu, A.dtype, True, None if tiling is None else tuple(tiling))
    bufs = _lq_buffers(args, Bt, N, nx, nu, tb)
    if fn(*_ptrs(args), *_ptrs(bufs), Bt, N, float(reg), int(dx0 is None)) != 0:
        raise RuntimeError("riccati_lq_host refused its arguments")
    return bufs[:6]


def _even(v: int) -> int:
    return (v + 1) & ~1


def riccati_lq_wide_words(nx: int, nu: int) -> int:
    """Shared-memory words of one scenario of the ``riccati_lq_wide`` kernel:
    two stage buffers (X = [B | A | c] and C0 = [[R | S | r]; [· | Q | q]]
    in one padded column space), then P transposed, p, P X, K, kff, dx, dx',
    du and cost_red (csrc/riccati_lq_wide.cuh:GLay::E)."""
    nup, nxp = _even(nu), _even(nx)
    xw = nup + nxp + 2
    buf = nx * xw + (nup + nxp) * xw
    return (2 * buf + nx * nxp + nxp + nx * xw + nu * nxp + nup + 2 * nxp + nup
            + 2)


def riccati_lq_wide_smem_bytes(nx: int, nu: int, dtype) -> int:
    """Dynamic shared memory of one block (one scenario) of the
    ``riccati_lq_wide`` kernel; the same for every group size."""
    return riccati_lq_wide_words(nx, nu) * (torch.finfo(dtype).bits // 8)


def riccati_lq_wide_tiles(nx: int, nu: int) -> int:
    """The most 2 x 2 register tiles of one phase of the wide kernel: P X,
    Xᵀ(P X) (the u rows and the x block of the x rows) or the mirrored
    update of P with p's pairs (csrc/riccati_lq_wide.cuh:GLay::T_*)."""
    nup, nxp = _even(nu), _even(nx)
    xw, h = nup + nxp + 2, nxp // 2
    return max(h * (xw // 2), (nup // 2) * (xw // 2) + h * (h + 1),
               h * (h + 1) // 2 + h)


def riccati_lq_wide_group(nx: int, nu: int, dtype) -> int:
    """Warps G per scenario of the ``riccati_lq_wide`` kernel for one
    (nx, nu, dtype): the fewest of ``RICCATI_WIDE_GROUPS`` whose threads
    deal the largest product phase in at most ``RICCATI_WIDE_ROUNDS`` tiles
    each (2 in float32, 4 in float64), at most ``RICCATI_WIDE_MAX_GROUP``
    warps (2 in float32, 4 in float64). More warps shorten each phase;
    fewer put more scenarios on an SM, and a thread takes ~115-180
    registers, so a larger block soon fits an SM fewer times than its
    shared memory would allow. On an H100 at B=1024 the fastest G back to
    back was 1 (float64) and 2 (float32) at phase 4's (16, 8), 4 and 2 at
    the cap (32, 16), which this rule gives; 8 warps ranked no better than
    third in any of the four (PERF.md §6)."""
    f64 = dtype == torch.float64
    tiles = riccati_lq_wide_tiles(nx, nu)
    return next(g for g in RICCATI_WIDE_GROUPS
                if 32 * g * RICCATI_WIDE_ROUNDS[f64] >= tiles
                or g == RICCATI_WIDE_MAX_GROUP[f64])


def riccati_lq_wide_source(nx: int, nu: int, group=None) -> str:
    """Source of the ``riccati_lq_wide`` instantiation for one (nx, nu), from
    the template csrc/riccati_lq_wide.cuh, with the warps per scenario of
    each dtype (``group`` for both, else ``riccati_lq_wide_group``); built
    at first use."""
    _check_wide_size(nx, nu)
    if group is not None and group not in RICCATI_WIDE_GROUPS:
        raise ValueError(f"riccati_lq_wide groups are {RICCATI_WIDE_GROUPS} warps, "
                         f"got {group}")
    g32, g64 = (group or riccati_lq_wide_group(nx, nu, dt)
                for dt in (torch.float32, torch.float64))
    return ('#include "riccati_lq_wide.cuh"\n'
            f"#define RICCATI_LQ_WIDE_GROUP_F32 {g32}\n"
            f"#define RICCATI_LQ_WIDE_GROUP_F64 {g64}\n"
            f"RICCATI_LQ_WIDE_EXPORTS({nx}, {nu})\n")


@_build.per_build_dir
def _lq_wide_entry(nx: int, nu: int, dtype, host: bool, group=None):
    """(entry point bound with ctypes, stash words per stage) of the wide
    instance for (nx, nu, dtype), built at first use."""
    text = riccati_lq_wide_source(nx, nu, group)
    suffix = _suffix(dtype)
    if host:
        fn = getattr(_build.load_host(text), f"riccati_lq_wide_host_{suffix}")
    else:
        fn = getattr(_build.load_source(text), f"riccati_lq_wide_{suffix}")
    fn.argtypes = _LQ_ARGTYPES + ([] if host else [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, nx * nx + nx + nu * nx + nu


def riccati_lq_wide_layout(lib, dtype) -> tuple:
    """(warps per scenario, dynamic shared memory bytes, stash words per
    stage) of a built wide instance, as its ``riccati_lq_wide_layout_*``
    entry point reports them."""
    out = (ctypes.c_int * 3)()
    getattr(lib, f"riccati_lq_wide_layout_{_suffix(dtype)}")(out)
    return tuple(out)


def _lq_wide_buffers(args, Bt, N, nx, nu, sw):
    kw = dict(dtype=args[0].dtype, device=args[0].device)
    return (torch.empty((Bt, N + 1, nx), **kw), torch.empty((Bt, N, nu), **kw),
            torch.empty((Bt, N, nx), **kw), torch.empty((Bt, N, nu, nx), **kw),
            torch.empty((Bt, N, nu), **kw), torch.empty((Bt,), **kw),
            torch.empty((Bt, N, sw), **kw))


@torch.library.custom_op("hilo_mpc_tpu_torch::riccati_lq_wide", mutates_args=(),
                         device_types="cpu")
def riccati_lq_wide_op(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor,
                       S: torch.Tensor, R: torch.Tensor, q: torch.Tensor,
                       r: torch.Tensor, c: torch.Tensor, P_term: torch.Tensor,
                       p_term: torch.Tensor, dx0: Optional[torch.Tensor], reg: float,
                       group: int) -> _LQ_OUT:
    """The operator of ``riccati_lq_wide_cuda`` (``group`` 0: the default
    warps per scenario); on CPU tensors its plain version."""
    return riccati_lq_reference(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg=reg)


@riccati_lq_wide_op.register_kernel("cuda")
def _riccati_lq_wide_launch(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg, group):
    args = (A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
    Bt, N, nx, nu = _check_lq(args, host=False, check_size=_check_wide_size)
    fn, sw = _lq_wide_entry(nx, nu, A.dtype, False, group or None)
    bufs = _lq_wide_buffers(args, Bt, N, nx, nu, sw)
    with torch.cuda.device(A.device):
        rc = fn(*_ptrs(args), *_ptrs(bufs), Bt, N, float(reg), int(dx0 is None),
                torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"riccati_lq_wide kernel launch failed: cudaError {rc}")
    riccati_lq_wide_cuda.launches += 1
    riccati_lq_wide_cuda.free_x0_launches += dx0 is None
    return bufs[:6]


riccati_lq_wide_op.register_fake(
    lambda A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg, group:
    _lq_fake(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg))


def riccati_lq_wide_cuda(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                         reg: float = 1e-8, group=None):
    """The batched stagewise LQ solve of ``riccati_lq_cuda`` for the sizes
    above its cap, as ONE CUDA kernel with a group of warps per scenario
    (csrc/riccati_lq_wide.cuh), replacing
    ``hilo_mpc_tpu/ops/pallas_kernels.py:riccati_lq_pallas`` there. Same
    arguments, shapes and returns as ``riccati_lq_cuda``, the free-x0 mode
    (``dx0=None``) included; 1 <= nx <=
    ``RICCATI_WIDE_MAX_NX`` and 1 <= nu <= ``RICCATI_WIDE_MAX_NU`` (each size
    is built at its first use). ``group`` (warps per scenario) overrides
    ``riccati_lq_wide_group``. Counts its own launches. Runs the operator
    ``hilo_mpc_tpu_torch::riccati_lq_wide``."""
    if group is not None and group not in RICCATI_WIDE_GROUPS:
        raise ValueError(f"riccati_lq_wide groups are {RICCATI_WIDE_GROUPS} warps, "
                         f"got {group}")
    return riccati_lq_wide_op(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, float(reg),
                              int(group or 0))


riccati_lq_wide_cuda.launches = riccati_lq_wide_cuda.free_x0_launches = 0


def riccati_lq_wide_host(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                         reg: float = 1e-8, group=None):
    """The wide kernel's own group schedule (csrc/riccati_lq_wide.cuh),
    compiled with the host C++ compiler, on CPU tensors: the threads of the
    group in a loop in each phase, the 32 lanes of warp 0 in the gain. Same
    arguments and returns as ``riccati_lq_wide_cuda``."""
    args = (A, B, Q, S, R, q, r, c, P_term, p_term, dx0)
    Bt, N, nx, nu = _check_lq(args, host=True, check_size=_check_wide_size)
    fn, sw = _lq_wide_entry(nx, nu, A.dtype, True, group)
    bufs = _lq_wide_buffers(args, Bt, N, nx, nu, sw)
    if fn(*_ptrs(args), *_ptrs(bufs), Bt, N, float(reg), int(dx0 is None)) != 0:
        raise RuntimeError("riccati_lq_wide_host refused its arguments")
    return bufs[:6]


def fgm_constants(H):
    """(1/L, β) of the fast gradient method from the spectrum of sym(H), in
    float64 on the host: μ floored at 1e-9, κ = √(L/μ), β = (κ−1)/(κ+1)
    (hilo_mpc_tpu/ops/pallas_kernels.py:47-52). H is a numpy array or a
    tensor; a CUDA tensor is copied to the host, which waits for the card."""
    Hn = (H.detach().to("cpu", torch.float64).numpy() if torch.is_tensor(H)
          else np.asarray(H, dtype=float))
    eigs = np.linalg.eigvalsh(0.5 * (Hn + Hn.T))
    L = float(eigs[-1])
    mu = float(max(eigs[0], 1e-9))
    kappa = np.sqrt(L / mu)
    return 1.0 / L, float((kappa - 1.0) / (kappa + 1.0))


def _fgm_bounds(lb, ub):
    """Bounds with every non-finite entry replaced by ∓FGM_INF (the plain
    version's; every FGM kernel does the same as it loads the bounds)."""
    return (torch.where(torch.isfinite(lb), lb, torch.full_like(lb, -FGM_INF)),
            torch.where(torch.isfinite(ub), ub, torch.full_like(ub, FGM_INF)))


def fgm_boxqp_reference(H, G, x0_batch, lb, ub, iters: int, u0_batch=None,
                        constants=None):
    """Plain PyTorch version of ``fgm_boxqp_cuda``, the port of
    ``hilo_mpc_tpu/ops/pallas_kernels.py:fgm_boxqp_batch_xla``: a loop of
    ``y @ H.T + g`` and ``clamp`` in float32 on the device of ``x0_batch``,
    with full float32 products (TF32 off for the loop, the caller's setting
    restored after it). Same arguments and return."""
    inv_L, beta = fgm_constants(H) if constants is None else constants
    kw = dict(dtype=torch.float32, device=x0_batch.device)
    H, G = H.to(**kw), G.to(**kw)
    lb, ub = _fgm_bounds(lb.to(**kw), ub.to(**kw))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = x0_batch.to(**kw) @ G.T
        u = torch.zeros_like(g) if u0_batch is None else u0_batch.to(**kw)
        y = u
        for _ in range(iters):
            u_new = torch.clamp(y - inv_L * (y @ H.T + g), lb, ub)
            y = u_new + beta * (u_new - u)
            u = u_new
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return u


def round_tf32(x):
    """float32 rounded to TF32 (10 explicit mantissa bits) as PTX's
    ``cvt.rna.tf32.f32`` does: to nearest, ties away from zero, on the bits
    (subnormals included; a magnitude that rounds past the largest finite
    value becomes ±inf); ±inf and NaN pass through unchanged. Returns a
    float32 tensor whose low 13 mantissa bits are 0."""
    x = torch.as_tensor(x, dtype=torch.float32)
    bits = x.view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) | (bits & -0x80000000)
    return torch.where(torch.isfinite(x), rounded, bits).view(torch.float32)


def fgm_boxqp_tf32x3(H, G, x0_batch, lb, ub, iters: int, u0_batch=None,
                     constants=None):
    """The arithmetic of the tensor-core design (csrc/fgm_boxqp_tc.cuh) in
    plain PyTorch, for tests and ``chip_smoke.py`` (no path of the package
    calls it): H and, every iteration, y split as a = hi + lo with
    hi = rna_tf32(a), lo = rna_tf32(a − hi); H y + g as g + y_lo·H_hiᵀ +
    y_hi·H_loᵀ + y_hi·H_hiᵀ, three float32 products (lo·lo dropped); the
    float32 update. Not bit-equal to the card, whose tensor cores sum each
    k-block of 8 in their own order. Same arguments and return as
    ``fgm_boxqp_reference``."""
    inv_L, beta = fgm_constants(H) if constants is None else constants
    kw = dict(dtype=torch.float32, device=x0_batch.device)
    H, G = H.to(**kw), G.to(**kw)
    lb, ub = _fgm_bounds(lb.to(**kw), ub.to(**kw))
    h_hi = round_tf32(H)
    h_lo = round_tf32(H - h_hi)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = x0_batch.to(**kw) @ G.T
        u = torch.zeros_like(g) if u0_batch is None else u0_batch.to(**kw)
        y = u
        for _ in range(iters):
            y_hi = round_tf32(y)
            y_lo = round_tf32(y - y_hi)
            acc = g + y_lo @ h_hi.T + y_hi @ h_lo.T + y_hi @ h_hi.T
            u_new = torch.clamp(y - inv_L * acc, lb, ub)
            y = u_new + beta * (u_new - u)
            u = u_new
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return u


def _fgm_fn():
    lib = _build.load("fgm_boxqp")
    fn = lib.fgm_boxqp_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_fgm(H, G, x0_batch, lb, ub, iters, u0_batch, device, check_size):
    """Shapes, dtype, device and contiguity of the FGM inputs; returns
    (B, n, nx)."""
    if H.dim() != 2 or G.dim() != 2 or x0_batch.dim() != 2:
        raise ValueError(f"H, G and x0_batch must be 2-D, got {tuple(H.shape)}, "
                         f"{tuple(G.shape)} and {tuple(x0_batch.shape)}")
    n, nx, Bt = H.shape[0], G.shape[1], x0_batch.shape[0]
    check_size(n)
    if nx < 1 or not 1 <= Bt < 2 ** 31 or int(iters) < 0:
        raise ValueError(f"need nx >= 1, 1 <= B < 2**31 and iters >= 0, got "
                         f"nx={nx}, B={Bt}, iters={iters}")
    args = [H, G, x0_batch, lb, ub] + ([] if u0_batch is None else [u0_batch])
    expected = {"H": (n, n), "G": (n, nx), "x0_batch": (Bt, nx), "lb": (n,),
                "ub": (n,), "u0_batch": (Bt, n)}
    for (name, shape), t in zip(expected.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; all inputs must "
                             f"be torch.float32 on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return Bt, n, nx


def fgm_boxqp_cuda(H, G, x0_batch, lb, ub, iters: int, u0_batch=None,
                   constants=None):
    """B box-QPs  min ½uᵀHu + (G x0_b)ᵀu,  lb <= u <= ub,  with H and G shared,
    by ``iters`` projected fast-gradient steps from u0 (or zero), as ONE CUDA
    kernel, replacing ``hilo_mpc_tpu/ops/pallas_kernels.py:fgm_boxqp_batch``:
    for n <= ``FGM_REG_MAX_N`` the register design (csrc/fgm_boxqp_reg.cuh,
    built per n at first use), up to 128 the tensor-core design
    (csrc/fgm_boxqp_tc.cuh, built per padded n), above it the cluster
    kernel of csrc/fgm_boxqp.cu (``fgm_boxqp_design``).

    Shapes: H (n, n), G (n, nx), x0_batch (B, nx), lb and ub (n,) (infinite
    entries allowed: the kernel takes them as ∓``FGM_INF``), u0_batch (B, n)
    or None; float32, contiguous, one CUDA device; 1 <= n <= ``FGM_MAX_N``.
    Returns u (B, n) float32. ``constants`` is (1/L, β) as ``fgm_constants``
    gives them; when it is None they are taken from H here, and that copy
    of H to the host waits for the card (``LMPC.optimize_batch_fgm`` passes
    them from its float64 H).
    """
    args = [H, G, x0_batch, lb, ub] + ([] if u0_batch is None else [u0_batch])
    if not any(t.is_cuda for t in args):
        return fgm_boxqp_reference(H, G, x0_batch, lb, ub, iters, u0_batch,
                                   constants)
    _check_fgm(H, G, x0_batch, lb, ub, iters, u0_batch, x0_batch.device,
               fgm_boxqp_design)
    if constants is None:
        constants = fgm_constants(H)
    out = fgm_boxqp_launch(H, G, x0_batch, lb, ub, iters, u0_batch, *constants)
    fgm_boxqp_cuda.launches += 1
    return out


def fgm_boxqp_cluster_rows(n: int, cluster: int) -> int:
    """Rows of H one block of a cluster keeps: ceil(n / cluster) rounded up
    to the 4 rows of a thread (csrc/fgm_boxqp.cu:launch_cluster)."""
    return -(-(-(-n // cluster)) // 4) * 4


def fgm_boxqp_cluster_smem_bytes(n: int, cluster: int, tile: int) -> int:
    """Dynamic shared memory of one block of the cluster design: its rows of
    H and the tile's y, double-buffered."""
    return 4 * (n * fgm_boxqp_cluster_rows(n, cluster) + 2 * n * tile)


def fgm_boxqp_design(n: int) -> tuple:
    """The design that takes a QP of n variables, as (name, blocks per
    tile, scenarios per tile): ("registers", 1, ``FGM_REG_TPB``) for
    n <= ``FGM_REG_MAX_N`` (csrc/fgm_boxqp_reg.cuh: a scenario per thread,
    its iterate in registers); ("tensor", 1, scenarios per block) up to
    ``FGM_NARROW_MAX_N`` (csrc/fgm_boxqp_tc.cuh: 3xTF32 on the tensor
    cores, H in one block's shared memory, ``fgm_boxqp_tc_layout``); else
    ("cluster", C, TB): H split by rows over a cluster of C blocks, the
    first of ``FGM_CLUSTER_DESIGNS`` whose block fits ``RICCATI_SMEM_MAX``
    (227 KB): (4, 32) up to n = 368, (8, 32) up to 468, (8, 16) above. Each
    puts at least 128 blocks on the card at B = 1024. Raises ValueError
    outside 1 <= n <= ``FGM_MAX_N``."""
    if not 1 <= n <= FGM_MAX_N:
        raise ValueError(f"fgm_boxqp_cuda takes 1 <= n <= FGM_MAX_N = {FGM_MAX_N} "
                         f"QP variables, got n={n}")
    if n <= FGM_REG_MAX_N:
        return "registers", 1, FGM_REG_TPB
    if n <= FGM_NARROW_MAX_N:
        return "tensor", 1, fgm_boxqp_tc_layout(fgm_boxqp_tc_pad(n))[1]
    for cluster, tile in FGM_CLUSTER_DESIGNS:
        if fgm_boxqp_cluster_smem_bytes(n, cluster, tile) <= RICCATI_SMEM_MAX:
            return "cluster", cluster, tile
    raise AssertionError(f"no cluster design fits n={n}")


def fgm_boxqp_tc_pad(n: int) -> int:
    """n padded to the tensor-core design's k-blocks of ``FGM_TC_STEP``: the
    NPAD of the build that takes n."""
    if not 1 <= n <= FGM_NARROW_MAX_N:
        raise ValueError(f"the FGM tensor-core design takes 1 <= n <= "
                         f"FGM_NARROW_MAX_N = {FGM_NARROW_MAX_N}, got n={n}")
    return -(-n // FGM_TC_STEP) * FGM_TC_STEP


def fgm_boxqp_tc_layout(n_pad: int) -> tuple:
    """(warps per block, scenarios per block, dynamic shared memory per
    block) of the tensor-core build for ``n_pad``, as csrc/fgm_boxqp_tc.cuh
    computes them: H as hi and lo (8·n_pad² bytes), lb and ub, and per warp
    its 16 scenarios' u and g (128·n_pad bytes); as many whole warpgroups
    (4 warps) as ``RICCATI_SMEM_MAX`` holds, at most ``FGM_TC_MAX_WARPS``
    warps."""
    fixed = 8 * n_pad * n_pad + 8 * n_pad
    warps = min(FGM_TC_MAX_WARPS, (RICCATI_SMEM_MAX - fixed) // (128 * n_pad)) // 4 * 4
    return warps, 16 * warps, fixed + warps * 128 * n_pad


def _wgmma_text(n_pad: int) -> str:
    """The device function fgm_tc_wgmma(d, a, desc) the header calls: one
    wgmma.mma_async m64n<n_pad>k8 TF32 with A from registers, D += A·B, its
    n_pad/2 accumulators per thread written out as asm operands."""
    nd = n_pad // 2
    outs = ", ".join(f'"+f"(d[{i // 4}][{i % 4}])' for i in range(nd))
    regs = ", ".join(f"%{i}" for i in range(nd))
    a = ", ".join(f"%{nd + i}" for i in range(4))
    return ("#include <stdint.h>\n"
            f"__device__ __forceinline__ void fgm_tc_wgmma(float (&d)[{n_pad // 8}][4], "
            "const uint32_t (&a)[4], uint64_t desc) {\n"
            '  asm volatile("{\\n.reg .pred p;\\n'
            f'setp.ne.b32 p, %{nd + 5}, 0;\\n'
            f"wgmma.mma_async.sync.aligned.m64n{n_pad}k8.f32.tf32.tf32 "
            f'{{{regs}}}, {{{a}}}, %{nd + 4}, p, 1, 1;\\n}}\\n"\n'
            f"      : {outs}\n"
            '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));\n'
            "}\n")


def fgm_boxqp_tc_source(n_pad: int) -> str:
    """Source of the tensor-core design (csrc/fgm_boxqp_tc.cuh) for n padded
    to ``n_pad``, with the wgmma call it needs; built at first use, one
    library per n_pad."""
    if n_pad % FGM_TC_STEP or not FGM_TC_STEP <= n_pad <= FGM_NARROW_MAX_N:
        raise ValueError(f"n_pad must be a multiple of {FGM_TC_STEP} in "
                         f"{FGM_TC_STEP}..{FGM_NARROW_MAX_N}, got {n_pad}")
    return (f"#define FGM_TC_NPAD {int(n_pad)}\n" + _wgmma_text(int(n_pad))
            + '#include "fgm_boxqp_tc.cuh"\n')


@_build.per_build_dir
def _fgm_tc_entry(n_pad: int):
    """``fgm_tc_f32`` of the tensor-core build for ``n_pad``, bound with
    ctypes and built at first use."""
    fn = _build.load_source(fgm_boxqp_tc_source(n_pad)).fgm_tc_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fgm_boxqp_tc_built_layout(lib) -> tuple:
    """(warps per block, scenarios per block, shared memory per block,
    resident blocks per SM) of a built tensor-core library, as its
    ``fgm_tc_layout_f32`` reports them."""
    out = (ctypes.c_int * 4)()
    lib.fgm_tc_layout_f32(out)
    return tuple(out)


def _check_reg_size(n: int):
    if not 1 <= n <= FGM_REG_BUILD_MAX_N:
        raise ValueError(f"the FGM register design builds for 1 <= n <= "
                         f"FGM_REG_BUILD_MAX_N = {FGM_REG_BUILD_MAX_N}, got n={n}")


def fgm_boxqp_source(n: int) -> str:
    """Source of the register design (csrc/fgm_boxqp_reg.cuh) for QPs of n
    variables; built at first use, one library per n."""
    _check_reg_size(n)
    return f'#define FGM_REG_N {int(n)}\n#include "fgm_boxqp_reg.cuh"\n'


@_build.per_build_dir
def _fgm_reg_entry(n: int, host: bool):
    """The entry point of the register design for n, bound with ctypes and
    built at first use: ``fgm_reg_f32`` on the card (last argument the
    stream), ``fgm_reg_host_f32`` on the host."""
    text = fgm_boxqp_source(n)
    if host:
        fn = _build.load_host(text).fgm_reg_host_f32
    else:
        fn = _build.load_source(text).fgm_reg_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_double, ctypes.c_double]
                   + ([] if host else [ctypes.c_void_p]))
    fn.restype = ctypes.c_int
    return fn


def fgm_boxqp_reg_layout(lib) -> tuple:
    """(threads per block, scenarios per block, resident blocks per SM (0
    on the host), FGM_REG_MAX_N) of a built register-design library, as its
    ``fgm_reg_layout_f32`` reports them."""
    out = (ctypes.c_int * 4)()
    lib.fgm_reg_layout_f32(out)
    return tuple(out)


def fgm_boxqp_host(H, G, x0_batch, lb, ub, iters: int, u0_batch=None,
                   constants=None):
    """The register design's own per-scenario code (csrc/fgm_boxqp_reg.cuh),
    compiled with the host C++ compiler, on CPU tensors: a loop over
    scenarios. Same arguments and return as ``fgm_boxqp_cuda``, for
    1 <= n <= ``FGM_REG_BUILD_MAX_N``."""
    _check_fgm(H, G, x0_batch, lb, ub, iters, u0_batch, torch.device("cpu"),
               _check_reg_size)
    Bt, n, nx = x0_batch.shape[0], H.shape[0], G.shape[1]
    inv_L, beta = fgm_constants(H) if constants is None else constants
    out = torch.empty((Bt, n), dtype=torch.float32)
    rc = _fgm_reg_entry(n, True)(
        H.data_ptr(), G.data_ptr(), x0_batch.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        None if u0_batch is None else u0_batch.data_ptr(), out.data_ptr(),
        Bt, nx, int(iters), float(inv_L), float(beta))
    if rc != 0:
        raise RuntimeError("fgm_boxqp_host refused its arguments")
    return out


def fgm_boxqp_launch(H, G, x0_batch, lb, ub, iters, u0_batch, inv_L, beta,
                     design=None):
    """The bare launch behind ``fgm_boxqp_cuda``, in the design
    ``fgm_boxqp_design`` picks (``design`` = "registers" or "tensor"
    overrides it for n <= 128): inputs already checked, constants given.
    Not counted; ``chip_smoke.py`` times the kernels alone through it."""
    Bt, n, nx = x0_batch.shape[0], H.shape[0], G.shape[1]
    name, cluster, tile = fgm_boxqp_design(n)
    if design is not None:
        if n > FGM_NARROW_MAX_N or design not in ("registers", "tensor"):
            raise ValueError(f"design {design!r} does not take n={n}")
        name = design
    out = torch.empty((Bt, n), dtype=torch.float32, device=x0_batch.device)
    ptrs = (H.data_ptr(), G.data_ptr(), x0_batch.data_ptr(), lb.data_ptr(),
            ub.data_ptr(), None if u0_batch is None else u0_batch.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(x0_batch.device):
        stream = torch.cuda.current_stream(x0_batch.device).cuda_stream
        if name == "registers":
            rc = _fgm_reg_entry(n, False)(*ptrs, Bt, nx, int(iters), inv_L, beta,
                                          stream)
        elif name == "tensor":
            rc = _fgm_tc_entry(fgm_boxqp_tc_pad(n))(*ptrs, Bt, n, nx, int(iters),
                                                    inv_L, beta, stream)
        else:
            rc = _fgm_fn()(*ptrs, Bt, n, nx, int(iters), inv_L, beta, cluster, tile,
                           stream)
    if rc != 0:
        raise RuntimeError(f"fgm_boxqp {name} kernel launch failed: cudaError {rc}")
    return out


fgm_boxqp_cuda.launches = 0
