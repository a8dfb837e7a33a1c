"""PyTorch port: the FGM tensor-core design (csrc/fgm_boxqp_tc.cuh), which
takes the QPs of FGM_REG_MAX_N < n <= 128 on the card: 3xTF32 products by
``wgmma.mma_async`` (A, the iterate, from registers), H split into hi and lo
in shared memory. A CUDA kernel cannot run here, so these tests cover its
arithmetic and its layout maps on the CPU:

- ``round_tf32`` (PTX's ``cvt.rna.tf32.f32``) on hand-built bit patterns
  (ties away from zero, negatives, ±inf and NaN, subnormals, overflow) and
  against a float64 rounding to 11 significant bits;
- the emulation ``fgm_boxqp_tf32x3`` (the split, three float32 products, the
  float32 update) against the plain version at n in {25, 32, 64, 128}, with
  and without u0 and infinite bounds (2e-5: it read up to 8.5e-06), with an
  ill-conditioned H (κ = 1e4; 5e-5: it read 2.0e-05–3.2e-05, against the
  plain version's own 6.5e-06–9.2e-06 from float64), and against the JAX
  Pallas kernel in interpret mode (1e-5). The split carries each operand to
  2^-22 relative (hi and lo of 11 bits each, lo·lo dropped), 4x float32's
  unit roundoff, so the emulation strays 3-5x as far from float64 as the
  plain version does;
- the kernel's fragment maps, written out from the PTX ISA's layouts of the
  TF32 register fragments and of wgmma's K-major shared-memory tiles: the k
  permutation is a bijection that makes each accumulator the next A
  fragment, and a warpgroup simulated register by register (the kernel's
  packing of H, its descriptor's strides, its A fragments, its element map)
  computes y Hᵀ exactly and, with the split, the emulation's iterates;
- the sizes: n padded to 8, each build's warps and shared memory (mirrored
  from the header), the source text, and the design chooser's name;
- ``cuda`` tests: the kernel against the plain version at n in {25, 32, 40,
  64, 100, 128} on a ragged batch with u0 and infinite bounds, to 1e-4, its
  launch count, and csrc/fgm_boxqp.cu refusing n <= 128.
"""
import os
import re

import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ops.pallas_kernels import fgm_boxqp_batch
from hilo_mpc_tpu_torch.ops import _build
from hilo_mpc_tpu_torch.ops import cuda_kernels as ck
from hilo_mpc_tpu_torch.ops.cuda_kernels import (
    FGM_NARROW_MAX_N, FGM_REG_MAX_N, FGM_TC_MAX_WARPS, FGM_TC_STEP, RICCATI_SMEM_MAX,
    fgm_boxqp_cuda, fgm_boxqp_design, fgm_boxqp_reference, fgm_boxqp_tc_layout,
    fgm_boxqp_tc_pad, fgm_boxqp_tc_source, fgm_boxqp_tf32x3, fgm_constants, round_tf32)

from test_torch_lmpc import _t, make_qp, report

torch.set_num_threads(1)
NS = (25, 32, 64, 128)


def _bits(x):
    return int(torch.tensor([x], dtype=torch.float32).view(torch.int32)[0]) & 0xFFFFFFFF


def _from_bits(b):
    return torch.tensor([b - (1 << 32) if b >= 1 << 31 else b],
                        dtype=torch.int32).view(torch.float32)


# (input bits, expected bits): the low 13 mantissa bits decide
ROUNDING = {
    "exact": (0x3F800000, 0x3F800000),
    "below_half": (0x3F800FFF, 0x3F800000),
    "tie_away": (0x3F801000, 0x3F802000),
    "tie_away_odd": (0x3F803000, 0x3F804000),
    "above_half": (0x3F801001, 0x3F802000),
    "negative_tie": (0xBF801000, 0xBF802000),
    "negative_below": (0xBF800FFF, 0xBF800000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "overflow_to_inf": (0x7F7FFFFF, 0x7F800000),
    "negative_overflow": (0xFF7FF000, 0xFF800000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_below": (0x00000FFF, 0x00000000),
    "subnormal_to_normal": (0x007FF000, 0x00800000),
    "negative_zero": (0x80000000, 0x80000000),
    "inf": (0x7F800000, 0x7F800000),
    "negative_inf": (0xFF800000, 0xFF800000),
}


@pytest.mark.parametrize("case", sorted(ROUNDING))
def test_round_tf32_bit_patterns(case):
    given, expected = ROUNDING[case]
    assert _bits(float(round_tf32(_from_bits(given))[0])) == expected


def test_round_tf32_passes_nan_through():
    for b in (0x7FC00000, 0x7F800001, 0xFFC01234):
        out = round_tf32(_from_bits(b))
        assert torch.isnan(out).all()
        assert int(out.view(torch.int32)[0]) & 0xFFFFFFFF == b


def test_round_tf32_matches_rounding_to_11_bits():
    """Random float32 over many binades, normal and subnormal, against
    round-half-away-from-zero to 11 significant bits in float64."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 2.0 ** rng.integers(-149, 120, 20000)).astype(np.float32)
    x = x[np.isfinite(x)]
    a = np.abs(x.astype(np.float64))
    step = np.where(a >= 2.0 ** -126, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-300))) - 10),
                    2.0 ** -136)
    ref = np.sign(x) * np.floor(a / step + 0.5) * step
    np.testing.assert_array_equal(round_tf32(torch.from_numpy(x)).numpy().astype(np.float64),
                                  ref)


# -- the emulation against the plain version and the JAX kernel -------------

def _problem(n, Bt, u0, inf, seed=0, kappa=None):
    H, G, lb, ub = make_qp(n=n, seed=seed)
    if kappa is not None:
        Q, _ = np.linalg.qr(np.random.default_rng(seed + 2).normal(size=(n, n)))
        H = (Q * np.geomspace(1.0, kappa, n)) @ Q.T
        H = 0.5 * (H + H.T)
    if inf:
        lb[::2], ub[1::3] = -np.inf, np.inf
    rng = np.random.default_rng(seed + 1)
    x0 = rng.normal(size=(Bt, 2))
    U0 = _t(0.1 * rng.normal(size=(Bt, n))) if u0 else None
    return [_t(a) for a in (H, G, x0, lb, ub)], U0


@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("u0", [False, True])
@pytest.mark.parametrize("n", NS)
def test_emulation_matches_plain(n, u0, inf):
    args, U0 = _problem(n, 64, u0, inf)
    out = fgm_boxqp_tf32x3(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    assert out.dtype == torch.float32 and out.shape == (64, n)
    report(f"fgm_boxqp_tf32x3 vs plain n={n}", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", NS)
def test_emulation_matches_plain_ill_conditioned(n):
    """κ(H) = 1e4, so β = 0.98 and 200 iterations carry every rounding far."""
    args, U0 = _problem(n, 64, True, True, kappa=1e4)
    out = fgm_boxqp_tf32x3(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    report(f"fgm_boxqp_tf32x3 vs plain n={n} kappa=1e4", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("n", [25, 64, 128])
def test_emulation_matches_pallas_interpret(n):
    H, G, lb, ub = make_qp(n=n, seed=7)
    H = H / n                                  # keep the spectrum moderate
    lb[::3] = -np.inf
    x0 = np.random.default_rng(8).normal(size=(9, 2))
    ref = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=200, tile_b=8))
    out = fgm_boxqp_tf32x3(_t(H), _t(G), _t(x0), _t(lb), _t(ub), 200)
    report(f"fgm_boxqp_tf32x3 vs Pallas interpret n={n} (float32)", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_emulation_zero_iterations_return_u0():
    args, U0 = _problem(25, 8, True, False)
    assert torch.equal(fgm_boxqp_tf32x3(*args, 0, U0), U0)


# -- the fragment maps ---------------------------------------------------------
# The PTX ISA's TF32 register fragments of a warp: A (16 × 8) a0..a3 at
# (row, col) = (gr, q), (gr + 8, q), (gr, q + 4), (gr + 8, q + 4), with
# groupID gr = lane / 4 and q = lane % 4; an m16n8 accumulator c0..c3 at
# (gr, 2q), (gr, 2q + 1), (gr + 8, 2q), (gr + 8, 2q + 1). mma.sync.m16n8k8
# and wgmma.m64nNk8 (A from registers) share them: in wgmma warp w of the
# warpgroup holds rows 16w..16w + 15 and one accumulator per 8 columns
# (CuTe's ALayout_64x8 and CLayout_64xN).

LANE = np.arange(32)
GR, Q = LANE // 4, LANE % 4


def a_map(r):
    return GR + 8 * (r & 1), Q + 4 * (r >> 1)


def c_map(r):
    return GR + 8 * (r >> 1), 2 * Q + (r & 1)


# the kernel's k permutation (k-position p of a block holds variable σ(p))
# and the order in which it reads an accumulator as an A fragment
SIGMA = np.array([0, 2, 4, 6, 1, 3, 5, 7])
A_FROM_C = (0, 2, 1, 3)


def test_k_permutation_makes_the_accumulator_the_next_a_fragment():
    """σ is a bijection of 0..7; A-fragment slot r of k-block t, filled
    from accumulator slot A_FROM_C[r] of row tile t, holds the element the
    A map names (its scenario, and variable σ(k-position)); and the 32
    lanes' slots cover the 16 × 8 tile once."""
    assert sorted(SIGMA) == list(range(8))
    seen = set()
    for r in range(4):
        row_a, kpos = a_map(r)
        row_c, col_c = c_map(A_FROM_C[r])
        np.testing.assert_array_equal(row_a, row_c)
        np.testing.assert_array_equal(SIGMA[kpos], col_c)
        seen |= set(zip(row_a.tolist(), kpos.tolist()))
    assert len(seen) == 16 * 8


def pack_h(H, n_pad):
    """H as the kernel's loader stores it: per k-block tk the B tiles 2tk
    (hi) and 2tk + 1 (lo) of n_pad rows × 8 k-positions; element (i, j) at
    float (i % 8)·4 + (i / 8)·64 + (p / 4)·32 + p % 4 of its tile, p =
    σ⁻¹(j % 8); zero past n."""
    n, nt = H.shape[0], n_pad // 8
    Hp = np.zeros((n_pad, n_pad), np.float32)
    Hp[:n, :n] = H
    hi = round_tf32(torch.from_numpy(Hp)).numpy()
    lo = round_tf32(torch.from_numpy(Hp - hi)).numpy()
    tiles = np.zeros((2 * nt, n_pad * 8), np.float32)
    inv = np.argsort(SIGMA)
    for i in range(n_pad):
        for j in range(n_pad):
            p = inv[j % 8]
            off = (i % 8) * 4 + (i // 8) * 64 + (p // 4) * 32 + p % 4
            tiles[2 * (j // 8), off] = hi[i, j]
            tiles[2 * (j // 8) + 1, off] = lo[i, j]
    return tiles


def b_tile(tile, n_pad):
    """The 8 × n_pad B operand wgmma reads from a tile under the kernel's
    descriptor (K-major, no swizzle: core matrices of 8 rows × 16 bytes,
    LBO 128 bytes between the k-halves, SBO 256 bytes between row
    groups): B[p][i] at float (i % 8)·4 + (i / 8)·(256 / 4) + (p / 4)·(128
    / 4) + p % 4."""
    p = np.arange(8)[:, None]
    i = np.arange(n_pad)[None, :]
    return tile[(i % 8) * 4 + (i // 8) * 64 + (p // 4) * 32 + p % 4]


def wgmma(d, a, B):
    """One wgmma.m64nNk8 as the PTX ISA defines it, on per-lane registers:
    d (4 warps, N/8, 32, 4) += A (64 × 8) · B (8 × N), A from a (4 warps,
    32, 4)."""
    A = np.zeros((64, 8))
    C = np.zeros((64, B.shape[1]))
    for w in range(4):
        for r in range(4):
            row, col = a_map(r)
            A[16 * w + row, col] = a[w, :, r]
            for t in range(d.shape[1]):
                row, col = c_map(r)
                C[16 * w + row, 8 * t + col] = d[w, t, :, r]
    D = C + A @ B
    out = np.empty_like(d)
    for w in range(4):
        for t in range(d.shape[1]):
            for r in range(4):
                row, col = c_map(r)
                out[w, t, :, r] = D[16 * w + row, 8 * t + col]
    return out


def warpgroup_solve(H, G, x0, lb, ub, iters, inv_L, beta, split=True):
    """One warpgroup of the kernel (4 warps, 64 scenarios), register by
    register: y and the accumulator as (4 warps, row tiles, 32 lanes, 4) in
    the accumulator layout, element c of tile t of lane (gr, q) of warp w
    being scenario 16w + gr + 8(c / 2), variable 8t + 2q + c % 2; per k-block
    the A fragment read from the accumulator layout (A_FROM_C) and three
    products lo·hi, hi·lo, hi·hi on the packed B tiles (without ``split``
    one product of the unsplit values); the update in float32. Products in
    float64 (the card's tensor cores sum in their own order)."""
    n = H.shape[0]
    n_pad = fgm_boxqp_tc_pad(n)
    nt = n_pad // 8
    tiles = pack_h(H, n_pad)
    w = np.arange(4)[:, None, None, None]
    scen = 16 * w + GR[None, None, :, None] + 8 * (np.arange(4) >> 1)
    var = 8 * np.arange(nt)[None, :, None, None] + 2 * Q[None, None, :, None] + (np.arange(4) & 1)
    scen, var = np.broadcast_arrays(scen, var)
    live = var < n
    vi = np.minimum(var, n - 1)
    g = np.where(live, (x0 @ G.T)[scen, vi], 0).astype(np.float32)
    lo_b = np.where(live, lb[vi], 0).astype(np.float32)
    hi_b = np.where(live, ub[vi], 0).astype(np.float32)
    u = np.zeros(var.shape, np.float32)
    y = u.copy()

    def tf32(a):
        return round_tf32(torch.from_numpy(np.ascontiguousarray(a, np.float32))).numpy()

    for _ in range(iters):
        acc = g.astype(np.float64)
        for tk in range(nt):
            a = y[:, tk][..., list(A_FROM_C)]
            B_hi, B_lo = b_tile(tiles[2 * tk], n_pad), b_tile(tiles[2 * tk + 1], n_pad)
            if split:
                a_hi = tf32(a)
                a_lo = tf32(a - a_hi)
                acc = wgmma(acc, a_lo, B_hi)
                acc = wgmma(acc, a_hi, B_lo)
                acc = wgmma(acc, a_hi, B_hi)
            else:
                acc = wgmma(acc, a, B_hi.astype(np.float64) + B_lo)
        acc = acc.astype(np.float32)
        un = np.minimum(np.maximum(y - np.float32(inv_L) * acc, lo_b), hi_b)
        y = (un + np.float32(beta) * (un - u)).astype(np.float32)
        u = un.astype(np.float32)
    out = np.zeros((64, n), np.float32)
    out[scen[live], var[live]] = u[live]
    return out


def test_simulated_warpgroup_computes_y_h_transpose():
    """Two iterations of the simulated warpgroup, H exact in one TF32 pass
    and the product unsplit in float64: y Hᵀ + g as numpy computes it, at
    n = 27 (ragged padding) with H not symmetric."""
    rng = np.random.default_rng(3)
    n = 27
    H = round_tf32(torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))).numpy()
    G = rng.normal(size=(n, 2))
    x0 = rng.normal(size=(64, 2))
    lb, ub = -10 * np.ones(n), 10 * np.ones(n)
    out = warpgroup_solve(H, G, x0, lb, ub, 2, 0.1, 0.5, split=False)
    g = x0 @ G.T
    u1 = np.clip(-0.1 * g, lb, ub)
    y1 = u1 + 0.5 * u1
    u2 = np.clip(y1 - 0.1 * (y1 @ H.T + g), lb, ub)
    np.testing.assert_allclose(out, u2, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [25, 40])
def test_simulated_warpgroup_matches_the_emulation(n):
    """The warpgroup simulated register by register with the kernel's maps
    and 3xTF32 against fgm_boxqp_tf32x3, 30 iterations, bounds active."""
    args, _ = _problem(n, 64, False, True, seed=4)
    H, G, x0, lb, ub = (a.numpy() for a in args)
    inv_L, beta = fgm_constants(H)
    out = warpgroup_solve(H, G, x0, lb, ub, 30, inv_L, beta)
    emu = fgm_boxqp_tf32x3(*args, 30, constants=(inv_L, beta)).numpy()
    report(f"simulated warpgroup vs fgm_boxqp_tf32x3 n={n}", [out], [emu])
    np.testing.assert_allclose(out, emu, rtol=0, atol=2e-6)


# -- sizes, sources and the chooser --------------------------------------------

@pytest.mark.parametrize("n,n_pad", [(1, 8), (8, 8), (9, 16), (25, 32), (64, 64),
                                     (100, 104), (121, 128), (128, 128)])
def test_padding(n, n_pad):
    assert fgm_boxqp_tc_pad(n) == n_pad


@pytest.mark.parametrize("n", [0, FGM_NARROW_MAX_N + 1])
def test_padding_rejects_n_outside_the_design(n):
    with pytest.raises(ValueError, match="FGM_NARROW_MAX_N = 128"):
        fgm_boxqp_tc_pad(n)


def test_layout_for_every_build():
    """Every NPAD 8..128: H (8·NPAD² bytes), the bounds and each warp's u and
    g within RICCATI_SMEM_MAX, as many whole warpgroups as fit up to
    FGM_TC_MAX_WARPS warps (1 at NPAD = 120 and 128), 16 scenarios per
    warp."""
    for n_pad in range(FGM_TC_STEP, FGM_NARROW_MAX_N + 1, FGM_TC_STEP):
        warps, spb, smem = fgm_boxqp_tc_layout(n_pad)
        assert spb == 16 * warps and smem <= RICCATI_SMEM_MAX
        assert smem == 8 * n_pad * n_pad + 8 * n_pad + warps * 128 * n_pad
        assert warps % 4 == 0 and 4 <= warps <= FGM_TC_MAX_WARPS
        assert warps == FGM_TC_MAX_WARPS or smem + 4 * 128 * n_pad > RICCATI_SMEM_MAX
    assert fgm_boxqp_tc_layout(128) == (4, 64, 197632)
    assert fgm_boxqp_tc_layout(64) == (8, 128, 98816)


def test_layout_mirrored_from_the_header():
    with open(os.path.join(_build.CSRC_DIR, "fgm_boxqp_tc.cuh")) as fh:
        text = fh.read()

    def define(name):
        return re.search(rf"#define {name} (\S+)", text).group(1)
    assert int(define("FGM_TC_SMEM_MAX")) == RICCATI_SMEM_MAX
    assert int(define("FGM_TC_MAX_WARPS")) == FGM_TC_MAX_WARPS
    assert int(define("FGM_TC_MAX_NPAD")) == FGM_NARROW_MAX_N
    assert float(define("FGM_TC_INF").rstrip("f")) == ck.FGM_INF
    for line in ("H_BYTES = NPAD * NPAD * 8;", "BOUND_BYTES = NPAD * 8;",
                 "WARP_BYTES = NPAD * 128;", "MAX_WARPS / 4 * 4",
                 # the A fragment from the accumulator (A_FROM_C), σ⁻¹ and
                 # the tile offsets of pack_h and b_tile, the descriptor's
                 # LBO and SBO
                 "{y[tk][0], y[tk][2], y[tk][1], y[tk][3]}",
                 "kpos = (jj >> 1) + 4 * (jj & 1)",
                 "(i & 7) * 4 + (i >> 3) * 64 + (kpos >> 2) * 32 + (kpos & 3)",
                 "(static_cast<uint64_t>(128 >> 4) << 16)",
                 "(static_cast<uint64_t>(256 >> 4) << 32)"):
        assert line in text


@pytest.mark.parametrize("n_pad", [8, 64, 128])
def test_source_writes_npad_and_the_wgmma_call(n_pad):
    text = fgm_boxqp_tc_source(n_pad)
    assert f"#define FGM_TC_NPAD {n_pad}\n" in text
    assert f"wgmma.mma_async.sync.aligned.m64n{n_pad}k8.f32.tf32.tf32" in text
    assert f'"+f"(d[{n_pad // 8 - 1}][3])' in text and f"%{n_pad // 2 + 4}, p, 1, 1" in text
    assert text.endswith('#include "fgm_boxqp_tc.cuh"\n')


@pytest.mark.parametrize("n_pad", [0, 12, 136])
def test_source_rejects_other_widths(n_pad):
    with pytest.raises(ValueError, match="multiple of 8"):
        fgm_boxqp_tc_source(n_pad)


def test_design_names_the_tensor_cores_above_the_register_design():
    """FGM_REG_MAX_N < n <= 128 take ("tensor", 1, scenarios per block of
    the build for n padded to 8); the chooser's names change only at
    FGM_REG_MAX_N + 1 and 129."""
    names = []
    for n in range(1, 513):
        name, blocks, tile = fgm_boxqp_design(n)
        names.append(name)
        if FGM_REG_MAX_N < n <= FGM_NARROW_MAX_N:
            assert (name, blocks) == ("tensor", 1)
            assert tile == fgm_boxqp_tc_layout(fgm_boxqp_tc_pad(n))[1]
    changes = [n for n in range(2, 513) if names[n - 1] != names[n - 2]]
    assert changes == [FGM_REG_MAX_N + 1, FGM_NARROW_MAX_N + 1]
    assert names[FGM_REG_MAX_N] == "tensor" and names[FGM_NARROW_MAX_N] == "cluster"


def test_launch_takes_the_tensor_override_only_up_to_128():
    with pytest.raises(ValueError, match="does not take"):
        ck.fgm_boxqp_launch(*(_t(np.zeros(s)) for s in ((160, 160), (160, 2),
                                                        (4, 2), (160,), (160,))),
                            10, None, 1.0, 0.5, design="tensor")


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [25, 32, 40, 64, 100, 128])
def test_tensor_design_matches_plain_on_card(n):
    """A ragged batch (B = 1001: a last block of 105 scenarios at 128 per
    block), u0 and infinite bounds, 200 iterations, to 1e-4; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    assert fgm_boxqp_design(n)[0] == "tensor"
    args, U0 = _problem(n, 1001, True, True)
    dev = dict(dtype=torch.float32, device="cuda")
    args, U0 = [a.to(**dev) for a in args], U0.to(**dev)
    n0 = fgm_boxqp_cuda.launches
    out = fgm_boxqp_cuda(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    torch.cuda.synchronize()
    assert fgm_boxqp_cuda.launches == n0 + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cluster_entry_refuses_n_up_to_128_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    args, _ = _problem(64, 32, False, False)
    dev = dict(dtype=torch.float32, device="cuda")
    H, G, x0, lb, ub = [a.to(**dev) for a in args]
    out = torch.empty((32, 64), **dev)
    rc = ck._fgm_fn()(H.data_ptr(), G.data_ptr(), x0.data_ptr(), lb.data_ptr(),
                      ub.data_ptr(), None, out.data_ptr(), 32, 64, 2, 10, 0.1, 0.5, 4, 32,
                      torch.cuda.current_stream().cuda_stream)
    assert rc != 0
