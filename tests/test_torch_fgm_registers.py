"""PyTorch port: the FGM register design (csrc/fgm_boxqp_reg.cuh: one
scenario per thread, its iterate in registers), which takes the QPs of
n <= FGM_REG_MAX_N on the card.

- the host build of its per-scenario code (``fgm_boxqp_host``) against the
  plain version at n in {1, 3, FGM_REG_MAX_N, 20, 24} on ragged batches (B = 37
  and 1000), with and without u0, with and without infinite bounds, float32
  to 1e-5 (a sequential fmaf per element against the plain version's
  matrix product, which sums in another order);
- the host build at n = 20 against the JAX Pallas kernel in interpret mode
  (as tests/test_torch_lmpc.py runs it), float32 to 1e-5;
- ``fgm_boxqp_source`` and the host entry's checks; the design chooser for
  every n from 1 to 512, and the crossover mirrored from the header;
- ``cuda`` tests: the kernel against the plain version at every n the
  design takes on a ragged batch, the CUDA route with ``_fgm_bounds``
  made to raise (the kernels map infinite bounds themselves), and the
  launch counter.
Five host builds in all (n = 1, 3, FGM_REG_MAX_N, 20 and 24), about half
a second each.
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
    FGM_MAX_N, FGM_NARROW_MAX_N, FGM_REG_BUILD_MAX_N, FGM_REG_MAX_N, FGM_REG_TPB,
    fgm_boxqp_cuda,
    fgm_boxqp_design, fgm_boxqp_host, fgm_boxqp_reference, fgm_boxqp_reg_layout,
    fgm_boxqp_source)

from test_torch_lmpc import _t, make_qp, report

torch.set_num_threads(1)
HOST_NS = (1, 3, FGM_REG_MAX_N, 20, 24)


def _problem(n, Bt, u0, inf, seed=0):
    H, G, lb, ub = make_qp(n=n, seed=seed)
    if inf:
        lb[::2], ub[1::3] = -np.inf, np.inf
    rng = np.random.default_rng(seed + 1)
    x0 = rng.normal(size=(Bt, 2))
    U0 = _t(0.1 * rng.normal(size=(Bt, n))) if u0 else None
    return [_t(a) for a in (H, G, x0, lb, ub)], U0


@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("u0", [False, True])
@pytest.mark.parametrize("Bt", [37, 1000])
@pytest.mark.parametrize("n", HOST_NS)
def test_host_build_matches_plain(n, Bt, u0, inf):
    args, U0 = _problem(n, Bt, u0, inf)
    out = fgm_boxqp_host(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    assert out.dtype == torch.float32 and out.shape == (Bt, n)
    report(f"fgm_boxqp_host vs plain n={n} B={Bt}", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_host_build_matches_pallas_interpret():
    """n = 20 (the flagship's size; the JAX kernel pads it to 128 lanes)."""
    H, G, lb, ub = make_qp(n=20, seed=7)
    H = H / 20                                 # keep the spectrum moderate
    lb[::3] = -np.inf
    x0 = np.random.default_rng(8).normal(size=(9, 2))
    ref = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=60, tile_b=8))
    out = fgm_boxqp_host(_t(H), _t(G), _t(x0), _t(lb), _t(ub), 60)
    report("fgm_boxqp_host vs Pallas interpret n=20 (float32)", [out], [ref])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_host_build_takes_the_given_constants():
    args, _ = _problem(20, 37, False, True)
    consts = (0.01, 0.5)
    np.testing.assert_allclose(
        fgm_boxqp_host(*args, 50, constants=consts).numpy(),
        fgm_boxqp_reference(*args, 50, constants=consts).numpy(), rtol=0, atol=1e-5)


def test_zero_iterations_return_u0():
    args, U0 = _problem(3, 37, True, False)
    assert torch.equal(fgm_boxqp_host(*args, 0, U0), U0)
    assert not fgm_boxqp_host(*args, 0).any()


@pytest.mark.parametrize("n", [1, 20, FGM_REG_BUILD_MAX_N])
def test_source_writes_n(n):
    text = fgm_boxqp_source(n)
    assert f"#define FGM_REG_N {n}\n" in text
    assert '#include "fgm_boxqp_reg.cuh"' in text


@pytest.mark.parametrize("n", [0, -3, FGM_REG_BUILD_MAX_N + 1, FGM_NARROW_MAX_N,
                               FGM_MAX_N])
def test_source_rejects_n_outside_the_design(n):
    with pytest.raises(ValueError, match="FGM_REG_BUILD_MAX_N = 64"):
        fgm_boxqp_source(n)


def test_crossover_mirrored_from_the_header():
    """FGM_REG_MAX_N and the block size in csrc/fgm_boxqp_reg.cuh, as the
    header defines them and as a host build reports them."""
    with open(os.path.join(_build.CSRC_DIR, "fgm_boxqp_reg.cuh")) as fh:
        text = fh.read()
    assert int(re.search(r"#define FGM_REG_MAX_N (\d+)", text).group(1)) == FGM_REG_MAX_N
    assert (int(re.search(r"#define FGM_REG_BUILD_MAX_N (\d+)", text).group(1))
            == FGM_REG_BUILD_MAX_N)
    assert int(re.search(r"#define FGMR_TPB (\d+)", text).group(1)) == FGM_REG_TPB
    assert fgm_boxqp_reg_layout(_build.load_host(fgm_boxqp_source(20))) == (
        FGM_REG_TPB, FGM_REG_TPB, 0, FGM_REG_MAX_N)


BAD = {
    "H_not_square": lambda a: [a[0][:, :5]] + a[1:],
    "G_rows": lambda a: [a[0], a[1][:5]] + a[2:],
    "x0_width": lambda a: a[:2] + [torch.zeros(37, 3)] + a[3:],
    "lb_length": lambda a: a[:3] + [a[3][:5]] + a[4:],
    "float64": lambda a: [a[0].double()] + a[1:],
    "not_contiguous": lambda a: [a[0].t()] + a[1:],
    "empty_batch": lambda a: a[:2] + [torch.zeros(0, 2)] + a[3:],
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_host_entry_refuses_bad_arguments(case):
    args, _ = _problem(6, 37, False, False)
    args[0] = args[0] + torch.arange(36.0).reshape(6, 6) * 1e-3   # not symmetric
    with pytest.raises(ValueError):
        fgm_boxqp_host(*BAD[case](args), 10)


def test_host_entry_refuses_u0_iterations_and_sizes():
    args, U0 = _problem(6, 37, True, False)
    with pytest.raises(ValueError, match="u0_batch"):
        fgm_boxqp_host(*args, 10, U0[:, :5])
    with pytest.raises(ValueError, match="iters"):
        fgm_boxqp_host(*args, -1)
    big, _ = _problem(FGM_REG_BUILD_MAX_N + 1, 2, False, False)
    with pytest.raises(ValueError, match="FGM_REG_BUILD_MAX_N"):
        fgm_boxqp_host(*big, 10)


def test_design_for_every_n():
    """1..FGM_REG_MAX_N the register design (blocks of FGM_REG_TPB
    scenarios), up to 128 the tensor-core design, up to 512 a cluster; the
    chooser's names change only at those two sizes."""
    assert FGM_REG_MAX_N <= FGM_REG_BUILD_MAX_N < FGM_NARROW_MAX_N < FGM_MAX_N == 512
    names = []
    for n in range(1, FGM_MAX_N + 1):
        name, blocks, tile = fgm_boxqp_design(n)
        names.append(name)
        if n <= FGM_REG_MAX_N:
            assert (name, blocks, tile) == ("registers", 1, FGM_REG_TPB)
        elif n <= FGM_NARROW_MAX_N:
            assert (name, blocks, tile) == ("tensor", 1, ck.fgm_boxqp_tc_layout(
                ck.fgm_boxqp_tc_pad(n))[1])
        else:
            assert name == "cluster" and (blocks, tile) in ck.FGM_CLUSTER_DESIGNS
    changes = [n for n in range(2, FGM_MAX_N + 1) if names[n - 1] != names[n - 2]]
    assert changes == [FGM_REG_MAX_N + 1, FGM_NARROW_MAX_N + 1]


def test_launch_refuses_a_design_override_above_128():
    with pytest.raises(ValueError, match="does not take"):
        ck.fgm_boxqp_launch(*(_t(np.zeros(s)) for s in ((160, 160), (160, 2),
                                                        (4, 2), (160,), (160,))),
                            10, None, 1.0, 0.5, design="registers")


# -- on the card ----------------------------------------------------------------

def _on_card(args, U0):
    dev = dict(dtype=torch.float32, device="cuda")
    return ([a.to(**dev) for a in args], None if U0 is None else U0.to(**dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(1, FGM_REG_MAX_N + 1))
def test_register_design_matches_plain_on_card(n):
    """Every n the router sends to the register design, on a ragged batch
    (B = 1001: a last block of 41 scenarios), with u0 and infinite bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    assert fgm_boxqp_design(n)[0] == "registers"
    args, U0 = _on_card(*_problem(n, 1001, True, True))
    out = fgm_boxqp_cuda(*args, 200, U0)
    ref = fgm_boxqp_reference(*args, 200, U0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 64, 160])
def test_cuda_route_maps_infinite_bounds_in_the_kernel(n, monkeypatch):
    """The CUDA route launches no bound-replacement kernels: with
    ``_fgm_bounds`` made to raise it still answers, as the plain version
    (which keeps calling it) does, for each of the three designs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    args, _ = _on_card(*_problem(n, 1001, False, True))
    ref = fgm_boxqp_reference(*args, 200)

    def refuse(lb, ub):
        raise AssertionError("the CUDA route replaced the bounds on the host side")

    monkeypatch.setattr(ck, "_fgm_bounds", refuse)
    out = fgm_boxqp_cuda(*args, 200)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_register_design_counts_its_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    args, _ = _on_card(*_problem(20, 256, False, False))
    n0 = fgm_boxqp_cuda.launches
    fgm_boxqp_cuda(*args, 10)
    fgm_boxqp_cuda(*args, 10)
    assert fgm_boxqp_cuda.launches == n0 + 2
    ck.fgm_boxqp_launch(*args, 10, None, 0.01, 0.5)       # the bare launch: not counted
    torch.cuda.synchronize()
    assert fgm_boxqp_cuda.launches == n0 + 2
