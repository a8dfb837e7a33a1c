#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hilo_mpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  card name and power limit; build every CUDA kernel from csrc/.
Phase 1  each kernel against its plain PyTorch version on the card, at the
         shapes the main path gives it (float32 and float64), and both timed
         at the flagship shape.
Phase 2  the main path at full width: the flagship CSTR NMPC (N=20, RK4,
         box-bounded input, quadratic tracking cost) through
         NMPC.setup(device="cuda") -> prepare_batch -> solve_batch_fn, cold
         and warm-started, on B=131072 scenarios; kernel launch counts are
         read around exactly this run. The first 1024 scenarios are solved
         again with the plain LQ step in place of the kernel and compared.
Phase 3  the golden closed-loop fixture tests/golden/cstr_tracking.npz
         replayed through NMPC.optimize in float64 on the card.

Any failed phase raises and the script exits non-zero. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result. The second-to-last line is the kernels JSON object, the last line
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 131072
N = 20
GOLDEN = os.path.join(ROOT, "tests", "golden", "cstr_tracking.npz")


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps=10, warmup=3):
    """Median device time of fn() over `reps` timed calls (CUDA events)."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def lq_problem(Bt, n, nx, nu, dtype, seed=0):
    """Random stagewise LQ problem (the generator of tests/test_pallas_kernels.py)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((Bt, n, nx, nx))
    B = 0.3 * rng.standard_normal((Bt, n, nx, nu))
    Q = np.tile(np.eye(nx), (Bt, n, 1, 1))
    S = 0.1 * rng.standard_normal((Bt, n, nu, nx))
    R = np.tile(0.5 * np.eye(nu), (Bt, n, 1, 1))
    q = rng.standard_normal((Bt, n, nx))
    r = rng.standard_normal((Bt, n, nu))
    c = 0.1 * rng.standard_normal((Bt, n, nx))
    Pt = np.tile(np.eye(nx), (Bt, 1, 1))
    pt = rng.standard_normal((Bt, nx))
    dx0 = rng.standard_normal((Bt, nx))
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
                 for a in (A, B, Q, S, R, q, r, c, Pt, pt, dx0))


# the option set of __graft_entry__._build_nmpc (the flagship batched solve)
FLAGSHIP = {"tol": 1e-4, "max_iter": 25, "convexify": False, "n_linesearch": 1,
            "mu_init": 1e-2, "mehrotra": False}


def plain_lq_factory(reg):
    """Stand-in for ops/riccati.py:make_lq_solver whose LQ step is the plain
    PyTorch version of the kernel (patched into ops.ip_solver to compare)."""
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_reference
    from hilo_mpc_tpu_torch.ops.riccati import LQSolution

    def solve(*a, reg=None, _reg=reg):
        return LQSolution(*riccati_lq_reference(*a, reg=_reg))
    return solve


def build_cstr_nmpc(options, dtype):
    import torch  # noqa: F401
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options},
               device="cuda", dtype=dtype)
    return nmpc


def phase1(report):
    """Kernel vs plain version on the card."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                     riccati_lq_reference)
    names = ("dX", "dU", "lam", "K", "kff", "cost_red")
    max_err = 0.0
    cases = [(1000, nx, nu, dt) for dt in (torch.float32, torch.float64)
             for nx, nu in ((2, 1), (3, 2), (2, 3))]
    cases.append((B_MAIN, 2, 1, torch.float32))
    for Bt, nx, nu, dt in cases:
        args = lq_problem(Bt, N, nx, nu, dt)
        out = riccati_lq_cuda(*args, reg=1e-8)
        ref = riccati_lq_reference(*args, reg=1e-8)
        torch.cuda.synchronize()
        f32 = dt == torch.float32
        errs = {}
        for name, a, b in zip(names, out, ref):
            # f32: the tolerances of tests/test_pallas_kernels.py:94-101
            # (lam and the summed cost_red carry more roundoff); f64: 1e-10
            if f32:
                tol = dict(rtol=1e-4, atol=1e-3 if name in ("lam", "cost_red") else 1e-4)
            else:
                tol = dict(rtol=1e-10, atol=1e-10)
            torch.testing.assert_close(a, b, **tol)
            errs[name] = float((a - b).abs().max())
        max_err = max(max_err, max(errs.values()))
        log(f"phase1 riccati_lq B={Bt} N={N} nx={nx} nu={nu} {str(dt)[6:]}: "
            f"max|kernel-plain| " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    args = lq_problem(B_MAIN, N, 2, 1, torch.float32)
    ms = cuda_time_ms(lambda: riccati_lq_cuda(*args, reg=1e-8))
    plain_ms = cuda_time_ms(lambda: riccati_lq_reference(*args, reg=1e-8))
    log(f"phase1 riccati_lq B={B_MAIN} N={N} nx=2 nu=1 float32: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of 10, CUDA events)")
    report.update(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def phase2(report):
    """The main path at full width."""
    import numpy as np
    import torch
    import hilo_mpc_tpu_torch.ops.ip_solver as ips
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
    rng = np.random.default_rng(0)
    x0s = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B_MAIN, 2))
    # untimed warm-up at a small batch (CUDA context, library handles)
    nmpc.solve_batch_fn()(*nmpc.prepare_batch(x0s[:256]))
    torch.cuda.synchronize()

    riccati_lq_cuda.launches = 0
    t0 = time.perf_counter()
    args = nmpc.prepare_batch(x0s)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = nmpc.solve_batch_fn()(*args)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    theta_B, xs0_B, _, _ = args
    X_w = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
    X_w[:, 0] = xs0_B
    U_w = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)
    t0 = time.perf_counter()
    sol_w = nmpc.solve_batch_fn(warm=True)(theta_B, xs0_B, X_w, U_w)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launches = riccati_lq_cuda.launches

    for name, s in (("cold", sol), ("warm", sol_w)):
        assert s.U.shape == (B_MAIN, N, 1) and s.X.shape == (B_MAIN, N + 1, 2)
        assert bool(torch.isfinite(s.U).all()) and bool(torch.isfinite(s.X).all())
        conv = float(s.converged.float().mean())
        assert conv >= 0.97, f"{name} converged fraction {conv}"
    assert launches > 0, "the main path never launched the riccati_lq kernel"
    conv_c = float(sol.converged.float().mean())
    conv_w = float(sol_w.converged.float().mean())
    it_c = float(sol.iterations.float().median())
    it_w = float(sol_w.iterations.float().median())
    log(f"phase2 main path B={B_MAIN} N={N} float32: prepare_batch {t_prep:.4f} s")
    log(f"phase2 cold: {B_MAIN / t_cold:.1f} solves/s ({t_cold:.4f} s wall), "
        f"converged {conv_c:.4f}, iterations p50 {it_c:g} max "
        f"{int(sol.iterations.max())}")
    log(f"phase2 warm: {B_MAIN / t_warm:.1f} solves/s ({t_warm:.4f} s wall), "
        f"converged {conv_w:.4f}, iterations p50 {it_w:g} max "
        f"{int(sol_w.iterations.max())}")
    log(f"phase2 riccati_lq launches in the main path: {launches}")

    # the same solve with the plain LQ step in place of the kernel
    sub = tuple(a[:1024] for a in args)
    saved = ips.make_lq_solver
    ips.make_lq_solver = plain_lq_factory
    try:
        sol_ref = nmpc.solve_batch_fn()(*sub)
    finally:
        ips.make_lq_solver = saved
    dev = float((sol.U[:1024] - sol_ref.U).abs().max())
    log(f"phase2 first 1024 scenarios: max|U_kernel - U_plain| = {dev:.3e}")
    assert dev < 1e-3, dev
    report["launches"] = launches


def phase3():
    """Golden closed-loop replay in float64 on the card."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    data = np.load(GOLDEN)
    X_meas, U_gold = data["X_meas"], data["U_gold"]
    nmpc = build_cstr_nmpc({"tol": 1e-9, "max_iter": 80}, torch.float64)
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    devs = []
    for k in range(U_gold.shape[0]):
        u = nmpc.optimize(X_meas[k])
        devs.append(float(np.abs(u - U_gold[k]).max()))
        assert nmpc.stats["converged"], (k, nmpc.stats)
    dt = time.perf_counter() - t0
    assert riccati_lq_cuda.launches > n0
    log(f"phase3 golden cstr_tracking float64: {len(devs)} steps in {dt:.2f} s, "
        f"max|u - u_gold| = {max(devs):.3e}")
    assert max(devs) < 1e-4, devs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hilo_mpc_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"phase0 device: {name}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    lib = _build.library_path("riccati_lq")
    log(f"phase0 built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f} s")
    with open(lib + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    report = {}
    phase1(report)
    phase2(report)
    phase3()
    kernels = [{"name": "riccati_lq", "route": "cuda",
                "source": "hilo_mpc_tpu_torch/csrc/riccati_lq.cu",
                "replaces": "hilo_mpc_tpu/ops/pallas_kernels.py:169",
                "launches": report["launches"],
                "max_abs_err": report["max_abs_err"],
                "ms": report["ms"], "plain_ms": report["plain_ms"]}]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
