"""Where the time goes in the PyTorch port's flagship batched NMPC solve (one GPU).

    python tools/profile_torch_port.py [B]

Builds the flagship CSTR NMPC (N=20, RK4, float32, the option set of
chip_smoke.py phase 2) on "cuda", then
  1. times the cold solve with the hand-written Riccati kernel and with the
     plain PyTorch sweeps in its place, in turns (plain, kernel, kernel, plain);
  2. profiles one cold solve with torch.profiler and prints the device time by
     kernel name, the device busy time and the idle share of the wall time.
The Chrome trace goes to chiprun_out/profile_torch_port.json.
"""
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import FLAGSHIP, build_cstr_nmpc  # noqa: E402
from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp  # noqa: E402
from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver, make_plain_lq_solver  # noqa: E402


def timed_solve(fn, args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = fn(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, sol


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: no CUDA device")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
    rng = np.random.default_rng(0)
    args = nmpc.prepare_batch(np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2)))
    fn = nmpc.solve_batch_fn()
    fn(*args)                                   # warm-up: context, handles, build

    def solve_with(lq_solver):
        return lambda *a: solve_ocp(nmpc._funcs, nmpc._dims, nmpc._bounds, *a,
                                    options=nmpc._ip_opts, mu0=nmpc._ip_opts.mu_init,
                                    lq_solver=lq_solver)

    solvers = {"plain": solve_with(make_plain_lq_solver),
               "kernel": solve_with(make_lq_solver)}
    for which in ("plain", "kernel", "kernel", "plain"):
        dt, sol = timed_solve(solvers[which], args)
        print(f"cold solve B={B} LQ step={which}: {dt:.4f} s wall, "
              f"{B / dt:.1f} solves/s, iterations max {int(sol.iterations.max())}",
              flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sol = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = int(sol.iterations.max())

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    # device-side events only (one per kernel name), so nothing is counted twice
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)), reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"profiled cold solve: wall {wall * 1e3:.2f} ms (profiler on), "
          f"{iters} iterations, device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / 1e3 / (wall * 1e3):.3f}, {len(rows)} kernel names",
          flush=True)
    print(f"{'self device ms':>14} {'share':>6} {'calls':>6}  name")
    for t_us, n, key in rows[:30]:
        print(f"{t_us / 1e3:14.3f} {t_us / max(busy_us, 1e-9):6.3f} {n:6d}  {key[:100]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out",
                                          "profile_torch_port.json"))


if __name__ == "__main__":
    main()
