"""Run chosen phase functions of chip_smoke.py alone on one GPU.

    PYTHONPATH=. python3 tools/chip_phase.py phase13_fused_loop phase13_rti ...

Each argument names a function of chip_smoke.py that takes the report dict
(phase13_fused_loop, phase13_rti, phase13_mhe_loop, phase13_ekf_loop,
phase13_tvp, phase13_options, phase2, ...); the kernels build on first use.
Prints the card's name and power limit first, each function's wall time,
and the report's non-empty entries last.
"""
import os
import subprocess
import sys
import time


def main(names):
    import torch
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip(), torch.__version__, torch.version.cuda)
    report = {k: {} for k in cs.KERNELS}
    t0 = time.perf_counter()
    for name in names:
        t = time.perf_counter()
        getattr(cs, name)(report)
        cs.log(f"== {name} {time.perf_counter() - t:.1f} s")
    cs.log(f"total {time.perf_counter() - t0:.1f} s", {k: v for k, v in report.items() if v})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
