#!/usr/bin/env python3
"""Time another checkout's FGM kernel beside this checkout's, in one process
on one NVIDIA GPU, at the flagship FGM shape (chip_smoke.py phase 4's
condensed QP: n=20, nx=2, B=131072, 100 iterations).

    PYTHONPATH=. python3 tools/fgm_parent_compare.py _work/parent

The other checkout (for example the parent commit, unpacked with
``git archive <commit> | tar -x -C _work/parent``) gives its
``hilo_mpc_tpu_torch/csrc/fgm_boxqp.cu``, built here with this checkout's
nvcc flags and called through the same C entry point
(``fgm_boxqp_f32``). Prints the card's name and power limit, the largest
|u_this - u_other| (0.0 when the two give the same bits), and each kernel
alone as one call and back to back, in turns (other, this, this, other).
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from hilo_mpc_tpu_torch.ops import _build
from hilo_mpc_tpu_torch.ops.cuda_kernels import (fgm_boxqp_design, fgm_boxqp_launch,
                                                 fgm_constants)


def other_fgm(root):
    """The other checkout's fgm_boxqp_f32, built into this checkout's
    _build/ (the name carries a hash of the source)."""
    src = os.path.join(os.path.abspath(root), "hilo_mpc_tpu_torch", "csrc", "fgm_boxqp.cu")
    with open(src, "rb") as fh:
        digest = _build._digest(fh.read())
    lib = _build._compile(_build._nvcc_cmd(), src,
                          os.path.join(_build.BUILD_DIR, f"libfgm_other_{digest}.so"))
    fn = ctypes.CDLL(lib).fgm_boxqp_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(root):
    if not torch.cuda.is_available():
        print("fgm_parent_compare: no CUDA device", file=sys.stderr)
        return 2
    cs.log(torch.cuda.get_device_name(0))
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip())
    H, G, lb, ub = cs.build_di_lmpc(torch.float32, {}, setup=False).condensed_qp()
    n, nx = G.shape
    inv_L, beta = fgm_constants(H)
    x0 = np.random.default_rng(0).standard_normal((cs.B_MAIN, nx))
    dev = [cs.fgm_dev(a) for a in (H, G, x0, lb, ub)]
    fn = other_fgm(root)
    _, cluster, tile = fgm_boxqp_design(n)

    def other():
        out = torch.empty((cs.B_MAIN, n), dtype=torch.float32, device="cuda")
        rc = fn(*(t.data_ptr() for t in dev), None, out.data_ptr(), cs.B_MAIN, n, nx,
                cs.FGM_ITERS, inv_L, beta, cluster, tile,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other checkout's kernel failed: cudaError {rc}")
        return out

    def this():
        return fgm_boxqp_launch(*dev, cs.FGM_ITERS, None, inv_L, beta)

    diff = float((this() - other()).abs().max())
    torch.cuda.synchronize()
    cs.log(f"fgm_parent_compare B={cs.B_MAIN} n={n} iters={cs.FGM_ITERS} "
           f"({fgm_boxqp_design(n)[0]} here): max|u_this - u_other| = {diff!r}")
    for name, fn_ in (("other", other), ("this", this), ("this", this),
                      ("other", other)):
        one = cs.cuda_time_ms(fn_)
        b2b = cs.cuda_time_ms(fn_, inner=cs.INNER)
        cs.log(f"fgm_parent_compare {name}: {one:.4f} ms one call, {b2b:.4f} ms back "
               f"to back ({cs.INNER} calls per run; medians of 10 runs, CUDA events)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
