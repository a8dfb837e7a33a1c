#!/usr/bin/env python3
"""Time another checkout's kernel beside this checkout's, in one process on
one NVIDIA GPU, in turns (other, this, this, other).

    PYTHONPATH=. python3 tools/parent_compare.py fgm _work/parent [--n 25,64]
    PYTHONPATH=. python3 tools/parent_compare.py riccati _work/parent

The other checkout (for example the parent commit, unpacked with
``git archive <commit> | tar -x -C _work/parent``) gives its kernel source,
built here with this checkout's nvcc flags and called through its own C
entry point:

- ``fgm``: ``csrc/fgm_boxqp.cu`` (``fgm_boxqp_f32``; up to n = 128 the
  SIMT resident kernel in checkouts that still have it) at B=131072, nx=2,
  100 iterations, at each n of ``--n`` (a comma-separated list): n = 20
  (the default) is the flagship FGM shape (chip_smoke.py phase 4's
  condensed QP), another n chip_smoke.py's crossover problem
  (``random_qp(n, seed=n)``, x0 from ``default_rng(n)``);
- ``riccati``: the tiled Riccati kernel ``csrc/riccati_lq.cuh``
  (``riccati_lq_f32`` / ``_f64``), instantiated with this checkout's tiles,
  with a fixed initial state: at the flagship ((nx, nu) = (2, 1), N=20,
  B=131072) in float32 and float64, and at the tiled cap (8, 4) in float32.
  An entry whose arguments end at ``reg`` (a header without the free-x0
  flag) is called without the flag.

Prints the card's name and power limit, the largest |out_this - out_other|
(0.0 when the two give the same bits), and each kernel alone as one call and
back to back.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from hilo_mpc_tpu_torch.ops import _build
from hilo_mpc_tpu_torch.ops.cuda_kernels import (_lq_buffers, _ptrs, fgm_boxqp_design,
                                                 fgm_boxqp_launch, fgm_constants,
                                                 riccati_lq_cuda, riccati_lq_source,
                                                 riccati_lq_tiling)

RICCATI_CASES = ((2, 1, torch.float32), (2, 1, torch.float64), (8, 4, torch.float32))


# The other checkout's build keeps the static locals of its template
# functions (e.g. the once-per-device shared-memory attribute flags) to
# itself: as GNU unique symbols the loader would share them with this
# checkout's library of the same instantiation, RTLD_LOCAL or not, and the
# other kernel would launch without its attribute set.
PRIVATE_STATICS = ["-Xcompiler", "-fno-gnu-unique"]


def other_fgm(root):
    """The other checkout's fgm_boxqp_f32, built into this checkout's
    _build/ (the name carries a hash of the source and the flags)."""
    src = os.path.join(os.path.abspath(root), "hilo_mpc_tpu_torch", "csrc", "fgm_boxqp.cu")
    with open(src, "rb") as fh:
        digest = _build._digest(fh.read() + " ".join(PRIVATE_STATICS).encode())
    lib = _build._compile(_build._nvcc_cmd() + PRIVATE_STATICS, src,
                          os.path.join(_build.BUILD_DIR, f"libfgm_other_{digest}.so"))
    fn = ctypes.CDLL(lib).fgm_boxqp_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def other_riccati(root, nx, nu, dtype):
    """(entry, takes the free-x0 flag) of the other checkout's riccati_lq_f32
    / _f64 for (nx, nu), built into this checkout's _build/gen/ (the name
    carries a hash of the text, the other header and the flags)."""
    csrc = os.path.join(os.path.abspath(root), "hilo_mpc_tpu_torch", "csrc")
    text = riccati_lq_source(nx, nu)
    with open(os.path.join(csrc, "riccati_lq.cuh"), "rb") as fh:
        header = fh.read()
    flag = b"double reg, int free_x0" in header
    digest = _build._digest(text.encode() + header + " ".join(PRIVATE_STATICS).encode())
    os.makedirs(_build.GEN_DIR, exist_ok=True)
    src = os.path.join(_build.GEN_DIR, f"other_riccati_{digest}.cu")
    with open(src, "w") as fh:
        fh.write(text)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", csrc, *PRIVATE_STATICS]
    lib = _build._compile(cmd, src, os.path.join(_build.GEN_DIR,
                                                 f"libother_riccati_{digest}.so"))
    fn = getattr(ctypes.CDLL(lib), f"riccati_lq_{'f64' if dtype == torch.float64 else 'f32'}")
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int, ctypes.c_int, ctypes.c_double]
                   + ([ctypes.c_int] if flag else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, flag


def in_turns(label, other, this):
    for name, fn_ in (("other", other), ("this", this), ("this", this),
                      ("other", other)):
        one = cs.cuda_time_ms(fn_)
        b2b = cs.cuda_time_ms(fn_, inner=cs.INNER)
        cs.log(f"  {label} {name}: {one:.4f} ms one call, {b2b:.4f} ms back to back "
               f"({cs.INNER} calls per run; medians of 10 runs, CUDA events)")


def compare_fgm(n, fn):
    if n == 20:
        H, G, lb, ub = cs.build_di_lmpc(torch.float32, {}, setup=False).condensed_qp()
        seed = 0
    else:
        H, G, lb, ub = cs.random_qp(n, seed=n)
        seed = n
    n, nx = G.shape
    inv_L, beta = fgm_constants(H)
    x0 = np.random.default_rng(seed).standard_normal((cs.B_MAIN, nx))
    dev = [cs.fgm_dev(a) for a in (H, G, x0, lb, ub)]
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
    label = f"fgm B={cs.B_MAIN} n={n} iters={cs.FGM_ITERS}"
    cs.log(f"parent_compare {label} ({fgm_boxqp_design(n)[0]} here): "
           f"max|u_this - u_other| = {diff!r}")
    in_turns(label, other, this)


def compare_riccati(root):
    for nx, nu, dtype in RICCATI_CASES:
        args = cs.lq_problem(cs.B_MAIN, cs.N, nx, nu, dtype)
        fn, flag = other_riccati(root, nx, nu, dtype)
        tb = riccati_lq_tiling(nx, nu, dtype)[0]

        def other():
            bufs = _lq_buffers(args, cs.B_MAIN, cs.N, nx, nu, tb)
            rc = fn(*_ptrs(args), *_ptrs(bufs), cs.B_MAIN, cs.N, 1e-8,
                    *([0] if flag else []), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"the other checkout's kernel failed: cudaError {rc}")
            return bufs[:6]

        def this():
            return riccati_lq_cuda(*args, reg=1e-8)

        diff = max(float((a - b).abs().max()) for a, b in zip(this(), other()))
        torch.cuda.synchronize()
        label = f"riccati B={cs.B_MAIN} N={cs.N} nx={nx} nu={nu} {str(dtype)[6:]}"
        cs.log(f"parent_compare {label}: max|out_this - out_other| = {diff!r}")
        in_turns(label, other, this)
        del args


def main(kernel, root, ns=(20,)):
    if not torch.cuda.is_available():
        print("parent_compare: no CUDA device", file=sys.stderr)
        return 2
    cs.log(torch.cuda.get_device_name(0))
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip())
    if kernel == "fgm":
        fn = other_fgm(root)
        for n in ns:
            compare_fgm(n, fn)
    else:
        compare_riccati(root)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="time another checkout's kernel "
                                 "beside this checkout's")
    ap.add_argument("kernel", choices=("fgm", "riccati"))
    ap.add_argument("checkout")
    ap.add_argument("--n", type=lambda v: [int(x) for x in v.split(",")], default=[20],
                    help="the FGM QP sizes, comma-separated (fgm only)")
    a = ap.parse_args()
    sys.exit(main(a.kernel, a.checkout, a.n))
