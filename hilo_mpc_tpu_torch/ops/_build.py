"""Build the package's CUDA kernels at first use and load them with ctypes.

Two kinds of source are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into shared libraries with a plain
C interface:

- ``csrc/<name>.cu``, a kernel with a fixed source (``library_path``);
- generated source text (``source_library_path``): an instantiation of a
  template from ``csrc/`` for one problem or size, written by the package
  (ops/codegen_cuda.py, ops/cuda_kernels.py) from those templates and the
  user's model alone. The text is written to ``_build/gen/<sha>.cu`` and
  compiled with ``-I csrc/``.

Each library lands in ``hilo_mpc_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of its source, so an edited
source rebuilds and concurrent builders never clobber each other (each writes
a temporary file and renames it into place). The compiler's output
(``-Xptxas -v``: registers, stack frame, spills) is kept beside each library
as ``<library>.log``. ``host_library_path`` compiles generated text with the
host C++ compiler instead, for checks of the ``__host__ __device__`` code on
the CPU. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GEN_DIR = os.path.join(BUILD_DIR, "gen")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are compiled at first use on the GPU host")


def host_cxx() -> str:
    """The host C++ compiler on PATH (``c++``, else ``g++``)."""
    found = shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    return found


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:12]


def _compile(cmd, src: str, out: str) -> str:
    """Run ``cmd + [-o tmp, src]`` unless ``out`` exists; keep the log."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".lib", suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = [*cmd, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed for {src} (exit "
                           f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    with open(out + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _nvcc_cmd():
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC_DIR]


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (built if missing)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = _digest(fh.read())
    return _compile(_nvcc_cmd(), src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so"))


def _gen_source(text: str) -> tuple:
    """Write generated text to ``_build/gen/<sha>.cu`` (the sha also covers
    the csrc/ headers it includes); returns (path, sha)."""
    data = text.encode()
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, name), "rb") as fh:
                data += fh.read()
    digest = _digest(data)
    os.makedirs(GEN_DIR, exist_ok=True)
    src = os.path.join(GEN_DIR, f"{digest}.cu")
    if not os.path.exists(src):
        fd, tmp = tempfile.mkstemp(prefix=".src", suffix=".cu", dir=GEN_DIR)
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, src)
    return src, digest


def source_library_path(text: str) -> str:
    """Path of the nvcc build of generated source ``text`` (built if
    missing)."""
    src, digest = _gen_source(text)
    return _compile(_nvcc_cmd(), src, os.path.join(GEN_DIR, f"lib{digest}.so"))


def host_library_path(text: str) -> str:
    """Path of the host C++ build of generated source ``text`` (its
    ``__host__ __device__`` code and host entry points; built if missing)."""
    src, digest = _gen_source(text)
    cmd = [host_cxx(), "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
           "-I", CSRC_DIR]
    return _compile(cmd, src, os.path.join(GEN_DIR, f"lib{digest}_host.so"))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(library_path(name))


@functools.lru_cache(maxsize=None)
def load_source(text: str) -> ctypes.CDLL:
    """Build (if needed) and load generated source ``text`` with nvcc."""
    return ctypes.CDLL(source_library_path(text))


@functools.lru_cache(maxsize=None)
def load_host(text: str) -> ctypes.CDLL:
    """Build (if needed) and load generated source ``text`` for the host."""
    return ctypes.CDLL(host_library_path(text))
