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

Each library lands in the build directory, ``hilo_mpc_tpu_torch/_build/``
(listed in ``.gitignore``) unless ``set_build_dir`` (or
``utils/session.py:Session(compilation_cache=...)``) points it elsewhere,
under a name that carries a hash of its source, so an edited source rebuilds
and concurrent builds never clobber each other (each writes a temporary
file and renames it into place). The compiler's output (``-Xptxas -v``:
registers, stack frame, spills) is kept beside each library as
``<library>.log``. ``host_library_path`` compiles generated text with the
host C++ compiler instead, for checks of the ``__host__ __device__`` code on
the CPU. The loaders (``load``, ``load_source``, ``load_host`` and the entry
points that ops/cuda_kernels.py binds) keep one handle per source and build
directory (``per_build_dir``). A cached library that fails to load, and a
build that fails to write, go through the build-cache guard of
utils/cache_guard.py when it is installed. Nothing here runs at import time.
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
# the default build directory and its generated sources
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GEN_DIR = os.path.join(BUILD_DIR, "gen")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_build_dir = BUILD_DIR


def set_build_dir(path=None) -> str:
    """Build and load the kernels' libraries under ``path`` from now on
    (``None``: the default ``BUILD_DIR``); returns the absolute path. The
    setting holds for the rest of the process, as JAX's compilation-cache
    directory does."""
    global _build_dir
    _build_dir = BUILD_DIR if path is None else os.path.abspath(os.fspath(path))
    return _build_dir


def get_build_dir() -> str:
    """The directory the next build writes to and loads from."""
    return _build_dir


def _gen_dir() -> str:
    return os.path.join(_build_dir, "gen")


def per_build_dir(fn):
    """``functools.lru_cache`` of ``fn`` keyed on the build directory as
    well as the arguments: after ``set_build_dir`` a source not yet loaded
    from the new directory is built and loaded there."""
    cached = functools.lru_cache(maxsize=None)(
        lambda build_dir, args, kwargs: fn(*args, **dict(kwargs)))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return cached(_build_dir, args, tuple(sorted(kwargs.items())))

    wrapper.cache_clear = cached.cache_clear
    return wrapper


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
    """Run ``cmd + [-o tmp, src]`` unless ``out`` exists; keep the log. The
    library appears at ``out`` only whole (renamed into place); a failed
    build (the compiler's error, a killed compiler, a full disk) leaves
    nothing there, is counted by the build-cache guard and raises. Where
    the guard keeps the cache read-only, the build goes to a private
    temporary directory instead."""
    if os.path.exists(out):
        return out
    from ..utils import cache_guard
    out = cache_guard.write_target(out)
    if os.path.exists(out):
        return out
    tmp = None
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".lib", suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        cmd = [*cmd, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed for {src} (exit "
                               f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        with open(out + ".log", "w") as fh:
            fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    except (OSError, RuntimeError):
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
        cache_guard.note_write_failure(out)
        raise
    return out


def _nvcc_cmd():
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC_DIR]


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (built if missing)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = _digest(fh.read())
    return _compile(_nvcc_cmd(), src, os.path.join(_build_dir, f"lib{name}_{digest}.so"))


def _gen_source(text: str) -> tuple:
    """Write generated text to ``<build dir>/gen/<sha>.cu`` (the sha also
    covers the csrc/ headers it includes); returns (path, sha)."""
    data = text.encode()
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, name), "rb") as fh:
                data += fh.read()
    digest = _digest(data)
    src = os.path.join(_gen_dir(), f"{digest}.cu")
    if not os.path.exists(src):
        from ..utils import cache_guard
        src = cache_guard.write_target(src)
    if not os.path.exists(src):
        os.makedirs(os.path.dirname(src), exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".src", suffix=".cu", dir=os.path.dirname(src))
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, src)
    return src, digest


def source_library_path(text: str) -> str:
    """Path of the nvcc build of generated source ``text`` (built if
    missing)."""
    src, digest = _gen_source(text)
    return _compile(_nvcc_cmd(), src, os.path.join(_gen_dir(), f"lib{digest}.so"))


def host_library_path(text: str) -> str:
    """Path of the host C++ build of generated source ``text`` (its
    ``__host__ __device__`` code and host entry points; built if missing)."""
    src, digest = _gen_source(text)
    cmd = [host_cxx(), "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
           "-I", CSRC_DIR]
    return _compile(cmd, src, os.path.join(_gen_dir(), f"lib{digest}_host.so"))


def _open(path_of, key) -> ctypes.CDLL:
    """Load the library ``path_of(key)`` builds; a cached library that fails
    to load goes to the build-cache guard (a miss: removed, rebuilt once)."""
    from ..utils import cache_guard
    path = path_of(key)
    try:
        cache_guard.check_read(path)
        return ctypes.CDLL(path)
    except OSError as err:
        return cache_guard.reload_after_failure(path, err, lambda: path_of(key))


@per_build_dir
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process
    and build directory."""
    return _open(library_path, name)


@per_build_dir
def load_source(text: str) -> ctypes.CDLL:
    """Build (if needed) and load generated source ``text`` with nvcc."""
    return _open(source_library_path, text)


@per_build_dir
def load_host(text: str) -> ctypes.CDLL:
    """Build (if needed) and load generated source ``text`` for the host."""
    return _open(host_library_path, text)
