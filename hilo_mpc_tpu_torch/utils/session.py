"""Session and temporary-directory management.

PyTorch port of ``hilo_mpc_tpu/utils/session.py``. The JAX ``Session``
points XLA's persistent compilation cache at ``compilation_cache``; the
port's compiled artifacts are the kernels' shared libraries, so the port's
``Session`` points the kernel build cache there instead (ops/_build.py:
``lib<name>_<sha>.so`` and ``gen/<sha>.cu`` with its ``lib<sha>.so``) and
installs the build-cache guard (utils/cache_guard.py). As in JAX, the
setting outlives the ``with`` block. The session also owns a temporary
directory (``path``), removed on exit.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional


class TempDir:
    def __init__(self, prefix: str = "hilo_mpc_tpu_"):
        self.path = tempfile.mkdtemp(prefix=prefix)

    def cleanup(self):
        shutil.rmtree(self.path, ignore_errors=True)

    def __enter__(self):
        return self.path

    def __exit__(self, *exc):
        self.cleanup()


class Session:
    """Context manager owning a temporary directory and, optionally, the
    directory the kernels are built into and loaded from, so that later
    runs skip the builds."""

    def __init__(self, compilation_cache: Optional[str] = None,
                 prefix: str = "hilo_mpc_tpu_"):
        self._tmp = TempDir(prefix=prefix)
        self.path = self._tmp.path
        self._cache_dir = compilation_cache

    def __enter__(self):
        if self._cache_dir:
            os.makedirs(self._cache_dir, exist_ok=True)
            from ..ops import _build
            from .cache_guard import install_cache_crash_guard

            _build.set_build_dir(self._cache_dir)
            # a broken library in the cache must not stop the process that
            # chose it (utils/cache_guard.py; HILO_CACHE_SAFE_MODE=off opts out)
            install_cache_crash_guard()
        return self

    def __exit__(self, *exc):
        self._tmp.cleanup()
        return False
