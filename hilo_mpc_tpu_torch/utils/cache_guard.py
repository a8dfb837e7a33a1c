"""The build-cache guard: a broken kernel library in the cache is a miss.

PyTorch port of ``hilo_mpc_tpu/utils/cache_guard.py``. The JAX guard keeps
a crashing read or write of XLA's persistent compilation cache from killing
the process. The port's compiled artifacts are the kernels' shared
libraries in the build directory of ops/_build.py, and the failures that
directory sees are of its own kind: a truncated or foreign library left by
a killed build or another machine fails ``dlopen``; a build killed midway,
or a full or read-only disk, fails to write. With the guard installed:

- a cached library that fails to load is a **cache miss**: it is removed,
  rebuilt once and loaded; a second failure raises, naming the file and
  the compiler's log (``read_failures``, ``rebuilds``);
- a failed write leaves nothing at the library's name (ops/_build.py
  renames a finished build into place) and raises; after
  ``MAX_WRITE_FAILURES`` of them the cache is no longer written, and later
  builds go to a private temporary directory (``write_failures``,
  ``writes_disabled``), as the JAX guard stops writing after repeated
  crashes;
- ``guard_reads=True`` also loads each library in a forked child first, so
  a library whose loading crashes the process is a miss too.

Nothing here gives way to a kernel's plain version: a library that cannot
be built and loaded raises.

Usage::

    from hilo_mpc_tpu_torch.utils.cache_guard import install_cache_crash_guard
    install_cache_crash_guard()              # rebuild broken entries (default)
    install_cache_crash_guard("no-write")    # read-only cache
    install_cache_crash_guard(guard_reads=True)  # also probe loads in a child

Environment override: ``HILO_CACHE_SAFE_MODE`` = ``fork`` (the default mode
when the guard is installed, kept under the JAX package's name) |
``no-write`` | ``off``. ``utils.session.Session`` installs the guard when
it is given a cache directory.
"""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

logger = logging.getLogger(__name__)

#: seconds before a forked probe child is killed (a child that hangs in a
#: library's constructors must not hang the parent)
CHILD_TIMEOUT_S = 120
#: failed writes after which the cache is no longer written
MAX_WRITE_FAILURES = 3

_state = {
    "installed": False,
    "mode": None,
    "guard_reads": False,
    "write_failures": 0,
    "writes_disabled": False,
    "read_failures": 0,
    "rebuilds": 0,
    "private_dir": None,
}


def _resolve_mode(mode: Optional[str]) -> str:
    env = os.environ.get("HILO_CACHE_SAFE_MODE", "").strip().lower()
    if env in ("off", "0", "disable", "disabled"):
        return "off"
    if env in ("no-write", "nowrite", "ro", "read-only"):
        return "no-write"
    if env in ("fork", "1", "on"):
        return "fork"
    return mode or "fork"


def install_cache_crash_guard(mode: Optional[str] = None,
                              guard_reads: bool = False) -> str:
    """Install the guard; returns the effective mode ('fork', 'no-write' or
    'off'). Idempotent: installing again switches the mode in place."""
    uninstall_cache_crash_guard()
    mode = _resolve_mode(mode)
    if mode == "off":
        return mode
    if mode not in ("fork", "no-write"):
        raise ValueError(f"unknown cache guard mode {mode!r} (fork | no-write | off)")
    _state.update(installed=True, mode=mode,
                  guard_reads=bool(guard_reads) and hasattr(os, "fork"))
    return mode


def uninstall_cache_crash_guard() -> None:
    _state.update(installed=False, mode=None, guard_reads=False, write_failures=0,
                  writes_disabled=False, read_failures=0, rebuilds=0)


def cache_guard_status() -> dict:
    """The JAX guard's keys (``installed``, ``mode``, ``write_failures``,
    ``writes_disabled``), and the loads that failed (``read_failures``) and
    the libraries rebuilt after one (``rebuilds``)."""
    return {k: _state[k] for k in ("installed", "mode", "write_failures",
                                   "writes_disabled", "read_failures", "rebuilds")}


def write_target(path: str) -> str:
    """Where a build meant for ``path`` writes: ``path`` itself, or under
    the guard in no-write mode (or with writes disabled) the same name in a
    private temporary directory of this process."""
    if not _state["installed"] or not (_state["mode"] == "no-write"
                                       or _state["writes_disabled"]):
        return path
    from ..ops import _build
    if _state["private_dir"] is None:
        _state["private_dir"] = tempfile.mkdtemp(prefix="hilo_mpc_tpu_torch_build_")
    rel = os.path.relpath(path, _build.get_build_dir())
    if rel.startswith(os.pardir):
        rel = os.path.basename(path)
    return os.path.join(_state["private_dir"], rel)


def note_write_failure(path: str) -> None:
    """Count a build that failed to write ``path`` (it raises on)."""
    if not _state["installed"]:
        return
    _state["write_failures"] += 1
    logger.warning("kernel build for %s failed (%d/%d failures before the cache is "
                   "no longer written)", path, _state["write_failures"],
                   MAX_WRITE_FAILURES)
    if _state["write_failures"] >= MAX_WRITE_FAILURES:
        _state["writes_disabled"] = True


def check_read(path: str) -> None:
    """With ``guard_reads``, load ``path`` in a forked child first; a child
    that crashes or fails raises OSError here (a miss)."""
    if not (_state["installed"] and _state["guard_reads"]):
        return
    import signal
    import warnings
    with warnings.catch_warnings():
        # CPython warns that fork in a threaded process may deadlock the
        # child; the child only loads the library and its alarm ends it
        warnings.simplefilter("ignore", DeprecationWarning)
        pid = os.fork()
    if pid == 0:
        status = 1
        try:
            import ctypes
            signal.alarm(CHILD_TIMEOUT_S)
            ctypes.CDLL(path)
            status = 0
        finally:
            os._exit(status)
    _, wait_status = os.waitpid(pid, 0)
    if wait_status != 0:
        raise OSError(f"loading {path} failed in a probe child (wait status "
                      f"{wait_status})")


def reload_after_failure(path: str, err: OSError, rebuild):
    """A library at ``path`` failed to load with ``err``. Without the guard
    that error stands. With it the library is a miss: removed, rebuilt once
    by ``rebuild()`` (which returns the new path) and loaded; a second
    failure raises a RuntimeError naming the file and the compiler's log."""
    import ctypes
    if not _state["installed"]:
        raise err
    _state["read_failures"] += 1
    logger.warning("cached kernel library %s failed to load (%s); rebuilding it",
                   path, err)
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    new = rebuild()
    _state["rebuilds"] += 1
    try:
        check_read(new)
        return ctypes.CDLL(new)
    except OSError as err2:
        log = new + ".log"
        text = open(log).read() if os.path.exists(log) else "(no log)"
        raise RuntimeError(f"kernel library {new} failed to load again after a "
                           f"rebuild: {err2}\ncompiler log {log}:\n{text}") from err2
