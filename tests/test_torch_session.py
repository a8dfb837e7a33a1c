"""PyTorch port: Session and the kernel build cache (utils/session.py,
ops/_build.py), the build-cache guard (utils/cache_guard.py) and profiling
(utils/profiling.py), held to the contracts of the JAX package's
tests/test_cache_guard.py and tests/test_aux_utils.py. There is no nvcc
here, so the builds are host builds of a small generated source
(``host_library_path``/``load_host``), which share the cache, the names and
the guard with the card's builds."""
import ctypes
import json
import os

import numpy as np
import pytest
import torch

from hilo_mpc_tpu.utils.cache_guard import cache_guard_status as jax_status
from hilo_mpc_tpu.utils.profiling import SolveTimer as JaxSolveTimer
from hilo_mpc_tpu.utils.session import Session as JaxSession
from hilo_mpc_tpu_torch import Session
from hilo_mpc_tpu_torch.ops import _build
from hilo_mpc_tpu_torch.utils import cache_guard
from hilo_mpc_tpu_torch.utils.cache_guard import (cache_guard_status,
                                                  install_cache_crash_guard,
                                                  uninstall_cache_crash_guard)
from hilo_mpc_tpu_torch.utils.profiling import SolveTimer, trace


def _text(value):
    """A small generated source: one C function returning ``value``."""
    return f'extern "C" int hilo_probe() {{ return {value}; }}\n'


def _probe(value):
    fn = _build.load_host(_text(value)).hilo_probe
    fn.restype = ctypes.c_int
    return fn()


@pytest.fixture
def cache(tmp_path):
    """A fresh build directory and no guard; the default ones afterwards."""
    uninstall_cache_crash_guard()
    yield _build.set_build_dir(tmp_path / "cache")
    _build.set_build_dir(None)
    uninstall_cache_crash_guard()


def test_build_dir_moves_and_keys_the_loaders(cache, tmp_path):
    value = int(np.random.default_rng(0).integers(1000, 2000))
    assert _build.get_build_dir() == cache
    path = _build.host_library_path(_text(value))
    assert path.startswith(os.path.join(cache, "gen")) and os.path.exists(path)
    assert _probe(value) == value
    handle = _build.load_host(_text(value))
    assert _build.load_host(_text(value)) is handle          # cached
    other = _build.set_build_dir(tmp_path / "other")
    assert _build.load_host(_text(value)) is not handle      # built again there
    assert os.path.exists(_build.host_library_path(_text(value)))
    assert _build.host_library_path(_text(value)).startswith(other)
    _build.set_build_dir(None)
    assert _build.get_build_dir() == _build.BUILD_DIR


def _corrupt(value):
    path = _build.host_library_path(_text(value))
    with open(path, "wb") as fh:
        fh.write(b"\x7fELF truncated")
    return path


def test_corrupt_library_is_a_miss_rebuilt_once(cache):
    value = 2101
    install_cache_crash_guard()
    path = _corrupt(value)
    assert _probe(value) == value
    st = cache_guard_status()
    assert st["read_failures"] == 1 and st["rebuilds"] == 1
    with open(path, "rb") as fh:
        assert fh.read(4) == b"\x7fELF" and os.path.getsize(path) > 100


def test_second_failure_raises_with_the_log(cache, monkeypatch):
    value = 2102
    install_cache_crash_guard()
    path = _corrupt(value)

    def refuse(name, *a, **k):
        raise OSError(f"{name}: refused")

    monkeypatch.setattr(ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="failed to load again") as err:
        _build.load_host(_text(value))
    assert path in str(err.value) and "compiler log" in str(err.value)
    assert cache_guard_status()["rebuilds"] == 1


def test_without_the_guard_a_corrupt_library_raises(cache):
    _corrupt(2103)
    with pytest.raises(OSError):
        _build.load_host(_text(2103))


def test_env_off_disables_the_guard(cache, monkeypatch):
    monkeypatch.setenv("HILO_CACHE_SAFE_MODE", "off")
    assert install_cache_crash_guard() == "off"
    assert not cache_guard_status()["installed"]
    _corrupt(2104)
    with pytest.raises(OSError):
        _build.load_host(_text(2104))


def test_no_write_mode_leaves_the_cache_untouched(cache, monkeypatch):
    monkeypatch.setenv("HILO_CACHE_SAFE_MODE", "no-write")
    assert install_cache_crash_guard() == "no-write"
    assert _probe(2105) == 2105
    assert not os.path.exists(os.path.join(cache, "gen"))


def test_failed_write_is_counted_and_leaves_nothing(cache):
    install_cache_crash_guard()
    bad = "this is not C++\n"
    for k in range(cache_guard.MAX_WRITE_FAILURES):
        with pytest.raises(RuntimeError, match="failed for"):
            _build.host_library_path(bad + "//" * k)
    st = cache_guard_status()
    assert st["write_failures"] == cache_guard.MAX_WRITE_FAILURES
    assert st["writes_disabled"]
    gen = os.path.join(cache, "gen")
    assert not [f for f in os.listdir(gen) if f.endswith(".so")]
    # with writes disabled a build goes to a private directory
    assert _probe(2106) == 2106
    assert not [f for f in os.listdir(gen) if f.endswith(".so")]


def test_guard_reads_probes_in_a_child(cache):
    install_cache_crash_guard(guard_reads=True)
    assert _probe(2107) == 2107
    _corrupt(2108)
    assert _probe(2108) == 2108
    assert cache_guard_status()["read_failures"] == 1


def test_status_keys_mirror_jax():
    ours, theirs = cache_guard_status(), jax_status()
    assert set(theirs) <= set(ours)
    assert {"read_failures", "rebuilds"} <= set(ours)


def test_session_sets_the_cache_and_installs_the_guard(cache, tmp_path):
    where = tmp_path / "session_cache"
    with Session(compilation_cache=str(where)) as s, JaxSession() as js:
        assert os.path.isdir(s.path) and os.path.isdir(js.path)
        assert _build.get_build_dir() == str(where)
        assert cache_guard_status()["installed"]
        tmp_dir = s.path
    # the temporary directory goes with the block; the cache setting stays,
    # as JAX's compilation-cache directory does
    assert not os.path.exists(tmp_dir)
    assert _build.get_build_dir() == str(where)
    with Session() as s:
        assert _build.get_build_dir() == str(where)


def test_solve_timer_percentiles_equal_jax():
    times = list(np.random.default_rng(3).exponential(0.01, 37))
    ours, theirs = SolveTimer(), JaxSolveTimer()
    assert ours.stats() == theirs.stats() == {"n": 0}
    ours.times, theirs.times = list(times), list(times)
    assert ours.stats() == theirs.stats()
    with ours.measure(result=[torch.zeros(2)]):
        sum(range(100))
    assert ours.stats()["n"] == 38


def test_trace_of_a_cpu_solve_names_the_riccati_op(tmp_path):
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    n = NMPC(cstr_schaffner_and_zeitz())
    n.horizon = 5
    n.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    n.quad_stage_cost.add_inputs(weights=0.1)
    n.set_parameters([1.0] * 6)
    # without the Mehrotra corrector: one LQ solve per iteration
    n.setup(options={"dt": 0.1, "mehrotra": False}, device="cpu", dtype=torch.float64)
    with trace(str(tmp_path / "tr")) as log_dir:
        sol = n.solve_batch_fn()(*n.prepare_batch(np.array([[0.2, 0.1], [0.25, 0.12]])))
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    n_op = names.count("hilo_mpc_tpu_torch::riccati_lq")
    assert n_op == int(sol.iterations.max()) > 0
    assert any(e.key == "hilo_mpc_tpu_torch::riccati_lq" for e in trace.last.key_averages())
