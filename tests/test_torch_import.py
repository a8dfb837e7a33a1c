"""PyTorch port: importing the package needs neither JAX nor a GPU toolchain."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import hilo_mpc_tpu_torch
import hilo_mpc_tpu_torch.ops.cuda_kernels
import hilo_mpc_tpu_torch.utils.interop
import hilo_mpc_tpu_torch.estimation
from hilo_mpc_tpu_torch import NMPC, Model, TimeSeries, library
from hilo_mpc_tpu_torch import EKF, KF, MHE, PF, UKF
import hilo_mpc_tpu_torch.ops.programs
import hilo_mpc_tpu_torch.parallel.sharding
import hilo_mpc_tpu_torch.parallel.distributed
import hilo_mpc_tpu_torch.embedded
from hilo_mpc_tpu_torch import LP, NLP, QP, OptimizationSeries
from hilo_mpc_tpu_torch import (Session, clear_trace_registry, get_plot_backend,
                                set_plot_backend, trace_registry_stats)
import hilo_mpc_tpu_torch.utils.aot
import hilo_mpc_tpu_torch.utils.cache_guard
import hilo_mpc_tpu_torch.utils.plotting_bokeh
import hilo_mpc_tpu_torch.utils.profiling
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "hilo_mpc_tpu", "triton"))
print("LOADED=" + ",".join(loaded))
"""


def test_import_without_jax_or_toolchain(tmp_path):
    # nvcc is out of reach: a bare PATH and a CUDA_HOME that does not exist
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": ROOT, "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED=\n" in proc.stdout, proc.stdout


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    """No fallback: without nvcc the kernel build raises instead of running
    something else."""
    from hilo_mpc_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_missing_c_compiler_is_an_error(monkeypatch, tmp_path):
    """The embedded export finds no compiler on an empty PATH and says so."""
    from hilo_mpc_tpu_torch.embedded import find_c_compiler

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CC", raising=False)
    with pytest.raises(RuntimeError, match="no C compiler"):
        find_c_compiler()


_BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("matplotlib", "bokeh"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, Block())
import hilo_mpc_tpu_torch as h
from hilo_mpc_tpu_torch import (Session, clear_trace_registry, get_plot_backend,
                                set_plot_backend, trace_registry_stats)
import hilo_mpc_tpu_torch.utils.plotting_bokeh
assert get_plot_backend() == "matplotlib" and trace_registry_stats()["entries"] == 0
assert set(["Session", "set_plot_backend", "get_plot_backend", "clear_trace_registry",
            "trace_registry_stats"]) <= set(h.__all__)
try:
    set_plot_backend("bokeh")
except ImportError as err:
    print("GATE", err)
print("PLOTTING=" + ",".join(sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("matplotlib", "bokeh"))))
"""


def test_import_without_plotting_packages(tmp_path):
    """The five flat names of the host utilities import with matplotlib and
    bokeh blocked (the card's host has neither); the bokeh backend's gate
    then raises its clear error."""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT, "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PLOTTING=\n" in proc.stdout, proc.stdout
    assert "GATE plot backend 'bokeh' requires the bokeh package" in proc.stdout
