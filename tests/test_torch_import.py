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
