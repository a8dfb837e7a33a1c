"""Ahead-of-time export of the port's functions (deployment artifacts).

PyTorch port of ``hilo_mpc_tpu/utils/aot.py``. Where the JAX package
serializes the lowered StableHLO of a jitted function with ``jax.export``,
the port captures the function's graph with ``torch.export.export``
(non-strict: the Python of the model and the solver runs once on fake
tensors of the example inputs' shapes, dtype and device) and saves it with
``torch.export.save``. ``load_function`` reloads it with
``torch.export.load`` in any process that has imported this package (for
its registered operators); no model code and no controller is needed
there.

A function is first traced by ``make_fx`` (which records what
``torch.func``'s transforms compute, as the solver's derivatives need),
then exported from that graph.

The exported NMPC solve (``export_nmpc_solver``) is ``ops/ip_solver.py:
solve_ocp`` with the controller's options and ``fix_x0=True``, without the
early exit: the solve's one host sync, the test whether every scenario has
finished, cannot be part of a captured graph, so the exported solve runs all
``max_iter`` iterations, the finished scenarios frozen as they are in the
live solve, and returns the same X and U. It is saved as three exported
programs in one zip archive (``ops/ip_solver.py:solve_ocp_carry``): the cold
start, ONE iteration, and the solution from the final state; the callable
that ``load_function`` returns runs the iteration ``max_iter`` times. (An
unrolled graph of every iteration took seconds per iteration to trace and
export on the CPU; ``torch``'s ``while_loop`` traces its body with
TorchDynamo, which does not take the model's Python.) Its Newton steps are
nodes of the registered Riccati operator (``hilo_mpc_tpu_torch::riccati_lq``
or ``::riccati_lq_wide``), the hand-written kernel on CUDA tensors, so the
exported and the live solve run one code.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Callable

import torch

_SOLVER_META = "hilo_mpc_solver.json"


def _export(fn: Callable, example_args) -> "torch.export.ExportedProgram":
    """``fn`` traced by ``make_fx`` at ``example_args`` (tensors it closes
    over become constants of the graph), then exported; each captured
    tensor is given a storage of its own, since ``torch.export.save``
    groups tensors by storage."""
    from torch.fx.experimental.proxy_tensor import make_fx

    args = tuple(example_args)
    gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    # what the traced code computed and did not use (in a piece of the
    # solve: the cold start a given state replaces)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    ep = torch.export.export(gm, args, strict=False)
    for table in (ep.constants, ep.state_dict):
        for k, v in list(table.items()):
            if torch.is_tensor(v):
                table[k] = v.detach().clone(memory_format=torch.contiguous_format)
    return ep


def export_function(fn: Callable, example_args, path: str,
                    platforms=None) -> str:
    """Export ``fn`` specialized to ``example_args``' shapes, dtype and
    device to ``path``. ``platforms`` is JAX's lowering-platform list and
    has no effect: the graph runs on the device of its example inputs."""
    torch.export.save(_export(fn, example_args), path)
    return path


class ExportedSolve:
    """The callable of an exported NMPC solve: the cold start, ``max_iter``
    iterations and the solution, each an exported program's module
    (``programs``: "init", "step", "finish")."""

    def __init__(self, programs: dict, max_iter: int):
        self.programs = programs
        self.max_iter = max_iter
        self._mods = {k: ep.module() for k, ep in programs.items()}

    def __call__(self, theta, xs0, X_init, U_init):
        args = (theta, xs0, X_init, U_init)
        carry = self._mods["init"](*args)
        for _ in range(self.max_iter):
            carry = self._mods["step"](*args, *carry)
        return self._mods["finish"](*args, *carry)


def load_function(path: str) -> Callable:
    """Reload an exported function; returns a callable running its graph
    (an ``ExportedSolve`` for ``export_nmpc_solver``'s archive)."""
    from ..ops import cuda_kernels  # noqa: F401  (registers the operators)

    with zipfile.ZipFile(path) as z:
        if _SOLVER_META in z.namelist():
            meta = json.loads(z.read(_SOLVER_META))
            return ExportedSolve({k: torch.export.load(io.BytesIO(z.read(f"{k}.pt2")))
                                  for k in ("init", "step", "finish")},
                                 meta["max_iter"])
    return torch.export.load(path).module()


def export_model_step(model, path: str, batch: int = 0) -> str:
    """Export a Model's one-step transition (optionally batched) as an
    artifact: (x, z, u, p) -> (x_next, z_next, y_next, q_next) at t = 0."""
    if not model.is_setup():
        raise RuntimeError("model.setup(dt=...) first")
    step = model.step_fn
    dt = model.dt

    def stepper(x, z, u, p):
        return step(x, z, u, p, 0.0, dt)

    lead = (batch,) if batch else ()
    kw = dict(dtype=model.dtype, device=model.device)
    shapes = tuple(torch.zeros(lead + (n,), **kw)
                   for n in (model.n_x, model.n_z, model.n_u, model.n_p))
    return export_function(stepper, shapes, path)


def export_nmpc_solver(nmpc, path: str, batch: int = 0) -> str:
    """Export the (optionally batched) NMPC solve as a deployment artifact:
    (theta, xs0, X_init, U_init) -> (X, U, converged, kkt_error), each with
    a leading batch axis of ``batch`` if it is nonzero. The solve is the
    controller's general path (``pallas_full`` does not apply, as in JAX)."""
    from ..ops.ip_solver import solve_ocp_carry

    if not nmpc.is_setup():
        raise RuntimeError("call setup() first")
    funcs, dims, bounds, opts = nmpc._funcs, nmpc._dims, nmpc._bounds, nmpc._ip_opts
    N, nxs, nus = dims.N, dims.nx, dims.nu
    n_theta = nmpc._assemble_theta(None, None).shape[-1]

    def piece(args, carry=None, steps=0, finish=False):
        if not batch:
            args = [a[None] for a in args]
        return solve_ocp_carry(funcs, dims, bounds, *args, options=opts, fix_x0=True,
                               carry=carry, steps=steps, finish=finish)

    def init(theta, xs0, X_init, U_init):
        return piece((theta, xs0, X_init, U_init))

    def step(theta, xs0, X_init, U_init, *carry):
        return piece((theta, xs0, X_init, U_init), carry, steps=1)

    def finish(theta, xs0, X_init, U_init, *carry):
        sol = piece((theta, xs0, X_init, U_init), carry, finish=True)
        out = (sol.X, sol.U, sol.converged, sol.kkt_error)
        return out if batch else tuple(o[0] for o in out)

    lead = (batch,) if batch else ()
    kw = dict(dtype=nmpc.dtype, device=nmpc.device)
    args = (torch.zeros(lead + (N + 1, n_theta), **kw), torch.zeros(lead + (nxs,), **kw),
            torch.zeros(lead + (N + 1, nxs), **kw), torch.zeros(lead + (N, nus), **kw))
    # dense example states: make_fx's fake copies keep the strides, and the
    # solver's forward-mode derivatives want dense primals
    carry = tuple(c.contiguous() for c in init(*args))
    programs = {"init": _export(init, args), "step": _export(step, args + carry),
                "finish": _export(finish, args + carry)}
    with zipfile.ZipFile(path, "w") as z:
        for k, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"{k}.pt2", buf.getvalue())
        z.writestr(_SOLVER_META, json.dumps({"max_iter": opts.max_iter}))
    return path
