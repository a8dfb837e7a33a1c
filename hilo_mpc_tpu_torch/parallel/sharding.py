"""Splitting a batch of scenarios over devices.

PyTorch port of ``hilo_mpc_tpu/parallel/sharding.py``. JAX annotates a
batch with a sharding over a device mesh and lets ``jit`` partition the
vmapped solve and insert the collectives. Here the partitioning is
explicit:

- a ``Mesh`` is an ordered set of torch devices: on CUDA the first n of
  the visible cards, on the CPU n shards of ``"cpu"`` (``CPU_SHARDS`` of
  them at most, the counterpart of the virtual CPU devices JAX's tests
  run on);
- ``shard_batch`` splits the leading axis into one ``ShardedTensor`` piece
  per shard, each on its shard's device (a batch the mesh does not divide
  is refused, as JAX refuses it);
- ``sharded_solve_fn`` runs ``solve_ocp`` on each shard on that shard's
  device, with the controller's constants there (``on_device``): on CUDA
  every Newton step of a shard is one launch of the Riccati kernel on its
  card, and cards other than the first run in threads of their own;
- ``batch_stats`` reduces each shard where it lies and combines the
  partial counts and extrema; the medians need the per-scenario columns,
  which are gathered (across processes too, for a batch made by
  ``parallel/distributed.py:global_batch``).
"""
from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.model import resolve_device

# the CPU mesh's shard count (the JAX tests' --xla_force_host_platform_device_count)
CPU_SHARDS = 8


def _norm(device) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered set of devices, shaped, with one name per axis.

    ``devices`` are this process's devices; ``process_count`` processes
    with a mesh each make up a global mesh (``parallel/distributed.py``)."""
    devices: np.ndarray           # torch.device objects, of shape ``shape``
    axis_names: tuple
    process_count: int = 1

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def shard_devices(self, axis: str = "dp") -> list:
        """One device per shard of ``axis`` (the first device of each slice
        across the other axes)."""
        ax = self.axis_names.index(axis)
        return [np.take(self.devices, [i], axis=ax).flat[0]
                for i in range(self.devices.shape[ax])]


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None, device="cuda") -> Mesh:
    """A mesh over all (or the first ``n_devices``) devices of ``device``'s
    type: the visible cards, or ``CPU_SHARDS`` shards of the CPU. Asking for
    more than there are raises, and so does ``"cuda"`` without a card."""
    kind = resolve_device(device).type
    if kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * CPU_SHARDS
    else:
        raise ValueError(f"no mesh of {kind!r} devices")
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape) if shape is not None else (len(devs),)),
                tuple(axis_names))


class ShardedTensor:
    """A batch split along its leading axis: ``shards[i]`` lies on
    ``devices[i]``. A global batch (``parallel/distributed.py:global_batch``)
    is one process's part of a batch over a process group (``in_group``):
    ``offset`` is the global row of its first row and ``global_rows`` the
    rows of all processes."""

    def __init__(self, shards, devices, mesh: Mesh, offset: int = 0,
                 global_rows: Optional[int] = None, in_group: bool = False):
        self.shards = tuple(shards)
        self.devices = list(devices)
        self.mesh = mesh
        self.offset = offset
        self.local_rows = sum(int(s.shape[0]) for s in self.shards)
        self.global_rows = self.local_rows if global_rows is None else global_rows
        self.in_group = in_group

    @property
    def shape(self):
        return (self.global_rows,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def distributed(self) -> bool:
        return self.global_rows != self.local_rows

    def gather(self, device=None) -> torch.Tensor:
        """This process's rows in order, as one tensor on ``device`` (the
        first shard's by default)."""
        device = self.devices[0] if device is None else device
        return torch.cat([s.to(device) for s in self.shards])

    def __array__(self, dtype=None, copy=None):
        if self.distributed:
            raise RuntimeError("a batch spread over processes has no host array "
                               "in one process; gather it first")
        a = self.gather("cpu").numpy()
        return a if dtype is None else a.astype(dtype)


class Replicated(NamedTuple):
    """A full copy of one tensor on every device of a mesh."""
    copies: tuple
    mesh: Mesh


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.array(x))


def split_rows(x: torch.Tensor, devices: list) -> list:
    """``x``'s leading axis in len(devices) equal pieces, each on its device;
    an axis the shard count does not divide is refused."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"the batch's leading dimension {x.shape[0]} (shape "
                         f"{tuple(x.shape)}) is not divisible by the mesh's "
                         f"{n} shards")
    return [part.to(d) for part, d in zip(x.chunk(n) if x.shape[0] else
                                          [x] * n, devices)]


def shard_batch(tree, mesh: Mesh, axis: str = "dp"):
    """Every array of a pytree (tensors, numpy, tuples, NamedTuples, dicts)
    as a ShardedTensor with its leading axis split over ``axis``."""
    devs = mesh.shard_devices(axis)

    def put(x):
        if isinstance(x, ShardedTensor):
            return x
        return ShardedTensor(split_rows(_as_tensor(x), devs), devs, mesh)

    return _tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    """Every array of a pytree copied to each device of the mesh."""
    def put(x):
        x = _as_tensor(x)
        return Replicated(tuple(x.to(d) for d in mesh.devices.flat), mesh)

    return _tree_map(put, tree)


def on_device(obj, device):
    """``obj`` (a set-up NMPC, MHE, model or filter) with its constants on
    ``device``: itself where it was set up there, else a copy set up there
    with the same arguments, kept on ``obj`` until ``obj`` is set up again."""
    device = _norm(device)
    if not obj.is_setup() or _norm(obj._device) == device:
        return obj
    call = obj._setup_call
    cache = obj.__dict__.setdefault("_replicas", {})
    hit = cache.get(device)
    if hit is None or hit[0] is not call:
        hit = cache[device] = (call, replica_on(obj, device))
    return hit[1]


def replica_on(obj, device):
    """A copy of a set-up object, set up again on ``device`` with the
    arguments of its last ``setup`` call."""
    rep = copy.copy(obj)
    rep._replicas = {}
    args, kwargs = obj._setup_call
    rep.setup(*args, **{**kwargs, "device": device})
    return rep


def run_shards(fn, n: int, devices: list):
    """[fn(i) for i in range(n)]; shards on distinct cards run in threads
    of their own so that the cards work at once (every kernel launch enters
    its input's device and stream)."""
    distinct = len({str(d) for d in devices}) == n and n > 1
    if not distinct or devices[0].type != "cuda":
        return [fn(i) for i in range(n)]
    # the solver saves and restores the TF32 flags around each solve: off
    # here for all threads at once, so no thread restores another's
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def run(i):
        with torch.cuda.device(devices[i]):
            return fn(i)

    try:
        with ThreadPoolExecutor(n) as pool:
            return list(pool.map(run, range(n)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def map_shards(fn, args, like: ShardedTensor):
    """fn(shard's args..., device) on every shard: a NamedTuple (or tuple)
    of per-shard outputs regrouped as ShardedTensors like ``like``."""
    outs = run_shards(lambda i: fn(*[a.shards[i] for a in args], like.devices[i]),
                      len(like.shards), like.devices)
    return type(outs[0])(*(regroup(parts, like) for parts in zip(*outs)))


def regroup(parts, like: ShardedTensor) -> ShardedTensor:
    """Per-shard results as a ShardedTensor laid out like ``like``."""
    return ShardedTensor(parts, like.devices, like.mesh, like.offset, like.global_rows,
                         like.in_group)


def _local_columns(v):
    return list(v.shards) if isinstance(v, ShardedTensor) else [v]


def _median(col):
    """``jnp.median`` of a column: the mean of the two middle values of an
    even-sized set ((lo + hi)·0.5), NaN if any entry is NaN."""
    if bool(torch.isnan(col).any()):
        return col.new_full((), float("nan"))
    s = torch.sort(col).values
    k = s.shape[0]
    return (s[(k - 1) // 2] + s[k // 2]) * 0.5


def batch_stats(solution) -> dict:
    """Scalar statistics of a batched OCPSolution (tensors, or
    ShardedTensors from ``sharded_solve_fn``/``global_batch``), as 0-d
    tensors on the first shard's device, with JAX's dtypes under x64: each shard is
    reduced where it lies, the partial counts and extrema combined (across
    the process group by all-reduce), the per-scenario columns gathered
    for the medians."""
    conv = _local_columns(solution.converged)
    iters = _local_columns(solution.iterations)
    kkt = _local_columns(solution.kkt_error)
    dev = conv[0].device
    n = sum(int(c.numel()) for c in conv)
    n_conv = torch.stack([c.sum().to(dev) for c in conv]).sum()
    it_max = torch.stack([i.max().to(dev) for i in iters]).max()
    kkt_max = torch.stack([k.max().to(dev) for k in kkt]).max()
    it_col = torch.cat([i.to(dev) for i in iters]).to(torch.float32)
    kkt_col = torch.cat([k.to(dev) for k in kkt])
    if isinstance(solution.converged, ShardedTensor) and solution.converged.in_group:
        from .distributed import all_gather_rows, all_reduce
        n = solution.converged.global_rows
        n_conv = all_reduce(n_conv, "sum")
        it_max = all_reduce(it_max, "max")
        kkt_max = all_reduce(kkt_max, "max")
        it_col, kkt_col = all_gather_rows(it_col), all_gather_rows(kkt_col)
    f32 = torch.float32
    return {
        "n": torch.tensor(n, dtype=torch.int32, device=dev),
        # jnp.sum of int32 under x64 (the JAX tests' setting) is int64
        "n_converged": n_conv,
        "rate": n_conv.to(f32) / torch.tensor(n, dtype=f32, device=dev),
        "iterations_p50": _median(it_col),
        "iterations_max": it_max,
        "kkt_p50": _median(kkt_col),
        "kkt_max": kkt_max,
    }


def sharded_solve_fn(nmpc, mesh: Mesh, axis: str = "dp", *, with_stats: bool = False):
    """fn(theta_B, xs0_B, X_B, U_B) -> OCPSolution of ShardedTensors: each
    shard's scenarios solved by ``solve_ocp`` on its own device (the
    general path, as the JAX function, whatever ``pallas_full`` says).
    Inputs are ShardedTensors from ``shard_batch`` or whole arrays, which
    are split here. With ``with_stats=True`` fn returns (solution,
    ``batch_stats(solution)``). JAX's ``donate`` (a buffer option) has no
    counterpart."""
    from ..ops.ip_solver import solve_ocp

    if not nmpc.is_setup():
        raise RuntimeError("nmpc must be set up")
    opts = dataclasses.replace(nmpc._ip_opts, record_iterates=False)

    def solve_shard(theta, xs0, X, U, device):
        ctrl = on_device(nmpc, device)
        return solve_ocp(ctrl._funcs, ctrl._dims, ctrl._bounds, theta, xs0, X, U,
                         options=opts, fix_x0=True)

    def solve_many(theta_B, xs0_B, X_B, U_B):
        args = [shard_batch(a, mesh, axis) for a in (theta_B, xs0_B, X_B, U_B)]
        sol = map_shards(solve_shard, args, args[1])
        return (sol, batch_stats(sol)) if with_stats else sol

    return solve_many


def _host(v):
    if isinstance(v, ShardedTensor):
        return np.asarray(v)
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def convergence_stats(solution) -> dict:
    """Host-side reduction of a batched OCPSolution into summary
    statistics (numpy medians and extrema)."""
    conv = _host(solution.converged)
    return {
        "n": int(conv.size),
        "n_converged": int(conv.sum()),
        "rate": float(conv.mean()),
        "iterations_p50": float(np.median(_host(solution.iterations))),
        "iterations_max": int(np.max(_host(solution.iterations))),
        "kkt_p50": float(np.median(_host(solution.kkt_error))),
        "kkt_max": float(np.max(_host(solution.kkt_error))),
    }
