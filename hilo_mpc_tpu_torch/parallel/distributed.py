"""More than one process: a ``torch.distributed`` group and global batches.

PyTorch port of ``hilo_mpc_tpu/parallel/distributed.py``. One process runs
per host (or per card); ``initialize()`` wires them into one process group
(NCCL for CUDA, gloo for the CPU). Torch has no global array: a global
batch is each process's local rows as a ``ShardedTensor`` (split over this
process's mesh) that knows its global offset and the global row count, and
``batch_stats`` on it all-reduces the counts and extrema over the group
and all-gathers the per-scenario columns for the medians, so every process
gets the global figures without any process holding the whole batch.

Typical launch (the same program in every process; torchrun sets the
environment variables, and LOCAL_RANK gives each process its own cards):

    from hilo_mpc_tpu_torch.parallel import distributed as dist
    dist.initialize()          # MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE
    mesh = dist.global_mesh()
    theta = dist.global_batch(theta_local, mesh)
    ...
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..core.model import resolve_device
from .sharding import Mesh, ShardedTensor, _tree_map, make_mesh, split_rows

# the device of this process's collectives and its mesh devices' type
_state: dict = {}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device="cuda", timeout_s: float = 300.0) -> bool:
    """Join (or create) the process group; idempotent. Returns whether
    more than one process runs.

    ``coordinator_address`` "host:port" of rank 0's store (a loopback
    address for processes of one host), ``num_processes`` the world size,
    ``process_id`` this process's rank; each defaults to torch's own
    environment variables (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK).
    With none of them given nor set, nothing is set up and the call
    returns False. ``device`` "cuda" takes NCCL on this process's cards
    (``local_card_ids``; the first carries the collectives), "cpu" takes
    gloo (``local_device_ids`` then counts the CPU shards of this
    process's mesh). A CUDA group without a card raises: nothing falls
    back to the CPU."""
    if in_group():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator address, the process "
                         "count and this process's id (MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    kind = resolve_device(device).type
    if kind == "cuda":
        ids = local_card_ids(local_device_ids)
        comm = torch.device("cuda", ids[0])
        torch.cuda.set_device(comm)
        backend = "nccl"
    else:
        ids = list(local_device_ids) if local_device_ids is not None else None
        comm = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(kind=kind, ids=ids, comm=comm)
    return dist.get_world_size() > 1


def local_card_ids(local_device_ids: Optional[Sequence[int]] = None) -> list:
    """This process's cards: ``local_device_ids`` if given; else, under a
    launcher that sets LOCAL_RANK (torchrun: one process per card), card
    LOCAL_RANK; else every visible card. An id outside the visible cards
    raises."""
    count = torch.cuda.device_count()
    if local_device_ids is not None:
        ids = list(local_device_ids)
    elif os.environ.get("LOCAL_RANK"):
        ids = [int(os.environ["LOCAL_RANK"])]
    else:
        ids = list(range(count))
    if not ids or min(ids) < 0 or max(ids) >= count:
        raise ValueError(f"cards {ids} for this process, but {count} visible")
    return ids


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def process_index() -> int:
    return dist.get_rank() if in_group() else 0


def is_multi_process() -> bool:
    return process_count() > 1


def global_mesh(axis_names: Sequence[str] = ("dp",),
                shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """This process's part of the mesh over every process's devices (its
    cards, or its CPU shards), with the group's process count. ``device``
    defaults to the group's device type, "cuda" without a group."""
    kind = resolve_device(device or _state.get("kind", "cuda")).type
    ids = _state.get("ids") if kind == _state.get("kind") else None
    arr = make_mesh(None if ids is None else len(ids), device=kind).devices
    if kind == "cuda" and ids is not None:
        arr[:] = [torch.device("cuda", i) for i in ids]
    return Mesh(arr.reshape(tuple(shape) if shape is not None else (arr.size,)),
                tuple(axis_names), process_count())


def _comm_device(like: torch.Tensor) -> torch.device:
    return _state.get("comm", like.device) if in_group() else like.device


def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """A 0-d tensor reduced over the group ("sum" or "max"; a NaN anywhere
    makes the max NaN, as ``jnp.max``), back on ``t``'s device. Outside a
    group, ``t``."""
    if not in_group():
        return t
    x = t.detach().reshape(1).to(_comm_device(t)).clone()
    if op == "sum":
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x.reshape(()).to(t.device)
    nan = torch.isnan(x).to(torch.int64) if x.is_floating_point() else None
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    if nan is not None:
        dist.all_reduce(nan, op=dist.ReduceOp.SUM)
        x = torch.where(nan > 0, float("nan"), x)
    return x.reshape(()).to(t.device)


def all_gather_rows(col: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``col`` in rank order (sizes may differ),
    on ``col``'s device. Outside a group, ``col``."""
    if not in_group():
        return col
    dev = _comm_device(col)
    n = process_count()
    size = torch.tensor([col.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    pad = col.new_zeros((max(sizes),) + tuple(col.shape[1:]), device=dev)
    pad[:col.shape[0]] = col.to(dev)
    parts = [torch.zeros_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad)
    return torch.cat([p[:k] for p, k in zip(parts, sizes)]).to(col.device)


def global_batch(local_tree, mesh: Mesh, axis: str = "dp"):
    """Each process's local rows (leading dim B_local) as ShardedTensors of
    the global batch: split over this process's mesh, with the global
    offset of its first row and the global row count (every process's
    B_local summed over the group)."""
    devs = mesh.shard_devices(axis)

    def put(x):
        x = x if torch.is_tensor(x) else torch.as_tensor(x)
        counts = all_gather_rows(torch.tensor([x.shape[0]], dtype=torch.int64))
        i = process_index()
        return ShardedTensor(split_rows(x, devs), devs, mesh, offset=int(counts[:i].sum()),
                             global_rows=int(counts.sum()), in_group=in_group())

    return _tree_map(put, local_tree)


def local_slice(B_global: int) -> slice:
    """This process's slice of a globally-batched scenario set."""
    n = process_count()
    if B_global % n:
        raise ValueError(f"global batch {B_global} not divisible by "
                         f"{n} processes")
    per = B_global // n
    i = process_index()
    return slice(i * per, (i + 1) * per)
