"""Carry solver state between the JAX package and this port.

``to_torch`` maps NamedTuples of arrays (the JAX side's ``OCPBounds``,
``OCPSolution``, ``LQSolution``, and the ``(theta_B, xs0_B, X_B, U_B)`` tuple
from ``NMPC.prepare_batch``) onto this package's NamedTuples of tensors;
``to_numpy`` maps them back to NamedTuples of numpy arrays. NamedTuples are
matched by class name. Anything numpy can convert is accepted as an array, so
this module needs no JAX: a test hands both solvers identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.ip_solver import OCPBounds, OCPSolution
from ..ops.riccati import LQSolution

_PORT_TYPES = {cls.__name__: cls for cls in (OCPBounds, OCPSolution, LQSolution)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cpu", dtype=torch.float64):
    """Arrays -> tensors on ``device``; floating arrays are cast to ``dtype``,
    integer and boolean arrays keep their type."""
    if _is_namedtuple(tree):
        cls = _PORT_TYPES.get(type(tree).__name__, type(tree))
        return cls(*[to_torch(v, device, dtype) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    if tree is None:
        return None
    arr = np.asarray(tree)
    t = torch.as_tensor(arr.copy(), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def to_numpy(tree):
    """Tensors -> numpy arrays, keeping NamedTuple and tuple structure."""
    if _is_namedtuple(tree):
        return type(tree)(*[to_numpy(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree
