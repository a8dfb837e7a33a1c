"""Cross-instance registry of what a controller's setup builds.

PyTorch port of ``hilo_mpc_tpu/utils/trace_cache.py``. PyTorch runs
eagerly, so there is no solver trace to share as in JAX; what a ``setup()``
of the port builds per configuration and later calls reuse is: the
canonical ``OCPFunctions``/``OCPDims``/``IPOptions`` objects, and, keyed on
them, the whole-solve route's gate result, its emitted problem and loaded
entry points (``NMPC._whole_ip_cache``: the ``torch.fx`` trace of the
problem functions, the C++ emission and the library load), and the lazily
built objects of the RTI and batch sites (``"sites"``). Same-configuration
instances adopt the canonical objects, so a second controller of a
configuration skips that work. An entry's key is the configuration's
exhaustive signature (control/nmpc.py:``NMPC._trace_signature``,
estimation/mhe.py): everything baked into the problem functions, as in
JAX, plus the port's device and dtype.

Configurations that embed per-instance callables (generic costs and
constraints from fresh lambdas, models given as callables) key on the id of
the exact function object: the same object shares, a behaviorally identical
fresh lambda does not. Each entry's ``keep`` list pins every object whose
id() appears in its key so ids cannot be recycled. Signatures are taken at
setup() time; changing costs or constraints afterwards needs a new setup()
call (the documented contract).
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

_TRACE_REGISTRY: OrderedDict = OrderedDict()
# LRU bound: an entry pins its emitted problems and loaded libraries, so a
# long-lived process constructing many DISTINCT configurations (a test run,
# a sweep script) would otherwise grow without bound
_MAX_ENTRIES = int(os.environ.get("HILO_TRACE_REGISTRY_MAX", "256"))


def clear_trace_registry() -> None:
    """Drop every shared configuration."""
    _TRACE_REGISTRY.clear()


def trace_registry_stats() -> dict:
    """{'entries': #configurations, 'sites': #lazily shared sites}."""
    return {"entries": len(_TRACE_REGISTRY),
            "sites": sum(len(e["sites"]) for e in _TRACE_REGISTRY.values())}


def registry_lookup(sig):
    if sig is None:
        return None
    ent = _TRACE_REGISTRY.get(sig)
    if ent is not None:
        _TRACE_REGISTRY.move_to_end(sig)
    return ent


def registry_store(sig, entry: dict):
    entry.setdefault("sites", {})
    _TRACE_REGISTRY[sig] = entry
    _TRACE_REGISTRY.move_to_end(sig)
    while len(_TRACE_REGISTRY) > _MAX_ENTRIES:
        _TRACE_REGISTRY.popitem(last=False)
    return entry


def arr_key(a):
    """Hashable content key for an array-like (None passes through)."""
    if a is None:
        return None
    a = np.asarray(a)
    return (str(a.dtype), a.shape, a.tobytes())
