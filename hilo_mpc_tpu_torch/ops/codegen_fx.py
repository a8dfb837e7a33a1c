"""Emit C++ for the whole-solve kernel from a ``torch.fx`` trace of the problem.

Counterpart of ``_scalarized`` and the ``*_lane`` helpers of
``hilo_mpc_tpu/ops/pallas_ip.py`` (lines 215-322): the JAX kernel traces the
problem functions ``funcs.dyn``, ``funcs.stage_cost`` and ``funcs.term_cost``
into a jaxpr, replays it inside the kernel with its constants rebuilt there,
and differentiates it with ``jax.linearize`` and the ``jvp`` of ``jax.grad``.
Here the same three functions (``ops/ip_solver.py:OCPFunctions``, batch-first)
are traced with ``make_fx`` on one probe scenario, x (1, nx), u (1, nu),
theta (1, n_theta), on the device and in the dtype of the functions'
closures (a controller's own), and each graph is written as scalar C++:

- the whole integrated, scaled and theta-unpacked step is traced, not the
  user's bare callable, so the Δu augmentation, the path parameter's
  dynamics, time-varying parameters and the solver scaling come with it, as
  the JAX kernel takes ``funcs.dyn`` as it is; likewise the costs bring the
  quadratic terms, generic costs, measurement terms, soft penalties, path
  references and the h/dt factor;
- every tensor of the graph has a static shape (one scenario), so each one
  becomes an array of scalars: a view (select, slice, stack, expand, ...)
  only rearranges them, and an elementwise op, reduction or product emits
  one C++ statement per element into a function template over the plain
  type ``T`` and the active scalar type ``S`` (``T`` or the dual numbers of
  ``csrc/dual.cuh``); values that do not depend on (x, u) stay ``T``;
- numbers go into ``prm``: every floating-point constant tensor (weights,
  references, scalings, bounds) element by element and every Python float
  in the graph, one slot each, so controllers that differ only in numbers
  share one build; integer constants, exponents and shapes are structure
  and go into the source;
- ``csrc/traced.cuh`` takes the costs' gradients and Hessians by dual
  numbers through the emitted cost functions (forward over forward); F and
  [A | B] come from the kernel's own dual pass through ``dyn``
  (``csrc/whole_ip.cuh``). ``CROSS`` is set where the cost graph couples x
  and u (a product, quotient or nonlinear function of both), by a
  dependency pass over the graph.

The functions are functionalized first (``torch.func.functionalize``), so an
in-place write in a user callable becomes a scatter. An op outside the table
(``OPS``) raises ``NotImplementedError`` naming the op; a branch on a value
(``_local_scalar_dense``, as JAX's tracer refuses it) likewise. The trace is
taken when the problem is emitted: closure constants are read then, as
JAX's ``jit`` reads them at trace time.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .codegen_cuda import (_IP_FIELDS, EmittedProblem, _check_dims,
                           _emit_dyn, _includes, _Prm, _rows, _solver_flops,
                           _step_ops, _struct_head, newton_size, whole_ip_region)

class _V:
    """One scalar of the trace: its C++ (an expression or a name), its kind
    ('S' depends on x or u, 'T' plain, 'B' a flag), a structural literal's
    value (``lit``), the inputs it depends on (``dep``) and the input pairs
    its second derivative can couple (``hp``)."""
    __slots__ = ("code", "kind", "lit", "dep", "hp")

    def __init__(self, code, kind, lit=None, dep=frozenset(), hp=frozenset()):
        self.code, self.kind, self.lit, self.dep, self.hp = code, kind, lit, dep, hp


def _literal(v) -> _V:
    """A structural constant in the source: a bool or an integer-valued
    number (zeros, ones, an integer in the graph)."""
    if isinstance(v, (bool, np.bool_)):
        return _V("true" if v else "false", "B", lit=bool(v))
    v = float(v)
    if math.isinf(v):
        return _V("hm::m_inf<T>()" if v > 0 else "(-hm::m_inf<T>())", "T", lit=v)
    if math.isnan(v):
        raise NotImplementedError("a NaN literal in the trace cannot be emitted")
    return _V(f"T({v!r})", "T", lit=v)


# the zeros of aten._efficientzerotensor: the tangents a traced jvp knows to
# be zero
_ZERO_TANGENT = _literal(0.0)


def _pairs(a, b):
    return frozenset((min(i, j), max(i, j)) for i in a for j in b)


class _Fn:
    """The C++ body of one traced function: statements over S, T and bool."""

    def __init__(self, prm: _Prm):
        self.prm = prm
        self.lines = []
        # per statement: (kind, a function call, |dep|, |hp|), for the count
        self.work = []
        self._cse = {}

    def number(self, v) -> _V:
        """A number of the problem: a slot of prm."""
        return _V(f"prm[{self.prm.add(v)}]", "T")

    def scalar(self, v) -> _V:
        """A Python scalar argument: a float is a number, an int or bool
        structure."""
        if isinstance(v, (bool, int, np.integer, np.bool_)):
            return _literal(v)
        if isinstance(v, (float, np.floating)):
            return self.number(float(v))
        raise NotImplementedError(f"argument {v!r} of type {type(v).__name__}")

    def emit(self, kind, expr, dep=frozenset(), hp=frozenset(), call=False) -> _V:
        key = (kind, expr)
        if key in self._cse:
            return self._cse[key]
        name = f"v{len(self.lines)}"
        ctype = {"S": "S", "T": "T", "B": "bool"}[kind]
        self.lines.append(f"    const {ctype} {name} = {expr};")
        self.work.append((kind, call, len(dep), len(hp)))
        v = self._cse[key] = _V(name, kind, dep=dep, hp=hp)
        return v

    # -- scalar operations -------------------------------------------------
    @staticmethod
    def _kind(*vs):
        return "S" if any(v.kind == "S" for v in vs) else "T"

    def add(self, a, b):
        if a.lit == 0.0:
            return b
        if b.lit == 0.0:
            return a
        return self.emit(self._kind(a, b), f"({a.code} + {b.code})", a.dep | b.dep,
                         a.hp | b.hp)

    def sub(self, a, b):
        if b.lit == 0.0:
            return a
        return self.emit(self._kind(a, b), f"({a.code} - {b.code})", a.dep | b.dep,
                         a.hp | b.hp)

    def mul(self, a, b):
        # a product with a structural one is the other factor; one with a
        # zero tangent is a zero tangent, as PyTorch multiplies its zero
        # tensors (whatever the other factor, inf and NaN too)
        for x, y in ((a, b), (b, a)):
            if x.lit == 1.0:
                return y
            if x is _ZERO_TANGENT:
                return x
        return self.emit(self._kind(a, b), f"({a.code} * {b.code})", a.dep | b.dep,
                         a.hp | b.hp | _pairs(a.dep, b.dep))

    def div(self, a, b):
        if b.lit == 1.0:
            return a
        return self.emit(self._kind(a, b), f"({a.code} / {b.code})", a.dep | b.dep,
                         a.hp | b.hp | _pairs(a.dep | b.dep, b.dep))

    def neg(self, a):
        return self.emit(a.kind, f"(-{a.code})", a.dep, a.hp)

    def func(self, name, *args, linear=False, flat=False):
        """hm::name(args): ``linear`` piecewise linear (abs, min, max),
        ``flat`` a zero derivative (sign, floor, ceil)."""
        dep = frozenset().union(*(a.dep for a in args))
        if flat:
            dep, hp = frozenset(), frozenset()
        elif linear:
            hp = frozenset().union(*(a.hp for a in args))
        else:
            hp = frozenset().union(*(a.hp for a in args)) | _pairs(dep, dep)
        code = ", ".join(a.code for a in args)
        return self.emit(self._kind(*args), f"hm::{name}({code})", dep, hp, call=True)

    def pow(self, a, c):
        """a ** c for a structural exponent c, as torch.pow computes it."""
        if c == 1.0:
            return a
        if c == 0.0:
            return _literal(1.0)
        if c == 2.0:
            return self.emit(a.kind, f"hm::m_sq({a.code})", a.dep,
                             a.hp | _pairs(a.dep, a.dep))
        if c == 0.5:
            return self.func("m_sqrt", a)
        return self.func("m_pow", a, _literal(c))

    def compare(self, op, a, b):
        return self.emit("B", f"(hm::plain({a.code}) {op} hm::plain({b.code}))")

    def where(self, c, a, b):
        if c.lit is not None:
            return a if c.lit else b
        kind = self._kind(a, b)
        return self.emit(kind, f"({c.code} ? {kind}({a.code}) : {kind}({b.code}))",
                         a.dep | b.dep, a.hp | b.hp)

    def logical(self, op, a, b=None):
        if op == "not":
            return self.emit("B", f"(!{a.code})")
        return self.emit("B", f"({a.code} {op} {b.code})")


# unary aten op -> (function of csrc/dual.cuh, 'linear' / 'flat' / None)
_UNARY = {
    "exp": ("m_exp", None), "log": ("m_log", None), "log10": ("m_log10", None),
    "sqrt": ("m_sqrt", None), "sin": ("m_sin", None), "cos": ("m_cos", None),
    "tan": ("m_tan", None), "asin": ("m_asin", None), "acos": ("m_acos", None),
    "atan": ("m_atan", None), "sinh": ("m_sinh", None), "cosh": ("m_cosh", None),
    "tanh": ("m_tanh", None), "asinh": ("m_asinh", None), "acosh": ("m_acosh", None),
    "atanh": ("m_atanh", None), "abs": ("m_abs", "linear"), "sign": ("m_sign", "flat"),
    "floor": ("m_floor", "flat"), "ceil": ("m_ceil", "flat"), "erf": ("m_erf", None),
}
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}
# views, copies and creations: the scalars rearranged or made, no code
_VIEWS = {"alias", "clone", "detach", "lift_fresh", "_to_copy", "select", "slice",
          "unsqueeze", "squeeze", "expand", "view", "_unsafe_view", "permute", "t",
          "transpose", "copy", "select_scatter", "slice_scatter", "stack", "cat",
          "zeros", "zeros_like", "new_zeros", "_efficientzerotensor", "ones",
          "ones_like", "new_ones", "full", "full_like", "new_full", "eye", "triu",
          "tril", "scalar_tensor"}
_LOGICAL = {"logical_not": "not", "bitwise_not": "not", "logical_and": "&&",
            "bitwise_and": "&&", "logical_or": "||", "bitwise_or": "||"}
_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "pow", "maximum", "minimum",
          "atan2", "where", "sum", "mean", "mm", "bmm", "mv", "dot", "addmm",
          "reciprocal", "rsqrt", "linalg_solve_triangular"}
# every aten op the emitter takes (the functionalized graph names views
# "<view>_copy"): what the model and costs of
# tests/test_torch_whole_ip_traced.py trace to, and what the SMPC surrogate
# adds (control/smpc.py: the GP variance's triangular solve, and the zeros,
# views, identity and triangle that make_fx writes for the mean step's
# nested jvp), each op in its general form
OPS = frozenset(_VIEWS | _ARITH | set(_LOGICAL) | set(_UNARY) | set(_COMPARE))


def _op_name(target) -> str:
    name = target._schema.name.split("::")[-1]
    if name.endswith("_copy") and name[:-5] in _VIEWS:
        name = name[:-5]
    return name


def _full(shape, v: _V):
    a = np.empty(tuple(shape), dtype=object)
    a.fill(v)
    return a


class _Interp:
    """Runs one graph over arrays of _V, emitting into a _Fn."""

    def __init__(self, gm, fn: _Fn):
        self.gm, self.fn = gm, fn

    def run(self, inputs):
        env = {}
        it = iter(inputs)
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(it)
            elif node.op == "get_attr":
                env[node] = self.constant(getattr(self.gm, node.target))
            elif node.op == "call_function":
                if not isinstance(node.target, torch._ops.OpOverload):
                    raise NotImplementedError(f"{node.target} cannot be emitted as C++")
                args = torch.fx.node.map_arg(node.args, lambda n: env[n])
                kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
                env[node] = self.call(node.target, args, kwargs, node)
            elif node.op == "output":
                return torch.fx.node.map_arg(node.args[0], lambda n: env[n])
            else:
                raise NotImplementedError(f"fx node {node.op} cannot be emitted")
        raise NotImplementedError("the trace has no output")

    def constant(self, t):
        t = t.detach().cpu()
        if t.is_floating_point():
            flat = [self.fn.number(float(v)) for v in t.double().reshape(-1).tolist()]
        elif not t.is_complex():
            flat = [_literal(v) for v in t.reshape(-1).tolist()]
        else:
            raise NotImplementedError(f"a {t.dtype} constant in the trace")
        a = np.empty(len(flat), dtype=object)
        a[:] = flat
        return a.reshape(tuple(t.shape))

    def arr(self, v):
        """An operand as an array of _V (a Python scalar as a 0-d one)."""
        if isinstance(v, np.ndarray):
            return v
        return _full((), self.fn.scalar(v))

    def elementwise(self, f, *operands):
        arrs = np.broadcast_arrays(*[self.arr(o) for o in operands])
        out = np.empty(arrs[0].shape, dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = f(*(a[idx] for a in arrs))
        return out

    def call(self, target, args, kw, node):
        name = _op_name(target)
        if name not in OPS:
            raise NotImplementedError(
                f"the op {target} is not in the whole-solve emitter's table "
                f"(ops/codegen_fx.py:OPS)")
        fn = self.fn
        a = args[0] if args else None
        if name in ("alias", "clone", "lift_fresh"):
            return a
        if name == "_to_copy":
            # a device move, a cast of a value that does not depend on (x, u)
            # (prm and theta reach the kernel in its own type), or a widening
            # cast: the kernel computes all of them in its type. A narrowing
            # cast of a value that depends on (x, u) marks a part computed
            # wider than the controller (a float64 GP under a float32
            # controller), which a build in the controller's type cannot
            # compute: it declines
            src, dst = node.args[0].meta["val"].dtype, node.meta["val"].dtype
            if not dst.is_floating_point or (
                    src.is_floating_point and torch.finfo(dst).bits < torch.finfo(src).bits
                    and any(v.kind == "S" for v in a.reshape(-1))):
                raise NotImplementedError(
                    f"{target} to {dst} of a value that depends on x or u")
            return a
        if name == "detach":
            if any(v.kind == "S" for v in a.reshape(-1)):
                raise NotImplementedError(
                    f"{target} of a value that depends on x or u (its derivative "
                    f"is cut)")
            return a
        if name == "select":
            return np.take(a, args[2], axis=args[1])
        if name == "slice":
            dim = args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            idx = [slice(None)] * a.ndim
            idx[dim] = slice(start, end, step)
            return a[tuple(idx)]
        if name == "unsqueeze":
            dim = args[1] if args[1] >= 0 else args[1] + a.ndim + 1
            return np.expand_dims(a, dim)
        if name == "squeeze":
            dims = (range(a.ndim) if len(args) == 1 else
                    [args[1]] if isinstance(args[1], int) else args[1])
            dims = [d % a.ndim for d in dims] if a.ndim else []
            keep = [i for i in range(a.ndim) if not (i in dims and a.shape[i] == 1)]
            return a.reshape([a.shape[i] for i in keep])
        if name == "expand":
            size = [s if s != -1 else a.shape[i - (len(args[1]) - a.ndim)]
                    for i, s in enumerate(args[1])]
            return np.broadcast_to(a, size)
        if name == "view":
            return np.ascontiguousarray(a).reshape(args[1])
        if name == "permute":
            return np.transpose(a, args[1])
        if name == "t":
            return a.T
        if name == "transpose":
            return np.swapaxes(a, args[1], args[2])
        if name == "stack":
            dim = args[1] if len(args) > 1 else 0
            return np.stack(args[0], axis=dim)
        if name == "cat":
            dim = args[1] if len(args) > 1 else 0
            parts = [p for p in args[0] if not (p.ndim == 1 and p.shape[0] == 0)]
            return np.concatenate(parts, axis=dim) if parts else args[0][0]
        if name == "copy":
            return np.broadcast_to(args[1], a.shape).copy()
        if name == "select_scatter":
            out = a.copy()
            idx = [slice(None)] * a.ndim
            idx[args[2]] = args[3]
            out[tuple(idx)] = args[1]
            return out
        if name == "slice_scatter":
            out = a.copy()
            dim = args[2] if len(args) > 2 else kw.get("dim", 0)
            start = args[3] if len(args) > 3 else kw.get("start")
            end = args[4] if len(args) > 4 else kw.get("end")
            step = args[5] if len(args) > 5 else kw.get("step", 1)
            idx = [slice(None)] * a.ndim
            idx[dim] = slice(start, end, step)
            out[tuple(idx)] = args[1]
            return out
        if name in ("zeros", "new_zeros", "zeros_like", "ones", "new_ones", "ones_like"):
            shape = (a.shape if name.endswith("_like") else
                     args[1] if name.startswith("new_") else a)
            return _full(shape, _literal(0.0 if "zeros" in name else 1.0))
        if name in ("full", "new_full", "full_like"):
            shape = (a.shape if name == "full_like" else args[1] if name == "new_full"
                     else a)
            return _full(shape, fn.scalar(args[-1]))
        if name == "_unsafe_view":
            return np.ascontiguousarray(a).reshape(args[1])
        if name == "_efficientzerotensor":
            return _full(a, _ZERO_TANGENT)
        if name == "eye":
            n = a
            m = args[1] if len(args) > 1 else n
            out = _full((n, m), _literal(0.0))
            for i in range(min(n, m)):
                out[i, i] = _literal(1.0)
            return out
        if name in ("triu", "tril"):
            # the elements on and above (below) the diagonal-th diagonal
            diag = args[1] if len(args) > 1 else kw.get("diagonal", 0)
            out = a.copy()
            for idx in np.ndindex(a.shape):
                i, j = idx[-2], idx[-1]
                if (j - i < diag) if name == "triu" else (j - i > diag):
                    out[idx] = _literal(0.0)
            return out
        if name == "scalar_tensor":
            # an integer-valued number is structure, any other a number
            v = a
            if not isinstance(v, (bool, np.bool_)) and math.isfinite(float(v)) \
                    and float(v) != int(float(v)):
                return _full((), fn.number(float(v)))
            return _full((), _literal(v))
        return self.arith(name, target, args, kw)

    def arith(self, name, target, args, kw):
        fn = self.fn
        ew = self.elementwise
        if name in ("add", "sub", "rsub"):
            alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
            x, y = args[0], args[1]
            if name == "rsub":
                x, y = y, x
            if alpha != 1:
                al = fn.scalar(alpha)
                y = ew(lambda v: fn.mul(v, al), y)
            return ew(fn.add if name == "add" else fn.sub, x, y)
        if name == "mul":
            return ew(fn.mul, args[0], args[1])
        if name == "div":
            if kw.get("rounding_mode") is not None:
                raise NotImplementedError(f"{target} with a rounding mode")
            return ew(fn.div, args[0], args[1])
        if name == "neg":
            return ew(fn.neg, args[0])
        if name == "reciprocal":
            return ew(lambda v: fn.div(_literal(1.0), v), args[0])
        if name == "rsqrt":
            return ew(lambda v: fn.div(_literal(1.0), fn.func("m_sqrt", v)), args[0])
        if name == "pow":
            base, ex = args[0], args[1]
            if target._overloadname == "Tensor_Scalar":
                return ew(lambda v: fn.pow(v, float(ex)), base)
            return ew(lambda u, v: fn.func("m_pow", u, v), base, ex)
        if name in _UNARY:
            cxx, how = _UNARY[name]
            return ew(lambda v: fn.func(cxx, v, linear=how == "linear",
                                        flat=how == "flat"), args[0])
        if name in ("maximum", "minimum"):
            cxx = "m_fmax" if name == "maximum" else "m_fmin"
            return ew(lambda u, v: fn.func(cxx, u, v, linear=True), args[0], args[1])
        if name == "atan2":
            return ew(lambda u, v: fn.func("m_atan2", u, v), args[0], args[1])
        if name in _COMPARE:
            return ew(lambda u, v: fn.compare(_COMPARE[name], u, v), args[0], args[1])
        if name == "where":
            return ew(fn.where, args[0], args[1], args[2])
        if name in _LOGICAL:
            op = _LOGICAL[name]
            if any(v.kind != "B" for a in args for v in self.arr(a).reshape(-1)):
                raise NotImplementedError(f"{target} on a value that is not a flag")
            if op == "not":
                return ew(lambda v: fn.logical(op, v), args[0])
            return ew(lambda u, v: fn.logical(op, u, v), args[0], args[1])
        if name in ("sum", "mean"):
            a = args[0]
            dims = (args[1] if len(args) > 1 else kw.get("dim")) or list(range(a.ndim))
            dims = [dims] if isinstance(dims, int) else dims
            keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
            dims = sorted(d % a.ndim for d in dims) if a.ndim else []
            count = int(np.prod([a.shape[d] for d in dims])) if dims else 1
            moved = np.moveaxis(a, dims, list(range(a.ndim - len(dims), a.ndim)))
            rest = moved.shape[:a.ndim - len(dims)]
            flat = moved.reshape(rest + (count,))
            out = np.empty(rest, dtype=object)
            for idx in np.ndindex(rest):
                s = _literal(0.0)
                for k in range(count):
                    s = fn.add(s, flat[idx + (k,)])
                out[idx] = s if name == "sum" else fn.div(s, _literal(float(count)))
            if keep:
                for d in dims:
                    out = np.expand_dims(out, d)
            return out
        if name == "linalg_solve_triangular":
            return self.tri_solve(args[0], args[1], kw["upper"], kw.get("left", True),
                                  kw.get("unitriangular", False))
        if name in ("mm", "bmm", "mv", "dot", "addmm"):
            if name == "addmm":
                beta, alpha = kw.get("beta", 1), kw.get("alpha", 1)
                if beta != 1 or alpha != 1:
                    raise NotImplementedError(f"{target} with beta or alpha")
                bias, a, b = args[0], args[1], args[2]
            else:
                bias, a, b = None, args[0], args[1]
            out = self.matmul(a, b)
            return out if bias is None else ew(fn.add, out, bias)
        raise NotImplementedError(f"the op {target} cannot be emitted as C++")

    def tri_solve(self, A, B, upper, left, unit):
        """X of A X = B (``left``) or X A = B for a triangular A (..., n, n)
        and B (..., n, k) or (..., k, n), batch dims broadcast: forward or
        back substitution, one statement per element, each a division by
        the diagonal (none where ``unit``). A may depend on (x, u) too."""
        fn = self.fn
        if not left:                              # X A = B  <=>  Aᵀ Xᵀ = Bᵀ
            return np.swapaxes(self.tri_solve(np.swapaxes(A, -1, -2),
                                              np.swapaxes(B, -1, -2), not upper, True,
                                              unit), -1, -2)
        lead = np.broadcast_shapes(A.shape[:-2], B.shape[:-2])
        A = np.broadcast_to(A, lead + A.shape[-2:])
        B = np.broadcast_to(B, lead + B.shape[-2:])
        n, k = B.shape[-2:]
        out = np.empty(lead + (n, k), dtype=object)
        rows = range(n - 1, -1, -1) if upper else range(n)
        for idx in np.ndindex(lead + (k,)):
            l, c = idx[:-1], idx[-1]
            for i in rows:
                s = B[l + (i, c)]
                for j in (range(i + 1, n) if upper else range(i)):
                    s = fn.sub(s, fn.mul(A[l + (i, j)], out[l + (j, c)]))
                out[l + (i, c)] = s if unit else fn.div(s, A[l + (i, i)])
        return out

    def matmul(self, a, b):
        """a @ b for (m, k) @ (k, n), (B, m, k) @ (B, k, n), (m, k) @ (k,),
        (k,) @ (k,), as sums over k in order."""
        fn = self.fn
        vec_b = b.ndim == 1
        if vec_b:
            b = b[:, None]
        vec_a = a.ndim == 1
        if vec_a:
            a = a[None, :]
        lead = a.shape[:-2]
        out = np.empty(lead + (a.shape[-2], b.shape[-1]), dtype=object)
        for idx in np.ndindex(out.shape):
            *l, i, j = idx
            s = _literal(0.0)
            for k in range(a.shape[-1]):
                s = fn.add(s, fn.mul(a[tuple(l) + (i, k)], b[tuple(l) + (k, j)]))
            out[idx] = s
        if vec_b:
            out = out[..., 0]
        if vec_a:
            out = out[..., 0, :] if not vec_b else out[..., 0]
        return out


def trace(f, *args):
    """``make_fx`` of the functionalized ``f`` on ``args``, its dead nodes
    removed (an output computed and never used, such as the GP variance
    inside the SMPC mean step's Jacobian, writes no code); a branch on a
    value raises NotImplementedError."""
    from torch.fx.experimental.proxy_tensor import make_fx
    g = torch.func.functionalize(f, remove="mutations_and_views")
    try:
        gm = make_fx(g)(*args)
    except RuntimeError as e:
        if "_local_scalar_dense" in str(e):
            raise NotImplementedError(
                "a branch on a value in the problem functions "
                "(aten._local_scalar_dense while tracing)") from e
        raise
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def _inputs(names_kinds, offsets):
    """Arrays of input scalars: (name, kind, width) -> a (1, width) array."""
    out = []
    for (name, kind, n), off in zip(names_kinds, offsets):
        a = np.empty((1, n), dtype=object)
        for i in range(n):
            dep = frozenset((off + i,)) if kind == "S" else frozenset()
            a[0, i] = _V(f"{name}[{i}]", kind, dep=dep)
        out.append(a)
    return out


def _body(gm, fn: _Fn, inputs, out_shape):
    out = _Interp(gm, fn).run(inputs)
    if not isinstance(out, np.ndarray) or out.shape != out_shape:
        raise NotImplementedError(f"a traced output of shape "
                                  f"{getattr(out, 'shape', None)}, expected {out_shape}")
    return out


def _cost_fn(name, args_decl, body: _Fn, out):
    return (f"  template <typename T, typename S>\n"
            f"  HM_HD static S {name}({args_decl}) {{\n"
            + "\n".join(body.lines) + ("\n" if body.lines else "")
            + f"    return S({out.reshape(-1)[0].code});\n  }}\n")


def emit_fx_problem(funcs, dims, bounds, n_theta: int, options) -> EmittedProblem:
    """The problem struct for csrc/whole_ip.cuh from a trace of ``funcs``
    (dyn, stage_cost, term_cost) and its numbers. ``bounds`` are numpy arrays
    (lbx, ubx, lbu, ubu) in solver coordinates; ``options`` the IPOptions
    whose constants go into prm. Raises NotImplementedError naming what
    cannot be traced or emitted."""
    nx, nu, N = dims.nx, dims.nu, dims.N
    if nu == 0:
        raise NotImplementedError("a problem without controls cannot be emitted "
                                  "for the whole-solve kernel")
    src = funcs.source
    kw = (dict(dtype=src.dtype, device=src.device) if src is not None and src.dtype
          else dict(dtype=torch.float64))
    x = torch.zeros(1, nx, **kw)
    u = torch.zeros(1, nu, **kw)
    th = torch.zeros(1, n_theta, **kw)
    # an implicit step (collocation, or a DAE model's algebraic Newton): the
    # model's own functions are traced and wrapped in ops/codegen_cuda.py's
    # step, whose Newton csrc/implicit.cuh runs, with the Δu augmentation and
    # the path parameter around it
    implicit = (src is not None
                and newton_size(src.spec, src.model.n_x, src.model.n_z) > 0)
    if implicit:
        _check_dims(src, nx, nu)
        g_model = _trace_model(src.model, kw)
    else:
        g_dyn = trace(funcs.dyn, x, u, th)
    g_stage = trace(funcs.stage_cost, x, u, th)
    g_term = trace(funcs.term_cost, x, th)

    prm = _Prm()
    for name in _IP_FIELDS:
        prm.add(options.tol / 10.0 if name == "tol10" else getattr(options, name))
    masks, offs, tmask, toffs = _rows(bounds, N, nx, nu)
    p_row = len(prm.vals)
    for v in offs:
        prm.add(v)
    p_trow = len(prm.vals)
    for v in toffs:
        prm.add(v)
    prm.add(0.0)                  # keeps P_ROW and P_TROW inside the array

    spec = [("xs", "S", nx), ("us", "S", nu), ("th", "T", n_theta)]
    f_dyn, f_stage, f_term = _Fn(prm), _Fn(prm), _Fn(prm)
    if implicit:
        dyn_text, model_ops, work = _emit_model_step(src, g_model, prm, nx, nu)
    else:
        out_dyn = _body(g_dyn, f_dyn, _inputs(spec, (0, nx, 0)), (1, nx))
        dyn_text = ("  template <typename T, typename S>\n"
                    "  HM_HD static void fx_dyn(const S* xs, const S* us, const T* th, "
                    "const T* prm, S* out) {\n"
                    + "\n".join(f_dyn.lines) + ("\n" if f_dyn.lines else "")
                    + "\n".join(f"    out[{i}] = S({v.code});"
                                for i, v in enumerate(out_dyn[0])) + "\n  }\n")
    out_stage = _body(g_stage, f_stage, _inputs(spec, (0, nx, 0)), (1,))
    out_term = _body(g_term, f_term, _inputs([spec[0], spec[2]], (0, 0)), (1,))
    hp = out_stage[0].hp
    cross = any(i < nx <= j for i, j in hp)

    stage_text = _cost_fn("fx_stage", "const S* xs, const S* us, const T* th, "
                          "const T* prm", f_stage, out_stage)
    term_text = _cost_fn("fx_term", "const S* xs, const T* th, const T* prm",
                         f_term, out_term)
    region = whole_ip_region(nx, nu, N, n_theta, len(offs), len(toffs))
    head = _struct_head(nx, nu, N, n_theta, masks, len(offs), len(toffs), tmask,
                        cross, p_row, p_trow, region)
    hux = ", T* Hux" if cross else ""
    text = f"""// Generated by hilo_mpc_tpu_torch/ops/codegen_fx.py from a torch.fx trace of
// one NMPC problem, for the whole-solve interior point of csrc/whole_ip.cuh.
#include "traced.cuh"
{_includes(implicit)}
{head}{dyn_text}
{stage_text}
{term_text}
{"" if implicit else _FX_DYN}  template <typename T>
  HM_HD static T stage_cost(const T* xs, const T* us, const T* th,
                            const T* prm) {{
    return fx_stage<T, T>(xs, us, th, prm);
  }}
  template <typename T>
  HM_HD static void stage_grad(const T* xs, const T* us, const T* th,
                               const T* prm, T* gx, T* gu) {{
    hm::traced_stage_grad<T, Problem>(xs, us, th, prm, gx, gu);
  }}
  template <typename T>
  HM_HD static void stage_hess(const T* xs, const T* us, const T* th,
                               const T* prm, T* Hxx, T* Huu{hux}) {{
    hm::traced_stage_hess<T, Problem>(xs, us, th, prm, Hxx, Huu, {"Hux" if cross else "nullptr"});
  }}
  template <typename T>
  HM_HD static T term_cost(const T* xs, const T* th, const T* prm) {{
    return fx_term<T, T>(xs, th, prm);
  }}
  template <typename T>
  HM_HD static void term_grad(const T* xs, const T* th, const T* prm, T* gx) {{
    hm::traced_term_grad<T, Problem>(xs, th, prm, gx);
  }}
  template <typename T>
  HM_HD static void term_hess(const T* xs, const T* th, const T* prm, T* Hxx) {{
    hm::traced_term_hess<T, Problem>(xs, th, prm, Hxx);
  }}
}};

HM_WHOLE_IP_EXPORTS(Problem)
"""
    stage_rows = tuple((k, r) for k, m in enumerate(masks)
                       for r in range(2 * nu + 2 * nx) if (m >> r) & 1)
    term_rows = tuple(t for t in range(2 * nx) if (tmask >> t) & 1)
    dyn_ops = (_step_ops(work, *model_ops, src.model.n_x, nx + nu)
               + (2 * nx + nu) * (1 + nx + nu) if implicit else None)
    flops = _traced_flops(nx, nu, N, len(offs), len(toffs), f_dyn, f_stage, f_term,
                          cross, dyn_ops)
    return EmittedProblem(text=text, prm=np.asarray(prm.vals, np.float64),
                          stage_rows=stage_rows, term_rows=term_rows, flops=flops,
                          region=region)


# the problem's dyn where the whole step is traced
_FX_DYN = """  template <typename T, typename S>
  HM_HD static void dyn(const S* xs, const S* us, const T* th, const T* prm,
                        S* out) {
    fx_dyn<T, S>(xs, us, th, prm, out);
  }
"""


def _trace_model(model, kw):
    """``make_fx`` graphs of the model's ``ode`` and (a DAE's) ``alg`` at one
    probe (x, z, u, p, t), each output in (1, n) form: {"rhs": ..., "alg":
    ...}."""
    from ..core.model import one_row_last
    nx, nz, nu, n_p = model.n_x, model.n_z, model.n_u, model.n_p
    probe = (torch.zeros(1, nx, **kw), torch.zeros(1, nz, **kw),
             torch.zeros(1, nu, **kw), torch.zeros(1, n_p, **kw), torch.zeros(1, **kw))

    def rows(fn, n):
        return lambda x, z, u, p, t: one_row_last(fn(x, z, u, p, t), x, n)

    return {name: trace(rows(fn, n), *probe)
            for name, fn, n in (("rhs", model.ode_fn(), nx), ("alg", model.alg_fn(), nz))
            if n}


def _emit_model_step(src, graphs, prm: _Prm, nx: int, nu: int) -> tuple:
    """The problem's ``rhs``, ``alg`` (written from the model's traces, over
    x, z, u of type S and p, t plain, as ops/codegen_cuda.py:emit_model
    writes them from the DSL) and ``dyn`` (ops/codegen_cuda.py:_emit_dyn:
    the scaling and the implicit step): (text, ((ops, calls) of rhs, of
    alg), the step's work)."""
    model = src.model
    nxm, nz = model.n_x, model.n_z
    p_sx = len(prm.vals)
    for v in src.x_scaling + (src.u_scaling if src.augment_du else ()):
        prm.add(v)
    p_su = len(prm.vals)
    for v in src.u_scaling:
        prm.add(v)
    text, counts = "", []
    names = ([("x", "S", nxm)] + ([("z", "S", nz)] if nz else [])
             + [("u", "S", model.n_u)])
    for name, n_out in (("rhs", nxm), ("alg", nz)):
        if name not in graphs:
            counts.append((0, 0))
            continue
        fn = _Fn(prm)
        ins = _inputs(names, [0] * len(names))
        if not nz:
            ins.insert(1, np.empty((1, 0), dtype=object))
        ins.append(_inputs([("p", "T", model.n_p)], [0])[0])
        t = np.empty((1,), dtype=object)
        t[0] = _V("t", "T")
        out = _body(graphs[name], fn, ins + [t], (1, n_out))
        args = ", ".join(f"const S* {nm}" for nm, _, _ in names)
        text += (f"  template <typename T, typename S>\n"
                 f"  HM_HD static void {name}({args}, const T* p, T t, const T* prm, "
                 f"S* out) {{\n"
                 + "\n".join(fn.lines) + ("\n" if fn.lines else "")
                 + "\n".join(f"    out[{i}] = S({v.code});" for i, v in enumerate(out[0]))
                 + "\n    (void)p; (void)t; (void)prm;\n  }\n")
        calls = [call for kind, call, _, _ in fn.work if kind == "S"]
        counts.append((calls.count(False), calls.count(True)))
    dyn, work = _emit_dyn(src, nx, nu, prm, p_sx, p_su)
    return text + dyn, tuple(counts), work


def _lanes_work(fn: _Fn, second: bool) -> int:
    """Operations of ``fn``'s statements over the derivative lanes each one
    carries, as ops/codegen_cuda.py:_iteration_flops counts a dual
    operation (a value and 3 per lane, a function call 2 and 2 per lane):
    first-order lanes over the inputs it depends on (``_V.dep``) and, where
    ``second``, second-order lanes over the input pairs it couples
    (``_V.hp``). A lane that is zero by structure needs no work, so this is
    less than csrc/whole_ip.cuh's dense Dual<T, D> pass and csrc/traced.cuh's
    nested one compute."""
    total = 0
    for kind, call, ndep, nhp in fn.work:
        lanes = (ndep + (nhp if second else 0)) if kind == "S" else 0
        total += 2 + 2 * lanes if call else 1 + 3 * lanes
    return total


def _traced_flops(nx, nu, N, RS, RT, f_dyn, f_stage, f_term, cross,
                  dyn_ops=None) -> int:
    """Operations of one IP iteration of one scenario, counted as
    ops/codegen_cuda.py:_iteration_flops counts the DSL route's (as the
    algorithm needs them): per stage the step with its Jacobian (``dyn_ops``
    where the step is emitted around the traced model: an implicit step)
    and the stage cost with its gradient and Hessian, the terminal cost
    with its once, and the solver algebra."""
    per_stage = ((_lanes_work(f_dyn, False) if dyn_ops is None else dyn_ops)
                 + _lanes_work(f_stage, True))
    return int(N * per_stage + _lanes_work(f_term, True)
               + _solver_flops(nx, nu, N, RS, RT, cross))
