"""Emit C++ for the card from a model and an optimal-control problem.

Counterpart of what ``hilo_mpc_tpu/ops/pallas_ip.py`` does before its
``pallas_call``: ``_stage_rows`` (lines 92-121) picks the active box rows and
``_scalarized`` with the ``*_lane`` helpers (lines 215-322) trace the user's
dynamics and cost into the kernel and differentiate them there. CUDA has no
in-kernel AD, so this module writes the model as C++ instead:

- the model's equations are walked as Python ``ast`` (numbers, names,
  ``+ - * / **``, unary minus and calls into the DSL's function table) into
  a function template over a scalar type ``S``; with ``S`` the dual number of
  ``csrc/dual.cuh`` one pass gives F and [A | B] (forward mode);
- the step wraps it in the configured ERK tableau with substeps, the
  discrete map, or a collocation step (Radau or Gauss-Legendre, ``irk``,
  the ``cvodes``/``idas`` stand-ins); a DAE model's algebraic equations
  become ``alg`` and the step solves them by Newton (at every ERK stage,
  at every collocation node together with the node states), as
  core/integrators.py:make_step does, through csrc/implicit.cuh: the Newton
  on plain values, the implicit function theorem's tangents in the dual
  pass; all with the solver scaling and the theta unpack of
  ``control/nmpc.py`` (x = xs·sx, u = us·su, p = theta[2:2+n_p],
  t = theta[0], h = theta[1]); under the Δu augmentation the state carries
  u_prev (scaled by su) after the model's states, the control is Δu, the
  model sees u = u_prev + Δu and the step appends u/su;
- the quadratic cost gets its gradient and Hessian in closed form:
  g = (h/dt)·sx∘(W+Wᵀ)e and H = (h/dt)·diag(sx)(W+Wᵀ)diag(sx), scattered by
  the term's indices (no h factor and u = 0 in the terminal cost). Under
  the augmentation an input term's e holds u_prev + Δu, so its weights land
  in the u_prev block of Hxx, in Huu and in the cross block Hux (the
  problem's ``CROSS``); an input-change term weighs Δu alone;
- soft state bounds, the penalty w·Σ relu(x − ub)² + relu(lb − x)² on the
  unscaled x, likewise: g = 2w·(relu(x − ub) − relu(lb − x)) and a diagonal
  Hessian, 2w where a bound is violated, with the stage's h/dt factor and
  the solver scaling as above (none of h/dt in the terminal cost). The
  Hessian functions take the point for it; a problem without soft bounds
  emits no such code;
- the box rows become bit masks over the candidate rows
  ``[u-ub; lb-u; x-ub; lb-x]`` of each stage (no x rows at k = 0), then the
  terminal rows ``[x-ub; lb-x]``, in 32-bit words (row r is bit r & 31 of
  word r >> 5), so any number of rows fits.

Structure goes into the source (sizes, the active-row pattern, the tableau,
the expressions, the cost's sparsity); numbers go into the array ``prm``
(bound offsets, weights, constant references, scalings, dt, the IP
constants), so controllers that differ only in numbers share one build.

``emit_problem`` chooses the route: a problem this module can write is
written here, every other one (a model given as a Python callable, a
generic cost, a measurement term, a soft generic constraint, a
path-following reference or path parameter: ``OCPSource.dsl_error``) by
ops/codegen_fx.py from a ``torch.fx`` trace of the problem functions, which
shares ``_struct_head``, ``_rows`` and the solver's operation count with
this module (for an implicit step the traced route traces the model's own
functions and wraps them in this module's step, with the Δu augmentation
and the path parameter around it). What neither route can write (a free
final time: ``OCPSource.cost_error``; a Newton of more than ``NEWTON_MAX``
unknowns) raises ``NotImplementedError``.
"""
from __future__ import annotations

import ast
import dataclasses
import math
from typing import Optional

import numpy as np

from ..core.integrators import (IMPLICIT_METHODS, IntegratorSpec,
                                collocation_coefficients, erk_tableau)
from ..utils.parsing import _CallStripper

# DSL function -> (C++ function in csrc/dual.cuh, arity)
_FUNCS = {
    "exp": ("m_exp", 1), "log": ("m_log", 1), "ln": ("m_log", 1),
    "log10": ("m_log10", 1), "sqrt": ("m_sqrt", 1), "sin": ("m_sin", 1),
    "cos": ("m_cos", 1), "tan": ("m_tan", 1), "asin": ("m_asin", 1),
    "arcsin": ("m_asin", 1), "acos": ("m_acos", 1), "arccos": ("m_acos", 1),
    "atan": ("m_atan", 1), "arctan": ("m_atan", 1), "atan2": ("m_atan2", 2),
    "arctan2": ("m_atan2", 2), "sinh": ("m_sinh", 1), "cosh": ("m_cosh", 1),
    "tanh": ("m_tanh", 1), "asinh": ("m_asinh", 1), "arsinh": ("m_asinh", 1),
    "acosh": ("m_acosh", 1), "arcosh": ("m_acosh", 1), "atanh": ("m_atanh", 1),
    "artanh": ("m_atanh", 1), "abs": ("m_abs", 1), "fabs": ("m_abs", 1),
    "sign": ("m_sign", 1), "fmin": ("m_fmin", 2), "fmax": ("m_fmax", 2),
    "minimum": ("m_fmin", 2), "maximum": ("m_fmax", 2), "floor": ("m_floor", 1),
    "ceil": ("m_ceil", 1), "erf": ("m_erf", 1),
}
_CONSTS = {"pi": math.pi}
# the most unknowns of an implicit step's Newton (d·(nx + nz) for
# collocation, nz for an explicit or discrete step of a DAE model): its
# Jacobian, NEWTON_MAX² values, lives in one thread's registers
NEWTON_MAX = 16
# the whole-solve kernel's tiles: TB scenarios per block, and the blocks per
# SM that __launch_bounds__ asks for in the float32 and the float64 build,
# which caps a thread's registers near 65536 / (TB · MINB). Float32: 8
# blocks (16 warps, at most 128 registers), the fastest of the tiles and
# placements timed on an H100 (PERF.md). Float64 spills at 8 and at 5
# blocks; at 4 it takes ~190 registers without spills, and 5 blocks fit.
WIP_TB = 64
WIP_MIN_BLOCKS = (8, 4)
# the IP constants at the head of prm, in this order (then max_iter)
_IP_FIELDS = ("tol", "tol10", "reg", "s_min", "kappa_eps", "kappa_mu",
              "theta_mu", "tau_min", "max_iter")


@dataclasses.dataclass(frozen=True, eq=False)
class OCPSource:
    """What the emitters need of an NMPC problem (``NMPC.setup`` attaches it
    to its ``OCPFunctions``): the model and integrator, the theta layout
    [t, h, p (n_p), stage refs, terminal refs] and its width, the quadratic
    cost terms (control/costs.py:QuadTerm), the solver scalings and the
    sampling time that divides the stage cost's h; the soft state bounds
    (unscaled, ±inf where a state has none) and their weight; where the
    problem holds a part that this module's emitter cannot write, what that
    part is (``dsl_error``: the problem then takes the traced route of
    ops/codegen_fx.py); where neither emitter can, what that is
    (``cost_error``: a free final time); the dtype and device of the problem
    functions' closures, in which the traced route traces them; and the
    algebraic states' Newton guess ``z0``."""
    model: object
    spec: IntegratorSpec
    off_rs: int
    off_rt: int
    stage_terms: tuple
    term_terms: tuple
    x_scaling: tuple
    u_scaling: tuple
    dt: float
    soft_lb: tuple = ()
    soft_ub: tuple = ()
    soft_weight: float = 0.0
    cost_error: Optional[str] = None
    # the Δu augmentation: u_prev rides in the state after the model's
    # states and the control is Δu
    augment_du: bool = False
    # a path parameter (create_path_variable): the last solver state th
    # (after u_prev under Δu) and the last control, its velocity u_pf
    augment_path: bool = False
    dsl_error: Optional[str] = None
    n_theta: Optional[int] = None
    dtype: object = None
    device: object = None
    # the algebraic states' Newton guess (the model's z0, else zeros)
    z0: tuple = ()


@dataclasses.dataclass(frozen=True, eq=False)
class EmittedProblem:
    """One problem as C++ (``text``, compiled together with
    csrc/whole_ip.cuh) and its numbers (``prm``, float64, cast to the
    kernel's type at launch). ``stage_rows`` lists (k, full column) of each
    active stage row in slot order, ``term_rows`` the full column of each
    active terminal row; ``flops`` the operations of one IP iteration of one
    scenario (the algorithm's: one linearization per iteration), counted
    from the emitted code and the solver template; ``region`` the elements
    of one scenario's state region (csrc/whole_ip.cuh:WipLay::E)."""
    text: str
    prm: np.ndarray
    stage_rows: tuple
    term_rows: tuple
    flops: int
    region: int


def whole_ip_region(nx: int, nu: int, N: int, n_theta: int, RS: int, RT: int) -> int:
    """Elements of one scenario's region of the whole-solve kernel
    (csrc/whole_ip.cuh:WipLay): theta, X, U, lam, the active rows' s and z,
    the stash K, kff, P (upper triangle), p, the direction dX, dU, and every
    stage's linearization A, B, F - x_{k+1}."""
    return ((N + 1) * (n_theta + nx) + N * nu + N * nx + 2 * RS + 2 * RT
            + N * nu * nx + N * nu + N * nx * (nx + 1) // 2 + N * nx + N * nx
            + N * nu + N * (nx * nx + nx * nu + nx))


def _lit(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "hm::m_inf<T>()" if v > 0 else "(-hm::m_inf<T>())"
    if math.isnan(v):
        raise NotImplementedError("a NaN constant in the model cannot be emitted")
    return f"T({v!r})"


class _Expr:
    """C++ for one DSL expression; ``names`` maps DSL names to C++. Counts
    the operations it emits (``ops``: arithmetic, ``calls``: functions)."""

    def __init__(self, names):
        self.names = names
        self.ops = 0
        self.calls = 0

    def __call__(self, src: str) -> str:
        tree = _CallStripper().visit(ast.parse(src, mode="eval"))
        return self.emit(tree.body)

    @staticmethod
    def _number(node) -> Optional[float]:
        if isinstance(node, ast.Constant) and type(node.value) in (int, float):
            return float(node.value)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            v = _Expr._number(node.operand)
            if v is not None:
                return -v if isinstance(node.op, ast.USub) else v
        return None

    def emit(self, node) -> str:
        if isinstance(node, ast.Constant):
            if type(node.value) not in (int, float):
                raise NotImplementedError(
                    f"constant {node.value!r} cannot be emitted as C++")
            return _lit(node.value)
        if isinstance(node, ast.Name):
            if node.id in self.names:
                return self.names[node.id]
            if node.id in _CONSTS:
                return _lit(_CONSTS[node.id])
            if node.id == "inf":
                return _lit(float("inf"))
            raise NotImplementedError(f"unknown name {node.id!r} in a model equation")
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            self.ops += 1
            return f"(-{self.emit(node.operand)})"
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
            return self.emit(node.operand)
        if isinstance(node, ast.BinOp):
            ops = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}
            if type(node.op) in ops:
                self.ops += 1
                return (f"({self.emit(node.left)} {ops[type(node.op)]} "
                        f"{self.emit(node.right)})")
            if isinstance(node.op, ast.Pow):
                return self._pow(node)
            raise NotImplementedError(
                f"operator {type(node.op).__name__} cannot be emitted as C++")
        if isinstance(node, ast.Call):
            fn = node.func.id if isinstance(node.func, ast.Name) else None
            if fn not in _FUNCS or node.keywords:
                raise NotImplementedError(
                    f"function {fn or ast.dump(node.func)!r} is not in the DSL "
                    f"table and cannot be emitted as C++")
            cxx, arity = _FUNCS[fn]
            if len(node.args) != arity:
                raise NotImplementedError(f"{fn} takes {arity} argument(s)")
            self.calls += 1
            return f"hm::{cxx}({', '.join(self.emit(a) for a in node.args)})"
        raise NotImplementedError(
            f"{type(node).__name__} cannot be emitted as C++ (numbers, names, "
            f"+ - * / **, unary minus and the DSL functions can)")

    def _pow(self, node) -> str:
        base = self.emit(node.left)
        c = self._number(node.right)
        # the exponents torch.pow computes by multiplication or a root
        if c == 1.0:
            return base
        if c == 2.0:
            self.ops += 1
            return f"hm::m_sq({base})"
        if c == 0.5:
            self.calls += 1
            return f"hm::m_sqrt({base})"
        self.calls += 1
        if c is not None:
            return f"hm::m_pow({base}, {_lit(c)})"
        return f"hm::m_pow({base}, {self.emit(node.right)})"


def model_emit_error(model) -> Optional[str]:
    """Why ``model`` cannot be emitted as C++, or None if it can."""
    try:
        emit_model(model)
    except NotImplementedError as e:
        return str(e)
    return None


def emit_model(model, implicit: bool = False) -> tuple:
    """C++ of the model's equations: (text, operation count, function-call
    count of ``rhs``, the same two of ``alg``). ``rhs(x, u, p, t, out)`` is a
    function template over the scalar type ``S`` of x, u and out (T or a
    dual number); p and t are plain ``T``. A DAE model's functions take its
    algebraic states z (type ``S``) after x: ``rhs(x, z, u, p, t, out)``
    and its algebraic residuals ``alg(x, z, u, p, t, out)``. For an
    implicit step (``implicit``) both also take ``prm`` before ``out``, as
    the traced model's functions (ops/codegen_fx.py) need it."""
    nx, nu, nz = model.n_x, model.n_u, model.n_z
    if nu == 0:
        raise NotImplementedError("a model without inputs cannot be emitted "
                                  "for the whole-solve kernel")
    origin = getattr(model, "_ode_origin", None)
    body, alg_body = [], []
    alg_ops = alg_calls = 0
    if origin == "dsl":
        dsl = model._dsl
        text = getattr(model._ode, "_hilo_dsl_src", None)
        if nz and not (dsl.alg and text is not None
                       and getattr(model._alg, "_hilo_dsl_src", None) == text):
            raise NotImplementedError(
                "the algebraic equations are not the equation DSL's of the state "
                "equations (ops/codegen_fx.py traces them)")
        names = {n: f"x[{i}]" for n, i in dsl.x_idx.items()}
        names.update({n: f"z[{i}]" for n, i in dsl.z_idx.items()})
        names.update({n: f"u[{i}]" for n, i in dsl.u_idx.items()})
        names.update({n: f"p[{i}]" for n, i in dsl.p_idx.items()})
        names.update({n: _lit(v) for n, v in dsl.constants.items()})
        names.update(t="t", k="t")

        def emit(srcs):
            ex, lines = _Expr(dict(names)), []
            for j, (name, src) in enumerate(dsl.aux):
                lines.append(f"  const auto a{j} = {ex(src)};")
                ex.names[name] = f"a{j}"
            for i, src in enumerate(srcs):
                lines.append(f"  out[{i}] = S({ex(src)});")
            return lines, ex.ops, ex.calls

        body, ops, calls = emit(dsl.rhs)
        if nz:
            alg_body, alg_ops, alg_calls = emit(dsl.alg)
    elif origin == "state_space":
        A = model._ss["A"]
        Bm = model._ss["B"]
        ops, calls = 0, 0
        for i in range(nx):
            terms = [f"x[{j}] * {_lit(A[i, j])}" for j in range(nx) if A[i, j] != 0.0]
            if Bm is not None:
                terms += [f"u[{j}] * {_lit(Bm[i, j])}" for j in range(nu)
                          if Bm[i, j] != 0.0]
            ops += max(2 * len(terms) - 1, 0)
            body.append(f"  out[{i}] = S({' + '.join(terms) or _lit(0.0)});")
    else:
        raise NotImplementedError(
            "the model's equations are a Python callable: this emitter writes "
            "models given in the equation DSL or by state-space matrices "
            "(ops/codegen_fx.py traces the others)")
    zarg = "const S* z, " if nz else ""
    parg = "const T* prm, " if implicit else ""
    text = ("  template <typename T, typename S>\n"
            f"  HM_HD static void rhs(const S* x, {zarg}const S* u, const T* p, T t, "
            f"{parg}S* out) {{\n"
            + "\n".join("  " + line for line in body) + "\n  }\n")
    if nz:
        text += ("  template <typename T, typename S>\n"
                 "  HM_HD static void alg(const S* x, const S* z, const S* u, "
                 f"const T* p, T t, {parg}S* out) {{\n"
                 + "\n".join("  " + line for line in alg_body) + "\n  }\n")
    return text, ops, calls, alg_ops, alg_calls


class _Prm:
    """The numbers array, filled while the source is written."""

    def __init__(self):
        self.vals = []

    def add(self, v) -> int:
        self.vals.append(float(v))
        return len(self.vals) - 1


def _collocation(spec: IntegratorSpec) -> tuple:
    """(degree, scheme) of a collocation step as core/integrators.py:make_step
    builds it: ``irk`` as ``collocation``, ``cvodes`` and ``idas`` Radau at
    degree max(d, 3)."""
    if spec.method.lower() in ("cvodes", "idas"):
        return max(int(spec.degree), 3), "radau"
    return int(spec.degree), spec.scheme


def newton_size(spec: IntegratorSpec, nx: int, nz: int) -> int:
    """Unknowns of the step's Newton solve: d·(nx + nz) for collocation, nz
    for an explicit or discrete step of a DAE model, 0 for one of an ODE
    model."""
    if spec.method.lower() in IMPLICIT_METHODS:
        return _collocation(spec)[0] * (nx + nz)
    return nz


def _call(fn: str, x: str, z: Optional[str], u: str, t: str, out: str,
          types: str = "T, S") -> str:
    """A call of the model's ``rhs`` or ``alg`` in an implicit step: z only
    for a DAE model."""
    zarg = f"{z}, " if z is not None else ""
    return f"{fn}<{types}>({x}, {zarg}{u}, p, {t}, prm, {out});"


def _alg_newton(ind: str, nx: int, nz: int, nu: int, x: str, t: str, iters: int,
                tangents: Optional[str]) -> list:
    """An explicit or discrete step's algebraic Newton at the state ``x`` and
    time ``t``: nz unknowns from the guess zg (updated in place), the
    Jacobian g_z by one Dual<T, nz> pass; with ``tangents`` the name of an
    S array that receives z with the implicit function theorem's tangents
    (csrc/implicit.cuh:ift)."""
    i2 = ind + "  "
    lines = [f"{ind}{{",
             f"{i2}T xp[{nx}], up[{nu}];",
             f"{i2}for (int i = 0; i < {nx}; ++i) xp[i] = hm::plain({x}[i]);",
             f"{i2}for (int j = 0; j < {nu}; ++j) up[j] = hm::plain(u[j]);",
             f"{i2}auto rj = [&](const T* w, T* r, T* J) {{",
             f"{i2}  using V = hm::Dual<T, {nz}>;",
             f"{i2}  V X[{nx}], Z[{nz}], U[{nu}], G[{nz}];",
             f"{i2}  for (int i = 0; i < {nx}; ++i) X[i] = V(xp[i]);",
             f"{i2}  for (int j = 0; j < {nu}; ++j) U[j] = V(up[j]);",
             f"{i2}  for (int i = 0; i < {nz}; ++i) {{",
             f"{i2}    Z[i] = V(w[i]);",
             f"{i2}    Z[i].d[i] = T(1);",
             f"{i2}  }}",
             f"{i2}  {_call('alg', 'X', 'Z', 'U', t, 'G', 'T, V')}",
             f"{i2}  for (int i = 0; i < {nz}; ++i) {{",
             f"{i2}    r[i] = G[i].v;",
             f"{i2}    for (int c = 0; c < {nz}; ++c) J[i * {nz} + c] = G[i].d[c];",
             f"{i2}  }}",
             f"{i2}}};",
             f"{i2}hm::newton<T, {nz}, {iters}>(zg, rj);"]
    if tangents is not None:
        lines += [f"{i2}auto rs = [&](const T* w, S* r) {{",
                  f"{i2}  S Z[{nz}];",
                  f"{i2}  for (int i = 0; i < {nz}; ++i) Z[i] = S(w[i]);",
                  f"{i2}  {_call('alg', x, 'Z', 'u', t, 'r')}",
                  f"{i2}}};",
                  f"{i2}hm::ift<T, S, {nz}>(zg, {tangents}, rj, rs);"]
    return lines + [f"{ind}}}"]


def _colloc_lines(nx: int, nz: int, nu: int, d: int, iters: int, p_c: int,
                  p_d: int, p_tau: int) -> list:
    """One collocation step from x at tq over hh, in place on x (and on the
    algebraic guess zg), as core/integrators.py:make_collocation_step: the
    unknowns w = (X_1, Z_1, ..., X_d, Z_d) from the guess (x, zg) at every
    node; each node's residual rows and Jacobian block by one
    Dual<T, nx + nz> pass; C[j, r] at prm[p_c + j·(d+1) + r], D[r] at
    prm[p_d + r], the nodes τ_j at prm[p_tau + j]."""
    nv, M = nx + nz, d * (nx + nz)
    zx = "Z" if nz else None
    lines = ["      {",
             f"        T xp[{nx}], up[{nu}], w[{M}];",
             f"        for (int i = 0; i < {nx}; ++i) xp[i] = hm::plain(x[i]);",
             f"        for (int j = 0; j < {nu}; ++j) up[j] = hm::plain(u[j]);",
             "#pragma unroll",
             f"        for (int j = 0; j < {d}; ++j) {{",
             f"          for (int i = 0; i < {nx}; ++i) w[j * {nv} + i] = xp[i];"]
    if nz:
        lines.append(f"          for (int i = 0; i < {nz}; ++i) w[j * {nv} + {nx} + i] = "
                     "zg[i];")
    lines += ["        }",
              "        auto rj = [&](const T* w, T* r, T* J) {",
              f"          using V = hm::Dual<T, {nv}>;",
              f"          for (int i = 0; i < {M * M}; ++i) J[i] = T(0);",
              "#pragma unroll",
              f"          for (int j = 0; j < {d}; ++j) {{",
              f"            V X[{nx}], U[{nu}], F[{nx}]{f', Z[{nz}], G[{nz}]' if nz else ''};",
              f"            for (int i = 0; i < {nx}; ++i) {{",
              f"              X[i] = V(w[j * {nv} + i]);",
              "              X[i].d[i] = T(1);",
              "            }"]
    if nz:
        lines += [f"            for (int i = 0; i < {nz}; ++i) {{",
                  f"              Z[i] = V(w[j * {nv} + {nx} + i]);",
                  f"              Z[i].d[{nx} + i] = T(1);",
                  "            }"]
    lines += [f"            for (int k = 0; k < {nu}; ++k) U[k] = V(up[k]);",
              f"            const T tn = tq + prm[{p_tau} + j] * hh;",
              "            " + _call("rhs", "X", zx, "U", "tn", "F", "T, V")]
    if nz:
        lines.append("            " + _call("alg", "X", "Z", "U", "tn", "G", "T, V"))
    lines += [f"            for (int a = 0; a < {nx}; ++a) {{",
              f"              T v = prm[{p_c} + j * {d + 1}] * xp[a];",
              "#pragma unroll",
              f"              for (int e = 1; e <= {d}; ++e)",
              f"                v = v + prm[{p_c} + j * {d + 1} + e] * w[(e - 1) * {nv} + a];",
              f"              r[j * {nv} + a] = v - hh * F[a].v;",
              "#pragma unroll",
              f"              for (int e = 0; e < {d}; ++e)",
              f"                J[(j * {nv} + a) * {M} + e * {nv} + a] = "
              f"prm[{p_c} + j * {d + 1} + e + 1];",
              f"              for (int c = 0; c < {nv}; ++c)",
              f"                J[(j * {nv} + a) * {M} + j * {nv} + c] =",
              f"                    J[(j * {nv} + a) * {M} + j * {nv} + c] + (-hh) * F[a].d[c];",
              "            }"]
    if nz:
        lines += [f"            for (int b = 0; b < {nz}; ++b) {{",
                  f"              r[j * {nv} + {nx} + b] = G[b].v;",
                  f"              for (int c = 0; c < {nv}; ++c)",
                  f"                J[(j * {nv} + {nx} + b) * {M} + j * {nv} + c] = G[b].d[c];",
                  "            }"]
    lines += ["          }",
              "        };",
              f"        hm::newton<T, {M}, {iters}>(w, rj);",
              "        auto rs = [&](const T* w, S* r) {",
              "#pragma unroll",
              f"          for (int j = 0; j < {d}; ++j) {{",
              f"            S X[{nx}], F[{nx}]{f', Z[{nz}], G[{nz}]' if nz else ''};",
              f"            for (int i = 0; i < {nx}; ++i) X[i] = S(w[j * {nv} + i]);"]
    if nz:
        lines.append(f"            for (int i = 0; i < {nz}; ++i) Z[i] = "
                     f"S(w[j * {nv} + {nx} + i]);")
    lines += [f"            const T tn = tq + prm[{p_tau} + j] * hh;",
              "            " + _call("rhs", "X", zx, "u", "tn", "F")]
    if nz:
        lines.append("            " + _call("alg", "X", "Z", "u", "tn", "G"))
    lines += [f"            for (int a = 0; a < {nx}; ++a) {{",
              f"              S v = prm[{p_c} + j * {d + 1}] * x[a];",
              "#pragma unroll",
              f"              for (int e = 1; e <= {d}; ++e)",
              f"                v = v + prm[{p_c} + j * {d + 1} + e] * w[(e - 1) * {nv} + a];",
              f"              r[j * {nv} + a] = v - hh * F[a];",
              "            }"]
    if nz:
        lines.append(f"            for (int b = 0; b < {nz}; ++b) r[j * {nv} + {nx} + b] = "
                     "G[b];")
    lines += ["          }",
              "        };",
              f"        S ws[{M}];",
              f"        hm::ift<T, S, {M}>(w, ws, rj, rs);",
              f"        for (int a = 0; a < {nx}; ++a) {{",
              f"          S v = prm[{p_d}] * x[a];",
              "#pragma unroll",
              f"          for (int e = 1; e <= {d}; ++e) v = v + prm[{p_d} + e] * "
              f"ws[(e - 1) * {nv} + a];",
              "          x[a] = v;",
              "        }"]
    if nz:
        lines.append(f"        for (int b = 0; b < {nz}; ++b) zg[b] = "
                     f"w[{(d - 1) * nv + nx} + b];")
    return lines + ["      }"]


def _solve_ops(M: int, lanes: int = 0) -> int:
    """Operations of one csrc/implicit.cuh:SmallSolve of size M, its factor
    and its application to a right-hand side of ``lanes`` derivative lanes."""
    if M == 1:
        factor = 0
    elif M <= 3:
        factor = 2 * M * M + (7 if M == 2 else 50)
    else:
        factor = sum(r * (1 + 2 * r) for r in range(M))
    apply = 2 * M * M if M > 1 else 1
    return factor + apply * (1 + lanes)


def _emit_step(spec: IntegratorSpec, nx: int, nz: int = 0, nu: int = 1,
               prm: Optional["_Prm"] = None, z0=()) -> tuple:
    """The integrator step from x at time t0 over h, in place on x, as
    core/integrators.py:make_step builds it; returns (lines, work). The
    lines call the model's ``rhs`` (and a DAE model's ``alg``) over the
    active type S or a node's dual type; ``work`` counts the passes:
    ``("rhs"|"alg", lanes)`` -> passes (lanes "S": the active type's),
    ``"comb"`` the combinations x + h·a·k of S values per state and
    ``"plain"`` the Newton's own operations on plain values. Numbers (the
    collocation matrices C and D, the nodes τ, the algebraic guess z0) go
    into ``prm``; the structure (the method, d, nx, nz, the tableau, the
    Newton's iteration count) into the text. Implicit steps use
    csrc/implicit.cuh: the Newton on plain values, the derivatives of the
    implicit function theorem. A Newton of more than ``NEWTON_MAX``
    unknowns raises NotImplementedError."""
    prm = _Prm() if prm is None else prm
    lines, work = [], {"comb": 0, "plain": 0}

    def count(key, n=1):
        work[key] = work.get(key, 0) + n

    m = max(int(spec.substeps), 1)
    method = spec.method.lower()
    iters = int(spec.newton_iters)
    size = newton_size(spec, nx, nz)
    if size > NEWTON_MAX:
        raise NotImplementedError(
            f"a Newton of {size} unknowns in the integrator step (at most "
            f"{NEWTON_MAX}: NEWTON_MAX)")
    if nz:
        z0 = tuple(z0) if len(z0) else (0.0,) * nz
        p_z0 = len(prm.vals)
        for v in z0:
            prm.add(v)
        lines.append(f"    T zg[{nz}];")
        lines.append(f"    for (int i = 0; i < {nz}; ++i) zg[i] = prm[{p_z0} + i];")
        if method == "discrete":
            lines.append(f"    S zs[{nz}];")
            lines.append(f"    for (int i = 0; i < {nz}; ++i) zs[i] = S(zg[i]);")
    if m > 1:
        lines += [f"    const T hh = h / {_lit(m)};",
                  f"    for (int q = 0; q < {m}; ++q) {{",
                  "      const T tq = t0 + T(q) * hh;"]
    else:
        lines += ["    const T hh = h;", "    {", "      const T tq = t0;"]
    # the plain operations of one Newton of M unknowns (its iterations, the
    # Jacobian at the answer and the tangents' solve over S)
    newton_plain = lambda M, assemble: (iters * (_solve_ops(M) + M)  # noqa: E731
                                        + (iters + 1) * assemble + _solve_ops(M, 0))
    if method in IMPLICIT_METHODS:
        d, scheme = _collocation(spec)
        C, D, _, taus = collocation_coefficients(d, scheme)
        p_c = len(prm.vals)
        for v in np.asarray(C).reshape(-1):
            prm.add(v)
        p_d = len(prm.vals)
        for v in D:
            prm.add(v)
        p_tau = len(prm.vals)
        for v in taus[1:]:
            prm.add(v)
        lines += _colloc_lines(nx, nz, nu, d, iters, p_c, p_d, p_tau)
        nv, M = nx + nz, d * (nx + nz)
        count(("rhs", nv), (iters + 1) * d * m)
        count(("rhs", "S"), d * m)
        if nz:
            count(("alg", nv), (iters + 1) * d * m)
            count(("alg", "S"), d * m)
        # the residual rows (2(d+1) per state), the Jacobian's node blocks
        count("plain", m * newton_plain(M, d * nx * (2 * (d + 1) + 2 * nv)))
        # the tangents' residual rows, their solve and x_next over S
        work["comb"] += m * (d * (d + 1) + (d + 1))
        count(("solve", M), m)
    elif method == "discrete":
        if nz:
            lines += [f"      S xn[{nx}];", "      " + _call("rhs", "x", "zs", "u", "tq", "xn"),
                      f"      for (int i = 0; i < {nx}; ++i) x[i] = xn[i];"]
            if m > 1:
                lines.append(f"      if (q + 1 < {m})")
                lines += _alg_newton("      ", nx, nz, nu, "x", "tq + hh", iters, "zs")
                count(("alg", nz), (iters + 1) * (m - 1))
                count(("alg", "S"), m - 1)
                count("plain", (m - 1) * newton_plain(nz, 0))
                count(("solve", nz), m - 1)
        else:
            lines += [f"      S xn[{nx}];", "      rhs(x, u, p, tq, xn);",
                      f"      for (int i = 0; i < {nx}; ++i) x[i] = xn[i];"]
        count(("rhs", "S"), m)
    else:
        A, b, c = erk_tableau(method)
        s = len(b)
        for i in range(s):
            lines.append(f"      S k{i}[{nx}], x{i}[{nx}];")
            lines.append(f"      for (int n = 0; n < {nx}; ++n) {{")
            lines.append("        S v = x[n];")
            for j in range(i):
                if float(A[i][j]) != 0.0:
                    lines.append(f"        v = v + (hh * {_lit(A[i][j])}) * k{j}[n];")
                    work["comb"] += m
            lines.append(f"        x{i}[n] = v;")
            lines.append("      }")
            ti = f"tq + {_lit(c[i])} * hh"
            if nz:
                lines.append(f"      S zs{i}[{nz}];")
                lines += _alg_newton("      ", nx, nz, nu, f"x{i}", ti, iters, f"zs{i}")
                lines.append("      " + _call("rhs", f"x{i}", f"zs{i}", "u", ti, f"k{i}"))
            else:
                lines.append(f"      rhs(x{i}, u, p, {ti}, k{i});")
        lines.append(f"      for (int n = 0; n < {nx}; ++n) {{")
        lines.append("        S v = x[n];")
        for i in range(s):
            if float(b[i]) != 0.0:
                lines.append(f"        v = v + (hh * {_lit(b[i])}) * k{i}[n];")
                work["comb"] += m
        lines += ["        x[n] = v;", "      }"]
        count(("rhs", "S"), s * m)
        if nz:
            count(("alg", nz), (iters + 1) * s * m)
            count(("alg", "S"), s * m)
            count("plain", s * m * newton_plain(nz, 0))
            count(("solve", nz), s * m)
            if m > 1:
                # the guess for the next substep: z at x_next (plain; the
                # last substep's is not used)
                lines.append(f"      if (q + 1 < {m})")
                lines += _alg_newton("      ", nx, nz, nu, "x", "tq + hh", iters, None)
                count(("alg", nz), iters * (m - 1))
                count("plain", (m - 1) * iters * (_solve_ops(nz) + nz))
    lines.append("    }")
    return lines, work


def _step_ops(work, rhs_oc, alg_oc, nx: int, D: int) -> int:
    """Operations of one step over the active type S with D derivative
    lanes, from ``_emit_step``'s ``work`` and the model functions' (ops,
    calls): a dual operation counts its value and 3 per lane, a function
    call 2 and 2 per lane (as ``_iteration_flops``); a solve's application
    to the tangents 2M² per lane."""
    total = work.get("plain", 0) + work.get("comb", 0) * nx * (1 + 2 * (1 + D))
    for key, n in work.items():
        if key in ("comb", "plain"):
            continue
        fn, lanes = key
        L = D if lanes == "S" else lanes
        if fn == "solve":
            total += n * (2 * L * L + L) * D
            continue
        ops, calls = rhs_oc if fn == "rhs" else alg_oc
        total += n * (ops * (1 + 3 * L) + calls * (2 + 2 * L))
    return int(total)


def _check_dims(src: OCPSource, nx: int, nu: int):
    nxm, num = src.model.n_x, src.model.n_u
    path = int(src.augment_path)
    if (nx, nu) != (nxm + (num if src.augment_du else 0) + path, num + path):
        raise NotImplementedError(
            f"the solver's (nx, nu) = ({nx}, {nu}) is not the model's with its Δu "
            f"and path augmentations: only those can be emitted")


def _includes(newton: bool) -> str:
    """The headers of a problem: csrc/implicit.cuh where its step has a
    Newton."""
    return '#include "whole_ip.cuh"\n' + ('#include "implicit.cuh"\n' if newton else "")


def _emit_dyn(src: OCPSource, nx: int, nu: int, prm: _Prm, p_sx: int,
              p_su: int) -> tuple:
    """The problem's ``dyn`` (text, work of ``_emit_step``): x_next of the
    solver-scaled (xs, us) at the stage parameters th, the solver scaling
    at prm[p_sx:] and prm[p_su:] (x = xs·sx, u = us·su, p = th + 2, t =
    th[0], h = th[1]) around the model's step, which calls the problem's
    ``rhs`` (and ``alg``). Under the Δu augmentation the model sees u =
    u_prev + Δu and the step appends u/su; with a path parameter (the last
    solver state th_path, unscaled, and the last control u_pf) the step
    appends th_path + h·u_pf, as control/nmpc.py's ``dyn`` does."""
    nxm, num = src.model.n_x, src.model.n_u
    step, work = _emit_step(src.spec, nxm, src.model.n_z, num, prm, src.z0)
    nxs = nx - int(src.augment_path)     # the scaled states: x (and u_prev)
    dyn_in = (f"\n    for (int j = 0; j < {num}; ++j) u[j] = x[{nxm} + j] + u[j];"
              if src.augment_du else "")
    dyn_out = (f"\n    for (int j = 0; j < {num}; ++j) out[{nxm} + j] = u[j] / prm[{p_su} + j];"
               if src.augment_du else "")
    if src.augment_path:
        dyn_out += f"\n    out[{nxs}] = xs[{nxs}] + h * us[{num}];"
    text = f"""  // x_next of the solver-scaled (xs, us) at the stage parameters th
  template <typename T, typename S>
  HM_HD static void dyn(const S* xs, const S* us, const T* th, const T* prm,
                        S* out) {{
    S x[{nxs}], u[{num}];
    for (int i = 0; i < {nxs}; ++i) x[i] = xs[i] * prm[{p_sx} + i];
    for (int j = 0; j < {num}; ++j) u[j] = us[j] * prm[{p_su} + j];{dyn_in}
    const T* p = th + 2;
    const T t0 = th[0], h = th[1];
{chr(10).join(step)}
    for (int i = 0; i < {nxm}; ++i) out[i] = x[i] / prm[{p_sx} + i];{dyn_out}
  }}
"""
    return text, work


def _rows(bounds, N: int, nx: int, nu: int):
    """Active rows in _stage_rows order: per stage a mask over the candidate
    rows and the bound offsets (-ub for upper, +lb for lower rows)."""
    lbx, ubx, lbu, ubu = (np.asarray(b, np.float64) for b in bounds)
    masks, offs = [], []
    for k in range(N):
        cand = ([(ubu[k, j], -1.0) for j in range(nu)]
                + [(lbu[k, j], 1.0) for j in range(nu)])
        if k > 0:                                  # x_0 is fixed
            cand += ([(ubx[k, i], -1.0) for i in range(nx)]
                     + [(lbx[k, i], 1.0) for i in range(nx)])
        mask = 0
        for r, (v, sg) in enumerate(cand):
            if np.isfinite(v):
                mask |= 1 << r
                offs.append(sg * v)
        masks.append(mask)
    tcand = ([(ubx[N, i], -1.0) for i in range(nx)]
             + [(lbx[N, i], 1.0) for i in range(nx)])
    tmask, toffs = 0, []
    for t, (v, sg) in enumerate(tcand):
        if np.isfinite(v):
            tmask |= 1 << t
            toffs.append(sg * v)
    return masks, offs, tmask, toffs


def _runs(masks):
    """Consecutive stages with one mask: [(k0, k1, mask, first slot)]."""
    runs, slot = [], 0
    for k, m in enumerate(masks):
        if runs and runs[-1][2] == m:
            runs[-1][1] = k + 1
        else:
            runs.append([k, k + 1, m, slot])
        slot += bin(m).count("1")
    return runs


def _emit_cost(terms, ref_off: int, prm: _Prm, nx: int, nu: int,
               terminal: bool, nx_model: Optional[int] = None) -> tuple:
    """(value, gradient, Hessian, cross) C++ bodies of a quadratic cost, and
    its operation count. x and u are the unscaled variables, g and H come
    out with respect to the solver-scaled ones. ``nx_model`` is the model's
    state count under the Δu augmentation (u_prev at x[nx_model + j], the
    control u the increment), else None; an input term then weighs
    u_prev + Δu and also writes the cross block Hux (NU x NX)."""
    val, grad, hess, cross = [], [], [], []
    ops = 0
    off = ref_off
    for n_t, term in enumerate(terms):
        src = "x" if term.kind == "states" else "u"
        # an input term of the augmented problem: u = u_prev + Δu
        both = nx_model is not None and term.kind == "inputs"
        idx = [int(i) for i in term.idx]
        W = np.asarray(term.W, np.float64)
        Ws = W + W.T
        e = []
        for i, vi in enumerate(idx):
            if terminal and src == "u":
                v = "T(0)"
            elif both:
                v = f"(x[{nx_model + vi}] + u[{vi}])"
            else:
                v = f"{src}[{vi}]"
            if term.runtime_ref:
                e.append(f"({v} - th[{off + i}])")
            elif term.ref is not None:
                e.append(f"({v} - prm[{prm.add(term.ref[i])}])")
            else:
                e.append(v)
        if term.runtime_ref:
            off += term.n
        names = [f"e{n_t}_{i}" for i in range(len(idx))]
        decl = [f"    const T {nm} = {ex};" for nm, ex in zip(names, e)]
        val += decl
        for i in range(len(idx)):
            for j in range(len(idx)):
                if W[i, j] != 0.0:
                    val.append(f"    c = c + prm[{prm.add(W[i, j])}] * {names[i]}"
                               f" * {names[j]};")
                    ops += 3
        if terminal and src == "u":
            continue                        # constant: no gradient, no Hessian
        grad += decl
        g = "gx" if src == "x" else "gu"
        H = "Hxx" if src == "x" else "Huu"
        dim = nx if src == "x" else nu
        for i, vi in enumerate(idx):
            for j, vj in enumerate(idx):
                if Ws[i, j] != 0.0:
                    w = prm.add(Ws[i, j])
                    grad.append(f"    {g}[{vi}] = {g}[{vi}] + prm[{w}] * {names[j]};")
                    hess.append(f"    {H}[{vi * dim + vj}] = {H}[{vi * dim + vj}]"
                                f" + prm[{w}];")
                    ops += 2
                    if both:
                        a, b = nx_model + vi, nx_model + vj
                        grad.append(f"    gx[{a}] = gx[{a}] + prm[{w}] * {names[j]};")
                        hess.append(f"    Hxx[{a * nx + b}] = Hxx[{a * nx + b}]"
                                    f" + prm[{w}];")
                        cross.append(f"    Hux[{vi * nx + b}] = Hux[{vi * nx + b}]"
                                     f" + prm[{w}];")
                        ops += 4
    return val, grad, hess, cross, ops


def _emit_soft(src: OCPSource, prm: _Prm, nx: int) -> tuple:
    """(value, gradient, Hessian) C++ lines of the soft state bounds'
    penalty on the unscaled x, and the gradient's and Hessian's operation
    count. Only states with a finite soft bound get code; the numbers (the
    weight, 2·weight, the bounds) go into prm. ``nx`` is the solver's state
    width (the row stride of Hxx)."""
    lbs = [(i, v) for i, v in enumerate(src.soft_lb) if math.isfinite(v)]
    ubs = [(i, v) for i, v in enumerate(src.soft_ub) if math.isfinite(v)]
    states = sorted({i for i, _ in lbs + ubs})
    if not states:
        return [], [], [], 0
    w, w2 = prm.add(src.soft_weight), prm.add(2.0 * src.soft_weight)
    ub = {i: prm.add(v) for i, v in ubs}
    lb = {i: prm.add(v) for i, v in lbs}
    val, grad, hess = ["    T sp = T(0);"], [], []
    ops = 0
    for i in states:
        hi = f"hm::m_fmax(x[{i}] - prm[{ub[i]}], T(0))" if i in ub else None
        lo = f"hm::m_fmax(prm[{lb[i]}] - x[{i}], T(0))" if i in lb else None
        v = " + ".join(e for e in (hi, lo) if e)
        val.append(f"    {{ const T v = {v}; sp = sp + v * v; }}")
        g = " - ".join(e for e in (hi, lo) if e) if hi else f"-{lo}"
        grad.append(f"    gx[{i}] = gx[{i}] + prm[{w2}] * ({g});")
        out = ([f"x[{i}] > prm[{ub[i]}]"] if i in ub else []) \
            + ([f"x[{i}] < prm[{lb[i]}]"] if i in lb else [])
        hess.append(f"    if ({' || '.join(out)}) Hxx[{i * nx + i}] = "
                    f"Hxx[{i * nx + i}] + prm[{w2}];")
        ops += 6
    val.append(f"    c = c + prm[{w}] * sp;")
    return val, grad, hess, ops


def _words(mask: int, n: int) -> list:
    """The 32-bit words of a row mask over n candidate rows, low rows first
    (at least one)."""
    return [(mask >> (32 * w)) & 0xFFFFFFFF for w in range(max(1, -(-n // 32)))]


def _struct_head(nx, nu, N, n_theta, masks, RS, RT, tmask, cross, p_row,
                 p_trow, region) -> str:
    """The head of the problem struct, shared by both emitters: the sizes,
    the tiles, the row pattern in 32-bit words (RW per stage, RTW at the
    terminal stage) and where the row offsets sit in prm."""
    runs = _runs(masks)
    n_rows = 2 * nu + 2 * nx
    rw, rtw = len(_words(0, n_rows)), len(_words(0, 2 * nx))

    def word_fn(ws):
        """The body returning word w of ``ws``."""
        return ("".join(f"if (w == {i}) return {v}u; " for i, v in enumerate(ws[:-1]))
                + f"return {ws[-1]}u;")

    k0, _, m_last, s_last = runs[-1]
    mask_fn = "".join(f"    if (k < {k1}) {{ {word_fn(_words(m, n_rows))} }}\n"
                      for _, k1, m, _ in runs[:-1])
    mask_fn += f"    {word_fn(_words(m_last, n_rows))}"
    off_fn = "".join(f"    if (k < {k1}) return {s0} + (k - {k0}) * "
                     f"{bin(m).count('1')};\n" for k0, k1, m, s0 in runs[:-1])
    off_fn += f"    return {s_last} + (k - {k0}) * {bin(m_last).count('1')};"
    return f"""struct Problem {{
  static constexpr int NX = {nx}, NU = {nu}, N = {N}, NT = {n_theta};
  static constexpr int RS = {RS}, RT = {RT}, RW = {rw}, RTW = {rtw};
  static constexpr int TB = {WIP_TB}, MINB_F32 = {WIP_MIN_BLOCKS[0]},
                       MINB_F64 = {WIP_MIN_BLOCKS[1]}, E = {region};
  static constexpr bool CROSS = {"true" if cross else "false"};
  static constexpr int P_TOL = 0, P_TOL10 = 1, P_REG = 2, P_SMIN = 3,
                       P_KEPS = 4, P_KMU = 5, P_TMU = 6, P_TAUMIN = 7,
                       P_MAXIT = 8, P_ROW = {p_row}, P_TROW = {p_trow};

  // word w of the active candidate rows [u-ub; lb-u; x-ub; lb-x] of stage
  // k (row r is bit r & 31 of word r >> 5), and the slot of the first of
  // them; word w of the terminal rows [x-ub; lb-x]
  HM_HD static unsigned row_mask(int k, int w) {{
    (void)w;
{mask_fn}
  }}
  HM_HD static int row_off(int k) {{
{off_fn}
  }}
  HM_HD static constexpr unsigned term_mask(int w) {{
    {"(void)w; " if rtw == 1 else ""}{word_fn(_words(tmask, 2 * nx))}
  }}

"""


def emit_problem(src: OCPSource, dims, bounds, n_theta: int, options,
                 funcs=None) -> EmittedProblem:
    """The C++ problem struct for csrc/whole_ip.cuh and its numbers.
    ``bounds`` are numpy arrays (lbx, ubx, lbu, ubu) in solver coordinates;
    ``options`` the IPOptions whose constants go into prm. A problem this
    module's emitter takes (a model in the DSL or by state-space matrices,
    quadratic terms on states, inputs and input changes, soft state bounds)
    is written here; every other one from a trace of ``funcs``
    (ops/codegen_fx.py). What neither can write raises
    NotImplementedError."""
    nx, nu, N = dims.nx, dims.nu, dims.N
    if src.cost_error is not None:
        raise NotImplementedError(
            f"the whole-solve kernel cannot take {src.cost_error} "
            f"(ROADMAP.md §B)")
    why = src.dsl_error or model_emit_error(src.model)
    if why is not None:
        if funcs is None:
            raise NotImplementedError(
                f"{why}: the traced route needs the problem functions")
        from .codegen_fx import emit_fx_problem
        return emit_fx_problem(funcs, dims, bounds, n_theta, options)
    implicit = newton_size(src.spec, src.model.n_x, src.model.n_z) > 0
    rhs, model_ops, model_calls, alg_ops, alg_calls = emit_model(src.model, implicit)
    _check_dims(src, nx, nu)
    aug = src.augment_du
    prm = _Prm()
    tol = float(options.tol)
    for name in _IP_FIELDS:
        prm.add(tol / 10.0 if name == "tol10" else getattr(options, name))
    p_dt = prm.add(src.dt)
    # the scaling of every solver state (u_prev's is su) and control
    p_sx = len(prm.vals)
    for v in src.x_scaling + (src.u_scaling if aug else ()):
        prm.add(v)
    p_su = len(prm.vals)
    for v in src.u_scaling:
        prm.add(v)
    nx_model = src.model.n_x if aug else None
    sv, sg, sh, sc, s_ops = _emit_cost(src.stage_terms, src.off_rs, prm, nx, nu, False,
                                       nx_model)
    tv, tg, th_, _, t_ops = _emit_cost(src.term_terms, src.off_rt, prm, nx, nu, True,
                                       nx_model)
    cross = bool(sc)
    # the soft state bounds' penalty: one set of numbers, in both costs
    pv, pg, ph, p_ops = _emit_soft(src, prm, nx)
    sv, sg, sh, s_ops = sv + pv, sg + pg, sh + ph, s_ops + p_ops
    tv, tg, th_ = tv + pv, tg + pg, th_ + ph
    masks, offs, tmask, toffs = _rows(bounds, N, nx, nu)
    p_row = len(prm.vals)
    for v in offs:
        prm.add(v)
    p_trow = len(prm.vals)
    for v in toffs:
        prm.add(v)
    prm.add(0.0)                  # keeps P_ROW and P_TROW inside the array
    dyn, work = _emit_dyn(src, nx, nu, prm, p_sx, p_su)

    scale_in = "\n".join(
        [f"    T x[{nx}], u[{nu}];"]
        + [f"    x[{i}] = xs[{i}] * prm[{p_sx + i}];" for i in range(nx)]
        + [f"    u[{j}] = us[{j}] * prm[{p_su + j}];" for j in range(nu)])
    scale_x = (f"    T x[{nx}];\n"
               f"    for (int i = 0; i < {nx}; ++i) x[i] = xs[i] * prm[{p_sx} + i];")
    zero = lambda name, n: f"    for (int i = 0; i < {n}; ++i) {name}[i] = T(0);"  # noqa: E731
    scale_h = "\n".join(
        [f"    Hxx[{a * nx + b}] = Hxx[{a * nx + b}] * (hs * (prm[{p_sx + a}] * "
         f"prm[{p_sx + b}]));" for a in range(nx) for b in range(nx)]
        + [f"    Huu[{a * nu + b}] = Huu[{a * nu + b}] * (hs * (prm[{p_su + a}] * "
           f"prm[{p_su + b}]));" for a in range(nu) for b in range(nu)]
        + [f"    Hux[{a * nx + b}] = Hux[{a * nx + b}] * (hs * (prm[{p_su + a}] * "
           f"prm[{p_sx + b}]));" for a in range(nu) for b in range(nx) if cross])
    region = whole_ip_region(nx, nu, N, n_theta, len(offs), len(toffs))
    head = _struct_head(nx, nu, N, n_theta, masks, len(offs), len(toffs), tmask,
                        cross, p_row, p_trow, region)
    text = f"""// Generated by hilo_mpc_tpu_torch/ops/codegen_cuda.py: one NMPC problem
// for the whole-solve interior point of csrc/whole_ip.cuh.
{_includes(implicit)}
{head}{rhs}
{dyn}
  template <typename T>
  HM_HD static T stage_cost(const T* xs, const T* us, const T* th,
                            const T* prm) {{
{scale_in}
    (void)x; (void)u;
    T c = T(0);
{chr(10).join(sv)}
    return c * th[1] / prm[{p_dt}];
  }}
  template <typename T>
  HM_HD static void stage_grad(const T* xs, const T* us, const T* th,
                               const T* prm, T* gx, T* gu) {{
{scale_in}
    (void)x; (void)u;
{zero("gx", nx)}
{zero("gu", nu)}
{chr(10).join(sg)}
    const T hs = th[1] / prm[{p_dt}];
    for (int i = 0; i < {nx}; ++i) gx[i] = hs * (prm[{p_sx} + i] * gx[i]);
    for (int j = 0; j < {nu}; ++j) gu[j] = hs * (prm[{p_su} + j] * gu[j]);
  }}
  template <typename T>
  HM_HD static void stage_hess(const T* xs, const T* us, const T* th,
                               const T* prm, T* Hxx, T* Huu{", T* Hux" if cross else ""}) {{
{scale_in + chr(10) if ph else ""}{zero("Hxx", nx * nx)}
{zero("Huu", nu * nu)}{chr(10) + zero("Hux", nu * nx) if cross else ""}
{chr(10).join(sh + sc)}
    const T hs = th[1] / prm[{p_dt}];
{scale_h}
  }}
  template <typename T>
  HM_HD static T term_cost(const T* xs, const T* th, const T* prm) {{
{scale_x}
    (void)x;
    T c = T(0);
{chr(10).join(tv)}
    return c;
  }}
  template <typename T>
  HM_HD static void term_grad(const T* xs, const T* th, const T* prm, T* gx) {{
{scale_x}
    (void)x;
{zero("gx", nx)}
{chr(10).join(tg)}
    for (int i = 0; i < {nx}; ++i) gx[i] = prm[{p_sx} + i] * gx[i];
  }}
  template <typename T>
  HM_HD static void term_hess(const T* xs, const T* th, const T* prm, T* Hxx) {{
{scale_x + chr(10) if ph else ""}{zero("Hxx", nx * nx)}
{chr(10).join(th_)}
    for (int a = 0; a < {nx}; ++a)
      for (int b = 0; b < {nx}; ++b)
        Hxx[a * {nx} + b] = Hxx[a * {nx} + b] * (prm[{p_sx} + a] * prm[{p_sx} + b]);
  }}
}};

HM_WHOLE_IP_EXPORTS(Problem)
"""
    stage_rows = tuple((k, r) for k, m in enumerate(masks)
                       for r in range(2 * nu + 2 * nx) if (m >> r) & 1)
    term_rows = tuple(t for t in range(2 * nx) if (tmask >> t) & 1)
    n_rhs, n_comb = work.pop(("rhs", "S"), 0), work.pop("comb", 0)
    flops = _iteration_flops(
        nx, nu, N, len(offs), len(toffs), model_ops, model_calls, n_rhs, n_comb, s_ops,
        cross, _step_ops(work, (model_ops, model_calls), (alg_ops, alg_calls),
                         src.model.n_x, nx + nu))
    return EmittedProblem(text=text, prm=np.asarray(prm.vals, np.float64),
                          stage_rows=stage_rows, term_rows=term_rows, flops=flops,
                          region=region)


def _iteration_flops(nx, nu, N, RS, RT, model_ops, model_calls, n_rhs, n_comb,
                     cost_ops, cross=False, newton_ops=0) -> int:
    """Operations of one IP iteration of one scenario, as the algorithm
    needs them (one linearization and one gradient evaluation per iteration;
    what csrc/whole_ip.cuh evaluates again instead of storing is left out):
    each dual operation counts its value
    and its D = nx + nu derivative lanes (a product 1 + 3D, a function call
    2 + 2D), one operation per add, multiply, divide, square root or
    exponential of the solver algebra. The cost's cross block adds its
    scaling (3 per entry) and its sum into the Riccati step's Hux (1). An
    implicit step adds ``newton_ops`` (``_step_ops``: its Newton on plain
    values, the algebraic residuals, the tangents' solve)."""
    D = nx + nu
    step = (n_rhs * (model_ops * (1 + 3 * D) + model_calls * (2 + 2 * D))
            + n_comb * nx * (1 + 2 * (1 + D)) + (2 * nx + nu) * (1 + D) + newton_ops)
    grad = cost_ops + 2 * (nx + nu) + 2
    return int(N * (step + grad) + _solver_flops(nx, nu, N, RS, RT, cross))


def _solver_flops(nx, nu, N, RS, RT, cross=False) -> int:
    """The solver algebra's share of ``_iteration_flops``: per stage the KKT
    terms, the condensation, the Riccati step, the forward pass and the
    candidate; per active row its terms; the terminal stage."""
    kkt = nu * (2 * nx + 3) + nx * (2 * nx + 3) + nx + 2 * nx
    rows_kkt = 8                                      # per active row
    cond = 6 + 2 * nx * nx + 2 * nu * nu              # Hessians, per stage
    if cross:
        cond += 4 * nu * nx
    rows_cond = 8
    riccati = (2 * nx * nx + 2 * nx ** 3 + 2 * nx * nx * nu + 2 * nu * nu * nx
               + 2 * nu * nx * nx + 2 * nu * nx + nu ** 3 + 2 * nu * nu * (nx + 1)
               + 2 * nx ** 3 + 2 * nx * nx * nu + 2 * nx * nx + 2 * nx * nu
               + 2 * nu + 3 * nu * nu + 3 * nx * nx)
    fwd = 2 * nu * nx + nu + 2 * nx * nx + 2 * nx * nu + 2 * nx + 2 * nx * nx + nx
    rows_step = 12 + 14                               # direction + candidate
    cand = 2 * (nx + nu)
    per_stage = kkt + cond + riccati + fwd + cand
    per_row = rows_kkt + rows_cond + rows_step
    tail = 20 + nx * (nx + 4) + RT * per_row
    return N * per_stage + RS * per_row + tail
