"""Equation-string DSL parser.

PyTorch port of ``hilo_mpc_tpu/utils/parsing.py``. Lines like ``dx/dt = ...``
declare ODEs, ``x(k+1) = ...`` discrete difference equations, ``y(k) = ...``
measurements, ``z(t) = ...`` explicit algebraic equations, ``0 = ...`` implicit
algebraic residuals, ``int = ...`` quadratures, ``name = <number>`` constants,
``name = expr`` auxiliary substitutions, and ``name|unit:/label:/description:``
metadata. Variable classes are inferred from notation: ``name(t)``
differential/algebraic states, ``name(k)`` inputs, bare undefined names
parameters. The bare symbols ``t`` and ``k`` are reserved.

Expressions compile via Python ``ast`` into plain functions over BATCH-FIRST
tensors: a variable vector ``x`` has shape ``(..., n_x)`` and ``x_i`` is read as
``x[..., i]``, so one call evaluates any number of scenarios/stages at once.
The function table holds only out-of-place torch ops, so the generated
functions run under ``torch.func`` transforms (``vmap``, ``jvp``, ``grad``).
"""
from __future__ import annotations

import ast
import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def _lift(torch_fn, np_fn):
    """DSL function: torch op when any argument is a tensor (plain numbers
    are converted to that tensor's dtype/device), a Python float otherwise
    (constant sub-expressions such as ``sqrt(2)``)."""
    def fn(*args):
        ref = next((a for a in args if torch.is_tensor(a)), None)
        if ref is None:
            return float(np_fn(*args))
        return torch_fn(*[a if torch.is_tensor(a)
                          else torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                          for a in args])
    return fn


_MATH_ENV = {
    "exp": _lift(torch.exp, np.exp), "log": _lift(torch.log, np.log),
    "ln": _lift(torch.log, np.log), "log10": _lift(torch.log10, np.log10),
    "sqrt": _lift(torch.sqrt, np.sqrt), "sin": _lift(torch.sin, np.sin),
    "cos": _lift(torch.cos, np.cos), "tan": _lift(torch.tan, np.tan),
    "asin": _lift(torch.asin, np.arcsin), "arcsin": _lift(torch.asin, np.arcsin),
    "acos": _lift(torch.acos, np.arccos), "arccos": _lift(torch.acos, np.arccos),
    "atan": _lift(torch.atan, np.arctan), "arctan": _lift(torch.atan, np.arctan),
    "atan2": _lift(torch.atan2, np.arctan2),
    "arctan2": _lift(torch.atan2, np.arctan2),
    "sinh": _lift(torch.sinh, np.sinh), "cosh": _lift(torch.cosh, np.cosh),
    "tanh": _lift(torch.tanh, np.tanh),
    "asinh": _lift(torch.asinh, np.arcsinh), "arsinh": _lift(torch.asinh, np.arcsinh),
    "acosh": _lift(torch.acosh, np.arccosh), "arcosh": _lift(torch.acosh, np.arccosh),
    "atanh": _lift(torch.atanh, np.arctanh), "artanh": _lift(torch.atanh, np.arctanh),
    "abs": _lift(torch.abs, np.abs), "fabs": _lift(torch.abs, np.abs),
    "sign": _lift(torch.sign, np.sign),
    "fmin": _lift(torch.minimum, np.minimum), "fmax": _lift(torch.maximum, np.maximum),
    "minimum": _lift(torch.minimum, np.minimum),
    "maximum": _lift(torch.maximum, np.maximum),
    "floor": _lift(torch.floor, np.floor), "ceil": _lift(torch.ceil, np.ceil),
    "erf": _lift(torch.special.erf, math.erf),
    "pi": np.pi, "inf": np.inf,
}

_META_RE = re.compile(r"^\s*(\w+)\s*\|\s*(unit|label|description)\s*:\s*(.*?)\s*$")
_ODE_RE = re.compile(r"^\s*d\s*(\w+)\s*/\s*dt\s*$")
_ODE_NESTED_RE = re.compile(r"^\s*d\s*\(\s*(\w+)\s*\(\s*t\s*\)\s*\)\s*/\s*dt\s*$")
_DISC_RE = re.compile(r"^\s*(\w+)\s*\(\s*k\s*\+\s*1\s*\)\s*$")
_MEAS_RE = re.compile(r"^\s*(\w+)\s*\(\s*k\s*\)\s*$")
_ALG_EXPL_RE = re.compile(r"^\s*(\w+)\s*\(\s*t\s*\)\s*$")


class _VarCollector(ast.NodeVisitor):
    """Collect name references, classified by call notation."""

    def __init__(self):
        self.t_vars: List[str] = []     # name(t)
        self.k_vars: List[str] = []     # name(k)
        self.bare: List[str] = []       # bare names
        self.funcs: List[str] = []

    def visit_Call(self, node: ast.Call):
        if (isinstance(node.func, ast.Name) and node.func.id not in _MATH_ENV
                and len(node.args) == 1 and isinstance(node.args[0], ast.Name)
                and node.args[0].id in ("t", "k") and not node.keywords):
            name = node.func.id
            kind = node.args[0].id
            tgt = self.t_vars if kind == "t" else self.k_vars
            if name not in tgt:
                tgt.append(name)
            return  # don't descend into the pseudo-call
        if isinstance(node.func, ast.Name) and node.func.id not in self.funcs:
            self.funcs.append(node.func.id)
        for arg in node.args:
            self.visit(arg)

    def visit_Name(self, node: ast.Name):
        if node.id not in self.bare:
            self.bare.append(node.id)


class _CallStripper(ast.NodeTransformer):
    """Rewrite ``name(t)`` / ``name(k)`` pseudo-calls to plain ``name`` references."""

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Name) and node.func.id not in _MATH_ENV
                and len(node.args) == 1 and isinstance(node.args[0], ast.Name)
                and node.args[0].id in ("t", "k") and not node.keywords):
            return ast.copy_location(ast.Name(id=node.func.id, ctx=ast.Load()), node)
        return node


def _compile_expr(expr: str, where: str):
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ValueError(f"cannot parse expression {expr!r} in {where}: {e}") from None
    for node in ast.walk(tree):
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Lambda, ast.ListComp,
                             ast.DictComp, ast.SetComp, ast.GeneratorExp, ast.Await,
                             ast.Yield, ast.YieldFrom, ast.NamedExpr)):
            raise ValueError(f"unsupported syntax in expression {expr!r}")
    collector = _VarCollector()
    collector.visit(tree.body)
    stripped = _CallStripper().visit(tree)
    ast.fix_missing_locations(stripped)
    code = compile(stripped, f"<model:{where}>", "eval")
    return code, collector


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _stack_like(vals, x):
    """Stack per-row values (tensors or numbers) along a new last axis, cast
    to ``x``'s dtype/device and broadcast to a common batch shape that
    includes ``x``'s own."""
    rows = [v.to(x.dtype) if torch.is_tensor(v)
            else torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in vals]
    rows = torch.broadcast_tensors(*rows, torch.zeros_like(x[..., 0]))[:-1]
    return torch.stack(rows, dim=-1)


@dataclasses.dataclass
class ParsedEquations:
    states: List[str]
    algebraic: List[str]
    inputs: List[str]
    parameters: List[str]
    measurements: List[str]
    constants: Dict[str, float]
    meta: Dict[str, Dict[str, str]]
    discrete: bool
    n_quad: int
    ode: Optional[Callable]      # f(x, z, u, p, t) -> dx   (or discrete map)
    alg: Optional[Callable]      # g(x, z, u, p, t) -> residuals
    meas: Optional[Callable]     # h(x, z, u, p, t) -> y
    quad: Optional[Callable]
    # raw RHS sources in declaration order
    ode_src: Dict[str, str] = dataclasses.field(default_factory=dict)
    meas_src: Dict[str, str] = dataclasses.field(default_factory=dict)
    aux_src: List[tuple] = dataclasses.field(default_factory=list)
    # the algebraic residuals' sources in the order ``alg`` returns them
    alg_src: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class DSLSource:
    """What code generation needs of a model's state equations
    (ops/codegen_cuda.py emits C++ from it): the RHS source of each state in
    state order (ODE or difference equation), the auxiliary definitions in
    dependency order, the numeric constants, and the name -> index maps of
    the state, input and parameter vectors; for a DAE the algebraic
    residuals' sources (``0 = g`` as g, ``z(t) = e`` as ``z - (e)``) in the
    order of the model's ``alg`` and the algebraic states' name -> index
    map."""
    rhs: tuple                   # (source, ...) per state, in state order
    aux: tuple                   # ((name, source), ...) in dependency order
    constants: Dict[str, float]
    x_idx: Dict[str, int]
    u_idx: Dict[str, int]
    p_idx: Dict[str, int]
    discrete: bool
    alg: tuple = ()
    z_idx: Dict[str, int] = dataclasses.field(default_factory=dict)


def parse_equations(text: str, known_states: Optional[List[str]] = None,
                    known_inputs: Optional[List[str]] = None,
                    known_parameters: Optional[List[str]] = None,
                    known_algebraic: Optional[List[str]] = None) -> ParsedEquations:
    ode_exprs: Dict[str, tuple] = {}
    disc_exprs: Dict[str, tuple] = {}
    meas_exprs: Dict[str, tuple] = {}
    ode_srcs: Dict[str, str] = {}
    meas_srcs: Dict[str, str] = {}
    aux_srcs: Dict[str, str] = {}
    alg_expl: Dict[str, tuple] = {}
    alg_impl: List[tuple] = []
    alg_srcs: Dict[object, str] = {}
    quad_exprs: List[tuple] = []
    aux_exprs: Dict[str, tuple] = {}
    constants: Dict[str, float] = {}
    meta: Dict[str, Dict[str, str]] = {}

    t_vars: List[str] = []
    k_vars: List[str] = []
    bare: List[str] = []

    def note(coll: _VarCollector):
        for n in coll.t_vars:
            if n not in t_vars:
                t_vars.append(n)
        for n in coll.k_vars:
            if n not in k_vars:
                k_vars.append(n)
        for n in coll.bare:
            if n not in bare:
                bare.append(n)

    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        m = _META_RE.match(line)
        if m:
            meta.setdefault(m.group(1), {})[m.group(2)] = m.group(3)
            continue
        if "=" not in line:
            raise ValueError(f"cannot parse line {raw_line!r}")
        lhs, rhs = line.split("=", 1)
        lhs, rhs = lhs.strip(), rhs.strip()
        where = lhs

        m = _ODE_RE.match(lhs) or _ODE_NESTED_RE.match(lhs)
        if m:
            code, coll = _compile_expr(rhs, where)
            ode_exprs[m.group(1)] = (code, coll)
            ode_srcs[m.group(1)] = rhs
            note(coll)
            continue
        m = _DISC_RE.match(lhs)
        if m:
            code, coll = _compile_expr(rhs, where)
            disc_exprs[m.group(1)] = (code, coll)
            ode_srcs[m.group(1)] = rhs
            note(coll)
            continue
        m = _MEAS_RE.match(lhs)
        if m:
            code, coll = _compile_expr(rhs, where)
            meas_exprs[m.group(1)] = (code, coll)
            meas_srcs[m.group(1)] = rhs
            note(coll)
            continue
        m = _ALG_EXPL_RE.match(lhs)
        if m:
            code, coll = _compile_expr(rhs, where)
            alg_expl[m.group(1)] = (code, coll)
            alg_srcs[m.group(1)] = f"{m.group(1)} - ({rhs})"
            note(coll)
            continue
        if lhs == "0":
            code, coll = _compile_expr(rhs, where)
            alg_srcs[len(alg_impl)] = rhs
            alg_impl.append((code, coll))
            note(coll)
            continue
        if lhs == "int":
            code, coll = _compile_expr(rhs, where)
            quad_exprs.append((code, coll))
            note(coll)
            continue
        if re.fullmatch(r"\w+", lhs):
            if _is_number(rhs):
                constants[lhs] = float(rhs)
            else:
                code, coll = _compile_expr(rhs, where)
                aux_exprs[lhs] = (code, coll)
                aux_srcs[lhs] = rhs
                note(coll)
            continue
        raise ValueError(f"cannot parse left-hand side {lhs!r}")

    discrete = bool(disc_exprs)
    if discrete and ode_exprs:
        raise ValueError("cannot mix dx/dt and x(k+1) equations in one model")
    state_eqs = disc_exprs if discrete else ode_exprs

    # --- classify variables -------------------------------------------------
    states = list(known_states or [])
    for n in state_eqs:
        if n not in states:
            states.append(n)
    if state_eqs:
        for n in states:
            if n not in state_eqs:
                raise ValueError(f"declared state {n!r} has no equation")

    algebraic = list(known_algebraic or [])
    for n in t_vars:
        if n not in states and n not in algebraic:
            algebraic.append(n)
    for n in alg_expl:
        if n not in algebraic and n not in states:
            algebraic.append(n)
    inputs = list(known_inputs or [])
    for n in k_vars:
        if n in meas_exprs or n in states:
            continue
        if n not in inputs:
            inputs.append(n)

    measurements = list(meas_exprs)

    defined = (set(states) | set(algebraic) | set(inputs) | set(constants)
               | set(aux_exprs) | set(measurements) | {"t", "k"} | set(_MATH_ENV))
    parameters = list(known_parameters or [])
    for n in bare:
        if n not in defined and n not in parameters:
            parameters.append(n)

    n_alg_eq = len(alg_impl) + len(alg_expl)
    if n_alg_eq != len(algebraic):
        raise ValueError(
            f"{len(algebraic)} algebraic variables {algebraic} but {n_alg_eq} "
            f"algebraic equations")

    # --- build evaluators ---------------------------------------------------
    x_idx = {n: i for i, n in enumerate(states)}
    z_idx = {n: i for i, n in enumerate(algebraic)}
    u_idx = {n: i for i, n in enumerate(inputs)}
    p_idx = {n: i for i, n in enumerate(parameters)}

    # order aux definitions by dependency
    aux_order: List[str] = []
    remaining = dict(aux_exprs)
    for _ in range(len(aux_exprs) + 1):
        progressed = False
        for name, (code, coll) in list(remaining.items()):
            deps = [b for b in coll.bare if b in aux_exprs and b != name]
            if all(d in aux_order for d in deps):
                aux_order.append(name)
                del remaining[name]
                progressed = True
        if not remaining:
            break
        if not progressed:
            raise ValueError(f"circular auxiliary definitions among {list(remaining)}")

    def make_env(x, z, u, p, t):
        env = dict(_MATH_ENV)
        env["t"] = t
        env["k"] = t
        for n, i in x_idx.items():
            env[n] = x[..., i]
        for n, i in z_idx.items():
            env[n] = z[..., i]
        for n, i in u_idx.items():
            env[n] = u[..., i]
        for n, i in p_idx.items():
            env[n] = p[..., i]
        env.update(constants)
        for n in aux_order:
            env[n] = eval(aux_exprs[n][0], {"__builtins__": {}}, env)
        return env

    def make_vector_fn(codes: List):
        def fn(x, z, u, p, t):
            env = make_env(x, z, u, p, t)
            return _stack_like([eval(c, {"__builtins__": {}}, env) for c in codes], x)
        return fn

    ode_fn = (make_vector_fn([state_eqs[n][0] for n in states])
              if state_eqs else None)

    alg_codes = [code for code, _ in alg_impl]
    alg_fn = None
    if algebraic:
        expl_items = [(z_idx[n], code) for n, (code, _) in alg_expl.items()]

        def alg_fn(x, z, u, p, t):
            env = make_env(x, z, u, p, t)
            res = [eval(c, {"__builtins__": {}}, env) for c in alg_codes]
            for zi, code in expl_items:
                res.append(z[..., zi] - eval(code, {"__builtins__": {}}, env))
            return _stack_like(res, x)

    meas_fn = (make_vector_fn([meas_exprs[n][0] for n in measurements])
               if measurements else None)
    quad_fn = (make_vector_fn([c for c, _ in quad_exprs]) if quad_exprs else None)

    return ParsedEquations(
        states=states, algebraic=algebraic, inputs=inputs, parameters=parameters,
        measurements=measurements, constants=constants, meta=meta, discrete=discrete,
        n_quad=len(quad_exprs), ode=ode_fn, alg=alg_fn, meas=meas_fn, quad=quad_fn,
        ode_src=dict(ode_srcs), meas_src=dict(meas_srcs),
        aux_src=[(n, aux_srcs[n]) for n in aux_order],
        alg_src=[alg_srcs[i] for i in range(len(alg_impl))]
        + [alg_srcs[n] for n in alg_expl])


def apply_parsed_equations(model, text: str) -> None:
    """Populate a Model from DSL text, honoring any pre-declared variable names."""
    parsed = parse_equations(
        text,
        known_states=model._x.names or None,
        known_inputs=model._u.names or None,
        known_parameters=model._p.names or None,
        known_algebraic=model._z.names or None,
    )
    model._x.names = list(parsed.states)
    model._z.names = list(parsed.algebraic)
    model._u.names = list(parsed.inputs)
    model._p.names = list(parsed.parameters)
    if parsed.measurements:
        model._y.names = list(parsed.measurements)
    for var, md in parsed.meta.items():
        for spec in (model._x, model._z, model._u, model._p, model._y):
            if var in spec:
                spec.set_meta(var, **md)
    if parsed.discrete:
        model._discrete = True
    # content markers: controllers on models built from equal text share a
    # registry entry (Model.trace_signature, utils/trace_cache.py)
    for fn in (parsed.ode, parsed.alg, parsed.meas, parsed.quad):
        if fn is not None:
            fn._hilo_dsl_src = text
    if parsed.ode is not None:
        model._ode = parsed.ode
        model._ode_origin = "dsl"
        model._dsl = DSLSource(
            rhs=tuple(parsed.ode_src[n] for n in parsed.states),
            aux=tuple(parsed.aux_src), constants=dict(parsed.constants),
            x_idx={n: i for i, n in enumerate(parsed.states)},
            u_idx={n: i for i, n in enumerate(parsed.inputs)},
            p_idx={n: i for i, n in enumerate(parsed.parameters)},
            discrete=parsed.discrete, alg=tuple(parsed.alg_src),
            z_idx={n: i for i, n in enumerate(parsed.algebraic)})
    if parsed.alg is not None:
        model._alg = parsed.alg
    if parsed.meas is not None:
        model._meas = parsed.meas
    if parsed.quad is not None:
        model._quad = parsed.quad
        if model._q.n == 0:
            model._q.add(parsed.n_quad, prefix="q")
