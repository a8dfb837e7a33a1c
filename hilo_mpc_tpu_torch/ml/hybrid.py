"""Hybrid (physics + ML) model composition.

PyTorch port of ``hilo_mpc_tpu/ml/hybrid.py``: a trained network whose
labels name model *parameters* replaces those parameters by its
predictions, evaluated from features that are model states, inputs,
parameters or the time ``t``. The learned component is a plain function
(``predict_fn``), so the substitution is function composition: every
equation of the model (dynamics, algebraic, measurement, quadrature) gets
the full parameter vector back from the shrunk one. The composed closures
are batch-first like every model function, so the hybrid model runs
wherever the model ran: simulation, the general interior point, and the
whole-solve kernel's traced route (ops/codegen_fx.py writes the network's
products and activations as C++, its weights into prm).

A Gaussian process substitutes its posterior mean, m(x) + k(x, X)·α with
the weights solved once (``GaussianProcess.mean_fn``: no triangular solve,
so it traces to the emitter's ops), and a ``GPArray`` one GP after another.
The learned component must be the port's own (``ArtificialNeuralNetwork``,
``GaussianProcess``, ``GPArray``; utils/interop.py carries JAX ones across).
"""
from __future__ import annotations

import torch


def _predict_fn_of(learned):
    from .gp.gp import GaussianProcess
    from .nn import ArtificialNeuralNetwork

    if isinstance(learned, GaussianProcess):
        mean = learned.mean_fn()
        return ((lambda x: mean(x)[..., None]), list(learned.features),
                list(learned.labels))
    if isinstance(learned, ArtificialNeuralNetwork):
        return learned.predict_fn(), list(learned.features), list(learned.labels)
    raise TypeError(f"cannot compose model with {type(learned).__name__}; expected "
                    "a trained ANN or GaussianProcess (or GPArray) of this package")


def substitute_from(model, learned) -> None:
    """In-place substitution of model parameters by learned predictions."""
    from .gp.gp import GPArray

    if isinstance(learned, GPArray):
        for gp in learned:
            substitute_from(model, gp)
        return
    fn, features, labels = _predict_fn_of(learned)
    x_names = model.dynamical_states
    z_names = model.algebraic_states
    u_names = model.inputs
    p_names = model.parameters

    missing = [l for l in labels if l not in p_names]
    if missing:
        raise ValueError(
            f"labels {missing} are not model parameters; substitute_from replaces "
            f"parameters (have {p_names})")
    for f in features:
        if f not in x_names + z_names + u_names + p_names and f != "t":
            raise ValueError(f"feature {f!r} is not a model variable")

    keep_idx = [i for i, nm in enumerate(p_names) if nm not in labels]
    label_pos = {nm: i for i, nm in enumerate(labels)}

    def full_p(x, z, u, p_new, t):
        """(..., n_p) of the full parameter vector from the shrunk one."""
        env = {}
        for i, nm in enumerate(x_names):
            env[nm] = x[..., i]
        for i, nm in enumerate(z_names):
            env[nm] = z[..., i]
        for i, nm in enumerate(u_names):
            env[nm] = u[..., i]
        for j, i in enumerate(keep_idx):
            env[p_names[i]] = p_new[..., j]
        if "t" in features:
            env["t"] = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        feat = torch.stack(torch.broadcast_tensors(*[env[f] for f in features]),
                           dim=-1)
        pred = fn(feat)
        vals = [pred[..., label_pos[nm]] if nm in label_pos else env[nm]
                for nm in p_names]
        return torch.stack(torch.broadcast_tensors(*vals), dim=-1)

    def wrap(rhs):
        if rhs is None:
            return None

        def wrapped(x, z, u, p, t):
            return rhs(x, z, u, full_p(x, z, u, p, t), t)

        return wrapped

    model._ode = wrap(model._ode)
    model._alg = wrap(model._alg)
    model._meas = wrap(model._meas)
    model._quad = wrap(model._quad)
    model._p.names = [p_names[i] for i in keep_idx]
    # composed closures can be written neither from the equation text nor
    # by the DSL emitter: the whole-solve kernel traces them
    model._equations_src = None
    model._ode_origin, model._dsl = "callable", None
    model._setup_done = False
    model._step = None


def hybridize(model, learned):
    """``model + ann``: a new hybrid model; ``model`` keeps its closures."""
    new = model.copy(name=f"{model.name}_hybrid", keep_solution=False)
    substitute_from(new, learned)
    return new
