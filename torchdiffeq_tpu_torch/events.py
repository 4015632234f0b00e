"""Event handling: root finding on the dense interpolant, multi-output event
combination, and `odeint_event` with implicit-function-theorem gradients
for the event time (counterpart of ``torchdiffeq_tpu/events.py``;
reference torchdiffeq/_impl/event_handling.py and odeint.py:160-231).

Event functions get their time as a 0-d float64 tensor on the state's
device, and signs follow `jnp.sign` (NaN at NaN; ``torch.sign`` gives 0
there, see `misc.nan_sign`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .misc import (check_inputs, data_axis, nan_sign, ravel_leaves, real_part,
                   scalar_type, smax, time_effect, time_tensor, tree_flatten,
                   tree_leaves, tree_map, tree_unflatten)


def find_event(interp_fn, sign0, t0, t1, event_fn, tol, dtype=torch.float64):
    """Bisect for the sign change of `event_fn` on [t0, t1] (JAX
    `find_event`, events.py:14-50; reference event_handling.py:5-20).

    ``ceil(log2(|t1 - t0| / tol))`` iterations localise the event time to
    within `tol`.  `t0`, `t1` and `tol` are host scalars (a tolerance
    tensor counts by its max, as JAX collapses per-leaf tolerances), so the
    count is known before the loop, and the loop is a plain sequence of
    ``torch.where`` on the device with no host read inside it.  `sign0` is
    a tensor on the state's device.  The bisection runs in the time
    `dtype`: float64, or the state dtype of a fixed-grid event solve.
    Returns ``(event_t, interp_fn(event_t))`` with `event_t` a 0-d tensor
    of `dtype` there.
    """
    if isinstance(tol, torch.Tensor):
        tol = tol.max().item()
    if dtype == torch.float64:
        span = abs(float(t1) - float(t0))
        nitrs = math.ceil(math.log2(max(span / float(tol), 1.0)))
    else:
        # the count in the time dtype, as JAX computes it
        sd = scalar_type(dtype)
        q = smax(abs(sd(t1) - sd(t0)) / sd(tol), sd(1.0))
        q = torch.log2(q) if isinstance(q, torch.Tensor) else np.log2(q)
        nitrs = math.ceil(float(q))
    lo = torch.full((), float(t0), dtype=dtype, device=sign0.device)
    hi = torch.full((), float(t1), dtype=dtype, device=sign0.device)
    for _ in range(nitrs):
        t_mid = (lo + hi) / 2.0
        same = sign0 == nan_sign(event_fn(t_mid, interp_fn(t_mid)))
        lo = torch.where(same, t_mid, lo)
        hi = torch.where(same, hi, t_mid)
    event_t = (lo + hi) / 2.0
    return event_t, interp_fn(event_t)


def combine_event_functions(event_fn, t0, y0):
    """Make a (possibly multi-output) event function initially positive and
    combine its outputs with `min` (JAX events.py:53-63; reference
    event_handling.py:23-35)."""
    with torch.no_grad():
        initial_signs = nan_sign(event_fn(time_tensor(t0, y0), y0))

    def combined_event_fn(t, y):
        return torch.min(event_fn(t, y) * initial_signs)

    return combined_event_fn


class _ImplicitFnGradientRerouting(torch.autograd.Function):
    """Identity on (event_t, state_t) whose backward reroutes the event-time
    gradient into the state (reference `ImplicitFnGradientRerouting`,
    odeint.py:197-231; JAX `_implicit_fn_gradient_rerouting`,
    events.py:66-132):

        dc/dt = dc/dt|_partial + <dc/dy, f(t*, y*)>
        grad_state += dc/dy * (-(grad_t + <grad_state, f>) / (dc/dt + 1e-12))

    The event time itself receives a zero gradient.  Tensors that `func`
    and `event_fn` capture (parameters) are not inputs of the Function, so
    the evaluation here gives them no gradient, as the JAX package's zero
    cotangents for its closure-converted constants do.

    Under a data axis (`misc.data_axis`, `parallel.sharding`) the state is
    this rank's rows and the event time is replicated: the event function
    gathers the state, so ``dc/dy`` comes back as this rank's rows, and the
    two inner products over the state, the blocks' shares, are summed over
    the axis (one all-reduce) before the replicated ``dc/dt|_partial`` and
    ``grad_t`` are added, each counted once.
    """

    @staticmethod
    def forward(ctx, func, event_fn, event_t, state_t):
        ctx.func, ctx.event_fn = func, event_fn
        ctx.axis = data_axis()
        ctx.save_for_backward(event_t, state_t)
        return event_t.detach(), state_t.detach()

    @staticmethod
    def backward(ctx, grad_t, grad_state):
        event_t, state_t = (x.detach() for x in ctx.saved_tensors)
        with torch.no_grad():
            f_val = ctx.func(event_t, state_t)
        with torch.enable_grad():
            tt = event_t.clone().requires_grad_()
            yy = state_t.clone().requires_grad_()
            c = ctx.event_fn(tt, yy)
            par_dt, dstate = torch.autograd.grad(
                c, (tt, yy), torch.ones_like(c), allow_unused=True)
        if par_dt is None:
            par_dt = torch.zeros_like(event_t)
        if dstate is None:
            dstate = torch.zeros_like(state_t)
        # total derivative of the event function in t at the event, and
        # the gradient from the final state to the final time, as for
        # odeint: real inner products, Re sum(conj(g) f) for a complex
        # state (`misc.time_effect`)
        inner = torch.stack([_inner(f_val, dstate),
                             _inner(f_val, grad_state)])
        if ctx.axis is not None:
            inner = ctx.axis.sum(inner)
        dcdt = par_dt + inner[0]
        grad_t_total = grad_t + inner[1]
        grad_state = grad_state + dstate * (-grad_t_total / (dcdt + 1e-12))
        return None, None, torch.zeros_like(event_t), grad_state


def _inner(f, g):
    return real_part(time_effect(f.reshape(1, -1), g.reshape(1, -1))[0])


def _implicit_fn_gradient_rerouting(func, event_fn, event_t, state_t):
    """``(event_t, state_t)``, detached, with the IFT backward of
    `_ImplicitFnGradientRerouting`."""
    return _ImplicitFnGradientRerouting.apply(func, event_fn, event_t,
                                              state_t)


def odeint_event(func, y0, t0, *, event_fn, reverse_time=False,
                 odeint_interface=None, args=(), **kwargs):
    """Solve until `event_fn(t, y)` crosses zero (JAX `odeint_event`,
    events.py:135-199; reference odeint.py:160-194).

    Returns ``(event_t, solution)``: `event_t` a 0-d float64 tensor on the
    state's device, and `solution` stacking ``[y(t0), y(event_t)]`` on a new
    leading axis (on each leaf of a pytree state).

    Gradients: the solve's come from the continuous adjoint, as if it had
    integrated up to the event time (`odeint` or `odeint_adjoint` as
    `odeint_interface`), and the event time's through the final state by
    the implicit function theorem (`_ImplicitFnGradientRerouting`).  With
    ``options=dict(replay_grad=True)`` on an adaptive method through
    `odeint`, both are the replay's (`solvers/replay.py`), exact for the
    discrete solution.
    """
    from .odeint import odeint
    from .solvers import SOLVERS

    if odeint_interface is None:
        odeint_interface = odeint

    # t0 keeps its gradient (a chained solve starts at an earlier event
    # time); the direction point is t0's value moved by one, no input
    t0 = torch.as_tensor(t0, dtype=torch.float64).cpu().reshape(())
    t1 = t0.detach() - 1.0 if reverse_time else t0.detach() + 1.0
    t = torch.stack([t0, t1])

    event_t, solution = odeint_interface(func, y0, t, event_fn=event_fn,
                                         args=args, **kwargs)

    # a replay event solve (JAX events.py:160-170) already returns an event
    # time and state with the exact gradients of the discrete solution:
    # no reroute, when the replay ran (an adaptive method through `odeint`)
    if (kwargs.get('options') or {}).get('replay_grad') \
            and odeint_interface is odeint \
            and SOLVERS.get(kwargs.get('method') or 'dopri5', {}).get(
                'kind') == 'adaptive':
        return event_t, solution

    # the reroute works in the internal frame and on the flat state, as the
    # event function of the normalised problem does (reference
    # odeint.py:171)
    prob = check_inputs(func, y0, t, 0.0, 0.0, None, None, event_fn, SOLVERS,
                        args=tuple(args))
    if prob.unravel is None:
        state_t = solution[-1]
    else:
        state_t = ravel_leaves(tree_map(lambda s: s[-1], solution))
    if reverse_time:
        event_t = -event_t
    event_t, state_t = _implicit_fn_gradient_rerouting(
        lambda tt, yy: prob.func(tt, yy), prob.event_fn, event_t, state_t)
    if reverse_time:
        event_t = -event_t

    # splice the rerouted final state back into the solution
    if prob.unravel is None:
        return event_t, torch.cat([solution[:-1], state_t[None]], dim=0)
    leaves, treedef = tree_flatten(solution)
    return event_t, tree_unflatten(treedef, [
        torch.cat([s[:-1], s_t[None]], dim=0)
        for s, s_t in zip(leaves, tree_leaves(prob.unravel(state_t)))])
