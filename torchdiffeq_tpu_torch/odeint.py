"""The `odeint` front door (counterpart of ``torchdiffeq_tpu/odeint.py``).

This slice carries the explicit adaptive tier through the host-loop solver,
event solves (``event_fn=...``) on the same tier, and the fused RK4 kernel
route ``odeint(..., method='rk4', options=dict(pallas=True, num_steps=N))``.
Everything that would reach a solver family not yet ported raises
`NotImplementedError` naming its ROADMAP item.

Gradients: as in the JAX package (odeint.py:319-329), an adaptive solve or
an event solve that autograd would have to differentiate -- grad mode on,
and `y0`, `t`, a tensor in `args` or a parameter of an ``nn.Module`` field
requiring grad -- takes its gradients from the continuous adjoint
(`adjoint.adjoint_solve`) at the forward settings.  The kernel route is
forward-only and raises instead of returning a detached result;
``replay_grad`` and ``forward_grad`` are ROADMAP A10.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .misc import check_inputs, host_times, is_tuple_state, needs_autograd
from .solvers import SOLVERS, NOT_PORTED
from .solvers import adaptive_rk
from .solvers.solution import Stats

# the Pallas kernels' own options, accepted and dropped off their routes
_KERNEL_OPTIONS = ('pallas', 'interpret', 'block_b')


def _differentiable(func, y0, t, args):
    """Whether autograd would have to record through a solve."""
    from .adjoint import _tensors_in
    leaves = tuple(y0) if is_tuple_state(y0) else (y0,)
    return needs_autograd(func, *leaves, t, *_tensors_in(args))


def _refuse_autograd(func, y0, t, args):
    if _differentiable(func, y0, t, args):
        raise NotImplementedError(
            "the rk4 kernel route is forward-only, as the JAX kernel is; its "
            "differentiable scan loop is ROADMAP A4 (call the route under "
            "torch.no_grad())")


def _adaptive_config(prob, tableau):
    opts = dict(prob.options)
    for name in opts:
        if name in adaptive_rk.NOT_PORTED_OPTIONS:
            raise NotImplementedError(
                f"option {name!r} is not ported yet "
                f"({adaptive_rk.NOT_PORTED_OPTIONS[name]})")
    unused = set(opts) - adaptive_rk.SUPPORTED_OPTIONS
    if unused:
        warnings.warn(f"adaptive solver: Unexpected arguments {sorted(unused)}")
    return adaptive_rk.AdaptiveConfig(
        tableau=tableau, rtol=prob.rtol, atol=prob.atol, norm=prob.norm,
        first_step=opts.get('first_step'),
        safety=opts.get('safety', 0.9),
        ifactor=opts.get('ifactor', 10.0),
        dfactor=opts.get('dfactor', 0.2),
        min_step=opts.get('min_step', 0.0),
        max_step=opts.get('max_step', float('inf')),
        max_num_steps=opts.get('max_num_steps', 2 ** 31 - 1),
        step_t=opts.get('step_t'), jump_t=opts.get('jump_t'),
        jump_state_fn=opts.get('jump_state_fn'),
        step_to_end=bool(opts.get('step_to_end', False)))


def odeint(func, y0, t, *, rtol=1e-7, atol=1e-9, method=None, options=None,
           event_fn=None, args=()):
    """Integrate ``dy/dt = func(t, y, *args)`` from ``y(t[0]) = y0`` and
    return the solution at every time in `t`, shape ``(T, *y0.shape)``
    (JAX `odeint`, torchdiffeq_tpu/odeint.py:162; reference odeint.py:49).

    `y0` is one float32/float64 tensor on any device, or a tuple of them;
    `t` is strictly monotonic (decreasing time integrates backwards).  Time
    is float64.  Under autograd the gradients come from the continuous
    adjoint (`odeint_adjoint` at the same settings).

    With `event_fn`, `t` holds two times (the start and a point giving the
    direction) and the solve runs until ``event_fn(t, y)`` changes sign; it
    returns ``(event_t, ys)``, `event_t` a 0-d float64 tensor on the
    state's device and ``ys = stack([y0, y(event_t)])``.
    """
    ys, _ = _odeint_impl(func, y0, t, rtol, atol, method, options, event_fn,
                         args)
    return ys


def odeint_with_stats(func, y0, t, *, rtol=1e-7, atol=1e-9, method=None,
                      options=None, event_fn=None, args=()):
    """Like `odeint`, also returning the solve's `Stats` (NFE, steps,
    accepted and rejected steps, error code)."""
    return _odeint_impl(func, y0, t, rtol, atol, method, options, event_fn,
                        args)


def _try_pallas_rk4(func, y0, t, method, options, event_fn, args):
    """The fused RK4 kernel route (JAX `_try_pallas_rk4`, odeint.py:190-239)
    for ``method='rk4', options=dict(pallas=True, num_steps=N)``, with the
    same qualification: a 2-D (B, D) real state, output times increasing
    and uniformly strided on the `num_steps` grid, no event function.  The
    Pallas kernel's own options `interpret` and `block_b` (a TPU lane tile)
    are accepted and dropped, as the JAX route takes them.
    Returns (ys, Stats) or None."""
    opts = options or {}
    if not isinstance(opts, dict) or not opts.get('pallas'):
        return None
    if method != 'rk4' or event_fn is not None:
        return None
    if set(opts) - {'pallas', 'num_steps', 'interpret', 'block_b'}:
        return None
    n_steps = opts.get('num_steps')
    if n_steps is None:
        return None
    if not isinstance(y0, torch.Tensor) or y0.dim() != 2 \
            or y0.is_complex():
        return None
    t_np = host_times(t)
    T = t_np.shape[0]
    if T < 2 or not (np.diff(t_np) > 0).all():
        return None
    n_steps = int(n_steps)
    if n_steps % (T - 1) != 0:
        return None
    # outputs must sit exactly on the uniform grid
    if not np.allclose(t_np, np.linspace(t_np[0], t_np[-1], T),
                       rtol=0, atol=1e-12 * max(1.0, abs(t_np[-1]))):
        return None

    from .ops.kernels import rk4_integrate
    _refuse_autograd(func, y0, t, args)
    dt = (t_np[-1] - t_np[0]) / n_steps
    ys = rk4_integrate(func, y0, t_np[0], dt, n_steps, tuple(args),
                       out_every=n_steps // (T - 1))
    return ys, Stats.make(nfe=4 * n_steps, n_steps=n_steps,
                          n_accepted=n_steps)


def _odeint_impl(func, y0, t, rtol, atol, method, options, event_fn, args):
    res = _try_pallas_rk4(func, y0, t, method, options, event_fn, args)
    if res is not None:
        return res
    if isinstance(options, dict):
        options = {k: v for k, v in options.items()
                   if k not in _KERNEL_OPTIONS}
    name = 'dopri5' if method is None else method
    if event_fn is not None and (name in NOT_PORTED or SOLVERS.get(
            name, {}).get('kind') == 'fixed'):
        raise NotImplementedError(
            f"event solves with method {name!r}: the fixed-grid, Adams and "
            "implicit event routes come with their tiers (ROADMAP A4, A9)")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"method {name!r} is not ported yet ({NOT_PORTED[name]})")
    if SOLVERS.get(name, {}).get('kind') == 'fixed':
        raise NotImplementedError(
            "rk4 runs only on the fused kernel route (options=dict("
            "pallas=True, num_steps=N) with uniform increasing output times "
            "and a 2-D state); its scan loop is ROADMAP A4")
    if _differentiable(func, y0, t, args):
        # JAX odeint.py:319-329: the continuous adjoint at the forward
        # settings, with no backward options
        from .adjoint import adjoint_solve
        return adjoint_solve(
            func, y0, t, rtol=rtol, atol=atol, method=name, options=options,
            event_fn=event_fn, args=args, adjoint_rtol=rtol,
            adjoint_atol=atol, adjoint_method=name, adjoint_options=None)
    prob = check_inputs(func, y0, t, rtol, atol, method, options, event_fn,
                        SOLVERS, args=tuple(args))
    cfg = _adaptive_config(prob, SOLVERS[prob.method]['tableau'])
    unravel = prob.unravel or (lambda x: x)
    with torch.no_grad():
        if event_fn is None:
            ys, stats = adaptive_rk.integrate(prob.func, prob.y0, prob.t, cfg)
            return unravel(ys), stats
        # JAX `_solve_event_normalised` (odeint.py:125-154), the event time
        # mapped back to the user's frame
        event_t, y_event, stats = adaptive_rk.integrate_until_event(
            prob.func, prob.y0, prob.t[0], prob.event_fn, cfg)
        return ((prob.t_sign * event_t,
                 unravel(torch.stack([prob.y0, y_event]))), stats)
