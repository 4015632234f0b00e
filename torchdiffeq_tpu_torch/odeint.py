"""The `odeint` front door (counterpart of ``torchdiffeq_tpu/odeint.py``).

Every method of the JAX package is here: the adaptive tier through the
host-loop solver (`solvers/adaptive_rk.py`; kvaerno3, kvaerno5 and radau5a
with its implicit step functions), the fixed-grid tier (euler, midpoint,
heun2, heun3, rk4; `solvers/fixed_grid.py`), the Adams methods
(`solvers/adams.py`) and the fixed-grid implicit methods
(`solvers/fixed_grid_implicit.py`) on the same loop, the SciPy bridge
(`solvers/scipy_wrapper.py`), event solves (``event_fn=...``) on all of
them but the SciPy bridge, and the fused RK4 kernel route
``odeint(..., method='rk4', options=dict(pallas=True, num_steps=N))``.  A
call that does not qualify for the kernel route (JAX `_try_pallas_rk4`'s
rules) runs the fixed-grid loop, as JAX falls back to its scan.

Gradients, as in the JAX package (odeint.py:242-315): a fixed-grid,
Adams or fixed-grid implicit solve without events is differentiated
through the loop by autograd (discretise-then-optimise, the implicit stage
solves by the implicit function theorem; ``forward_grad`` is accepted and
dropped there, and for the SciPy bridge, whose result is detached, as
JAX's is).  On an adaptive method, ``options=dict(forward_grad=True)``
runs the loop with tensor times under ``torch.no_grad()``, so that
``torch.func.jvp`` sees the tangent of every step the controller takes and
reverse mode finds no graph (`solvers/adaptive_rk.py`), and
``options=dict(replay_grad=True)`` records the steps and replays them
differentiably (`solvers/replay.py`; ``max_segments`` bounds the record).
Otherwise an adaptive solve or an event solve that autograd would have to
differentiate -- grad mode on, and `y0`, `t`, a tensor in `args` or a
parameter of an ``nn.Module`` field requiring grad -- takes its gradients
from the continuous adjoint (`adjoint.adjoint_solve`) at the forward
settings.  The kernel route is forward-only and raises under autograd
instead of returning a detached result.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .misc import (check_inputs, data_axis, host_times, needs_autograd,
                   tree_leaves)
from .solvers import SOLVERS, DIRECT_DIFF_KINDS
from .solvers import (adams, adaptive_rk, fixed_grid, fixed_grid_implicit,
                      replay, scipy_wrapper)
from .solvers.solution import Stats

# the Pallas kernels' own options, accepted and dropped off their routes
_KERNEL_OPTIONS = ('pallas', 'interpret', 'block_b')


def _differentiable(func, y0, t, args):
    """Whether autograd would have to record through a solve."""
    from .adjoint import _tensors_in
    return needs_autograd(func, *tree_leaves(y0), t, *_tensors_in(args))


def _refuse_autograd(func, y0, t, args):
    if _differentiable(func, y0, t, args):
        raise NotImplementedError(
            "the rk4 kernel route is forward-only, as the JAX kernel is: drop "
            "pallas=True for the differentiable fixed-grid loop, or call the "
            "route under torch.no_grad()")


def _warn_unused(kind, options, allowed):
    unused = set(options) - set(allowed)
    if unused:
        warnings.warn(f"{kind}: Unexpected arguments {sorted(unused)}")


_FIXED_OPTIONS = {'step_size', 'grid_constructor', 'num_steps', 'perturb',
                  'interp', 'remat'}


def _adaptive_config(prob, tableau):
    opts = dict(prob.options)
    for name in opts:
        if name in adaptive_rk.NOT_PORTED_OPTIONS:
            raise NotImplementedError(
                f"option {name!r} is not ported yet "
                f"({adaptive_rk.NOT_PORTED_OPTIONS[name]})")
    _warn_unused('adaptive solver', opts, adaptive_rk.SUPPORTED_OPTIONS)
    step_fn = None
    if tableau.implicit:
        from .solvers.adaptive_implicit import (make_esdirk_step_fn,
                                                make_firk_step_fn)
        make = make_esdirk_step_fn if tableau.sdirk else make_firk_step_fn
        step_fn = make(stage_tol=opts.get('stage_tol'),
                       max_iters=opts.get('max_iters', 100),
                       error_dtype=opts.get('error_dtype'))
    return adaptive_rk.AdaptiveConfig(
        step_fn=step_fn,
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
        step_to_end=bool(opts.get('step_to_end', False)),
        controller=opts.get('controller', 'i'),
        pcoeff=opts.get('pcoeff', 0.4),
        icoeff=opts.get('icoeff', 0.7),
        dcoeff=opts.get('dcoeff', 0.0),
        error_dtype=opts.get('error_dtype'))


def _fixed_step_method(prob, spec):
    """The `FixedStepMethod` of a fixed-grid, Adams or implicit fixed-grid
    method (JAX odeint.py:133-143)."""
    kind = spec['kind']
    if kind == 'fixed':
        return spec['method']
    if kind == 'adams':
        return adams.make_fixed_step_method(prob, spec['implicit'])
    return fixed_grid_implicit.make_fixed_step_method(
        prob, spec['tableau'], sequential=(kind == 'dirk'))


def _solve_normalised(prob, t_grad=None):
    """The raw solve of a normalised problem (JAX `_solve_normalised`,
    odeint.py:85-122): (ys in the solver's layout, Stats).  `t_grad`, the
    internal times as a float64 CPU tensor carrying a gradient, takes the
    place of `prob.t` on the fixed grid."""
    spec = SOLVERS[prob.method]
    kind = spec['kind']
    if kind == 'adaptive':
        cfg = _adaptive_config(prob, spec['tableau'])
        return adaptive_rk.integrate(prob.func, prob.y0, prob.t, cfg)
    if kind == 'adams':
        return adams.integrate_adams(prob, spec['implicit'], t_grad)
    if kind in ('firk', 'dirk'):
        return fixed_grid_implicit.integrate_implicit(
            prob, spec['tableau'], kind == 'dirk', t_grad)
    if kind == 'scipy':
        return scipy_wrapper.integrate_scipy(prob)
    opts = prob.options
    _warn_unused('fixed-grid solver', opts, _FIXED_OPTIONS)
    ts = prob.t if t_grad is None else t_grad
    grid = fixed_grid.construct_grid(
        prob.func, prob.y0, ts, opts.get('step_size'),
        opts.get('grid_constructor'), opts.get('num_steps'))
    return fixed_grid.integrate_fixed_grid(
        spec['method'], prob.func, prob.y0, ts, grid,
        interp=opts.get('interp', 'linear'),
        perturb=opts.get('perturb', False), remat=opts.get('remat', False))


def _solve_event_normalised(prob):
    """The raw event solve (JAX `_solve_event_normalised`,
    odeint.py:113-155): (event_t in the internal frame, stack([y0,
    y_event]), Stats)."""
    spec = SOLVERS[prob.method]
    if spec['kind'] == 'scipy':
        raise ValueError(
            f"method '{prob.method}' does not support event handling")
    if spec['kind'] == 'adaptive':
        cfg = _adaptive_config(prob, spec['tableau'])
        event_t, y_event, stats = adaptive_rk.integrate_until_event(
            prob.func, prob.y0, prob.t[0], prob.event_fn, cfg)
    else:
        opts = prob.options
        event_t, y_event, stats = fixed_grid.integrate_until_event_fixed_grid(
            _fixed_step_method(prob, spec), prob.func, prob.y0, prob.t[0],
            prob.event_fn,
            step_size=opts.get('step_size'),
            interp=opts.get('interp', 'linear'),
            perturb=opts.get('perturb', False), atol=prob.atol)
    return event_t, torch.stack([prob.y0, y_event]), stats


def odeint(func, y0, t, *, rtol=1e-7, atol=1e-9, method=None, options=None,
           event_fn=None, args=()):
    """Integrate ``dy/dt = func(t, y, *args)`` from ``y(t[0]) = y0`` and
    return the solution at every time in `t`, shape ``(T, *y0.shape)``
    (JAX `odeint`, torchdiffeq_tpu/odeint.py:162; reference odeint.py:49).

    `y0` is one float16/bfloat16/float32/float64 tensor on any device, or
    a pytree of them (dicts, tuples, lists, namedtuples; the result has
    its structure); `t` is strictly monotonic (decreasing time integrates
    backwards).  Time is float64.  Under autograd a fixed-grid solve is
    differentiated through its loop, and any other solve takes its
    gradients from the continuous adjoint (`odeint_adjoint` at the same
    settings).

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


def _internal_times(prob, t):
    """The problem's internal times as a float64 CPU tensor that carries
    the derivative of the user's `t` when it is a tensor (forward_grad's
    tangents, replay_grad's gradients)."""
    if isinstance(t, torch.Tensor):
        return prob.t_sign * t.to('cpu', torch.float64)
    return torch.from_numpy(prob.t)


def _forward_grad(func, y0, t, rtol, atol, method, options, event_fn, args):
    """``forward_grad``: the adaptive loop with tensor times and no graph
    (JAX odeint.py:275-298)."""
    if event_fn is not None:
        raise ValueError(
            "forward_grad does not support event solves (the event "
            "time's bisection is non-differentiable forward-through; "
            "use options=dict(replay_grad=True) for differentiable "
            "event times)")
    options = {k: v for k, v in options.items() if k != 'forward_grad'}
    prob = check_inputs(func, y0, t, rtol, atol, method, options, None,
                        SOLVERS, args=tuple(args))
    cfg = _adaptive_config(prob, SOLVERS[prob.method]['tableau'])
    with torch.no_grad():
        ys, stats = adaptive_rk.integrate(prob.func, prob.y0, prob.t, cfg,
                                          _internal_times(prob, t))
    return (prob.unravel or (lambda x: x))(ys), stats


def _block_inputs(func, y0, t, args):
    """A data-parallel rank's inputs to a solve that autograd
    differentiates through its own loop: each replicated one read through
    the data axis's `copy_inputs` (`parallel.sharding`), so that its
    gradient sums every rank's share; off the mesh they are the inputs."""
    axis = data_axis()
    if axis is None or not torch.is_grad_enabled():
        return func, y0, t, args
    return axis.copy_inputs(func, y0, t, args)


def _replay(func, y0, t, rtol, atol, method, options, event_fn, args):
    """``replay_grad``: record the steps, then replay them differentiably
    (JAX odeint.py:300-322).  step_to_end is dropped: the replay emits
    through the interpolant."""
    t_user = t
    func, y0, t, args = _block_inputs(func, y0, t, args)
    options = dict(options)
    options.pop('replay_grad')
    options.pop('step_to_end', None)
    max_segments = options.pop('max_segments', None)
    prob = check_inputs(func, y0, t, rtol, atol, method, options, event_fn,
                        SOLVERS, args=tuple(args))
    unravel = prob.unravel or (lambda x: x)
    cfg = _adaptive_config(prob, SOLVERS[prob.method]['tableau'])
    ts_d = _internal_times(prob, t)
    if event_fn is None:
        ys, stats = replay.integrate_replay(prob.func, prob.y0, prob.t, ts_d,
                                            cfg, max_segments)
        return unravel(ys), stats
    event_t, y_event, stats = replay.integrate_replay_event(
        prob.func, prob.y0, prob.t[0], ts_d[0], prob.event_fn, cfg,
        max_segments,
        t0_out=None if t is t_user else _internal_times(prob, t_user)[0])
    return ((prob.t_sign * event_t, unravel(torch.stack([prob.y0, y_event]))),
            stats)


def _odeint_impl(func, y0, t, rtol, atol, method, options, event_fn, args):
    res = _try_pallas_rk4(func, y0, t, method, options, event_fn, args)
    if res is not None:
        return res
    if isinstance(options, dict):
        options = {k: v for k, v in options.items()
                   if k not in _KERNEL_OPTIONS}
    name = 'dopri5' if method is None else method
    kind = SOLVERS.get(name, {}).get('kind')
    direct = kind in DIRECT_DIFF_KINDS or kind == 'scipy'
    if direct and isinstance(options, dict):
        # the loop is differentiable forward too, and the SciPy bridge's
        # result is detached (JAX odeint.py:261-267)
        options = {k: v for k, v in options.items() if k != 'forward_grad'}
    if direct and event_fn is None:
        # JAX odeint.py:269-271: backprop through the loop
        func, y0, t, args = _block_inputs(func, y0, t, args)
        prob = check_inputs(func, y0, t, rtol, atol, method, options, None,
                            SOLVERS, args=tuple(args))
        t_grad = None
        if (isinstance(t, torch.Tensor) and t.requires_grad
                and torch.is_grad_enabled()):
            t_grad = prob.t_sign * t.to('cpu', torch.float64)
        ys, stats = _solve_normalised(prob, t_grad)
        return (prob.unravel or (lambda x: x))(ys), stats
    opts = options if isinstance(options, dict) else {}
    if kind == 'adaptive' and opts.get('forward_grad', False):
        return _forward_grad(func, y0, t, rtol, atol, method, opts, event_fn,
                             args)
    if kind == 'adaptive' and opts.get('replay_grad', False):
        return _replay(func, y0, t, rtol, atol, method, opts, event_fn, args)
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
    unravel = prob.unravel or (lambda x: x)
    with torch.no_grad():
        if event_fn is None:
            ys, stats = _solve_normalised(prob)
            return unravel(ys), stats
        # the event time mapped back to the user's frame
        event_t, ys2, stats = _solve_event_normalised(prob)
        return (prob.t_sign * event_t, unravel(ys2)), stats
