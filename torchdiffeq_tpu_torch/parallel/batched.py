"""Per-sample batched solves (counterpart of
``torchdiffeq_tpu/parallel/batched.py``).

The reference shares one error norm across the whole batch, so one stiff
sample shrinks every sample's steps.  Here every sample gets its own
accept/reject sequence and step size, by two routes chosen with JAX's
rules (`_pallas_qualifies`, batched.py:57-78):

* the kernel route, for ``options=dict(pallas=True)`` and a problem the
  per-lane kernel takes (a per-lane method, a 2-D real (B, D) state of
  float32, float64, bfloat16 or float16, increasing output times, scalar
  tolerances, the kernel's options alone, args shared or mapped over their
  last axis): the whole batched solve is
  `ops/kernels.dopri5_integrate_batched`, with ``event_fn``
  `ops/kernels.dopri5_events_batched`, on CUDA, or their plain versions on
  the CPU.  On the card an `MLPField` (tanh, no args) and a `LinearEvent`
  run the hand-written instances; any other field and event function is
  traced (`ops/traced.py`: indexing, stack, + - * / and powers, sin cos exp
  log tanh sqrt abs minimum maximum where, @ by a shared matrix, sum; args
  shared or per lane; float32 and float64) into an instance of its own.  A
  field outside that set raises ``TypeError`` naming the operation: it
  never falls to the driver quietly.  The route is forward-only, as JAX's
  is.
* the batched driver, for every other problem (JAX's
  ``jax.vmap(odeint_with_stats)``, batched.py:252-260), every method of
  the registry but ``scipy_solver``.  Each sample's field is ``func(t_i,
  y_i, *args_i)`` vectorised by ``torch.func.vmap``; ``args_axes`` maps an
  arg over any axis.

  - The adaptive tier, explicit and stiff (kvaerno3, kvaerno5, radau5a):
    `solvers/batched_rk.py`, one masked host loop with a controller per
    sample; an implicit tableau's step is
    `adaptive_implicit.make_lane_step_fn`, each sample's Newton solves its
    own (batched Jacobians and LU solves, per-sample convergence and
    unconverged-step rejection).
  - The fixed-grid tiers (explicit, Adams, FIRK/DIRK) on the shared grid
    of `t` through `solvers/fixed_grid.integrate_fixed_grid` over the
    batched field, with the lane steppers of `fixed_grid_implicit` (each
    sample's own Broyden or Newton stage solves and error code) and
    `adams` (each sample's own corrector convergence, dropped history and
    so order, and NFE).  A ``grid_constructor`` is evaluated per sample as
    JAX's vmap does: a grid every sample shares takes the batched sweep,
    and grids that differ by sample take one solve a sample
    (`_per_sample_solves`).
  - Events per sample on every tier (``t`` of two times).
  - Callbacks fire per sample, each with that sample's values on its own
    steps, as its own solve fires them (JAX's vmap route fires them on
    finished lanes too, ROADMAP C9).
  - Gradients: the fixed-grid tiers by autograd through the loop (the
    stage solves by each sample's implicit-function gradient); the
    adaptive tier by the continuous adjoint vmapped (JAX's custom_vjp
    under vmap, ROADMAP C4), each sample solving its own backward with its
    own controller and adjoint norm (and, for a stiff method, its own
    Newton steps), a shared parameter's gradient the sum of the samples'
    and a per-sample arg's its own row; an adaptive event solve
    backpropagates each sample as if it had integrated to its own event
    time (JAX's event-mode adjoint under vmap), and a fixed-grid event
    solve's gradient is each sample's event-mode adjoint on its own grid
    from its own event time (one solve a sample).  ``replay_grad`` records
    every sample's own steps in one masked loop and replays them in
    another (`batched_rk.record_lanes`, `replay_lanes`; with an event, one
    replay a sample); ``forward_grad`` runs the driver with tensor times
    under ``torch.no_grad()``, so ``torch.func.jvp`` sees every sample's
    steps.

What the route refuses: ``scipy_solver``, as JAX's vmap route does (its
host callback cannot be batched).  Complex states take the driver on every
tier, never the kernel route (JAX batched.py:70).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..misc import (check_inputs, host_times, nan_sign, needs_autograd,
                    ravel_leaves, real_part, solver_callbacks, time_effect,
                    tree_flatten, tree_leaves, tree_map, tree_unflatten)
from ..models.neural_ode import LinearEvent, is_kernel_mlp
from ..solvers import SOLVERS, DIRECT_DIFF_KINDS
from ..solvers import batched_rk
from ..solvers.batched_rk import LaneField, lane_norm
from ..solvers.solution import Stats, OK, ERR_MAX_NUM_STEPS

# options the per-lane kernel route understands (JAX's set; `interpret`,
# the Pallas interpreter switch, is accepted and dropped)
_PALLAS_OPTS = {'pallas', 'first_step', 'safety', 'ifactor', 'dfactor',
                'max_num_steps', 'interpret'}


def _pallas_qualifies(y0, t, rtol, atol, method, options):
    """JAX `_pallas_qualifies` (batched.py:57-78): the host output times if
    the problem takes the kernel route, else None."""
    from ..ops.kernels import PER_LANE_METHODS
    if not isinstance(options, dict) or not options.get('pallas'):
        return None
    if method is not None and method not in PER_LANE_METHODS:
        return None
    if set(options) - _PALLAS_OPTS:
        return None
    if np.ndim(rtol) != 0 or np.ndim(atol) != 0:
        return None
    if not isinstance(y0, torch.Tensor) or y0.dim() != 2 or y0.is_complex():
        return None
    t_np = host_times(t)
    if t_np.shape[0] < 2 or not (np.diff(t_np) > 0).all():
        return None
    return t_np


def _norm_args_axes(args, args_axes):
    """`args_axes` as a per-arg tuple of None / axis ints (JAX
    `_norm_args_axes`, batched.py:81-90)."""
    if args_axes is None:
        return (None,) * len(args)
    args_axes = tuple(args_axes)
    if len(args_axes) != len(args):
        raise ValueError(f"args_axes has {len(args_axes)} entries for "
                         f"{len(args)} args")
    return args_axes


def _lane_field(func, args, axes):
    """Lane-vectorise a per-sample ``func(t, y_i, *args)`` to the kernel
    layout: t (1, B), y (D, B) with the batch on the last axis, args mapped
    over their last axis where `axes` says -1 (the per-lane kernels trace
    it on the card)."""
    from ..ops.traced import PerSampleField
    return PerSampleField(func, args,
                          tuple(None if a is None else -1 for a in axes))


def _lane_event(event_fn):
    """Lane-vectorise a per-sample event function and sign-combine its
    outputs per sample: ``min_k(e_k * sign0_k)`` with sign0 (K, B), the
    kernel's event layout (JAX `_pallas_per_sample_event`'s `ev`)."""
    from ..ops.traced import PerSampleEvent
    if isinstance(event_fn, LinearEvent):
        return event_fn     # combined with sign0 in the kernel
    return PerSampleEvent(event_fn)


def _per_step_nfe(method):
    from ..ops.kernels import _tableau_consts
    alpha, _, _, _, _, _, fsal = _tableau_consts(method, torch.float32)
    return len(alpha) + (0 if fsal else 1)


def _kernel_route(func, y0, t_np, rtol, atol, method, options, event_fn,
                  args, axes):
    """The per-lane kernel route (JAX `_pallas_per_sample(_event)`,
    batched.py:107-200)."""
    from ..ops.kernels import (_rounded, dopri5_integrate_batched,
                               dopri5_events_batched)

    if needs_autograd(func, y0, *args) or (event_fn is not None
                                            and needs_autograd(event_fn)):
        raise RuntimeError(
            "the per-sample kernel route is forward-only, as in the JAX "
            "package (ROADMAP A6): call it under torch.no_grad(), or drop "
            "pallas=True for the batched driver, which differentiates")
    method = method or 'dopri5'
    ts = _rounded(t_np, y0.dtype)
    if is_kernel_mlp(func) and not args and (
            event_fn is None or isinstance(event_fn, LinearEvent)):
        field = func   # the hand-written instances' field family
    else:
        field = _lane_field(func, tuple(args), axes)   # traced on the card
    max_steps = int(options.get('max_num_steps', 10_000))
    control = dict(rtol=float(rtol), atol=float(atol), method=method,
                   max_steps=max_steps,
                   safety=float(options.get('safety', 0.9)),
                   ifactor=float(options.get('ifactor', 10.0)),
                   dfactor=float(options.get('dfactor', 0.2)),
                   first_step=options.get('first_step'))
    init_nfe = 1 if options.get('first_step') is not None else 2

    if event_fn is not None:
        # t is (t0, a point giving the direction), and every sample stops
        # at its own event; the outputs are sign-combined with the signs at
        # t0 (JAX batched.py:150-200, :240-249)
        if t_np.shape[0] != 2:
            raise ValueError(
                "per-sample event solves require t of shape (2,) "
                f"(t0 and a horizon/direction point), got {t_np.shape}")
        t0 = torch.full((), float(ts[0]), dtype=y0.dtype, device=y0.device)
        lane_ev = _lane_event(event_fn)
        if isinstance(lane_ev, LinearEvent):
            sign0 = nan_sign(torch.func.vmap(
                lambda yy: torch.atleast_1d(event_fn(t0, yy)))(y0)).T
        else:
            # as the plain version evaluates it (a 16-bit state's event in
            # its dtype, ops/traced.py)
            sign0 = nan_sign(lane_ev.values(t0.expand(1, y0.shape[0]), y0.T))
        et, ye, found, acc, stp = dopri5_events_batched(
            field, y0.T.contiguous(), ts[0], lane_ev,
            ev_params=(sign0.contiguous(),), **control)
        result = (et[0], torch.stack([y0, ye.T], dim=1))
        failed = found[0] == 0
    else:
        ys, acc, stp = dopri5_integrate_batched(field, y0.T.contiguous(),
                                                ts[0], ts[-1], ts=ts,
                                                **control)
        result = ys.permute(2, 0, 1)   # (S, D, B) -> (B, S, D)
        failed = stp[0] >= max_steps

    stp_b, acc_b = stp[0], acc[0]
    stats = Stats.make(
        nfe=_per_step_nfe(method) * stp_b + init_nfe, n_steps=stp_b,
        n_accepted=acc_b, n_rejected=stp_b - acc_b,
        error_code=torch.where(failed, ERR_MAX_NUM_STEPS, OK).to(torch.int32))
    return result, stats


def _check_event_times(t_np):
    """The vmap route's check (JAX misc.py `check_inputs`)."""
    if t_np.shape[0] != 2:
        raise ValueError("We require len(t) == 2 when in event handling "
                         f"mode, but got len(t)={t_np.shape[0]}.")


# ---- the batched driver ------------------------------------------------------

def _refuse(y0, method):
    """What the per-sample route does not take: the SciPy bridge, which
    JAX's vmap route refuses itself."""
    name = method or 'dopri5'
    spec = SOLVERS.get(name)
    if spec is None:
        raise ValueError('Invalid method "{}". Must be one of {}'.format(
            name, '{"' + '", "'.join(SOLVERS.keys()) + '"}.'))
    if spec['kind'] == 'scipy':
        raise NotImplementedError(
            "method 'scipy_solver' on the per-sample route: the JAX "
            "package's vmap route refuses it too (its SciPy bridge is a "
            "jax.pure_callback that vmap cannot batch, "
            "solvers/scipy_wrapper.py:67); solve the samples one by one "
            "with odeint")
    return name, spec


def _lane_problem(func, y0, t, rtol, atol, method, options, args, axes,
                  time_direction='auto'):
    """The per-sample normalised problem: `check_inputs` on one sample (the
    internal times, tolerances, options and the per-sample norm and tuple
    layout), the batch in the solver's layout (a pytree state flattened
    per sample to (B, n)) and the batched field."""
    leaves = tree_leaves(y0)
    if not all(isinstance(x, torch.Tensor) and x.dim() >= 1
               for x in leaves):
        raise TypeError("y0 must be a tensor, or a pytree of tensors, with "
                        "a leading batch axis")
    B = leaves[0].shape[0]
    if any(x.shape[0] != B for x in leaves):
        raise ValueError("every leaf of y0 must have the same batch size")
    sample = tree_map(lambda x: x[0], y0)
    prob = check_inputs(lambda tt, yy: yy, sample, t, rtol, atol, method,
                        options, None, SOLVERS, time_direction=time_direction)
    unravel = prob.unravel
    if unravel is None:
        y0_b = y0
    else:
        y0_b = torch.cat([x.reshape(B, -1).to(prob.y0.dtype)
                          for x in leaves], dim=1)

    def one(tt, yy, *aa):
        out = func(tt, yy if unravel is None else unravel(yy), *aa)
        return out if unravel is None else ravel_leaves(out)

    # `ts_lanes`: per-sample output times, (B, T) internal float64 on the
    # state's device, in place of `prob.t` (`odeint_spans_with_stats`)
    return SimpleNamespace(
        prob=prob, y0=y0_b, B=B, one=one, args=args, axes=axes,
        unravel=unravel, ts_lanes=None,
        callbacks=solver_callbacks(func, method, SOLVERS, prob.t_sign,
                                   unravel))


def _lane_event_fn(lp, event_fn):
    """The batched, sign-combined event function of the internal frame
    (`events.combine_event_functions` per sample, each with its own signs
    at t0), taking the time in the dtype the solver hands it."""
    t_sign, unravel = lp.prob.t_sign, lp.unravel

    def ev(tt, yy):
        return torch.atleast_1d(event_fn(-tt if t_sign < 0 else tt,
                                         yy if unravel is None
                                         else unravel(yy)))

    vm = torch.func.vmap(ev)
    t0 = float(lp.prob.t[0])
    with torch.no_grad():
        sign0 = nan_sign(vm(torch.full((lp.B,), t0, dtype=torch.float64,
                                       device=lp.y0.device), lp.y0))
    # `amin` over the one axis: a full `torch.min` falls back to a loop over
    # the samples under vmap
    combined = torch.func.vmap(
        lambda tt, yy, s: torch.amin((ev(tt, yy) * s).reshape(-1), dim=0))
    return lambda tt, yy: combined(tt, yy, sign0)


def _unravel_rows(lp, ys):
    return ys if lp.unravel is None else lp.unravel(ys)


def _fixed_field(lp):
    """The fixed grid's field: one time for the batch, each sample's
    field vectorised (`misc.PerturbedFunc` over it); its ``callback_step``
    fires each sample's callback with that sample's state."""
    from ..misc import PerturbedFunc
    vm = torch.func.vmap(lp.one, in_dims=(None, 0) + tuple(lp.axes))
    field = PerturbedFunc(lambda tt, yy: vm(tt, yy, *lp.args),
                          lp.prob.t_sign)
    fire = lp.callbacks.get('callback_step')
    if fire is not None:
        def callback_step(t0, y, dt):
            for b in range(y.shape[0]):
                fire(t0, y[b], dt)
        field.callback_step = callback_step
    return field


def _lane_field_of(lp):
    """The adaptive tier's batched field, with each sample's callbacks."""
    return LaneField(lp.one, lp.args, lp.axes, lp.prob.t_sign, lp.callbacks)


def _broadcast_stats(stats, B, device):
    """A fixed-grid solve's counters as (B,) tensors: the shared ones
    broadcast, as JAX's vmap broadcasts its unbatched Stats, and the
    per-sample ones (the Adams NFE, the implicit tiers' error codes) kept."""
    def full(v, dtype):
        if isinstance(v, torch.Tensor) and v.dim() == 1:
            return v.to(device=device, dtype=dtype)
        return torch.full((B,), float(v) if dtype.is_floating_point
                          else int(v), dtype=dtype, device=device)
    return Stats.make(*(full(v, torch.int32) for v in stats[:5]),
                      final_dt=full(stats.final_dt, torch.float64))


def _adaptive_cfg(lp, spec):
    """The adaptive configuration of the batched driver: the problem's
    options, an implicit tableau's step the per-sample one."""
    from ..odeint import _adaptive_config
    cfg = _adaptive_config(lp.prob, spec['tableau'])
    if spec['tableau'].implicit:
        from ..solvers.adaptive_implicit import make_lane_step_fn
        opts = lp.prob.options
        cfg = cfg._replace(step_fn=make_lane_step_fn(
            spec['tableau'], stage_tol=opts.get('stage_tol'),
            max_iters=opts.get('max_iters', 100),
            error_dtype=opts.get('error_dtype')))
    return cfg


def _lane_fixed_method(lp, spec):
    """The stepper of a fixed-grid, Adams or implicit fixed-grid method on
    the batch (each sample's convergence its own), and the options its
    kind takes."""
    from ..odeint import _FIXED_OPTIONS
    from ..solvers import adams, fixed_grid_implicit
    kind = spec['kind']
    if kind == 'fixed':
        return spec['method'], ('fixed-grid solver', _FIXED_OPTIONS)
    if kind == 'adams':
        return (adams.make_fixed_step_method(lp.prob, spec['implicit'],
                                             lanes=True),
                ('Adams solver', adams.ADAMS_OPTIONS))
    return (fixed_grid_implicit.make_fixed_step_method(
        lp.prob, spec['tableau'], sequential=kind == 'dirk', lanes=True),
        ('implicit fixed-grid solver', fixed_grid_implicit.IMPLICIT_OPTIONS))


def _solve_lanes(lp, spec, y0_b=None, ts_t=None):
    """The adaptive forward solve of the batched driver, no graph: ys (B,
    T, ...) in the solver's layout, and (B,) Stats.  `ts_t`, the internal
    times as a tensor carrying tangents (``forward_grad``), gives the start
    and the emission times theirs."""
    y0_b = lp.y0 if y0_b is None else y0_b
    prob = lp.prob
    ts = prob.t if lp.ts_lanes is None else lp.ts_lanes
    with torch.no_grad():
        return batched_rk.integrate_lanes(_lane_field_of(lp), y0_b, ts,
                                          _adaptive_cfg(lp, spec),
                                          lane_norm(prob.norm), ts_t=ts_t)


def _solve_fixed(lp, spec, y0_b, t_grad=None, grid=None):
    from ..solvers import fixed_grid
    from ..odeint import _warn_unused
    prob = lp.prob
    opts = prob.options
    method, (kind, allowed) = _lane_fixed_method(lp, spec)
    _warn_unused(kind, opts, allowed)
    ts = prob.t if t_grad is None else t_grad
    func = _fixed_field(lp)
    if grid is None:
        grid = fixed_grid.construct_grid(func, y0_b, ts,
                                         opts.get('step_size'), None,
                                         opts.get('num_steps'))
    elif not grid.requires_grad:
        grid = grid.detach().numpy()
    ys, stats = fixed_grid.integrate_fixed_grid(
        method, func, y0_b, ts, grid,
        interp=opts.get('interp', 'linear'),
        perturb=opts.get('perturb', False),
        remat=spec['kind'] == 'fixed' and opts.get('remat', False))
    return ys.transpose(0, 1), _broadcast_stats(stats, lp.B, y0_b.device)


def _event_driver(lp, spec, event_fn):
    """Per-sample event solves: ((event_t (B,), ys (B, 2, ...)), Stats)."""
    et, ys2, stats = _event_solve(lp, spec, event_fn, lp.y0)
    return (lp.prob.t_sign * et, _unravel_rows(lp, ys2)), stats


def _event_solve(lp, spec, event_fn, y0_b):
    """The per-sample event solve, no graph: (event_t (B,) in the internal
    frame, stack([y0, y_event]) (B, 2, ...) in the solver's layout,
    Stats)."""
    prob = lp.prob
    _check_event_times(prob.t)
    ev = _lane_event_fn(lp, event_fn)
    with torch.no_grad():
        if spec['kind'] == 'adaptive':
            et, ye, stats = batched_rk.integrate_lanes_until_event(
                _lane_field_of(lp), y0_b, prob.t[0], ev,
                _adaptive_cfg(lp, spec),
                lane_norm(prob.norm))
        else:
            opts = prob.options
            et, ye, stats = \
                batched_rk.integrate_lanes_until_event_fixed_grid(
                    _lane_fixed_method(lp, spec)[0], _fixed_field(lp), y0_b,
                    prob.t[0], ev,
                    step_size=opts.get('step_size'),
                    interp=opts.get('interp', 'linear'),
                    perturb=opts.get('perturb', False), atol=prob.atol)
    return et, torch.stack([y0_b, ye], dim=1), stats


def _per_sample_solves(func, y0, t, rtol, atol, method, options, event_fn,
                       args, axes, spans=False):
    """Every sample solved alone by `odeint_with_stats` (its values, Stats
    and gradients those of its own solve, which is what JAX's vmap gives
    each sample), the results stacked as the driver returns them.  A host
    loop over the samples: the route of the problems whose samples do not
    share a grid of steps (module docstring).  With `spans`, `t` holds a
    row of times a sample."""
    from ..odeint import odeint_with_stats
    leaves = tree_leaves(y0)
    B = leaves[0].shape[0]
    results, stats = [], []
    for b in range(B):
        y0_b = tree_map(lambda x: x[b], y0)
        args_b = tuple(a if ax is None else a.select(ax, b)
                       for a, ax in zip(args, axes))
        res, st = odeint_with_stats(func, y0_b, t[b] if spans else t,
                                    rtol=rtol, atol=atol,
                                    method=method, options=options,
                                    event_fn=event_fn, args=args_b)
        results.append(res)
        stats.append(st)
    dev = leaves[0].device

    _, treedef = tree_flatten(results[0])
    out = tree_unflatten(treedef, [torch.stack(xs) for xs in
                                   zip(*map(tree_leaves, results))])
    fields = [torch.as_tensor([int(st[i]) for st in stats], dtype=torch.int32,
                              device=dev) for i in range(5)]
    final_dt = torch.as_tensor([float(st.final_dt) for st in stats],
                               dtype=torch.float64, device=dev)
    return out, Stats.make(*fields, final_dt=final_dt)


def _sample_grids(lp):
    """Each sample's grid from the ``grid_constructor`` (JAX evaluates it
    under vmap, misc.py:346-349): (B, N) internal times, one row a
    sample."""
    gc = lp.prob.options['grid_constructor']
    t_int = torch.from_numpy(lp.prob.t)
    rows = []
    for b in range(lp.B):
        args_b = tuple(a if ax is None else a.select(ax, b)
                       for a, ax in zip(lp.args, lp.axes))
        rows.append(gc(lambda tt, yy: lp.one(tt, yy, *args_b), lp.y0[b],
                       t_int))
    return torch.stack(rows)


def _driver(func, y0, t, rtol, atol, method, options, event_fn, args, axes):
    name, spec = _refuse(y0, method)
    kind = spec['kind']
    direct = kind in DIRECT_DIFF_KINDS
    opts = dict(options) if isinstance(options, dict) else {}
    if direct:
        # the fixed-grid loops are forward-differentiable as they are (JAX
        # odeint.py:261-267)
        opts.pop('forward_grad', None)
    if kind == 'adaptive' and opts.get('replay_grad'):
        if event_fn is not None:
            # each sample's replay to its own event, one by one
            return _per_sample_solves(func, y0, t, rtol, atol, name, opts,
                                      event_fn, args, axes)
        return _replay_driver(func, y0, t, rtol, atol, name, spec, opts,
                              args, axes)
    from ..adjoint import _tensors_in
    grad = needs_autograd(func, *tree_leaves(y0), t, *_tensors_in(args))
    if direct and event_fn is not None and grad:
        # JAX's gradient here is each sample's event-mode adjoint on its
        # own grid from its own event time back to t0
        return _per_sample_solves(func, y0, t, rtol, atol, name, opts,
                                  event_fn, args, axes)
    forward_grad = kind == 'adaptive' and opts.pop('forward_grad', False)
    if forward_grad and event_fn is not None:
        raise ValueError(
            "forward_grad does not support event solves (the event "
            "time's bisection is non-differentiable forward-through; "
            "use options=dict(replay_grad=True) for differentiable "
            "event times)")
    lp = _lane_problem(func, y0, t, rtol, atol, name, opts, args, axes)
    if direct and event_fn is None:
        t_grad = None
        if (isinstance(t, torch.Tensor) and t.requires_grad
                and torch.is_grad_enabled()):
            t_grad = lp.prob.t_sign * t.to('cpu', torch.float64)
        grid = None
        if lp.prob.options.get('grid_constructor') is not None:
            grids = _sample_grids(lp)
            if not bool((grids == grids[:1]).all()):
                # a grid per sample: each sample sweeps its own
                return _per_sample_solves(func, y0, t, rtol, atol, name,
                                          opts, event_fn, args, axes)
            grid = grids[0]
        # a shared grid: the solve differentiates through its loop
        ys, stats = _solve_fixed(lp, spec, lp.y0, t_grad, grid)
        return _unravel_rows(lp, ys), stats
    if forward_grad:
        ys, stats = _solve_lanes(lp, spec, ts_t=_internal_times(lp, t))
        return _unravel_rows(lp, ys), stats
    if grad:
        return _lane_adjoint(lp, spec, func, t, args, axes, opts, event_fn)
    if event_fn is not None:
        return _event_driver(lp, spec, event_fn)
    ys, stats = _solve_lanes(lp, spec)
    return _unravel_rows(lp, ys), stats


def _replay_driver(func, y0, t, rtol, atol, name, spec, opts, args, axes):
    """``replay_grad`` on the batched driver (JAX's replay under vmap):
    each sample's accepted steps recorded by one masked loop, then replayed
    differentiably by another (`batched_rk.record_lanes`,
    `replay_lanes`); a sample whose recording failed has NaN outputs."""
    from ..solvers.replay import _AUTO_LIMIT
    opts = dict(opts)
    opts.pop('replay_grad')
    opts.pop('step_to_end', None)
    max_segments = opts.pop('max_segments', None)
    cap = _AUTO_LIMIT if max_segments is None else int(max_segments)
    lp = _lane_problem(func, y0, t, rtol, atol, name, opts, args, axes)
    cfg = _adaptive_cfg(lp, spec)
    field = _lane_field_of(lp)
    times, counts, stats = batched_rk.record_lanes(
        field, lp.y0, lp.prob.t, cfg, lane_norm(lp.prob.norm), cap)
    ys = batched_rk.replay_lanes(field, lp.y0, _internal_times(lp, t), cfg,
                                 times, counts)
    bad = batched_rk.lanes(stats.error_code != OK, ys)
    ys = torch.where(bad, torch.full_like(ys, float('nan')), ys)
    return _unravel_rows(lp, ys), stats


def _internal_times(lp, t):
    """The internal times as a float64 tensor that carries the tangent of
    the user's `t` when it is a tensor (`odeint._internal_times`)."""
    if isinstance(t, torch.Tensor):
        return lp.prob.t_sign * t.to(torch.float64)
    return torch.from_numpy(lp.prob.t)


# ---- per-sample gradients: the continuous adjoint, vmapped -------------------

def _lane_adjoint(lp, spec, func, t, args, axes, options, event_fn=None):
    """The continuous adjoint of every sample (JAX's custom_vjp under vmap):
    `_LaneAdjointOp` over the flat batch, the parameters those of
    `adjoint._adjoint_params`.  With `event_fn`, JAX's event mode
    (adjoint.py:611-644) per sample: each sample backpropagates as if it
    had integrated to its own event time, which itself gets no gradient
    (the implicit-function reroute is `odeint_event`'s, not this route's,
    in JAX as here)."""
    from ..adjoint import _adjoint_params, _tensors_in
    module_params, arg_tensors = _adjoint_params(func, args, None)
    # the axis each differentiated arg tensor is mapped over
    axis_of = {}
    for a, ax in zip(args, axes):
        for x in _tensors_in(a):
            axis_of.setdefault(id(x), ax)
    # the per-sample tensors that get no gradient (integer ones): the
    # backward's field takes each sample's row of them too
    fixed = [(x, axis_of[id(x)]) for a in args for x in _tensors_in(a)
             if axis_of.get(id(x)) is not None
             and not (x.is_floating_point() or x.is_complex())]
    t_tensor = (t if isinstance(t, torch.Tensor)
                else torch.as_tensor(host_times(t), dtype=torch.float64))
    ctx = SimpleNamespace(
        lp=lp, spec=spec, func=func, module_params=module_params,
        arg_tensors=arg_tensors,
        p_dims=[None] * len(module_params)
        + [axis_of.get(id(x)) for x in arg_tensors],
        user_state_norm=(options or {}).get('norm'), event_fn=event_fn,
        t_tensor=t_tensor, stats=None, fixed=fixed)
    # lp.y0, a pytree state's leaves concatenated under autograd, carries
    # the gradient back to them
    out = _LaneAdjointOp.apply(ctx, lp.y0, t_tensor, *module_params,
                               *arg_tensors)
    if event_fn is None:
        return _unravel_rows(lp, out), ctx.stats
    event_t, ys2 = out
    return (event_t, _unravel_rows(lp, ys2)), ctx.stats


class _LaneAdjointOp(torch.autograd.Function):
    """``(y0 (B, ...), t, *params) -> ys (B, T, ...)`` (or ``-> (event_t
    (B,), ys (B, 2, ...))`` with an event function): every sample solved
    forward by the batched driver with no graph, and differentiated by its
    own adjoint sweep (`_lane_backward_pass`)."""

    @staticmethod
    def forward(ctx, spec, y0, t, *params):
        ctx.spec = spec
        if spec.event_fn is None:
            ys, spec.stats = _solve_lanes(spec.lp, spec.spec, y0.detach())
            ctx.event_t = None
            ctx.save_for_backward(ys)
            return ys
        event_t, ys, spec.stats = _event_solve(spec.lp, spec.spec,
                                               spec.event_fn, y0.detach())
        ctx.event_t = event_t
        ctx.save_for_backward(ys)
        event_t = spec.lp.prob.t_sign * event_t
        ctx.mark_non_differentiable(event_t)
        return event_t, ys

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        (ys,) = ctx.saved_tensors
        g_ys = grads[-1]
        with torch.no_grad():
            adj_y, ths, vt, dLds = _lane_backward_pass(spec, ys, g_ys,
                                                       ctx.event_t)
        t_grad = None
        if ctx.needs_input_grad[2]:
            sign = spec.lp.prob.t_sign
            if ctx.event_t is not None:
                # the event time's own effect is not differentiated
                dLds = torch.zeros_like(dLds)
            g_t = sign * torch.cat([vt[:, None], dLds], dim=1)
            if spec.lp.ts_lanes is None:
                g_t = g_t.sum(0)    # the samples share the times
            t_grad = real_part(g_t).to(device=spec.t_tensor.device,
                                        dtype=spec.t_tensor.dtype)
        p_grads = []
        for th, p, dim in zip(ths, list(spec.module_params)
                              + list(spec.arg_tensors), spec.p_dims):
            # a shared parameter's gradient is the sum over the samples
            g = th.sum(0) if dim is None else th.movedim(0, dim)
            g = g if p.is_complex() else real_part(g)
            p_grads.append(g.reshape(p.shape).to(p.dtype))
        return (None, adj_y if ctx.needs_input_grad[1] else None, t_grad,
                *p_grads)


def _lane_backward_pass(spec, ys, g_ys, event_t=None):
    """The adjoint sweep of every sample (the port's `adjoint._backward_pass`
    with the batched driver; JAX adjoint.py:335-561 under vmap).  Each
    sample's augmented state ``[vjp_t | y | adj_y | theta_bar]`` is a row of
    one (B, N) tensor, solved in reverse time with its own controller and
    its own default adjoint norm over that row; its field is
    ``torch.func.vmap`` of `adjoint._functional_aug_dyn`, whose vjp takes
    a shared parameter in full (a per-sample theta_bar) and a per-sample
    arg as its own row.  More than two output times take one fused sweep
    whose interior output times are `jump_t` points, the cotangents
    injected by each sample's own jump index.  With `event_t` (B,), the
    internal-frame event times, each sample's backward runs from its own
    event time to t0; with per-sample times (`lp.ts_lanes`), from its own
    last time to its own first.  Returns (adj_y0 (B, ...), [theta_bar (B, ...) per
    parameter], vjp_t (B,), dLds (B, T-1))."""
    from ..adjoint import (_Layout, _functional_aug_dyn, _make_adjoint_norm,
                           _replace_tensors)
    lp = spec.lp
    t_int = lp.prob.t
    t_lanes = lp.ts_lanes
    sign = lp.prob.t_sign
    T, B = ys.shape[1], ys.shape[0]
    dev = ys.device
    params = list(spec.module_params) + list(spec.arg_tensors)
    reps = [p if d is None else p.select(d, 0)
            for p, d in zip(params, spec.p_dims)]
    layout = _Layout(ys.shape[2:], lp.unravel, reps)
    n = layout.n
    spec_f = SimpleNamespace(func=spec.func, module_params=spec.module_params,
                             unravel=lp.unravel)
    n_p = len(params)

    def aug_one(s, aug, *xs):
        # a per-sample integer arg's row replaces it in the args the field
        # gets (the differentiated ones `_functional_aug_dyn` replaces)
        args_s = _replace_tensors(lp.args, {
            id(x): v for (x, _), v in zip(spec.fixed, xs[n_p:])})
        return _functional_aug_dyn(spec_f, layout, sign, args_s, params,
                                   dev)(s, aug, *xs[:n_p])
    norm_one = _make_adjoint_norm(None, spec.user_state_norm, layout)

    def t_out(j):
        if event_t is not None:
            return event_t
        if t_lanes is not None:
            return t_lanes[:, j]
        return torch.full((B,), float(t_int[j]), dtype=torch.float64,
                          device=dev)

    # the effect of moving each output time: one field call a time
    field = LaneField(lp.one, lp.args, lp.axes, sign)
    dLds = torch.stack([time_effect(field(t_out(j), ys[:, j]), g_ys[:, j])
                        for j in range(1, T)], dim=1)
    rows = torch.arange(B, device=dev)

    def aug_state(vt, y, adj_y, th=None):
        th = adj_y.new_zeros((B, sum(layout.p_sizes))) if th is None else th
        return torch.cat([vt.reshape(B, 1), y.reshape(B, -1),
                          adj_y.reshape(B, -1), th], dim=1)

    opts = dict(norm=norm_one, step_to_end=True)
    if T > 2:
        def inject(k, tt, aug):
            # hook index k is boundary j = (T-2) - k of the increasing grid
            j = (T - 2) - k
            out = aug.clone()
            out[:, 0] = aug[:, 0] - dLds[rows, j - 1]
            out[:, 1:1 + n] = ys[rows, j].reshape(B, -1)
            out[:, 1 + n:1 + 2 * n] = (aug[:, 1 + n:1 + 2 * n]
                                       + g_ys[rows, j].reshape(B, -1))
            return out

        opts.update(jump_t=t_int[1:-1] if t_lanes is None
                    else t_lanes[:, 1:-1].cpu().numpy(),
                    jump_state_fn=inject)
        aug0 = aug_state(-dLds[:, -1], ys[:, -1], g_ys[:, -1])
    else:
        aug0 = aug_state(-dLds[:, 0], ys[:, 1], g_ys[:, 1])
    # the reverse solve of the augmented rows, in the forward's internal
    # frame reversed; an event solve's samples start at their own event
    # times (a sample whose event is at t0 takes no step)
    t_hi = t_int[-1] if event_t is None else float(event_t.max())
    end = aug0
    if t_hi != t_int[0]:
        back = _lane_problem(lambda tt, yy: yy, aug0,
                             np.array([t_hi, t_int[0]]), lp.prob.rtol,
                             lp.prob.atol, lp.prob.method, opts, (), (),
                             time_direction='reverse')
        ps = [p.detach() for p in params] + [x for x, _ in spec.fixed]
        aug_field = LaneField(aug_one, ps, list(spec.p_dims)
                              + [ax for _, ax in spec.fixed],
                              back.prob.t_sign)
        # each sample's own span reversed, in the backward's frame
        grid = (back.prob.t if t_lanes is None
                else back.prob.t_sign * t_lanes[:, [T - 1, 0]])
        sol, _ = batched_rk.integrate_lanes(
            aug_field, aug0, grid, _adaptive_cfg(back, spec.spec),
            lane_norm(back.prob.norm),
            t0=None if event_t is None else back.prob.t_sign * event_t)
        end = sol[:, 1]
    adj_y = end[:, 1 + n:1 + 2 * n] + g_ys[:, 0].reshape(B, -1)
    th = end[:, 1 + 2 * n:]
    ths = [part.reshape((B,) + tuple(r.shape)) for part, r in
           zip(torch.split(th, layout.p_sizes, dim=1), reps)]
    return adj_y.reshape(ys[:, 0].shape), ths, end[:, 0], dLds


# ---- per-sample time spans (Parareal's fine sweep) ---------------------------

def _span_times(t, B):
    """The per-sample times as a (B, T) float64 host array (one read),
    each row strictly monotonic and every row in one direction."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to('cpu', torch.float64).numpy()
    t = np.asarray(t, dtype=np.float64)
    if t.ndim != 2 or t.shape[0] != B or t.shape[1] < 2:
        raise ValueError(f"per-sample times must be ({B}, T) with T >= 2, "
                         f"got {t.shape}")
    d = np.diff(t, axis=1)
    if not ((d > 0).all() or (d < 0).all()):
        raise ValueError("every sample's times must be strictly increasing, "
                         "or every sample's strictly decreasing")
    return t


def odeint_spans_with_stats(func, y0, t, *, rtol=1e-7, atol=1e-9,
                            method=None, options=None, args=()):
    """Every sample of `y0` (B, ...) solved over its own output times, the
    row b of `t` (B, T): ``jax.vmap(odeint_with_stats)`` over per-sample
    `t` and `y0` with shared `args` (the fine sweep of Parareal, JAX
    parallel/parareal.py:99-102, 128).  Returns (ys (B, T, ...), Stats of
    (B,) counters).

    An adaptive method without ``replay_grad``/``forward_grad`` runs as one
    batched solve (`batched_rk.integrate_lanes` with a row of times a
    sample: each sample starts, emits and stops at its own times) and takes
    its gradients in y0, `t`, the tensors in `args` and an ``nn.Module``
    field's parameters from each sample's own continuous adjoint, run from
    its own last time back to its first in one batched backward solve;
    `t`'s gradient is each sample's row.  Any other method or gradient mode
    solves the samples one by one with `odeint_with_stats`, as the driver
    does for samples that do not share a grid (`_per_sample_solves`).  The
    samples share one direction of time.  Internal: the public per-sample
    entry points take JAX's one shared `t`."""
    args = tuple(args)
    leaves = tree_leaves(y0)
    t_np = _span_times(t, leaves[0].shape[0])
    name, spec = _refuse(y0, method)
    opts = dict(options) if isinstance(options, dict) else {}
    axes = (None,) * len(args)
    if (spec['kind'] != 'adaptive' or opts.get('replay_grad')
            or opts.get('forward_grad')):
        return _per_sample_solves(func, y0, t, rtol, atol, name, opts, None,
                                  args, axes, spans=True)
    from ..adjoint import _tensors_in
    lp = _lane_problem(func, y0, t_np[0], rtol, atol, name, opts, args, axes)
    lp.ts_lanes = torch.from_numpy(lp.prob.t_sign * t_np).to(lp.y0.device)
    if needs_autograd(func, *leaves, t, *_tensors_in(args)):
        t_tensor = (t if isinstance(t, torch.Tensor)
                    else torch.from_numpy(t_np))
        return _lane_adjoint(lp, spec, func, t_tensor, args, axes, opts)
    ys, stats = _solve_lanes(lp, spec)
    return _unravel_rows(lp, ys), stats


# ---- the entry points ----------------------------------------------------------

def odeint_per_sample(func, y0, t, args=(), args_axes=None, **kwargs):
    """Batched solve with independent per-sample step-size controllers.

    Args:
        func: vector field per sample, ``func(t, y_i, *args)`` with `y_i`
            one sample (no batch axis).
        y0: initial states with a leading batch axis: one tensor, or a
            pytree of them.
        t: (T,) shared output times.
        args: extra tensors passed to `func`, shared across samples unless
            mapped by `args_axes`.
        args_axes: a per-arg tuple of None (shared) or an axis int (mapped
            per sample, like ``torch.func.vmap``'s `in_dims`).  The kernel
            route takes only axis -1.
        **kwargs: ``rtol``, ``atol``, ``method``, ``options`` and
            ``event_fn``.  ``options=dict(pallas=True)`` asks for the
            per-lane kernel (module docstring); a problem that does not
            qualify takes the batched driver.

    Returns:
        ys of shape (B, T, ...) (per leaf of a pytree state).
    """
    ys, _ = odeint_per_sample_with_stats(func, y0, t, args=args,
                                         args_axes=args_axes, **kwargs)
    return ys


def odeint_per_sample_with_stats(func, y0, t, args=(), args_axes=None, *,
                                 rtol=1e-7, atol=1e-9, method=None,
                                 options=None, event_fn=None, **kwargs):
    """Like `odeint_per_sample`, also returning per-sample `Stats`, each
    counter a (B,) int32 tensor and `final_dt` a (B,) float64 one (on the
    kernel route: ``nfe = per_step_nfe * n_steps + init``, ``n_rejected =
    n_steps - n_accepted``, ``ERR_MAX_NUM_STEPS`` where a sample used all
    `max_num_steps` steps, JAX batched.py:114-147).

    With ``event_fn`` (a per-sample ``event_fn(t, y_i)`` with one or more
    outputs) and `t` of shape (2,), each sample integrates until its own
    event fires, and the result is ``((event_t (B,), ys (B, 2, ...)),
    Stats)`` with ``ys[:, 1]`` the state at the event.  On the kernel
    route a sample whose event did not fire within `max_num_steps` steps
    has ``event_t`` NaN and ``ERR_MAX_NUM_STEPS``; on the driver its error
    code is the same and its event time is the bisection of its last step,
    as JAX's vmap route gives it."""
    args = tuple(args)
    axes = _norm_args_axes(args, args_axes)
    if kwargs:
        raise TypeError("odeint_per_sample_with_stats() got unexpected "
                        f"keyword arguments {sorted(kwargs)}")
    t_np = _pallas_qualifies(y0, t, rtol, atol, method, options)
    if t_np is not None and all(a in (None, -1) for a in axes):
        return _kernel_route(func, y0, t_np, rtol, atol, method, options,
                             event_fn, args, axes)
    if isinstance(options, dict) and ('pallas' in options
                                      or 'interpret' in options):
        options = {k: v for k, v in options.items()
                   if k not in ('pallas', 'interpret')}
    return _driver(func, y0, t, rtol, atol, method, options, event_fn, args,
                   axes)
