"""The continuous adjoint as a ``torch.autograd.Function`` (counterpart of
``torchdiffeq_tpu/adjoint.py``; reference torchdiffeq/_impl/adjoint.py).

The forward solve records nothing for autograd; the backward pass solves
the augmented ODE ``(vjp_t, y, adj_y, theta_bar)`` in reverse time:

* **Parameters.**  The JAX package finds them with `jax.closure_convert`.
  Here they are the reference's own PyTorch contract: `adjoint_params` when
  given, else the parameters of an ``nn.Module`` field that require grad,
  plus every floating tensor in `args` (nested lists, tuples and dicts
  included).  A tensor that the field captures in a closure gets no
  gradient unless it is passed in one of those ways.
* **The augmented field.**  Each evaluation runs the field once under
  ``torch.enable_grad()`` and then one ``torch.autograd.grad`` of
  ``<f, -adj_y>`` with respect to time, state and parameters; a parameter
  the field does not use gets zeros, as in JAX.  The time is a float64 host
  scalar in the solver; the evaluation makes it a 0-d tensor on the state's
  device (a fill, not a copy), so the time gradient stays on the device.
  An implicit backward method (`solvers.needs_jacobian`) also needs the
  augmented field's Jacobian, which ``torch.func.jacrev`` cannot take
  through ``autograd.grad``: for it the field is written with
  ``torch.func.vjp`` and ``torch.func.functional_call`` instead, the
  parameters passed explicitly (those of an ``nn.Module`` field and the
  tensors in `args`), so that reverse over reverse gives the Jacobian.
  Its values are the same.
* **The sweep.**  For adaptive adjoint methods and more than two output
  times, ONE reverse solve over the whole span, whose interior output times
  are ``jump_t`` points: there a `jump_state_fn` hook resets y to the
  forward estimate, adds the output's cotangent to adj_y and its time
  effect to vjp_t (JAX adjoint.py:481-529).  Otherwise an interval-by-
  interval sweep whose controller starts each interval from the previous
  interval's last proposed step (:531-561).  ``step_to_end`` is on by
  default: the backward's only outputs are the interval ends.  A fixed-grid
  adjoint method (``adjoint_options=dict(step_size=...)`` or
  ``num_steps``, per interval) takes the interval-by-interval sweep with no
  warm start, as in JAX (:455-466).
* **Callbacks.**  The field's ``callback_*_adjoint`` attributes fire as the
  backward solve's ``callback_*`` (JAX :356-358), with its time (the
  forward's internal frame) and the augmented state as the tuple
  ``(vjp_t, y, adj_y, theta_bar)``.
* **Norms** (reference `handle_adjoint_norm_`, adjoint.py:243-288): the
  default ``max(|vjp_t|, ||y||, ||adj_y||, mixed(theta_bar))``,
  ``'seminorm'`` without the parameter term, or a user callable.
* ``adjoint_options=dict(noise_floor=...)`` floors the backward rtol at the
  state dtype's rounding unit (JAX :136-186).

The state is kept flat inside the backward: the augmented state is one 1-D
tensor, so each step's stage sums are one operation each, whatever the
number of parameters.

``adjoint_options=dict(interpolated=True)`` (JAX adjoint.py:188-460;
Daulbaev et al. 2020) records the forward as one `odeint_dense` over the
span, whose interpolant gives the outputs, and sweeps the reduced state
``(vjp_t, adj_y, theta_bar)`` backwards with y(s) read from that
interpolant and held constant; ``max_segments`` (default 4096) bounds the
recording.  It refuses event mode, a non-adaptive forward or adjoint
method, a callable adjoint norm and an adjoint ``step_t`` or ``jump_t``.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from .misc import (CALLBACK_NAMES, DATA_AXIS, autograd_lane_jacobian,
                   check_inputs, data_axis, flatten_state, host_times,
                   is_tree_state, lane_jacobian, mixed_norm, ravel_leaves,
                   real_dtype, real_part, rms_norm, time_effect, time_sign,
                   tree_flatten, tree_leaves, tree_map, tree_unflatten)
from .solvers import SOLVERS, needs_jacobian


def _tensors_in(obj):
    """The tensors of a nested list, tuple or dict, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _tensors_in(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _tensors_in(v)]
    return []


def _replace_tensors(obj, subs):
    """`obj` with each tensor whose id is a key of `subs` replaced."""
    if isinstance(obj, torch.Tensor):
        return subs.get(id(obj), obj)
    if isinstance(obj, dict):
        return type(obj)((k, _replace_tensors(v, subs)) for k, v in
                         obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_replace_tensors(v, subs) for v in obj)
    return obj


def _adjoint_params(func, args, adjoint_params):
    """The tensors that get adjoint gradients, without repeats:
    `adjoint_params` (those requiring grad), or the parameters of an
    ``nn.Module`` `func` that require grad and every floating tensor in
    `args`.  Returns (module-side tensors, args tensors)."""
    seen = set()

    def fresh(xs):
        out = []
        for x in xs:
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        return out

    if adjoint_params is not None:
        return fresh(p for p in adjoint_params if p.requires_grad), []
    params = []
    if isinstance(func, torch.nn.Module):
        params = fresh(p for p in func.parameters() if p.requires_grad)
    arg_tensors = fresh(x for x in _tensors_in(args)
                        if x.is_floating_point() or x.is_complex())
    return params, arg_tensors


def _check_method(name):
    name = 'dopri5' if name is None else name
    if name not in SOLVERS:
        raise ValueError('Invalid method "{}". Must be one of {}'.format(
            name, '{"' + '", "'.join(SOLVERS.keys()) + '"}.'))
    return name


def _raw_odeint(func, y0, t, rtol, atol, method, options, time_direction):
    """A solve that records no gradient, inside the backward pass (JAX
    `_raw_odeint`): `y0` one tensor (the flat augmented state), the
    adaptive or fixed-grid driver.  Returns (ys, Stats)."""
    from .odeint import _solve_normalised
    prob = check_inputs(func, y0, t, rtol, atol, method, options, None,
                        SOLVERS, time_direction=time_direction)
    return _solve_normalised(prob)


def _noise_floor(spec, y0_leaves, rtol, atol):
    """The `noise_floor` preset (JAX adjoint.py:160-186): rtol floored at
    the state dtype's rounding unit (or at the given value), and atol
    scaled by the same factor, so the rtol/atol ratio is kept."""
    u = (max(torch.finfo(x.dtype).eps / 2 for x in y0_leaves)
         if spec is True else float(spec))

    def floor_r(r):
        return max(float(r), u)

    def scale_a(r, a):
        return a * (floor_r(r) / float(r)) if float(r) > 0 else a

    if np.ndim(rtol) == 0 and np.ndim(atol) == 0:
        return floor_r(rtol), scale_a(rtol, atol)
    if np.ndim(rtol) != 0 and np.ndim(atol) != 0 and len(rtol) == len(atol):
        return ([floor_r(r) for r in rtol],
                [scale_a(r, a) for r, a in zip(rtol, atol)])
    # rtol and atol of different structure: floor rtol only
    return (floor_r(rtol) if np.ndim(rtol) == 0
            else [floor_r(r) for r in rtol]), atol


class _Layout:
    """The flat augmented state ``[vjp_t | y | adj_y | theta_bar]`` and its
    views in the user's structure (the state's shape, or its pytree); the
    interpolated adjoint's ``[vjp_t | adj_y | theta_bar]`` has no y
    (`has_y` False)."""

    def __init__(self, y_shape, unravel, params, has_y=True):
        self.n = int(np.prod(y_shape))
        self.y_shape = tuple(y_shape)
        self.unravel = unravel
        self.has_y = has_y
        self.p_shapes = [p.shape for p in params]
        self.p_sizes = [p.numel() for p in params]

    def split(self, aug):
        """(vjp_t 0-d, y or None, adj_y, [theta_bar per parameter]) as
        views; y and adj_y in the solver's state layout."""
        n = self.n
        a = 1 + n if self.has_y else 1
        th = aug[a + n:]
        ths = [part.view(shape) for part, shape in
               zip(torch.split(th, self.p_sizes), self.p_shapes)]
        y = aug[1:1 + n].view(self.y_shape) if self.has_y else None
        return aug[0], y, aug[a:a + n].view(self.y_shape), ths

    def user(self, y):
        """A state-layout tensor in the user's structure."""
        return y if self.unravel is None else self.unravel(y)


def _make_adjoint_norm(norm_spec, user_state_norm, layout, field=None,
                       params=(), data=None):
    """The norm of the backward solve on the flat augmented state (JAX
    `_make_adjoint_norm`, adjoint.py:64-118): the default, ``'seminorm'``,
    or a user callable, which sees ``(vjp_t, y, adj_y, *theta_bar)``, y and
    adj_y splatted per leaf for a pytree state.  Under a data axis `data`
    (`parallel.sharding`) the callable sees the global augmented state: y
    and adj_y gathered over the axis (one all-gather a call), vjp_t and
    theta_bar global already.  A `field` whose
    parameters are sharded over ranks carries ``param_norm(theta_bar,
    params)``, the parameter term over each parameter's global extent
    (`parallel.sharding.TensorParallelMLP`), used in place of
    `mixed_norm`."""
    single = layout.unravel is None
    if user_state_norm is None:
        state_norm = rms_norm if single else mixed_norm
    else:
        state_norm = user_state_norm
    param_norm = getattr(field, 'param_norm', None)

    def states(aug):
        vt, y, adj_y, th = layout.split(aug)
        return vt, tuple(layout.user(s) for s in (y, adj_y)
                         if s is not None), th

    def param_term(th):
        return (mixed_norm(th) if param_norm is None
                else param_norm(th, params))

    def default_adjoint_norm(aug):
        vt, ss, th = states(aug)
        out = vt.abs()
        for s in ss:
            out = torch.maximum(out, state_norm(s))
        # with no parameters the term is 0, which a max of norms ignores
        return torch.maximum(out, param_term(th)) if th else out

    def adjoint_seminorm(aug):
        vt, ss, _ = states(aug)
        out = vt.abs()
        for s in ss:
            out = torch.maximum(out, state_norm(s))
        return out

    if norm_spec is None:
        return default_adjoint_norm
    if isinstance(norm_spec, str):
        if norm_spec != 'seminorm':
            raise ValueError(f"adjoint norm must be None, 'seminorm' or a "
                             f"callable, got {norm_spec!r}")
        return adjoint_seminorm

    def wrapped(aug):
        vt, (y, adj_y), th = states(aug)
        if data is not None:
            y, adj_y = _gather_trees(data, (y, adj_y))
        if single:
            return norm_spec((vt, y, adj_y) + tuple(th))
        return norm_spec((vt, *tree_leaves(y), *tree_leaves(adj_y), *th))

    return wrapped


def _gather_trees(data, trees):
    """Trees of this rank's rows of the batch (the leading dimension of
    every leaf) as the global batch's, in one all-gather over the data
    axis `data`: every leaf flattened to (rows, -1) and concatenated."""
    flat, treedefs = zip(*(tree_flatten(x) for x in trees))
    leaves = [x for part in flat for x in part]
    b = leaves[0].shape[0]
    dt = functools.reduce(torch.promote_types, [x.dtype for x in leaves])
    whole = data.gather(torch.cat([x.reshape(b, -1).to(dt) for x in leaves],
                                  1), 0)
    parts = iter(
        (p if x.is_complex() or not p.is_complex() else p.real)
        .reshape((-1,) + tuple(x.shape[1:])).to(x.dtype)
        for p, x in zip(torch.split(whole, [x[0].numel() for x in leaves],
                                    1), leaves))
    return tuple(tree_unflatten(td, [next(parts) for _ in part])
                 for td, part in zip(treedefs, flat))


def _global_rows(data, unravel, xs):
    """(T, *state) tensors of the solver's layout holding this rank's rows
    of the batch as the global batch's, each leaf gathered over the data
    axis on its batch dimension.  Returns (the tensors, the global
    layout's unravel: None for one tensor)."""
    if unravel is None:
        return [data.gather(x, 1) for x in xs], None
    out = []
    for x in xs:
        tree = tree_map(lambda leaf: data.gather(leaf, 1), unravel(x))
        out.append(torch.cat([leaf.reshape(leaf.shape[0], -1).to(x.dtype)
                              for leaf in tree_leaves(tree)], 1))
    return out, flatten_state(tree_map(lambda leaf: leaf[0], tree))[1]


def _scipy_global_backward(spec, ys, g_ys, t_int, sign, args_d, params):
    """A SciPy adjoint method under a data axis: its controller and its
    finite-difference Jacobians read the whole augmented state, so every
    rank runs the single-device backward on the global ys and cotangents
    and keeps its rows of adj_y, as the forward SciPy route runs the
    global solve (`parallel.sharding`); vjp_t, theta_bar and the time
    effects come out global."""
    data = spec.data_axis
    (ys_g, g_g), unravel_g = _global_rows(data, spec.unravel, (ys, g_ys))
    adj_y, th, vt, dLds = _backward_pass(
        SimpleNamespace(**dict(vars(spec), data_axis=None, unravel=unravel_g)),
        ys_g, g_g, t_int, sign, args_d, params)
    if unravel_g is None:
        return data.block(adj_y), th, vt, dLds
    own = tree_map(lambda leaf: data.block(leaf), unravel_g(adj_y))
    return flatten_state(own)[0], th, vt, dLds


def _forward(spec, y0, t):
    """The primal solve: (ys, Stats), or (event_t, ys2, Stats) with event_t
    in the internal frame.  ys in the solver's state layout (flat for a
    pytree state)."""
    from .odeint import _solve_normalised, _solve_event_normalised
    if spec.unravel is not None:
        y0 = spec.unravel(y0)
    prob = check_inputs(spec.func, y0, t, spec.rtol, spec.atol, spec.method,
                        spec.options, spec.event_fn, SOLVERS,
                        args=spec.args)
    if spec.event_fn is None:
        return _solve_normalised(prob)
    return _solve_event_normalised(prob)


def _record_dense(spec, y0, t_user):
    """The interpolated adjoint's forward (JAX `_record_dense`,
    adjoint.py:295-333): one `odeint_dense` over the span, whose
    interpolant gives both the outputs and the backward's y(s).  A failed
    recording covers a prefix of the span: the outputs past it are NaN, as
    the standard loop poisons its unwritten tail.  Returns (ys, Stats,
    the DenseSolution)."""
    from .dense import odeint_dense
    T = t_user.shape[0]
    opts = dict(spec.options or {})
    if opts.get('max_num_steps') is not None:
        # a per-interval budget in the standard loop; one span of T-1
        opts['max_num_steps'] = min(int(opts['max_num_steps'])
                                    * max(T - 1, 1), 2 ** 31 - 1)
    sol, stats = odeint_dense(
        spec.func, y0 if spec.unravel is None else spec.unravel(y0),
        t_user[0], t_user[-1], rtol=spec.rtol, atol=spec.atol,
        method=spec.method, options=opts, args=spec.args,
        max_segments=spec.interp_max_segments, _return_stats=True)
    ys = sol.flat(torch.from_numpy(t_user))
    if stats.error_code != 0:
        uncovered = torch.from_numpy(sol.t_sign * t_user > sol.t_hi)
        ys[uncovered.to(ys.device)] = float('nan')
    return ys, stats, sol


def _backward_pass(spec, ys, g_ys, t_int, sign, args_d, params,
                   rec_sol=None):
    """The adjoint sweep (JAX `_backward_pass`, adjoint.py:335-561) over
    internal-frame increasing times `t_int` (a float64 host array; `sign`
    maps it to the user's frame).  `ys` and `g_ys` are (T, *state) in the
    solver's layout; `args_d` the args with their differentiated tensors
    replaced by detached leaves, `params` every differentiated tensor;
    `rec_sol` the interpolated adjoint's recorded `DenseSolution`.
    Returns (adj_y0, [theta_bar], vjp_t at t_int[0], dLds)."""
    T = t_int.shape[0]
    sdt, dev = ys.dtype, ys.device
    layout = _Layout(ys.shape[1:], spec.unravel, params,
                     has_y=rec_sol is None)
    n = layout.n
    func = spec.func
    # the interpolated adjoint: y at internal time s from the recorded
    # interpolant, held constant (JAX adjoint.py:404-407)
    y_of = None if rec_sol is None else (
        lambda s: rec_sol._eval_internal(float(s)))

    # a rank of a data-parallel solve holds one block of the batch (the
    # forward's `misc.data_axis`, `parallel.sharding`): the rates of vjp_t
    # and theta_bar, sums over the batch, are summed over the blocks at
    # every evaluation, as XLA's partitioning sums them, so that every rank
    # carries the global vjp_t and theta_bar.  Summing shares at the norm
    # instead would not do: the error control scales each entry by atol +
    # rtol * |entry| before the norm sees it, and a share's scale is not
    # the sum's.
    batch_sum = None if spec.data_axis is None else spec.data_axis.sum
    kind = SOLVERS[spec.adjoint_method]['kind']
    if batch_sum is not None and kind == 'scipy':
        return _scipy_global_backward(spec, ys, g_ys, t_int, sign, args_d,
                                      params)
    n_th = sum(layout.p_sizes)
    # an implicit or Adams adjoint method decides by the augmented state:
    # its stage solves and corrector tests read it through the backward's
    # data axis, which knows which entries are this rank's block (y and
    # adj_y) and which replicated (vjp_t, theta_bar), set around each
    # reverse solve (`parallel.sharding._AugmentedAxis`); its `sum` is the
    # identity inside a stage Jacobian
    aug_axis = None
    if batch_sum is not None and (kind == 'adams'
                                  or needs_jacobian(spec.adjoint_method)):
        rows = (2 if layout.has_y else 1) * n
        aug_axis = spec.data_axis.augmented(1 + rows + n_th, 1, 1 + rows)
        batch_sum = aug_axis.sum

    def f_dir(s, y):
        """The field in the internal increasing frame: sign * f(sign * s)."""
        out = func(s if sign > 0 else -s, layout.user(y), *args_d)
        if spec.unravel is not None:
            out = ravel_leaves(out)
        return out if sign > 0 else -out

    def aug_dyn(s, aug):
        # in the augmented state's dtype: a fixed-grid backward's stages
        # are float64 for a float32 state, as in JAX.  Inside
        # `misc.autograd_lane_jacobian` the augmented state carries a graph,
        # which the result keeps (create_graph): the Jacobian of the
        # parameter term -adj_y df/dtheta then reaches tensors the field
        # captures
        _, y, adj_y, _ = layout.split(aug)
        if y_of is not None:
            y = y_of(s)
        adt = aug.dtype
        graph = aug.requires_grad
        with torch.enable_grad():
            # the time is real whatever the state: torch then returns its
            # gradient as Re sum(conj(-adj_y) df/ds), the real time's own
            # (`time_effect`)
            s_d = torch.full((), float(s), dtype=real_dtype(adt), device=dev,
                             requires_grad=True)
            y_d = y if y.requires_grad else y.detach().requires_grad_(True)
            f = f_dir(s_d, y_d)
            grads = torch.autograd.grad(f, (s_d, y_d, *params), -adj_y,
                                        allow_unused=True, create_graph=graph)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, (s_d, y_d, *params))]
        dy = [] if y_of is not None else [
            (f if graph else f.detach()).reshape(-1).to(adt)]
        return _aug_rates(grads, dy, adt, batch_sum)

    if needs_jacobian(spec.adjoint_method):
        names = _module_param_names(spec.func, spec.module_params)
        if names is None:
            # a tensor the field captures, given in `adjoint_params`, which
            # torch.func cannot swap into a closure: the stage solves take
            # the Jacobian of `aug_dyn` above with torch.autograd.grad
            aug_dyn.lane_jacobian = autograd_lane_jacobian
        else:
            # inside a stage solve's Jacobian the time is a tensor
            # torch.func made, which may not be read: the interpolant is
            # looked up on the device there
            aug_dyn = _functional_aug_dyn(
                spec, layout, sign, args_d, params, dev,
                None if rec_sol is None
                else (lambda s: rec_sol.flat(sign * s)), names, batch_sum)
        if aug_axis is not None:
            aug_dyn.lane_jacobian = aug_axis.local_jacobian(
                getattr(aug_dyn, 'lane_jacobian', lane_jacobian))

    # the `*_adjoint` callbacks fire as the backward solve's own (JAX
    # adjoint.py:356-358), with the augmented state as a tuple
    for name in CALLBACK_NAMES:
        cb = getattr(spec.func, name + '_adjoint', None)
        if cb is not None:
            setattr(aug_dyn, name, _aug_callback(cb, layout))

    adj_opts = dict(spec.adjoint_options)
    adj_opts['norm'] = _make_adjoint_norm(adj_opts.get('norm'),
                                          spec.user_state_norm, layout,
                                          func, params, spec.data_axis)

    # the effect of moving each output time: one batched field call
    with torch.no_grad():
        t_out = torch.tensor(t_int[1:], dtype=real_dtype(sdt), device=dev)
        f_at_out = torch.func.vmap(f_dir)(t_out, ys[1:])
        dLds = time_effect(f_at_out, g_ys[1:])
        if batch_sum is not None:
            dLds = batch_sum(dLds)

    def aug_state(vt, y, adj_y, th=None):
        th = adj_y.new_zeros(n_th) if th is None else th
        ys_ = [] if y is None else [y.reshape(-1)]
        return torch.cat([vt.reshape(1), *ys_, adj_y.reshape(-1), th])

    def reverse_solve(aug0, t_pair, opts):
        token = None if aug_axis is None else DATA_AXIS.set(aug_axis)
        try:
            return _raw_odeint(aug_dyn, aug0, t_pair, spec.adjoint_rtol,
                               spec.adjoint_atol, spec.adjoint_method, opts,
                               'reverse')
        finally:
            if token is not None:
                DATA_AXIS.reset(token)

    if rec_sol is not None:
        # the interpolated adjoint (JAX adjoint.py:394-460): one reduced
        # reverse sweep, the output cotangents injected at jump_t points
        adj_opts.setdefault('step_to_end', True)
        if T > 2:
            def inject(k, tt, aug):
                j = (T - 2) - k
                out = aug.clone()
                out[0] = aug[0] - dLds[j - 1]
                out[1:1 + n] = aug[1:1 + n] + g_ys[j].reshape(-1)
                return out

            adj_opts.update(jump_t=t_int[1:-1], jump_state_fn=inject)
            if 'max_num_steps' in adj_opts:
                adj_opts['max_num_steps'] = min(
                    int(adj_opts['max_num_steps']) * (T - 1), 2 ** 31 - 1)
        sol, _ = reverse_solve(aug_state(-dLds[-1], None, g_ys[-1]),
                               np.array([t_int[-1], t_int[0]]), adj_opts)
        vt, _, adj_y, th = layout.split(sol[1])
        return adj_y + g_ys[0], th, vt, dLds

    # warm starts, step_to_end and the fused sweep are the adaptive
    # backward's (JAX adjoint.py:455-466)
    adaptive = SOLVERS[spec.adjoint_method]['kind'] == 'adaptive'
    if adaptive:
        adj_opts.setdefault('step_to_end', True)
    warm_start = adaptive and 'first_step' not in adj_opts
    fused = (warm_start and T > 2 and 'step_t' not in adj_opts
             and 'jump_t' not in adj_opts)
    if fused:
        def inject(k, tt, aug):
            # the sorted negated jump times put boundary j = (T-2) - k of
            # the increasing grid at hook index k
            j = (T - 2) - k
            out = aug.clone()
            out[0] = aug[0] - dLds[j - 1]
            out[1:1 + n] = ys[j].reshape(-1)
            out[1 + n:1 + 2 * n] = aug[1 + n:1 + 2 * n] + g_ys[j].reshape(-1)
            return out

        opts = dict(adj_opts, jump_t=t_int[1:-1], jump_state_fn=inject)
        if 'max_num_steps' in opts:
            # a per-interval budget over T-1 intervals
            opts['max_num_steps'] = min(int(opts['max_num_steps']) * (T - 1),
                                        2 ** 31 - 1)
        sol, _ = reverse_solve(aug_state(-dLds[-1], ys[-1], g_ys[-1]),
                               np.array([t_int[-1], t_int[0]]), opts)
        vt, _, adj_y, th = layout.split(sol[1])
        return adj_y + g_ys[0], th, vt, dLds

    # interval by interval (T == 2, or user step_t/jump_t/first_step)
    aug = aug_state(torch.zeros((), dtype=sdt, device=dev), ys[-1], g_ys[-1])
    dt_prev = None
    for i in range(T - 1, 0, -1):
        opts = dict(adj_opts)
        if warm_start and dt_prev is not None:
            opts['first_step'] = dt_prev
        aug = aug.clone()
        aug[0] = aug[0] - dLds[i - 1]
        if t_int[i] != t_int[i - 1]:   # equal only for an event at t0
            sol, st = reverse_solve(aug, np.array([t_int[i], t_int[i - 1]]),
                                    opts)
            aug, dt_prev = sol[1], st.final_dt
        vt, _, adj_y, _ = layout.split(aug)
        # reset y to the forward estimate; add the output's cotangent
        aug = aug_state(vt, ys[i - 1], adj_y + g_ys[i - 1],
                        aug[1 + 2 * n:])
    vt, _, adj_y, th = layout.split(aug)
    return adj_y, th, vt, dLds


def _aug_rates(grads, dy, adt, batch_sum):
    """The augmented field's value ``[vjp_t | y | adj_y | theta_bar]``, in
    `adt`, from the pullback's gradients in (time, state, *parameters) and
    y's rate `dy` (a list, empty under the interpolated adjoint); with
    `batch_sum` the rates of vjp_t and theta_bar, sums over the batch, are
    summed over the data axis in one all-reduce."""
    if batch_sum is None:
        return torch.cat([grads[0].reshape(1).to(adt), *dy,
                          *(g.reshape(-1).to(adt) for g in grads[1:])])
    sums = batch_sum(torch.cat([grads[0].reshape(1).to(adt),
                                *(g.reshape(-1).to(adt) for g in grads[2:])]))
    return torch.cat([sums[:1], *dy, grads[1].reshape(-1).to(adt), sums[1:]])


def _module_param_names(func, module_params):
    """The names under which ``torch.func.functional_call`` swaps each of
    `module_params` into an ``nn.Module`` `func`, or None when one is not a
    parameter of it (a tensor of `adjoint_params` that the field captures
    in a closure)."""
    by_id = ({id(p): name for name, p in func.named_parameters()}
             if isinstance(func, torch.nn.Module) else {})
    names = [by_id.get(id(p)) for p in module_params]
    return None if None in names else names


def _functional_aug_dyn(spec, layout, sign, args_d, params, dev, y_of=None,
                        names=None, batch_sum=None):
    """The augmented field written with ``torch.func.vjp``, the
    differentiated tensors passed to the field explicitly (module
    docstring), so that ``torch.func.jacrev`` can take its Jacobian: the
    parameters of an ``nn.Module`` field by their `names`
    (`_module_param_names`), the tensors in `args` in place.  With `y_of`
    (the interpolated adjoint) y is read from it, not the state; with
    `batch_sum` the rates of vjp_t and theta_bar are summed by it, as
    `_backward_pass`'s field sums them."""
    func = spec.func
    n_mod = len(spec.module_params)
    if names is None:
        names = _module_param_names(func, spec.module_params)
    arg_ids = [id(p) for p in params[n_mod:]]
    detached = [p.detach() for p in params]

    def f_dir(s, y, ps):
        args = _replace_tensors(args_d, dict(zip(arg_ids, ps[n_mod:])))
        inputs = (s if sign > 0 else -s, layout.user(y), *args)
        if n_mod:
            out = torch.func.functional_call(
                func, dict(zip(names, ps[:n_mod])), inputs)
        else:
            out = func(*inputs)
        if spec.unravel is not None:
            out = ravel_leaves(out)
        return out if sign > 0 else -out

    def aug_dyn(s, aug, *ps):
        # `ps`, the differentiated tensors, default to `params` detached;
        # the per-sample driver passes each sample's own (a per-sample
        # arg's row, under ``torch.func.vmap``)
        _, y, adj_y, _ = layout.split(aug)
        if y_of is not None:
            y = y_of(s)
        adt = aug.dtype
        # a copy to the device, not a host read (`misc.lane_jacobian` refuses
        # reads); non-blocking, so that it does not wait for the stream
        s_d = torch.as_tensor(s).to(device=dev, dtype=real_dtype(adt),
                                    non_blocking=True)
        f, pullback = torch.func.vjp(lambda s_, y_, *ps_: f_dir(s_, y_, ps_),
                                     s_d, y, *(ps or detached))
        grads = pullback(-adj_y)
        dy = [] if y_of is not None else [f.reshape(-1).to(adt)]
        return _aug_rates(grads, dy, adt, batch_sum)

    return aug_dyn


def _aug_callback(cb, layout):
    """`cb` on the flat augmented state, given as ``(vjp_t, y, adj_y,
    theta_bar)`` with y and adj_y in the user's structure (``(vjp_t, adj_y,
    theta_bar)`` for the interpolated adjoint)."""
    def fire(t0, aug, dt):
        vt, y, adj_y, th = layout.split(aug)
        ys_ = () if y is None else (layout.user(y),)
        cb(t0, (vt, *ys_, layout.user(adj_y), tuple(th)), dt)
    return fire


class _AdjointOp(torch.autograd.Function):
    """``(y0, t, *params) -> ys`` (or ``-> (event_t, ys2)`` with an event
    function), solved forward with no graph and differentiated by the
    adjoint sweep.  `spec` carries the field, the settings and, after the
    forward, the `Stats`."""

    @staticmethod
    def forward(ctx, spec, y0, t, *params):
        ctx.spec = spec
        t_user = host_times(t)
        sign = time_sign(t_user)
        if spec.event_fn is None:
            ctx.rec_sol = None
            if spec.interp_max_segments is not None:
                ys, stats, ctx.rec_sol = _record_dense(spec, y0, t_user)
            else:
                ys, stats = _forward(spec, y0, t_user)
            spec.stats = stats
            ctx.save_for_backward(ys)
            ctx.t_int = sign * t_user
            ctx.sign = sign
            return ys
        event_t, ys2, stats = _forward(spec, y0, t_user)
        spec.stats = stats
        ctx.save_for_backward(ys2)
        ctx.t_int = np.array([sign * t_user[0], float(event_t)])
        ctx.sign = sign
        event_t = sign * event_t
        ctx.mark_non_differentiable(event_t)
        return event_t, ys2

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        (ys,) = ctx.saved_tensors
        g_ys = grads[-1]
        t_in = ctx.needs_input_grad
        subs = {id(x): x.detach().requires_grad_(True)
                for x in spec.arg_tensors}
        args_d = _replace_tensors(spec.args, subs)
        params = list(spec.module_params) + [subs[id(x)]
                                             for x in spec.arg_tensors]
        adj_y, th, vt, dLds = _backward_pass(
            spec, ys, g_ys, ctx.t_int, ctx.sign, args_d, params,
            getattr(ctx, 'rec_sol', None))
        t_grad = None
        if t_in[2]:
            t_ref = spec.t_tensor
            if spec.event_fn is None:
                g_t = torch.cat([vt.reshape(1), dLds])
            else:
                g_t = torch.cat([vt.reshape(1), vt.new_zeros(
                    t_ref.shape[0] - 1)])
            t_grad = (ctx.sign * real_part(g_t)).to(device=t_ref.device,
                                                     dtype=t_ref.dtype)
        th_grads = [(g if p.is_complex() else real_part(g)).to(p.dtype)
                    for g, p in
                    zip(th, list(spec.module_params) + spec.arg_tensors)]
        return (None, adj_y.reshape(ys.shape[1:]) if t_in[1] else None,
                t_grad, *th_grads)


def _check_interpolated(event_fn, method, adjoint_method, adjoint_options):
    """The interpolated adjoint's refusals (JAX adjoint.py:188-240)."""
    if event_fn is not None:
        raise ValueError(
            "adjoint_options=dict(interpolated=True) does not support "
            "event mode; use the standard adjoint for odeint_event.")
    kinds = [SOLVERS[m]['kind'] for m in (method, adjoint_method)]
    if kinds != ['adaptive', 'adaptive']:
        raise ValueError(
            "interpolated adjoint requires adaptive forward and adjoint "
            f"methods (got kinds {kinds[0]!r}/{kinds[1]!r}): the dense "
            "recording and the reduced single-sweep backward both ride the "
            "adaptive loop.")
    if callable(adjoint_options.get('norm')):
        raise ValueError(
            "interpolated adjoint does not support a custom adjoint norm "
            "callable (the augmented state has no y component); use "
            "norm='seminorm' or the default.")
    for key in ('step_t', 'jump_t'):
        if key in adjoint_options:
            raise ValueError(
                f"interpolated adjoint does not support adjoint {key!r} "
                "(the single-sweep backward owns the jump_t slots for "
                "output-cotangent injection).")


def adjoint_solve(func, y0, t, *, rtol, atol, method, options, event_fn, args,
                  adjoint_rtol, adjoint_atol, adjoint_method, adjoint_options,
                  adjoint_params=None):
    """Solve with continuous-adjoint gradients (JAX `adjoint_solve`).

    Returns (ys, Stats), or ((event_t, ys), Stats) with `event_fn`, in the
    user's time frame and state structure.  The Stats are the forward
    solve's.
    """
    method = _check_method(method)
    adjoint_method = _check_method(adjoint_method)
    args = tuple(args)
    adjoint_options = {} if adjoint_options is None else dict(adjoint_options)
    leaves = tree_leaves(y0)
    nf = adjoint_options.pop('noise_floor', False)
    if nf:
        adjoint_rtol, adjoint_atol = _noise_floor(nf, leaves, adjoint_rtol,
                                                  adjoint_atol)
    interp_max_segments = None
    if adjoint_options.pop('interpolated', False):
        interp_max_segments = int(adjoint_options.pop('max_segments', 4096))
        _check_interpolated(event_fn, method, adjoint_method,
                            adjoint_options)

    module_params, arg_tensors = _adjoint_params(func, args, adjoint_params)
    t_tensor = (t if isinstance(t, torch.Tensor)
                else torch.as_tensor(host_times(t), dtype=torch.float64))
    if is_tree_state(y0):
        y0_in, unravel = flatten_state(y0)
    else:
        y0_in, unravel = y0, None
    axis = data_axis()
    if axis is not None and torch.is_grad_enabled() and any(
            x.requires_grad for x in (y0_in, t_tensor, *module_params,
                                      *arg_tensors)):
        # refused on every rank before the forward's first collective
        axis.check_adjoint_method(adjoint_method, func)
    # what the autograd Function needs besides its tensor inputs; its
    # forward leaves the solve's Stats in `stats`
    spec = SimpleNamespace(
        func=func, args=args, rtol=rtol, atol=atol, method=method,
        options=options, event_fn=event_fn, unravel=unravel,
        adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
        adjoint_method=adjoint_method, adjoint_options=adjoint_options,
        user_state_norm=(options or {}).get('norm'),
        interp_max_segments=interp_max_segments,
        module_params=module_params, arg_tensors=arg_tensors,
        t_tensor=t_tensor, stats=None, data_axis=axis)
    out = _AdjointOp.apply(spec, y0_in, t_tensor, *module_params,
                           *arg_tensors)
    if event_fn is None:
        ys = out if unravel is None else unravel(out)
        return ys, spec.stats
    event_t, ys2 = out
    return ((event_t, ys2 if unravel is None else unravel(ys2)),
            spec.stats)


def odeint_adjoint(func, y0, t, *, rtol=1e-7, atol=1e-9, method=None,
                   options=None, event_fn=None, adjoint_rtol=None,
                   adjoint_atol=None, adjoint_method=None,
                   adjoint_options=None, adjoint_params=None, args=()):
    """`odeint` with gradients by the continuous adjoint (JAX
    `odeint_adjoint`, adjoint.py:647-684; reference adjoint.py:156-223).

    Gradients flow to `y0`, `t` and the adjoint parameters: `adjoint_params`
    when given, else the parameters of an ``nn.Module`` `func` that require
    grad and every floating tensor in `args`.  A tensor the field captures
    in a closure gets no gradient unless it is passed in one of those ways.

    The backward solve takes `adjoint_rtol`, `adjoint_atol`,
    `adjoint_method` and `adjoint_options`, each defaulting to the forward
    setting (`adjoint_options` to `options` without its norm);
    ``adjoint_options['norm']`` may be ``'seminorm'`` or a callable of
    ``(vjp_t, y, adj_y, *theta_bar)``.
    """
    if adjoint_rtol is None:
        adjoint_rtol = rtol
    if adjoint_atol is None:
        adjoint_atol = atol
    if adjoint_method is None:
        adjoint_method = method
    if adjoint_method != method and options is not None \
            and adjoint_options is None:
        raise ValueError(
            "If `adjoint_method != method` then we cannot infer "
            "`adjoint_options` from `options`. So as `options` has been "
            "passed then `adjoint_options` must be passed as well.")
    if adjoint_options is None:
        adjoint_options = ({k: v for k, v in options.items() if k != "norm"}
                           if options is not None else {})
    result, _ = adjoint_solve(
        func, y0, t, rtol=rtol, atol=atol, method=method,
        options=options, event_fn=event_fn, args=args,
        adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
        adjoint_method=adjoint_method, adjoint_options=adjoint_options,
        adjoint_params=adjoint_params)
    return result


__all__ = ['odeint_adjoint', 'adjoint_solve']
