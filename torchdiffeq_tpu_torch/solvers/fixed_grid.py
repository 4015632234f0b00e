"""Fixed-grid solvers as a host loop (counterpart of
``torchdiffeq_tpu/solvers/fixed_grid.py``; reference
torchdiffeq/_impl/solvers.py:70-164 and fixed_grid.py).

The five explicit steppers are here; the Adams (`adams.py`) and implicit
(`fixed_grid_implicit.py`) steppers ride the same loops.  A stepper
carries a state of its own from step to step (JAX's stepper state: empty
for the explicit ones, the slope history of Adams, the implicit tiers'
all-converged flag), which also gives the solve's extra NFE and its error
code.

The JAX package sweeps the grid with one `lax.scan` and backpropagates
through it.  Here the sweep is a Python loop of plain tensor operations, so
under autograd backprop through the solver is what autograd records
(discretise-then-optimise, the reference's semantics); ``remat=True``
wraps each step in ``torch.utils.checkpoint`` so that the backward pass
recomputes a step's stages instead of storing them.  The outputs are then
interpolated at once as in JAX: output time t_j lies in the first grid
interval whose right end reaches it (``searchsorted(side='left')``,
clipped), and its value is the linear or cubic Hermite interpolant there,
the same formula, so gradients to the grid states are the same too.

Time: the grid is float64.  Its points are Python floats, or 0-d float64
tensors when the output times carry a gradient (the grid, the step sizes
and the emission then differentiate to them, as JAX's traced grid does).
As in JAX, the stage arithmetic ``dt * k`` promotes a float32 or 16-bit
state to float64 (`ops/rk_step.tmul`), the field sees the float64 stage
states, and the increment is cast back to the state dtype.  The event
solve keeps its time in the state dtype, as JAX's does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..misc import Perturb, nan_sign, real_dtype, scalar_type
from ..ops import rk_step
from ..ops.interp import linear_interp, cubic_hermite_interp
from ..ops.rk_step import tmul, tscale
from .solution import Stats, OK, ERR_MAX_NUM_STEPS


class FixedStepMethod(NamedTuple):
    """A fixed-grid stepper (JAX fixed_grid.py:41-58).

    ``step(func, t0, dt, t1, y0, perturb, state) -> (dy, f0, state)``: the
    increment, the slope at the step's start and the stepper's new state;
    ``init_state(func, y0, t0)``, the state before the first step;
    ``error_from_state(state)``, the error code of the last state (None:
    OK); ``nfe_from_state(state)``, NFE counted in the state beyond
    ``nfe_per_step`` a step (None: none).
    """
    step: Callable
    order: int
    nfe_per_step: int
    init_state: Callable = lambda func, y0, t0: ()
    error_from_state: Callable = None
    nfe_from_state: Callable = None


def _stateless(fn):
    """A stepper of the form ``fn(func, t0, dt, t1, y0, perturb) -> (dy,
    f0)`` with an empty state."""
    def step(func, t0, dt, t1, y0, perturb, state):
        dy, f0 = fn(func, t0, dt, t1, y0, perturb)
        return dy, f0, state
    return step


def _state_nfe_and_error(method, state):
    """The extra NFE and the error code a stepper's last state reports."""
    nfe = 0 if method.nfe_from_state is None else method.nfe_from_state(state)
    err = OK if method.error_from_state is None else \
        method.error_from_state(state)
    return nfe, err


def _f0(func, t0, y0, perturb):
    return func(t0, y0, perturb=Perturb.NEXT if perturb else Perturb.NONE)


def _euler_step(func, t0, dt, t1, y0, perturb):
    f0 = _f0(func, t0, y0, perturb)
    return tmul(dt, f0), f0


def _midpoint_step(func, t0, dt, t1, y0, perturb):
    half_dt = tscale(dt, 0.5)
    f0 = _f0(func, t0, y0, perturb)
    y_mid = y0 + tmul(half_dt, f0)
    return tmul(dt, func(t0 + half_dt, y_mid)), f0


def _rk4_step(func, t0, dt, t1, y0, perturb):
    f0 = _f0(func, t0, y0, perturb)
    return rk_step.rk4_alt_step_func(func, t0, dt, t1, y0, f0=f0,
                                     perturb=perturb), f0


_HEUN3_TABLE = [
    [0.0, 0.0, 0.0, 0.0],
    [1 / 3, 1 / 3, 0.0, 0.0],
    [2 / 3, 0.0, 2 / 3, 0.0],
    [0.0, 1 / 4, 0.0, 3 / 4],
]

_HEUN2_TABLE = [
    [0.0, 0.0, 0.0],
    [1.0, 1.0, 0.0],
    [0.0, 1 / 2, 1 / 2],
]


def _heun3_step(func, t0, dt, t1, y0, perturb):
    f0 = _f0(func, t0, y0, perturb)
    return rk_step.rk3_step_func(func, t0, dt, t1, y0, _HEUN3_TABLE, f0=f0,
                                 perturb=perturb), f0


def _heun2_step(func, t0, dt, t1, y0, perturb):
    f0 = _f0(func, t0, y0, perturb)
    return rk_step.rk2_step_func(func, t0, dt, t1, y0, _HEUN2_TABLE, f0=f0,
                                 perturb=perturb), f0


FIXED_STEP_METHODS = {
    'euler': FixedStepMethod(_stateless(_euler_step), order=1,
                             nfe_per_step=1),
    'midpoint': FixedStepMethod(_stateless(_midpoint_step), order=2,
                                nfe_per_step=2),
    'rk4': FixedStepMethod(_stateless(_rk4_step), order=4, nfe_per_step=4),
    'heun3': FixedStepMethod(_stateless(_heun3_step), order=3,
                             nfe_per_step=3),
    'heun2': FixedStepMethod(_stateless(_heun2_step), order=2,
                             nfe_per_step=2),
}


def _host(t):
    """Times as a float64 numpy array (a tensor's values, detached)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to('cpu', torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


def construct_grid(func, y0, t, step_size, grid_constructor, num_steps=None):
    """The integration grid over the internal times `t` (JAX
    `construct_grid`, fixed_grid.py:120-154; reference solvers.py:70-96).

    `t` is a float64 numpy array, or a float64 CPU tensor carrying a
    gradient.  ``num_steps`` spreads ``num_steps + 1`` points uniformly over
    ``[t[0], t[-1]]``; ``step_size`` gives ``arange * step + start`` with
    its last point set to the end, in float64 on the host (it does not
    depend on `t` differentiably, as in JAX); a ``grid_constructor``
    returns its own grid; with none of them the grid is `t`.  The three
    are mutually exclusive.
    """
    if sum(x is not None for x in (step_size, grid_constructor,
                                   num_steps)) > 1:
        raise ValueError("step_size, grid_constructor and num_steps are "
                         "mutually exclusive arguments.")
    if num_steps is not None:
        frac = np.linspace(0.0, 1.0, int(num_steps) + 1)
        if isinstance(t, torch.Tensor):
            frac = torch.from_numpy(frac)
        return t[0] + (t[-1] - t[0]) * frac
    if step_size is None:
        if grid_constructor is None:
            return t
        grid = grid_constructor(func, y0, torch.as_tensor(t))
        return grid if grid.requires_grad else grid.numpy()
    t_np = _host(t)
    start_time, end_time = t_np[0], t_np[-1]
    niters = int(np.ceil((end_time - start_time) / step_size + 1))
    t_infer = (np.arange(0, niters, dtype=np.float64) * np.float64(step_size)
               + start_time)
    t_infer[-1] = end_time
    return t_infer


def integrate_fixed_grid(method: FixedStepMethod, func, y0, ts, grid, *,
                         interp="linear", perturb=False, remat=False):
    """Sweep `grid` with `method` and interpolate the solution at `ts`
    (JAX `integrate_fixed_grid`, fixed_grid.py:157-230).

    `ts` and `grid` are internal (increasing) float64 times: numpy arrays,
    or CPU tensors carrying a gradient.  The field's ``callback_step``
    fires before each step (reference solvers.py:113).  ``interp='cubic'``
    evaluates the field once more per interval, at its end.  Returns
    (ys (T, *y0.shape), Stats): NFE ``n_steps * nfe_per_step``, plus
    ``n_steps`` with cubic, plus what the stepper's state counts; every
    step accepted; the error code the stepper's state reports.
    """
    if interp not in ("linear", "cubic"):
        raise ValueError(f"Unknown interpolation method {interp}")
    cubic = interp == "cubic"
    grid_np = _host(grid)
    timed = isinstance(grid, torch.Tensor) and grid.requires_grad
    points = list(grid.unbind()) if timed else grid_np.tolist()
    G = len(points)
    callback = getattr(func, 'callback_step', None)

    def step(y, state, t0, t1):
        dy, f0, state = method.step(func, t0, t1 - t0, t1, y, perturb, state)
        y1 = y + dy.to(y.dtype)
        if cubic:
            return y1, state, f0, func(t1, y1, perturb=Perturb.NONE)
        return y1, state

    remat = remat and torch.is_grad_enabled()
    ys, f0s, f1s = [y0], [], []
    state = method.init_state(func, y0, points[0])
    for t0, t1 in zip(points[:-1], points[1:]):
        if callback is not None:
            callback(t0, ys[-1], t1 - t0)
        if remat:
            out = checkpoint(step, ys[-1], state, t0, t1, use_reentrant=False)
        else:
            out = step(ys[-1], state, t0, t1)
        ys.append(out[0])
        state = out[1]
        if cubic:
            f0s.append(out[2])
            f1s.append(out[3])

    # emission: t_j in grid interval [grid[i1-1], grid[i1]] with
    # grid[i1-1] < t_j <= grid[i1] (JAX fixed_grid.py:210-222)
    ts_t = ts if isinstance(ts, torch.Tensor) else torch.from_numpy(_host(ts))
    i1 = np.clip(np.searchsorted(grid_np, _host(ts), side='left'), 1, G - 1)
    grid_t = grid if timed else torch.from_numpy(grid_np)
    idx = torch.from_numpy(i1)
    t0s, t1s = grid_t[idx - 1], grid_t[idx]
    ya = torch.stack([ys[i - 1] for i in i1])
    yb = torch.stack([ys[i] for i in i1])
    if cubic:
        fa = torch.stack([f0s[i - 1] for i in i1])
        fb = torch.stack([f1s[i - 1] for i in i1])
        out = cubic_hermite_interp(t0s, ya, fa, t1s, yb, fb, ts_t)
    else:
        out = linear_interp(t0s, t1s, ya, yb, ts_t)

    n_steps = G - 1
    extra_nfe, err = _state_nfe_and_error(method, state)
    nfe = n_steps * method.nfe_per_step + (n_steps if cubic else 0) \
        + extra_nfe
    return out, Stats.make(nfe=nfe, n_steps=n_steps, n_accepted=n_steps,
                           error_code=err)


def integrate_until_event_fixed_grid(method: FixedStepMethod, func, y0, t0,
                                     event_fn, *, step_size, interp="linear",
                                     perturb=False, atol=1e-9,
                                     max_itrs=20000):
    """Step until `event_fn` changes sign, then bisect on the last
    interval's interpolant (JAX `integrate_until_event_fixed_grid`,
    fixed_grid.py:233-295; reference solvers.py:130-164).  The stepper's
    state adds its NFE; its error code does not enter, as in JAX.

    Time is in the state dtype, as in JAX: ``t1 = t0 + step_size`` rounds
    there, and so does the bisection (`events.find_event` with
    ``tol=atol``).  Each step reads the event's sign back to the host.
    After `max_itrs` steps with no sign change the bisection runs on the
    last (empty) interval and the error code is ``ERR_MAX_NUM_STEPS``.
    Returns (event_t, y_event, Stats), `event_t` a 0-d float64 tensor on
    the state's device.
    """
    from ..events import find_event

    if step_size is None:
        raise ValueError(
            "Event handling for fixed step solvers currently requires "
            "`step_size` to be provided in options.")
    if interp not in ("linear", "cubic"):
        raise ValueError(f"Unknown interpolation method {interp}")
    cubic = interp == "cubic"
    tdt = real_dtype(y0.dtype)
    sd = scalar_type(tdt)

    def time(t):
        return torch.full((), float(t), dtype=tdt, device=y0.device)

    t0, dt = sd(t0), sd(step_size)
    sign0_t = nan_sign(event_fn(time(t0), y0))
    sign0 = sign0_t.item()
    state = method.init_state(func, y0, t0)
    t1, y1, f0, f1 = t0, y0, None, None
    itr, changed = 0, False
    while not changed and itr < max_itrs:
        t1 = t0 + dt
        dy, f0, state = method.step(func, t0, dt, t1, y0, perturb, state)
        y1 = y0 + dy.to(y0.dtype)
        if cubic:
            f1 = func(t1, y1, perturb=Perturb.NONE)
        itr += 1
        # NaN != NaN: a NaN sign ends the loop, as in JAX
        changed = nan_sign(event_fn(time(t1), y1)).item() != sign0
        if not changed:
            t0, y0 = t1, y1

    ta, tb = time(t0).reshape(1), time(t1).reshape(1)
    if cubic:
        def interp_fn(t):
            return cubic_hermite_interp(ta, y0[None], f0[None], tb, y1[None],
                                        f1[None], t.reshape(1))[0]
    else:
        def interp_fn(t):
            return linear_interp(ta, tb, y0[None], y1[None], t.reshape(1))[0]

    event_t, y_event = find_event(interp_fn, sign0_t, t0, t1, event_fn, atol,
                                  dtype=tdt)
    nfe = itr * (method.nfe_per_step + (1 if cubic else 0)) \
        + _state_nfe_and_error(method, state)[0]
    stats = Stats.make(nfe=nfe, n_steps=itr, n_accepted=itr,
                       error_code=OK if changed else ERR_MAX_NUM_STEPS)
    return event_t.to(torch.float64), y_event, stats
