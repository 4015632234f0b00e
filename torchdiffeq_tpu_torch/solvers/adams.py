"""Adams-Bashforth(-Moulton) multistep solvers on the fixed-grid loop
(counterpart of ``torchdiffeq_tpu/solvers/adams.py``; reference
torchdiffeq/_impl/fixed_adams.py:164-228).

The stepper's state holds the slope history, newest first (a list of up to
``max_order - 1`` tensors, JAX's ring buffer), its length, the time of the
last entry and the NFE the corrector counts.  A slope is prepended only
when time advanced (fixed_adams.py:175-178).  Below order 4 the step is
the RK4 3/8-rule bootstrap, which evaluates the field 3 more times; from
there the order rises with the history to ``max_order``.

Arithmetic follows JAX's promotion: `dt` is cast to the state dtype, the
coefficient tables are float64, so a float32 state's increment is formed
in float64 and rounded back to float32 (the reference's ``.type_as(y0)``);
this is not the explicit fixed grid's promotion through the float64 grid
(`ops/rk_step.tmul`).

The implicit corrector iterates ``dy = dt * (m0 * f(t1, y0 + dy) + sum_j
m_j f_j)`` until the linf error ratio of two iterates is below 1
(fixed_adams.py:181-184), at most `max_iters` times; each test is a host
read.  JAX evaluates all `max_iters` iterations, masked, while this loop
stops at convergence (ROADMAP C3): the values are the same, and so is
`Stats.nfe`, which counts, as JAX's does, one evaluation a step, the
corrector's evaluations up to convergence and the bootstrap's 3.  A
corrector that does not converge drops the oldest history entry
(fixed_adams.py:219-221).  Autograd records the whole loop, so gradients
are backprop through the solver, as in JAX and the reference.
"""
from __future__ import annotations

import warnings

import torch

from ..misc import Perturb, linf_norm, scalar_type
from ..ops import rk_step
from ..ops.adams_coeffs import (BASHFORTH, MOULTON, MIN_ORDER, MAX_ORDER,
                                MAX_ITERS)
from ..ops.step_control import compute_error_ratio
from .fixed_grid import FixedStepMethod, construct_grid, integrate_fixed_grid
from .solution import IMPLICIT_COUNTS as COUNTS


def _dt_in(dt, dtype):
    """`dt` cast to `dtype` (JAX ``jnp.asarray(dt).astype(y0.dtype)``), as a
    float64 value: a Python float, or a 0-d float64 tensor when `dt` carries
    a time gradient.  Every product with it is then float64, as JAX
    promotes the state-dtype `dt` against the float64 tables."""
    if isinstance(dt, torch.Tensor) and dt.requires_grad:
        return dt.to(dtype).to(torch.float64)
    return float(scalar_type(dtype)(float(dt)))


_COEFFS = {}


def _coeffs(table, row, width, device):
    """Row `row` of a coefficient table, its first `width` entries, as a
    float64 tensor on `device` (made once per device)."""
    key = (id(table), row, width, str(device))
    if key not in _COEFFS:
        _COEFFS[key] = torch.tensor(table[row, :width], dtype=torch.float64,
                                    device=device)
    return _COEFFS[key]


def _increment(dt_y, c, hist, dtype):
    """``(dt_y * tensordot(c, hist)).astype(dtype)``, in float64."""
    h = torch.stack(hist).to(torch.float64)
    return (dt_y * torch.tensordot(c, h, dims=1)).to(dtype)


def make_adams_method(*, implicit, rtol, atol, max_iters=MAX_ITERS,
                      max_order=MAX_ORDER):
    """An Adams `FixedStepMethod` (JAX `make_adams_method`, adams.py:39)."""
    max_order = int(max_order)
    if max_order > MAX_ORDER:
        raise ValueError(f"max_order must be at most {MAX_ORDER}")
    if max_order < MIN_ORDER:
        warnings.warn(
            f"max_order is below {MIN_ORDER}, so the solver reduces to `rk4`.")
    hist_size = max(max_order - 1, 1)
    max_iters = int(max_iters)

    def init_state(func, y0, t0):
        # prev_t: the time of the newest entry, as a float of the time
        # dtype (JAX keeps it in the time dtype, not the state dtype)
        return dict(hist=[], hist_len=0, prev_t=None, nfe=0)

    def _update_history(state, t, f):
        if state['prev_t'] is not None and state['prev_t'] == t:
            return state
        return dict(state, hist=[f] + state['hist'][:hist_size - 1],
                    hist_len=min(state['hist_len'] + 1, hist_size), prev_t=t)

    def _has_converged(dy0, dy1):
        err = (dy0 - dy1).abs()
        COUNTS['host_reads'] += 1
        return compute_error_ratio(err, rtol, atol, dy0, dy1,
                                   linf_norm).item() < 1

    def step(func, t0, dt, t1, y0, perturb, state):
        f0 = func(t0, y0, perturb=Perturb.NEXT if perturb else Perturb.NONE)
        t_now = float(t0.detach() if isinstance(t0, torch.Tensor) else t0)
        state = _update_history(state, t_now, f0)
        order = min(state['hist_len'], max_order - 1)
        yd = y0.dtype
        hist = state['hist']
        if order < MIN_ORDER - 1:
            # the RK4 bootstrap: 3 evaluations beyond the shared f0; the grid
            # times' float64 does not promote the increment (`.to(yd)`)
            dy = rk_step.rk4_alt_step_func(func, t0, dt, t1, y0, f0=hist[0],
                                           perturb=perturb)
            return dy.to(yd), f0, dict(state, nfe=state['nfe'] + 3)
        dt_y = _dt_in(dt, yd)
        dev = y0.device
        dy = _increment(dt_y, _coeffs(BASHFORTH, order, order, dev),
                        hist[:order], yd)
        if not implicit:
            return dy, f0, state
        moult = _coeffs(MOULTON, order + 1, order + 1, dev)
        delta = _increment(dt_y, moult[1:], hist[:order], yd)
        # dt_y * m0 in float64, then the slope promoted to it
        c0 = dt_y * float(MOULTON[order + 1, 0])
        p1 = Perturb.PREV if perturb else Perturb.NONE
        n_ev, converged = 0, False
        while n_ev < max_iters and not converged:
            n_ev += 1
            f = func(t1, y0 + dy, perturb=p1)
            dy_new = (c0 * f.to(torch.float64)).to(yd) + delta
            converged = _has_converged(dy, dy_new)
            dy = dy_new
        COUNTS['corrector_steps'] += 1
        COUNTS['corrector_converged'] += converged
        hist_len = state['hist_len'] if converged else \
            max(state['hist_len'] - 1, 0)
        return dy, f0, dict(state, nfe=state['nfe'] + n_ev,
                            hist_len=hist_len)

    return FixedStepMethod(step, order=MIN_ORDER, nfe_per_step=1,
                           init_state=init_state,
                           nfe_from_state=lambda st: st['nfe'])


def make_fixed_step_method(prob, implicit):
    """The Adams stepper of a normalised problem's options (JAX
    adams.py:151-157)."""
    opts = dict(prob.options)
    return make_adams_method(
        implicit=opts.get('implicit', implicit),
        rtol=prob.rtol, atol=prob.atol,
        max_iters=opts.get('max_iters', MAX_ITERS),
        max_order=opts.get('max_order', MAX_ORDER))


ADAMS_OPTIONS = {'step_size', 'grid_constructor', 'num_steps', 'perturb',
                 'interp', 'implicit', 'max_iters', 'max_order', 'dtype'}


def integrate_adams(prob, implicit, ts=None):
    """The Adams solve of a normalised problem over its grid (JAX
    `integrate_adams`, adams.py:160-172); `ts` replaces ``prob.t`` when the
    output times carry a gradient."""
    from ..odeint import _warn_unused
    opts = dict(prob.options)
    _warn_unused('Adams solver', opts, ADAMS_OPTIONS)
    method = make_fixed_step_method(prob, implicit)
    ts = prob.t if ts is None else ts
    grid = construct_grid(prob.func, prob.y0, ts, opts.get('step_size'),
                          opts.get('grid_constructor'), opts.get('num_steps'))
    return integrate_fixed_grid(method, prob.func, prob.y0, ts, grid,
                                interp=opts.get('interp', 'linear'),
                                perturb=opts.get('perturb', False))
