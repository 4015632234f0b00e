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
in float64 (a complex state's in complex128, with `dt` and the history
times real) and rounded back to the state dtype (the reference's
``.type_as(y0)``);
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

import numpy as np
import torch

from ..misc import Perturb, data_axis, linf_norm, real_dtype, scalar_type
from ..ops import rk_step
from ..ops.adams_coeffs import (BASHFORTH, MOULTON, MIN_ORDER, MAX_ORDER,
                                MAX_ITERS)
from ..ops.step_control import compute_error_ratio, error_scale
from .fixed_grid import FixedStepMethod, construct_grid, integrate_fixed_grid
from .solution import IMPLICIT_COUNTS as COUNTS


def _dt_in(dt, dtype):
    """`dt` cast to `dtype` (JAX ``jnp.asarray(dt).astype(y0.dtype)``), as a
    float64 value: a Python float, or a 0-d float64 tensor when `dt` carries
    a time gradient.  Every product with it is then float64, as JAX
    promotes the state-dtype `dt` against the float64 tables."""
    if isinstance(dt, torch.Tensor) and dt.requires_grad:
        return dt.to(real_dtype(dtype)).to(torch.float64)
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


def _wide(dtype):
    """The dtype JAX forms an increment in, the float64 tables promoted
    against the state: float64, or complex128 for a complex state."""
    return torch.complex128 if dtype.is_complex else torch.float64


def _increment(dt_y, c, hist, dtype):
    """``(dt_y * tensordot(c, hist)).astype(dtype)``, in float64 (complex128
    for a complex state)."""
    h = torch.stack(hist).to(_wide(dtype))
    return (dt_y * torch.tensordot(c.to(h.dtype), h, dims=1)).to(dtype)


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

    axis = data_axis()
    norm = linf_norm
    if axis is not None:
        def norm(x):
            # a data-parallel solve's corrector test reads the global max
            # (`misc.data_axis`); a NaN, whose test fails, counts as +inf
            m = linf_norm(x)
            return axis.max(torch.where(torch.isnan(m), float('inf'), m))

    def _has_converged(dy0, dy1):
        err = (dy0 - dy1).abs()
        COUNTS['host_reads'] += 1
        return compute_error_ratio(err, rtol, atol, dy0, dy1,
                                   norm).item() < 1

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
            dy_new = (c0 * f.to(_wide(yd))).to(yd) + delta
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


def make_lane_adams_method(*, implicit, rtol, atol, max_iters=MAX_ITERS,
                           max_order=MAX_ORDER):
    """`make_adams_method` for a batch (B, ...) on a shared grid with a
    batched field: JAX's Adams stepper under vmap.  The history is shared
    in its entries (a slope is prepended for every sample when time
    advances) but its usable length is each sample's own, since a sample
    whose corrector did not converge drops its oldest entry: each sample
    then runs its own order, its Bashforth and Moulton rows gathered per
    sample, and the RK4 bootstrap is selected per sample where its order
    is below 4 (JAX's `lax.cond` on a batched predicate, which runs both
    branches and selects).  The lengths are kept on the host: they change
    by one where a step's corrector ends unconverged, which the loop reads
    only when it ran all `max_iters` iterations.  The corrector iterates
    while any sample is unconverged (one host read an iteration); each
    sample counts the evaluations it made before it converged, JAX's NFE
    (ROADMAP C3).  The state's ``nfe`` is (B,)."""
    max_order = int(max_order)
    if max_order > MAX_ORDER:
        raise ValueError(f"max_order must be at most {MAX_ORDER}")
    if max_order < MIN_ORDER:
        warnings.warn(
            f"max_order is below {MIN_ORDER}, so the solver reduces to `rk4`.")
    hist_size = max(max_order - 1, 1)
    max_iters = int(max_iters)

    def init_state(func, y0, t0):
        B = y0.shape[0]
        return dict(hist=[], hist_len=np.zeros(B, dtype=np.int64),
                    prev_t=None,
                    nfe=torch.zeros(B, dtype=torch.int32, device=y0.device))

    def rows(table, orders, offset, width, device):
        """Row ``order + offset`` of `table` per sample, its first `width`
        entries (zero beyond the row's own), (width, B) float64."""
        return torch.from_numpy(np.ascontiguousarray(
            table[orders + offset, :width].T)).to(device)

    def combine(dt_y, c, hist, dtype):
        """``(dt_y * tensordot(c_b, hist)).astype(dtype)`` per sample, in
        float64."""
        total = None
        for j, h in enumerate(hist):
            term = lanes_of(c[j], h) * h.to(_wide(dtype))
            total = term if total is None else total + term
        return (dt_y * total).to(dtype)

    def lanes_of(v, x):
        return v.reshape(v.shape + (1,) * (x.dim() - 1))

    def has_converged(dy0, dy1):
        scale = error_scale(rtol, atol, dy0, dy1)
        ratio = ((dy0 - dy1).abs() / scale).abs()
        return ratio.reshape(ratio.shape[0], -1).amax(1) < 1

    def step(func, t0, dt, t1, y0, perturb, state):
        f0 = func(t0, y0, perturb=Perturb.NEXT if perturb else Perturb.NONE)
        t_now = float(t0.detach() if isinstance(t0, torch.Tensor) else t0)
        if state['prev_t'] is None or state['prev_t'] != t_now:
            state = dict(state, hist=[f0] + state['hist'][:hist_size - 1],
                         hist_len=np.minimum(state['hist_len'] + 1,
                                             hist_size), prev_t=t_now)
        hist_len = state['hist_len']
        order = np.minimum(hist_len, max_order - 1)
        use_rk4 = order < MIN_ORDER - 1
        yd, dev = y0.dtype, y0.device
        hist = state['hist']
        dy = None
        nfe = state['nfe']
        if use_rk4.any():
            dy = rk_step.rk4_alt_step_func(func, t0, dt, t1, y0, f0=hist[0],
                                           perturb=perturb).to(yd)
            nfe = nfe + torch.from_numpy(3 * use_rk4.astype(np.int32)).to(dev)
        if use_rk4.all():
            return dy, f0, dict(state, nfe=nfe)
        dt_y = _dt_in(dt, yd)
        width = len(hist)
        bash = rows(BASHFORTH, order, 0, width, dev)
        dy_ad = combine(dt_y, bash, hist, yd)
        adams = torch.from_numpy(~use_rk4).to(dev)
        if implicit:
            moult = rows(MOULTON, order, 1, width + 1, dev)
            delta = combine(dt_y, moult[1:], hist, yd)
            c0 = lanes_of(dt_y * moult[0], y0)
            p1 = Perturb.PREV if perturb else Perturb.NONE
            converged = ~adams
            n_ev = torch.zeros_like(nfe)
            it = 0
            while it < max_iters:
                COUNTS['host_reads'] += 1
                if bool(converged.all()):
                    break
                it += 1
                n_ev = n_ev + (~converged).to(torch.int32)
                f = func(t1, y0 + dy_ad, perturb=p1)
                dy_new = (c0 * f.to(_wide(yd))).to(yd) + delta
                conv_now = has_converged(dy_ad, dy_new)
                dy_ad = torch.where(lanes_of(converged, dy_ad), dy_ad,
                                    dy_new)
                converged = converged | conv_now
            COUNTS['corrector_steps'] += 1
            nfe = nfe + n_ev
            if it == max_iters:
                COUNTS['host_reads'] += 1
                dropped = (~converged).cpu().numpy()
                COUNTS['corrector_converged'] += int(not dropped.any())
                hist_len = np.where(dropped, np.maximum(hist_len - 1, 0),
                                    hist_len)
            else:
                COUNTS['corrector_converged'] += 1
        dy = dy_ad if dy is None else torch.where(lanes_of(adams, dy), dy_ad,
                                                  dy)
        return dy, f0, dict(state, nfe=nfe, hist_len=hist_len)

    return FixedStepMethod(step, order=MIN_ORDER, nfe_per_step=1,
                           init_state=init_state,
                           nfe_from_state=lambda st: st['nfe'])


def make_fixed_step_method(prob, implicit, lanes=False):
    """The Adams stepper of a normalised problem's options (JAX
    adams.py:151-157); with `lanes`, `make_lane_adams_method`."""
    opts = dict(prob.options)
    make = make_lane_adams_method if lanes else make_adams_method
    return make(
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
