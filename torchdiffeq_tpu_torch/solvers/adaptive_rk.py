"""Adaptive Runge-Kutta solver as a host loop (counterpart of
``torchdiffeq_tpu/solvers/adaptive_rk.py``).

The JAX package runs the whole solve as one compiled ``lax.while_loop``.
PyTorch runs eagerly, so here the loop is on the host: each iteration takes
one step on the device and reads back ONE set of values -- the error ratio,
whether the new state is finite, and in an event solve the event's sign at
the step's end -- from which the host decides accept or reject, the next
step size, the guards, the output emission and the end of an event solve.  Time is
a float64 host scalar throughout.  Numerics (controller constants, FSAL,
perturbation, emission through the quartic interpolant, the per-interval
`max_num_steps` budget, NaN poisoning of unwritten outputs) are the JAX
solver's, so values and `Stats` counters match it.

Not yet ported (ROADMAP A2/A3): `step_t`, `jump_t`, `jump_state_fn`,
`step_to_end`, `error_dtype` and the PI/PID controllers.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..misc import Perturb, nan_sign, time_tensor
from ..ops.interp import interp_fit_step, interp_evaluate, interp_evaluate_at
from ..ops.rk_step import runge_kutta_step
from ..ops.step_control import (select_initial_step, compute_error_ratio,
                                optimal_step_size)
from ..ops.tableaus import ButcherTableau
from .solution import (Stats, OK, ERR_DT_UNDERFLOW, ERR_NONFINITE_STATE,
                       ERR_MAX_NUM_STEPS)

# JAX adaptive options that belong to later slices of the port.
NOT_PORTED_OPTIONS = {
    'step_t': 'ROADMAP A2', 'jump_t': 'ROADMAP A2',
    'jump_state_fn': 'ROADMAP A3', 'step_to_end': 'ROADMAP A3',
    'error_dtype': 'ROADMAP A2', 'controller': 'ROADMAP A2',
    'pcoeff': 'ROADMAP A2', 'icoeff': 'ROADMAP A2', 'dcoeff': 'ROADMAP A2',
    'replay_grad': 'ROADMAP A3', 'max_segments': 'ROADMAP A3',
    'forward_grad': 'ROADMAP A10', 'compensated_time': "ROADMAP 'Not to port'",
}
SUPPORTED_OPTIONS = {'first_step', 'safety', 'ifactor', 'dfactor',
                     'min_step', 'max_step', 'max_num_steps'}


class AdaptiveConfig(NamedTuple):
    tableau: ButcherTableau
    rtol: float
    atol: float
    norm: Any
    first_step: Any = None
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    min_step: float = 0.0
    max_step: float = float('inf')
    max_num_steps: int = 2 ** 31 - 1


def _setup(func, y0, t0, cfg: AdaptiveConfig):
    """Initial f0 and dt (reference `_before_integrate`,
    rk_common.py:213-241).  Returns (f0, dt0, nfe0)."""
    f0 = func(t0, y0, perturb=Perturb.NONE)
    if cfg.first_step is None:
        dt0 = select_initial_step(func, t0, y0, cfg.tableau.order - 1,
                                  cfg.rtol, cfg.atol, cfg.norm, f0)
        return f0, dt0, 2
    return f0, np.float64(cfg.first_step), 1


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


class _Carry:
    """The loop state on the host: the state and its slope at `t1`, the
    last step's window ``[t0, t1]`` and its quartic `coeff`, the next `dt`,
    the counters and the error code (the JAX `_Carry`)."""

    def __init__(self, func, y0, t0, cfg: AdaptiveConfig):
        self.f, self.dt, self.nfe = _setup(func, y0, t0, cfg)
        self.y = y0
        self.t0 = self.t1 = t0
        self.coeff = y0.new_zeros((5,) + tuple(y0.shape))
        self.n_steps = self.n_acc = self.n_rej = self.steps_in_interval = 0
        self.err = OK
        self.y_finite = bool(torch.isfinite(y0).all())

    def stats(self):
        return Stats.make(nfe=self.nfe, n_steps=self.n_steps,
                          n_accepted=self.n_acc, n_rejected=self.n_rej,
                          error_code=self.err, final_dt=float(self.dt))


def _adaptive_step(c: _Carry, func, cfg: AdaptiveConfig, probe=None):
    """One accept-or-reject step on the carry `c`, in place (JAX
    `_adaptive_step`, adaptive_rk.py:170-401).

    Makes ONE host read: the error ratio and whether the proposed state is
    finite, and with `probe`, ``probe(t1, y1)`` at the proposed step's end
    (a 0-d tensor), all read together.  Returns (accepted, probe value).  A
    tripped guard sets ``c.err`` and leaves the rest of the carry as it was
    (the JAX loop freezes its carry and exits).
    """
    tab = cfg.tableau
    min_step, max_step = np.float64(cfg.min_step), np.float64(cfg.max_step)
    t0 = c.t1
    dt = _clip(c.dt if math.isfinite(c.dt) else min_step, min_step, max_step)

    # --- guards (reference asserts, rk_common.py:286-287) -----------------
    t1 = t0 + dt
    if c.steps_in_interval >= cfg.max_num_steps:
        c.err = ERR_MAX_NUM_STEPS
    elif not t1 > t0:
        c.err = ERR_DT_UNDERFLOW
    elif not c.y_finite:
        c.err = ERR_NONFINITE_STATE
    if c.err != OK:
        return False, None

    # --- the RK step, and the one host read of the iteration --------------
    y1, f1, y1_err, k = runge_kutta_step(func, c.y, c.f, t0, dt, t1, tab)
    c.nfe += len(tab.alpha)
    ratio_t = compute_error_ratio(y1_err, cfg.rtol, cfg.atol, c.y, y1,
                                  cfg.norm)
    read = [ratio_t, torch.isfinite(y1).all().to(ratio_t.dtype)]
    if probe is not None:
        read.append(probe(t1, y1).to(ratio_t.dtype))
    ratio, y1_finite, *probed = torch.stack(read).tolist()
    accept = ratio <= 1
    if dt > max_step:
        accept = False
    if dt <= min_step:
        accept = True

    c.n_steps += 1
    c.steps_in_interval += 1
    c.t0 = t0
    if accept:
        c.n_acc += 1
        c.coeff = interp_fit_step(c.y, y1, k, dt, tab)
        c.y, c.f, c.t1, c.y_finite = y1, f1, t1, bool(y1_finite)
    else:
        c.n_rej += 1
    c.dt = _clip(optimal_step_size(dt, ratio, cfg.safety, cfg.ifactor,
                                   cfg.dfactor, tab.order),
                 min_step, max_step)
    return accept, (probed[0] if probed else None)


def integrate(func, y0, ts, cfg: AdaptiveConfig):
    """Integrate to every time in `ts` (increasing float64 host array).

    Returns (ys (T, *y0.shape), Stats): the JAX `integrate`
    (adaptive_rk.py:423-613), one `_adaptive_step` per loop iteration.
    """
    T = ts.shape[0]
    c = _Carry(func, y0, ts[0], cfg)
    out = y0.new_zeros((T,) + tuple(y0.shape))
    out[0] = y0
    i_out = 1
    while ts[-1] > c.t1 and c.err == OK:
        _adaptive_step(c, func, cfg)
        # --- emit every output time this step covered ---------------------
        emitted = False
        while i_out < T and ts[i_out] > c.t0 and ts[i_out] <= c.t1:
            out[i_out] = interp_evaluate(c.coeff, c.t0, c.t1, ts[i_out])
            i_out += 1
            emitted = True
        if emitted:
            # max_num_steps bounds steps per output interval (reference
            # `_advance`, rk_common.py:243-247)
            c.steps_in_interval = 0

    if c.err != OK:
        # poison the unwritten tail so stale zeros cannot pass as a result
        out[i_out:] = float('nan')
    return out, c.stats()


def integrate_until_event(func, y0, t0, event_fn, cfg: AdaptiveConfig):
    """Step until `event_fn(t, y)` changes sign, then bisect on the last
    step's quartic (JAX `integrate_until_event`, adaptive_rk.py:641-710;
    reference `_advance_until_event`, rk_common.py:252-264).

    The event's sign at each proposed step's end rides the step's one host
    read.  An event already zero at `t0` returns ``(t0, y0)`` without a
    step.  Returns (event_t, y_event, Stats), `event_t` a 0-d float64
    tensor on the state's device.
    """
    from ..events import find_event

    c = _Carry(func, y0, t0, cfg)
    sign0_t = nan_sign(event_fn(t0, y0))
    sign0 = sign0_t.item()
    at_event_already = sign0 == 0
    sign = sign0
    # NaN == NaN is False: a NaN sign stops the loop, as in JAX
    while sign == sign0 and c.err == OK and not at_event_already:
        accepted, probed = _adaptive_step(
            c, func, cfg, probe=lambda t, y: nan_sign(event_fn(t, y)))
        if accepted:
            sign = probed

    if at_event_already:
        event_t, y_event = time_tensor(t0, y0), y0
    else:
        coeff, t_lo, t_hi = c.coeff, c.t0, c.t1
        event_t, y_event = find_event(
            lambda t: interp_evaluate_at(coeff, t_lo, t_hi, t), sign0_t,
            t_lo, t_hi, event_fn, cfg.atol)
    return event_t, y_event, c.stats()
