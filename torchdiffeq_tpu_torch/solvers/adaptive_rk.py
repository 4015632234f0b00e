"""Adaptive Runge-Kutta solver as a host loop (counterpart of
``torchdiffeq_tpu/solvers/adaptive_rk.py``).

The JAX package runs the whole solve as one compiled ``lax.while_loop``.
PyTorch runs eagerly, so here the loop is on the host: each iteration takes
one step on the device and reads back ONE pair of values -- the error ratio
and whether the new state is finite -- from which the host decides accept
or reject, the next step size, the guards and the output emission.  Time is
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

from ..misc import Perturb
from ..ops.interp import interp_fit_step, interp_evaluate
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


def integrate(func, y0, ts, cfg: AdaptiveConfig):
    """Integrate to every time in `ts` (increasing float64 host array).

    Returns (ys (T, *y0.shape), Stats): the JAX `integrate`
    (adaptive_rk.py:423-613) with its per-step body `_adaptive_step`
    (:170-401), one step per loop iteration.
    """
    tab = cfg.tableau
    T = ts.shape[0]
    f64 = np.float64
    min_step, max_step = f64(cfg.min_step), f64(cfg.max_step)

    f, dt, nfe = _setup(func, y0, ts[0], cfg)
    out = y0.new_zeros((T,) + tuple(y0.shape))
    out[0] = y0
    y = y0
    coeff = None
    t_start = t_end = ts[0]            # the last step's window [t_start, t_end]
    i_out = 1
    n_steps = n_acc = n_rej = steps_in_interval = 0
    err = OK
    y_finite = bool(torch.isfinite(y0).all())

    while ts[-1] > t_end and err == OK:
        t0 = t_end
        dt_prop = dt     # kept as the final dt if a guard trips
        dt = _clip(dt if math.isfinite(dt) else min_step, min_step, max_step)

        # --- guards (reference asserts, rk_common.py:286-287) -------------
        t1 = t0 + dt
        if steps_in_interval >= cfg.max_num_steps:
            err = ERR_MAX_NUM_STEPS
        elif not t1 > t0:
            err = ERR_DT_UNDERFLOW
        elif not y_finite:
            err = ERR_NONFINITE_STATE
        if err != OK:
            dt = dt_prop   # the JAX loop freezes its carry and exits
            break

        # --- the RK step, and the one host read of the iteration ----------
        y1, f1, y1_err, k = runge_kutta_step(func, y, f, t0, dt, t1, tab)
        nfe += len(tab.alpha)
        ratio_t = compute_error_ratio(y1_err, cfg.rtol, cfg.atol, y, y1,
                                      cfg.norm)
        ratio, y1_finite = torch.stack(
            [ratio_t, torch.isfinite(y1).all().to(ratio_t.dtype)]).tolist()
        accept = ratio <= 1
        if dt > max_step:
            accept = False
        if dt <= min_step:
            accept = True

        n_steps += 1
        steps_in_interval += 1
        t_start = t0
        if accept:
            n_acc += 1
            coeff = interp_fit_step(y, y1, k, dt, tab)
            y, f, t_end, y_finite = y1, f1, t1, bool(y1_finite)
        else:
            n_rej += 1
        dt = _clip(optimal_step_size(dt, ratio, cfg.safety, cfg.ifactor,
                                     cfg.dfactor, tab.order),
                   min_step, max_step)

        # --- emit every output time this step covered ---------------------
        emitted = False
        while i_out < T and ts[i_out] > t_start and ts[i_out] <= t_end:
            out[i_out] = interp_evaluate(coeff, t_start, t_end, ts[i_out])
            i_out += 1
            emitted = True
        if emitted:
            # max_num_steps bounds steps per output interval (reference
            # `_advance`, rk_common.py:243-247)
            steps_in_interval = 0

    if err != OK:
        # poison the unwritten tail so stale zeros cannot pass as a result
        out[i_out:] = float('nan')
    stats = Stats.make(nfe=nfe, n_steps=n_steps, n_accepted=n_acc,
                       n_rejected=n_rej, error_code=err, final_dt=float(dt))
    return out, stats
