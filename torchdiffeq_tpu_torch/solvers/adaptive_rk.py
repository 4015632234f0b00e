"""Adaptive Runge-Kutta solver as a host loop (counterpart of
``torchdiffeq_tpu/solvers/adaptive_rk.py``).

The JAX package runs the whole solve as one compiled ``lax.while_loop``.
PyTorch runs eagerly, so here the loop is on the host: each iteration takes
one step on the device and reads back ONE set of values -- the error ratio,
whether the new state is finite, and in an event solve the event's sign at
the step's end -- from which the host decides accept or reject, the next
step size, the guards, the output emission and the end of an event solve.  Time is
a float64 host scalar throughout, except under ``forward_grad``: there the
output times, the step times and the step size are 0-d float64 CPU tensors
that carry forward-mode tangents (the field gets its time as a 0-d CPU
tensor in any case), so that a ``torch.func.jvp`` through the solve sees
the tangent of every step size the controller picks, as JAX's ``jax.jvp``
through its ``while_loop`` does; the host's decisions read their primal
values, and the loop runs under ``torch.no_grad()``.  Numerics (controller constants, FSAL,
perturbation, emission through the quartic interpolant, the per-interval
`max_num_steps` budget, NaN poisoning of unwritten outputs) are the JAX
solver's, so values and `Stats` counters match it.

Steps are truncated at ``step_t`` and ``jump_t`` times as in the JAX
`_adaptive_step` (adaptive_rk.py:212-258); after an accepted step that ends
on a ``jump_t`` time, ``jump_state_fn`` (if given) transforms the state
and the slope is evaluated again on the far side.  The hook runs only on
such a step (the JAX package's lazy branch; its branch-free variant is a
TPU device-loop measure, ROADMAP "Not to port").  ``step_to_end`` lands a
step on every output time and copies the state there instead of
interpolating (adaptive_rk.py:446-497).

The step size comes from the I controller (the reference's), or from the
PI or PID controller (``controller='pi'|'pid'``) on the last one or two
accepted error ratios.  ``error_dtype`` computes the error estimate, its
tolerance scale and its norm in that dtype while the state and the stages
stay in theirs (float32 error control of a bfloat16 state).  A 16-bit
state's dense output is fit and evaluated in float32 and emitted in the
state dtype.  The field's ``callback_step`` fires before each attempt and
``callback_accept_step`` or ``callback_reject_step`` after it, on the
host, as in JAX (adaptive_rk.py:187, :336-347).  An implicit tableau's
step is `AdaptiveConfig.step_fn` (`adaptive_implicit.py`), whose stage
solves read back to the host on their own.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..misc import Perturb, nan_sign, time_tensor
from ..ops.interp import (coeff_dtype, interp_fit_step, interp_evaluate,
                          interp_evaluate_at)
from ..ops.rk_step import runge_kutta_step
from ..ops.step_control import (select_initial_step, compute_error_ratio,
                                optimal_step_size, optimal_step_size_pi,
                                optimal_step_size_pid, _f64)
from ..ops.tableaus import ButcherTableau
from .solution import (Stats, OK, ERR_DT_UNDERFLOW, ERR_NONFINITE_STATE,
                       ERR_MAX_NUM_STEPS)

# JAX adaptive options the port does not take (TPU measures).
NOT_PORTED_OPTIONS = {
    'compensated_time': "ROADMAP 'Not to port'",
    '_jump_branch_free': "ROADMAP 'Not to port'",
}
# the gradient modes' options are consumed by `odeint` before the config is
# built; elsewhere (`odeint_adjoint`'s forward) they are accepted and
# dropped, as JAX's `_adaptive_config` accepts them
SUPPORTED_OPTIONS = {'first_step', 'safety', 'ifactor', 'dfactor',
                     'min_step', 'max_step', 'max_num_steps', 'step_t',
                     'jump_t', 'jump_state_fn', 'step_to_end', 'controller',
                     'pcoeff', 'icoeff', 'dcoeff', 'error_dtype',
                     'stage_tol', 'max_iters', 'replay_grad', 'max_segments',
                     'forward_grad'}


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
    step_t: Any = None            # float64 host array (internal frame)
    jump_t: Any = None
    # ``jump_state_fn(k, t1, y1) -> y1'``: the state transform on an
    # accepted step that ends on the k-th (sorted) jump_t time, before the
    # far-side re-evaluation of the slope (the fused adjoint's cotangent
    # injection, adjoint.py)
    jump_state_fn: Any = None
    # land a step on every output time and copy the state there (no
    # quartic fit or evaluation)
    step_to_end: bool = False
    controller: str = 'i'         # 'i' (the reference's), 'pi' or 'pid'
    pcoeff: float = 0.4
    icoeff: float = 0.7
    dcoeff: float = 0.0
    # the dtype of the error estimate, its scale and its norm (None: the
    # state dtype)
    error_dtype: Any = None
    # the step in place of `runge_kutta_step`, same contract (the implicit
    # tier's, `adaptive_implicit.py`, which applies `error_dtype` itself)
    step_fn: Any = None


def _prep_tvals(tvals, t0):
    """Sort a step_t/jump_t array and find the first entry past t0 (JAX
    `_prep_tvals`, adaptive_rk.py:151-159): ``(sorted, index)``, the index
    clipped to the array so that an exhausted array keeps pointing at its
    last entry, which the window test then never passes."""
    tvals = np.sort(np.asarray(tvals, dtype=np.float64).reshape(-1))
    idx = int(np.clip(np.searchsorted(tvals, float(t0), side='right'), 0,
                      tvals.shape[0] - 1))
    return tvals, idx


def _check_no_duplicates(step_t, jump_t):
    """`step_t` and `jump_t` must not share elements (JAX adaptive_rk.py:713;
    reference rk_common.py:229-231)."""
    if step_t is None or jump_t is None:
        return
    combined = np.concatenate([np.ravel(step_t), np.ravel(jump_t)])
    if len(np.unique(combined)) != len(combined):
        raise ValueError(
            "`step_t` and `jump_t` must not have any repeated elements "
            "between them.")


def _merged_step_t(cfg, ts):
    """step_to_end's forced boundaries: the user's step_t and every output
    time after the first, with the JAX package's two collision classes
    dropped (adaptive_rk.py:446-475): a second copy of a time, and an
    output time that is also a jump_t time (the jump truncation lands
    there instead, so its far-side re-evaluation still runs)."""
    extra = np.asarray(ts[1:], dtype=np.float64)
    merged = extra if cfg.step_t is None else np.concatenate(
        [np.ravel(cfg.step_t), extra])
    merged = np.sort(merged)
    drop = np.concatenate([[False], merged[1:] == merged[:-1]])
    if cfg.jump_t is not None:
        jt = np.ravel(cfg.jump_t)
        drop = drop | np.any(merged[:, None] == jt[None, :], axis=1)
    return np.sort(np.where(drop, np.inf, merged))


class _TVals:
    """A sorted step_t or jump_t array and the index of its next entry."""

    def __init__(self, tvals, t0):
        self.tvals, self.idx = _prep_tvals(tvals, t0)

    @property
    def next(self):
        return self.tvals[self.idx]

    def advance(self):
        if self.idx != self.tvals.shape[0] - 1:
            self.idx += 1


def _tvals(tvals, t0):
    return None if tvals is None or np.size(tvals) == 0 else _TVals(tvals, t0)


def _setup(func, y0, t0, cfg: AdaptiveConfig):
    """Initial f0 and dt (reference `_before_integrate`,
    rk_common.py:213-241).  Returns (f0, dt0, nfe0); dt0 a float64 host
    scalar, or a 0-d tensor when `t0` is one (``forward_grad``)."""
    f0 = func(t0, y0, perturb=Perturb.NONE)
    if cfg.first_step is None:
        dt0 = select_initial_step(func, t0, y0, cfg.tableau.order - 1,
                                  cfg.rtol, cfg.atol, cfg.norm, f0)
        return f0, dt0, 2
    return f0, np.float64(cfg.first_step), 1


def _clip(x, lo, hi):
    """``jnp.clip`` of a float64 host scalar, or of a 0-d tensor with its
    tangent."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, float(lo), float(hi))
    return np.minimum(np.maximum(x, lo), hi)


class _Carry:
    """The loop state on the host: the state and its slope at `t1`, the
    last step's window ``[t0, t1]`` and its quartic `coeff`, the next `dt`,
    the counters and the error code (the JAX `_Carry`)."""

    def __init__(self, func, y0, t0, cfg: AdaptiveConfig):
        # tensor time, with tangents (`forward_grad`)
        self.timed = isinstance(t0, torch.Tensor)
        self.f, self.dt, self.nfe = _setup(func, y0, t0, cfg)
        self.y = y0
        self.t0 = self.t1 = t0
        self.coeff = None if cfg.step_to_end else y0.new_zeros(
            (5,) + tuple(y0.shape), dtype=coeff_dtype(y0.dtype))
        self.n_steps = self.n_acc = self.n_rej = self.steps_in_interval = 0
        # the last two accepted error ratios (PI/PID), float64
        self.prev_ratio = self.prev_ratio2 = np.float64(1.0)
        self.err = OK
        self.y_finite = bool(torch.isfinite(y0).all())
        self.step_t = _tvals(cfg.step_t, t0)
        self.jump_t = _tvals(cfg.jump_t, t0)
        # step_to_end's forced boundaries that are output times, as tensors
        # carrying their tangents (`forward_grad`; filled by `integrate`)
        self.out_times = {}

    def stats(self):
        return Stats.make(nfe=self.nfe, n_steps=self.n_steps,
                          n_accepted=self.n_acc, n_rejected=self.n_rej,
                          error_code=self.err, final_dt=float(self.dt))


def _adaptive_step(c: _Carry, func, cfg: AdaptiveConfig, probe=None):
    """One accept-or-reject step on the carry `c`, in place (JAX
    `_adaptive_step`, adaptive_rk.py:170-401).

    Makes ONE host read: the error ratio and whether the proposed state is
    finite, and with `probe`, ``probe(t1, y1)`` at the proposed step's end
    (a 0-d tensor), all read together (read again after a jump hook, which
    changes the state).  Returns (accepted, probe value).  A tripped guard
    sets ``c.err`` and leaves the rest of the carry as it was (the JAX loop
    freezes its carry and exits).
    """
    tab = cfg.tableau
    min_step, max_step = np.float64(cfg.min_step), np.float64(cfg.max_step)
    t0 = c.t1
    dt = _clip(c.dt if math.isfinite(c.dt) else min_step, min_step, max_step)
    callback = getattr(func, 'callback_step', None)
    if callback is not None:
        callback(t0, c.y, dt)                # reference rk_common.py:272

    # --- guards (reference asserts, rk_common.py:286-287) -----------------
    t1 = t0 + dt
    if c.steps_in_interval >= cfg.max_num_steps:
        c.err = ERR_MAX_NUM_STEPS
    elif not t1 > t0:
        c.err = ERR_DT_UNDERFLOW
    elif not c.y_finite:
        c.err = ERR_NONFINITE_STATE
    if c.err != OK:
        # JAX's frozen iteration still fires the reject callback
        callback = getattr(func, 'callback_reject_step', None)
        if callback is not None:
            callback(t0, c.y, dt)
        return False, None

    # --- step_t / jump_t truncation (JAX adaptive_rk.py:212-258) ----------
    on_step_t = on_jump_t = False
    if c.step_t is not None:
        v = c.step_t.next
        on_step_t = t0 < v < t1
        if on_step_t:
            # a forced boundary on an output time carries that time's
            # tangent (`forward_grad` with step_to_end)
            t1 = c.out_times.get(v, v)
    if c.jump_t is not None:
        v = c.jump_t.next
        on_jump_t = t0 < v < t1
        if cfg.jump_state_fn is not None:
            # the hook fires on a step that lands exactly on the jump time
            # too (JAX :231-246), or its injection would be skipped
            on_jump_t = on_jump_t or (t0 < v and v == t1)
        on_step_t = on_step_t and not on_jump_t
        if on_jump_t:
            t1 = v
    if on_step_t or on_jump_t:
        dt = t1 - t0

    # --- the RK step, and the one host read of the iteration --------------
    timed = c.timed
    if cfg.step_fn is None:
        y1, f1, y1_err, k = runge_kutta_step(func, c.y, c.f, t0, dt, t1, tab,
                                             error_dtype=cfg.error_dtype)
    else:
        y1, f1, y1_err, k = cfg.step_fn(func, c.y, c.f, t0, dt, t1, tab)
    # an implicit step reports its one explicit evaluation (JAX :266-269)
    c.nfe += 1 if tab.implicit else len(tab.alpha)
    if cfg.error_dtype is None:
        ratio_t = compute_error_ratio(y1_err, cfg.rtol, cfg.atol, c.y, y1,
                                      cfg.norm)
    else:
        # JAX adaptive_rk.py:268-275: scale, ratio and norm in error_dtype
        ed = cfg.error_dtype
        ratio_t = compute_error_ratio(y1_err, cfg.rtol, cfg.atol,
                                      c.y.to(ed), y1.to(ed), cfg.norm)
    read = [ratio_t, torch.isfinite(y1).all().to(ratio_t.dtype)]
    if probe is not None:
        read.append(probe(t1, y1).to(ratio_t.dtype))
    read = torch.stack(read)
    if timed:
        # the ratio's tangent goes on to the controller; the copy to the
        # host is the one read of the step
        read = read.cpu()
        ratio_t = read[0]
    ratio, y1_finite, *probed = read.tolist()
    accept = ratio <= 1
    if dt > max_step:
        accept = False
    if dt <= min_step:
        accept = True

    c.n_steps += 1
    c.steps_in_interval += 1
    c.t0 = t0
    y0 = c.y
    if accept:
        c.n_acc += 1
        if not cfg.step_to_end:
            # the interpolant is fit to the pre-jump state
            c.coeff = interp_fit_step(c.y, y1, k, dt, tab)
        if on_jump_t:
            # the far side of the jump: the hook, then the slope again
            if cfg.jump_state_fn is not None:
                y1 = cfg.jump_state_fn(c.jump_t.idx, t1, y1)
                y1_finite = bool(torch.isfinite(y1).all())
                if probe is not None:
                    probed = [float(probe(t1, y1))]
            f1 = func(t1, y1, perturb=Perturb.NEXT)
            c.nfe += 1
        c.y, c.f, c.t1, c.y_finite = y1, f1, t1, bool(y1_finite)
        if on_step_t:
            c.step_t.advance()
        if on_jump_t:
            c.jump_t.advance()
    else:
        c.n_rej += 1
    callback = getattr(func, 'callback_accept_step' if accept
                       else 'callback_reject_step', None)
    if callback is not None:
        callback(t0, y0, dt)                 # reference rk_common.py:339,354
    c.dt = _clip(_next_step(c, cfg, dt, ratio_t if timed else ratio, accept),
                 min_step, max_step)
    return accept, (probed[0] if probed else None)


def _next_step(c: _Carry, cfg: AdaptiveConfig, dt, ratio, accept):
    """The controller's next step size; PI and PID take the last one and
    two accepted error ratios, updated on accept (JAX
    adaptive_rk.py:349-365).  `ratio` is a host scalar, or a 0-d tensor
    with its tangent (``forward_grad``)."""
    order = cfg.tableau.order
    if cfg.controller == 'pid':
        dt_next = optimal_step_size_pid(
            dt, ratio, c.prev_ratio, c.prev_ratio2, cfg.safety, cfg.ifactor,
            cfg.dfactor, order, cfg.pcoeff, cfg.icoeff, cfg.dcoeff)
    elif cfg.controller == 'pi':
        dt_next = optimal_step_size_pi(
            dt, ratio, c.prev_ratio, cfg.safety, cfg.ifactor, cfg.dfactor,
            order, cfg.pcoeff, cfg.icoeff)
    else:
        return optimal_step_size(dt, ratio, cfg.safety, cfg.ifactor,
                                 cfg.dfactor, order)
    if accept:
        c.prev_ratio, c.prev_ratio2 = _f64(ratio), c.prev_ratio
    return dt_next


def integrate(func, y0, ts, cfg: AdaptiveConfig, ts_d=None):
    """Integrate to every time in `ts` (increasing float64 host array).

    Returns (ys (T, *y0.shape), Stats): the JAX `integrate`
    (adaptive_rk.py:423-613), one `_adaptive_step` per loop iteration.
    With ``step_to_end`` the steps land on the output times and emission
    copies the state (JAX :446-475, :539).  `ts_d`, the same times as a
    float64 CPU tensor carrying tangents, makes the time tensors
    (``forward_grad``, module docstring): the start, the emission times and
    step_to_end's boundaries take their tangents from it.
    """
    T = ts.shape[0]
    _check_no_duplicates(cfg.step_t, cfg.jump_t)
    user_step_t = cfg.step_t
    if cfg.step_to_end:
        cfg = cfg._replace(step_t=_merged_step_t(cfg, ts))
    c = _Carry(func, y0, ts[0] if ts_d is None else ts_d[0], cfg)
    if ts_d is not None and cfg.step_to_end:
        # JAX's stable sort keeps a user step_t's copy of an output time,
        # which has no tangent
        user = set() if user_step_t is None else set(
            np.ravel(user_step_t).tolist())
        c.out_times = {float(ts[j]): ts_d[j] for j in range(1, T)
                       if float(ts[j]) not in user}
    out = [y0]
    while ts[-1] > c.t1 and c.err == OK:
        _adaptive_step(c, func, cfg)
        # --- emit every output time this step covered ---------------------
        emitted = False
        while len(out) < T and ts[len(out)] > c.t0 and ts[len(out)] <= c.t1:
            t_out = ts[len(out)] if ts_d is None else ts_d[len(out)]
            out.append(c.y if cfg.step_to_end else interp_evaluate(
                c.coeff, c.t0, c.t1, t_out).to(y0.dtype))
            emitted = True
        if emitted:
            # max_num_steps bounds steps per output interval (reference
            # `_advance`, rk_common.py:243-247)
            c.steps_in_interval = 0

    if c.err != OK:
        # poison the unwritten tail so stale zeros cannot pass as a result
        out += [torch.full_like(y0, float('nan'))] * (T - len(out))
    return torch.stack(out), c.stats()


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

    # event localisation bisects the interpolant: step_to_end does not apply
    cfg = cfg._replace(step_to_end=False)
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
            lambda t: interp_evaluate_at(coeff, t_lo, t_hi, t).to(y0.dtype),
            sign0_t,
            t_lo, t_hi, event_fn, cfg.atol)
    return event_t, y_event, c.stats()
