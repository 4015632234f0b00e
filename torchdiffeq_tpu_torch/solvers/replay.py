"""Replay-mode gradients for the adaptive solvers: exact
discretise-then-optimise (counterpart of ``torchdiffeq_tpu/solvers/replay.py``).

``options=dict(replay_grad=True)`` on an adaptive method:

1. **Record.**  A pass of the host loop with no graph (`record_segments`)
   keeps the accepted steps' boundary times in a list, as JAX's
   `record_segments` (replay.py:65) fills its buffer.
2. **Replay.**  A differentiable re-execution over those segments
   (`replay_integrate`, JAX :151-204): the first slope
   ``func(ts[0], y0)``, then one step of the forward's step function per
   segment with no accept or reject, the far side's slope evaluated again
   on a segment that ends on a ``jump_t`` time, and each output emitted
   through the quartic of the segment that owns it
   (``times[i] < ts[j] <= times[i+1]``).  Autograd records the replay, so
   its gradients are the exact derivatives of the discrete solver map with
   the step boundaries held fixed (JAX's ``stop_gradient`` on the recorded
   times); forward mode (``torch.func.jvp``) and higher orders go through
   it too.  The values are the replay's and the Stats the recording's.

``max_segments`` bounds the recorded steps as JAX's buffer capacity does:
a solve that needs more sets ``ERR_SEGMENT_OVERFLOW`` and every output is
NaN.  Without it the list grows as needed, up to JAX's probe limit
(``_AUTO_LIMIT``), so no probe is needed.

Event solves (`integrate_replay_event`): the recording steps until the
event's sign changes, the segments are replayed, and the event time is a
bisection with no gradient on the last segment's quartic plus one
differentiable Newton correction -- the implicit-function gradient of the
discrete interpolant, with no regulariser (JAX :331-446).
"""
from __future__ import annotations

import numpy as np
import torch

from ..misc import Perturb, data_axis, nan_sign
from ..ops.interp import interp_evaluate, interp_evaluate_at, interp_fit
from ..ops.rk_step import runge_kutta_step, weighted_sum
from .adaptive_rk import AdaptiveConfig, _Carry, _adaptive_step, _prep_tvals
from .solution import Stats, OK, ERR_SEGMENT_OVERFLOW

# JAX's auto-sized capacity stops doubling here (replay.py:210-215)
_AUTO_LIMIT = 1 << 20


def _bare(func):
    """`func` without its callback attributes: JAX's recording runs a
    wrapper of the field (`_tangent_free`), so no callback fires in a
    replay solve."""
    return lambda t, y, perturb=Perturb.NONE: func(t, y, perturb=perturb)


def _stats(c, err):
    return Stats.make(nfe=c.nfe, n_steps=c.n_steps, n_accepted=c.n_acc,
                      n_rejected=c.n_rej, error_code=err)


def record_segments(func, y0, ts, cfg: AdaptiveConfig, max_segments):
    """The host loop with no graph, recording the accepted steps'
    boundaries (JAX `record_segments`, replay.py:65-126).  `max_num_steps`
    is a budget per output interval in `integrate`; the recording emits
    nothing, so the budget is scaled to the whole span, as in JAX.
    Returns (times, a float64 array of count + 1 boundaries, Stats)."""
    n_iv = max(ts.shape[0] - 1, 1)
    if cfg.max_num_steps < 2 ** 31 - 1:
        cfg = cfg._replace(
            max_num_steps=min(cfg.max_num_steps * n_iv, 2 ** 31 - 1))
    t_end = ts[-1]
    func = _bare(func)
    with torch.no_grad():
        c = _Carry(func, y0.detach(), ts[0], cfg)
        times = [ts[0]]
        while c.t1 < t_end and c.err == OK and c.n_acc < max_segments:
            if _adaptive_step(c, func, cfg)[0]:
                times.append(c.t1)
    err = ERR_SEGMENT_OVERFLOW if (c.t1 < t_end and c.err == OK) else c.err
    return np.asarray(times, dtype=np.float64), _stats(c, err)


def _step(cfg):
    return cfg.step_fn if cfg.step_fn is not None else runge_kutta_step


def _replay_segment(func, cfg, y, f, t0, t1, jump_t):
    """One recorded segment, differentiably: (y1, f1, the quartic)."""
    tab = cfg.tableau
    dt = t1 - t0
    y1, f1, _, k = _step(cfg)(func, y, f, t0, dt, t1, tab)
    if jump_t is not None and t1 in jump_t:
        # the loop's far-side re-evaluation (JAX `_jump_reeval`): the
        # recorded boundary is the jump time itself, bit for bit
        f1 = func(t1, y1, perturb=Perturb.NEXT)
    y_mid = weighted_sum(tab.c_mid, list(k), dt, base=y)
    return y1, f1, (y, y1, y_mid, k[0], k[-1], dt)


def _jump_set(cfg, t0):
    if cfg.jump_t is None or np.size(cfg.jump_t) == 0:
        return None
    return set(_prep_tvals(cfg.jump_t, t0)[0].tolist())


def replay_integrate(func, y0, ts, ts_d, cfg: AdaptiveConfig, times):
    """Differentiable re-execution of the recorded steps (JAX
    `replay_integrate`, replay.py:151-204).  `times` are constants;
    gradients flow to `y0`, the field's parameters and the output times
    `ts_d` (a float64 CPU tensor of `ts`, which may carry them).  Returns
    (T, *y0.shape)."""
    T = ts.shape[0]
    count = times.shape[0] - 1
    jump_t = _jump_set(cfg, ts[0])
    # the segment owning each output time
    seg = np.searchsorted(times, ts, side='left') - 1
    outs = [y0] + [None] * (T - 1)
    y, f = y0, func(ts_d[0], y0, perturb=Perturb.NONE)
    for i in range(count):
        y1, f1, fit = _replay_segment(func, cfg, y, f, times[i],
                                      times[i + 1], jump_t)
        js = [j for j in range(1, T) if seg[j] == i]
        if js:
            coeff = interp_fit(*fit)
            for j in js:
                outs[j] = interp_evaluate(coeff, times[i], times[i + 1],
                                          ts_d[j]).to(y0.dtype)
        y, f = y1, f1
    # an output past the recorded span (a failed recording) stays zero
    # here and NaN below, as JAX's unemitted rows
    return torch.stack([torch.zeros_like(y0) if o is None else o
                        for o in outs])


def _poison(x, bad):
    """`x`, or NaN everywhere with a zero gradient when `bad` (JAX's
    ``jnp.where(bad, nan, x)``)."""
    if not bad:
        return x
    return torch.where(torch.ones((), dtype=torch.bool, device=x.device),
                       torch.full_like(x, float('nan')), x)


def integrate_replay(func, y0, ts, ts_d, cfg: AdaptiveConfig,
                     max_segments=None):
    """Record, then replay (JAX `integrate_replay`, replay.py:256-292).
    Returns (ys, Stats); every output is NaN when the recording failed."""
    cap = _AUTO_LIMIT if max_segments is None else int(max_segments)
    times, stats = record_segments(func, y0, ts, cfg, cap)
    ys = replay_integrate(func, y0, ts, ts_d, cfg, times)
    return _poison(ys, stats.error_code != OK), stats


def record_segments_until_event(func, y0, t0, event_fn, cfg: AdaptiveConfig,
                                max_segments):
    """The host loop stepping until `event_fn` changes sign, recording the
    accepted steps' boundaries (JAX `record_segments_until_event`,
    replay.py:300-366).  Returns (times, sign0 as a tensor, whether the
    event is zero at t0, Stats); the bracketing step is the last
    segment."""
    func = _bare(func)
    with torch.no_grad():
        y0 = y0.detach()
        c = _Carry(func, y0, t0, cfg)
        sign0_t = nan_sign(event_fn(t0, y0))
        sign0 = sign0_t.item()
        at_event = sign0 == 0
        sign = sign0
        times = [t0]
        # NaN == NaN is False: a NaN sign stops the loop, as in JAX
        while (sign == sign0 and c.err == OK and not at_event
               and c.n_acc < max_segments):
            accepted, probed = _adaptive_step(
                c, func, cfg, probe=lambda t, y: nan_sign(event_fn(t, y)))
            if accepted:
                times.append(c.t1)
                sign = probed
    err = c.err
    if sign == sign0 and c.err == OK and not at_event:
        err = ERR_SEGMENT_OVERFLOW
    return (np.asarray(times, dtype=np.float64), sign0_t, at_event,
            _stats(c, err))


def _replay_to_event(func, y0, t0_d, event_fn, cfg, times, sign0):
    """Replay the recorded segments; the event time is a bisection with no
    gradient on the last segment's quartic plus one Newton correction
    whose derivative is the implicit-function one (JAX `_replay_to_event`,
    replay.py:369-428).  Returns (event_t, y_event)."""
    from ..events import find_event

    # under a data axis (`misc.data_axis`) the event function gathers the
    # state and the event time is replicated: each block reads a time
    # through `_DataCopy`, so that its share of the time's derivative is
    # summed over the axis
    axis = data_axis()
    share = (lambda tt: tt) if axis is None else axis.copy
    jump_t = _jump_set(cfg, times[0])
    y, f = y0, func(t0_d, y0, perturb=Perturb.NONE)
    fit = None
    for i in range(times.shape[0] - 1):
        y, f, fit = _replay_segment(func, cfg, y, f, times[i], times[i + 1],
                                    jump_t)
    coeff = interp_fit(*fit)
    tb0, tb1 = float(times[-2]), float(times[-1])

    def interp(tt, cf=coeff):
        return interp_evaluate_at(cf, tb0, tb1, tt).to(y0.dtype)

    tol = cfg.atol.max().item() if isinstance(cfg.atol, torch.Tensor) \
        else cfg.atol
    with torch.no_grad():
        t_b, _ = find_event(lambda tt: interp(tt, coeff.detach()), sign0,
                            tb0, tb1, event_fn, tol)
    # t* = t_b - g(t_b) / g'(t_b), g'(t_b) held constant: the derivative of
    # t* is -(dg/dtheta)(t_b) / g'(t_b), that of g(t) = event_fn(t,
    # interp(t)) = 0 on the replayed (discrete) solution
    with torch.enable_grad():
        tt = t_b.detach().requires_grad_(True)
        g_t = event_fn(tt, interp(share(tt), coeff.detach())).reshape(())
        (gprime,) = torch.autograd.grad(g_t, tt)
    safe = torch.where(gprime.abs() > 0, gprime, torch.ones_like(gprime))
    g = event_fn(t_b, interp(t_b)).reshape(())
    event_t = torch.clamp(t_b - g / safe, tb0, tb1)
    return event_t, interp(share(event_t))


def integrate_replay_event(func, y0, t0, t0_d, event_fn, cfg: AdaptiveConfig,
                           max_segments=None, t0_out=None):
    """Replay-mode event solve (JAX `integrate_replay_event`,
    replay.py:410-446).  `t0_d` is the start as a 0-d float64 tensor, which
    may carry a gradient; `t0_out` (default `t0_d`) is the event time an
    event already zero at the start returns (a data-parallel solve's
    replicated start, where `t0_d` is the blocks' copy).  Returns (event_t,
    y_event, Stats); both NaN when the recording failed."""
    cap = _AUTO_LIMIT if max_segments is None else int(max_segments)
    times, sign0, at_event, stats = record_segments_until_event(
        func, y0, t0, event_fn, cfg, cap)
    if at_event or times.shape[0] < 2:
        event_t = (t0_d if t0_out is None else t0_out).to(y0.device)
        y_event = y0
    else:
        event_t, y_event = _replay_to_event(func, y0, t0_d, event_fn, cfg,
                                            times, sign0)
    bad = stats.error_code != OK
    return _poison(event_t, bad), _poison(y_event, bad), stats
