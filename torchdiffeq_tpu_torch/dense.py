"""`odeint_dense`: a continuous dense-output solution (counterpart of
``torchdiffeq_tpu/dense.py``; reference torchdiffeq/_impl/odeint.py:111-157).

The adaptive loop runs over [t0, t1] and records every accepted step's
time and quartic coefficients; the returned `DenseSolution` evaluates the
solution anywhere in the interval by `searchsorted`, its time derivative,
and the first zero of an event function without re-integrating.  Steps are
recorded in host lists; `max_segments` keeps the JAX package's capacity
semantics (a solve that needs more accepted steps stops and reports
`ERR_MAX_NUM_STEPS`, and the solution covers the integrated prefix).
"""
from __future__ import annotations

import numpy as np
import torch

from .misc import check_inputs, nan_sign, real_dtype
from .ops.interp import interp_evaluate, interp_evaluate_at
from .solvers import SOLVERS
from .solvers import adaptive_rk
from .solvers.solution import OK, ERR_MAX_NUM_STEPS


class DenseSolution:
    """Callable dense solution: ``sol(t)`` for scalar or batched `t`.

    Times are float64: `times` holds the accepted-step boundaries (host
    numpy and, as `times_d`, on the state's device), `coeffs` the (M, 5,
    *state) quartic coefficients of the M segments; `count` is M, or 0 for
    a solve that accepted no step (then one zero segment spans [t0, inf],
    as JAX's unfilled buffers do).  A pytree state's coefficients are
    flat, and `unravel` gives its values, derivatives and event states
    back in its structure.
    """

    def __init__(self, times, coeffs, count, t_lo, t_hi, t_sign, error_code,
                 unravel=None):
        self.times = times          # (M + 1,) host float64, internal frame
        self.times_d = torch.from_numpy(times).to(coeffs.device)
        self.coeffs = coeffs
        self.count = count
        self.t_lo = t_lo
        self.t_hi = t_hi
        self.t_sign = t_sign        # internal time = t_sign * user time
        self.error_code = error_code
        self.unravel = unravel or (lambda x: x)

    def _segments(self, t_eval):
        """Internal times, the containing segments' bounds and coefficients
        for a float64 tensor of user times (JAX `_segment`, dense.py:60-66),
        all on the device."""
        tt = torch.clamp(self.t_sign * t_eval, self.t_lo, self.t_hi)
        idx = torch.clamp(torch.searchsorted(self.times_d, tt, right=True),
                          1, max(self.count, 1))
        return tt, self.times_d[idx - 1], self.times_d[idx], \
            self.coeffs[idx - 1]

    def _eval_internal(self, tt):
        """The solution at one internal host time `tt` (a float), the
        segment found on the host and the quartic evaluated with host
        scalars: no copy to or read from the device (the interpolated
        adjoint's backward, one call an evaluation).  The same segment and
        values as `__call__`."""
        tt = min(max(tt, self.t_lo), self.t_hi)
        idx = int(np.clip(np.searchsorted(self.times, tt, side='right'), 1,
                          max(self.count, 1)))
        return interp_evaluate(self.coeffs[idx - 1], self.times[idx - 1],
                               self.times[idx], tt)

    def _user_times(self, t_eval):
        t_eval = torch.as_tensor(t_eval, dtype=torch.float64)
        return t_eval.to(self.coeffs.device)

    @staticmethod
    def _bcast(x, coeff):
        """x of shape t.shape against coefficient rows (t.shape + state)."""
        return x.reshape(x.shape + (1,) * (coeff.dim() - 1 - x.dim()))

    def _eval(self, t_eval):
        tt, t0, t1, coeff = self._segments(t_eval)
        return interp_evaluate_at(coeff.movedim(t_eval.dim(), 0), t0, t1, tt)

    def flat(self, t_eval):
        """The solution at `t_eval` in the flat layout of a pytree
        state."""
        return self._eval(self._user_times(t_eval))

    def __call__(self, t_eval):
        return self.unravel(self.flat(t_eval))

    def derivative(self, t_eval):
        """d(sol)/dt at `t_eval` (scalar or batched): the exact derivative of
        the quartic interpolant (JAX `_deriv_scalar`, dense.py:72-82)."""
        t_eval = self._user_times(t_eval)
        tt, t0, t1, coeff = self._segments(t_eval)
        rows = coeff.unbind(dim=t_eval.dim())
        tdt = real_dtype(coeff.dtype)
        x = self._bcast(((tt - t0) / (t1 - t0)).to(tdt), coeff)
        # jnp.polyval over [4a, 3b, 2c, d], starting from zero
        dy_dx = torch.zeros_like(rows[0])
        for k in range(len(rows) - 1, 0, -1):
            dy_dx = dy_dx * x + rows[k] * float(k)
        scale = self._bcast((self.t_sign / (t1 - t0)).to(tdt), coeff)
        return self.unravel(dy_dx * scale)

    def find_event(self, event_fn, tol=1e-6):
        """The first zero of ``event_fn(t, y(t))`` on the solution, without
        re-integrating (JAX `DenseSolution.find_event`, dense.py:98-137):
        the first accepted-step boundary whose sign-combined event value is
        not positive brackets the root, which is bisected on the quartic
        (`events.find_event`).  Returns ``(event_t, y_event)``; `event_t`
        is NaN when the event does not change sign on the integrated span.
        """
        from .events import combine_event_functions, find_event as _bisect

        user_t = self.t_sign * self.times_d[:self.count + 1]
        user_fn = lambda tt, yy: event_fn(tt, self.unravel(yy))
        combined = combine_event_functions(user_fn, user_t[0],
                                           self._eval(user_t[0]))
        ys = self._eval(user_t)
        vals = torch.stack([combined(user_t[i], ys[i])
                            for i in range(user_t.shape[0])])
        changed = (nan_sign(vals) != 1.0).cpu().numpy()
        j = int(np.argmax(changed))           # first boundary past the root
        found = bool(changed[j])
        j = max(j, 1)
        if j > self.count:                    # no segment: a [t0, t0] bracket
            t_lo_u = t_hi_u = self.t_sign * self.times[0]
        else:
            t_lo_u = self.t_sign * self.times[j - 1]
            t_hi_u = self.t_sign * self.times[j]
        one = torch.ones((), dtype=vals.dtype, device=vals.device)
        event_t, _ = _bisect(self._eval, one, t_lo_u, t_hi_u, combined, tol)
        if not found:
            event_t = torch.full_like(event_t, float('nan'))
        return event_t, self.unravel(self._eval(event_t))


def odeint_dense(func, y0, t0, t1, *, rtol=1e-7, atol=1e-9, method=None,
                 options=None, args=(), max_segments=4096,
                 _return_stats=False):
    """Integrate over [t0, t1] and return a `DenseSolution` (JAX
    `odeint_dense`, dense.py:140-226), or ``(sol, Stats)`` with
    `_return_stats`.  The stats are the JAX code's, whose NFE count starts
    at 2 whether or not `first_step` is given."""
    from .odeint import _adaptive_config, _differentiable

    t = np.array([float(t0), float(t1)])
    prob = check_inputs(func, y0, t, rtol, atol, method, options, None,
                        SOLVERS, args=tuple(args))
    spec = SOLVERS[prob.method]
    if spec.get('kind') != 'adaptive':
        raise ValueError(
            f"odeint_dense requires an adaptive method (the reference "
            f"allows only dopri5, odeint.py:119; this build accepts any "
            f"adaptive tableau), got method={prob.method!r}")
    if _differentiable(func, y0, np.asarray([t0, t1]), args):
        raise NotImplementedError(
            "odeint_dense records no gradients (the JAX package's dense "
            "while_loop is not reverse-differentiable either); call it under "
            "torch.no_grad(), or take gradients through odeint or "
            "odeint_adjoint")
    cfg = _adaptive_config(prob, spec['tableau'])
    t_end = prob.t[1]

    with torch.no_grad():
        c = adaptive_rk._Carry(prob.func, prob.y0, prob.t[0], cfg)
        c.nfe = 2
        times, coeffs = [prob.t[0]], []
        while c.t1 < t_end and c.err == OK and c.n_acc < max_segments:
            if adaptive_rk._adaptive_step(c, prob.func, cfg)[0]:
                times.append(c.t1)
                # stored in the state dtype, as JAX's buffer is (a 16-bit
                # state's float32 fit is rounded)
                coeffs.append(c.coeff.to(prob.y0.dtype))
    err = ERR_MAX_NUM_STEPS if (c.t1 < t_end and c.err == OK) else c.err
    if coeffs:
        coeffs = torch.stack(coeffs)
    else:   # as JAX's empty buffers: one zero segment over [t0, inf]
        times.append(float('inf'))
        coeffs = c.coeff.new_zeros((1,) + tuple(c.coeff.shape),
                                   dtype=prob.y0.dtype)
    c.err = err
    sol = DenseSolution(np.asarray(times, np.float64), coeffs, c.n_acc,
                        prob.t[0], c.t1, prob.t_sign, err, prob.unravel)
    return (sol, c.stats()) if _return_stats else sol
