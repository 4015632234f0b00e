"""Dense output (counterpart of ``torchdiffeq_tpu/ops/interp.py``;
reference torchdiffeq/_impl/interp.py and solvers.py:166-181).

* The quartic fit and evaluation of the adaptive RK solver: coefficients
  are one ``(5, *state.shape)`` tensor ``[e, d, c, b, a]`` in ascending
  powers of the normalised time x in [0, 1], in the state dtype, or in
  float32 for a 16-bit state (`coeff_dtype`).
* The linear and cubic Hermite interpolation of the fixed-grid solvers.
"""
from __future__ import annotations

import torch

from ..misc import real_dtype, scalar_type, tcast, tval
from .rk_step import weighted_sum


def coeff_dtype(dtype):
    """The dtype of the quartic coefficients of a state of `dtype`:
    float32 for float16 and bfloat16 (the fit runs in float32 there, see
    `interp_fit_step`), else the state dtype (JAX `coeff_dtype`)."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return dtype


def interp_fit_step(y0, y1, k, dt, tableau):
    """Quartic fit from one accepted step's stage slopes (JAX
    `interp_fit_step`, ops/interp.py:28-77).

    A float32/float64 state takes the reference's y-form and accumulation
    order (rk_common.py:363-369 then interp.py:1-22):
    ``y_mid = y0 + sum((c_mid * dt) * k)``.  A 16-bit state's y-form would
    cancel O(|y|) terms down to O(|increment|) in 16 bits, so the fit is
    taken on the step's increments ``d1 = sum((c_sol * dt) * k)`` and
    ``dmid = sum((c_mid * dt) * k)`` in float32 from the upcast slopes, and
    the coefficients are float32."""
    if coeff_dtype(y0.dtype) != y0.dtype:
        f32 = torch.float32
        dtf = tval(tcast(dt, f32))
        kf = [x.to(f32) for x in k]
        d1 = weighted_sum(tableau.c_sol, kf, dtf)
        dmid = weighted_sum(tableau.c_mid, kf, dtf)
        dtf0, dtf1 = dtf * kf[0], dtf * kf[-1]
        a = 2 * (dtf1 - dtf0) - 8 * d1 + 16 * dmid
        b = (5 * dtf0 - 3 * dtf1) + 14 * d1 - 32 * dmid
        c = (dtf1 - 4 * dtf0) - 5 * d1 + 16 * dmid
        return torch.stack([y0.to(f32), dtf0, c, b, a])
    dt = tcast(dt, y0.dtype)
    y_mid = weighted_sum(tableau.c_mid, k, dt, base=y0)
    return interp_fit(y0, y1, y_mid, k[0], k[-1], dt)


def interp_fit(y0, y1, y_mid, f0, f1, dt):
    """The quartic's coefficients from the step's ends, its midpoint and
    the end slopes (JAX `interp_fit`, ops/interp.py:87-103; reference
    interp.py:1-22), in the state dtype; `dt` a host time scalar or a 0-d
    tensor carrying a derivative."""
    dt = tcast(dt, y0.dtype)
    two_dt = scalar_type(y0.dtype)(2) * dt
    dtf = tval(dt)
    a = tval(two_dt) * (f1 - f0) - 8 * (y1 + y0) + 16 * y_mid
    b = dtf * (5 * f0 - 3 * f1) + 18 * y0 + 14 * y1 - 32 * y_mid
    c = dtf * (f1 - 4 * f0) - 11 * y0 - 5 * y1 + 16 * y_mid
    return torch.stack([y0, dtf * f0, c, b, a])


def interp_evaluate(coefficients, t0, t1, t):
    """Evaluate the fitted polynomial at time `t` in [t0, t1] (reference
    interp.py:25-48), with the guard for a zero-width step.  Horner-style
    in ascending powers; the powers of x are scalars in the coefficients'
    dtype, as the JAX package computes them: host scalars, or 0-d tensors
    where a time is a tensor carrying a derivative (``forward_grad``,
    ``replay_grad``)."""
    denom = t1 - t0 if t1 > t0 else 1.0
    x = tcast((t - t0) / denom, coefficients.dtype)
    total = coefficients[0] + tval(x) * coefficients[1]
    x_power = x
    for i in range(2, coefficients.shape[0]):
        x_power = x_power * x
        total = total + tval(x_power) * coefficients[i]
    return total


def interp_evaluate_at(coefficients, t0, t1, t):
    """`interp_evaluate` at float64 TENSOR times `t` on the coefficients'
    device, with no host read: JAX's `interp_evaluate`
    (torchdiffeq_tpu/ops/interp.py:106-127), x formed in float64 and cast
    to the coefficients' dtype.  As there, there is no zero-width guard:
    an interval with ``t1 == t0`` gives NaN.  `t` may have leading axes
    that the coefficient rows share (one interval per time, `t0` and `t1`
    broadcasting with `t`)."""
    x = ((t - t0) / (t1 - t0)).to(real_dtype(coefficients.dtype))
    x = x.reshape(x.shape + (1,) * (coefficients.dim() - 1 - x.dim()))
    total = coefficients[0] + x * coefficients[1]
    x_power = x
    for i in range(2, coefficients.shape[0]):
        x_power = x_power * x
        total = total + x_power * coefficients[i]
    return total


def _rows(x, like, dtype=None):
    """A (T,) tensor of per-output scalars on `like`'s device, in `dtype`
    (default `like`'s real dtype), shaped to broadcast against (T, *state)
    rows."""
    x = x.to(device=like.device,
             dtype=real_dtype(like.dtype) if dtype is None else dtype)
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def linear_interp(t0, t1, y0, y1, t):
    """Linear interpolation with exact endpoint reproduction (reference
    solvers.py:175-181; JAX `linear_interp`, ops/interp.py:130-139), for
    T outputs at once: `t0`, `t1`, `t` (T,) float64 tensors (on any device;
    they may carry gradients) and `y0`, `y1` (T, *state) rows.  The slope
    ``(t - t0) / (t1 - t0)`` is formed in float64 and cast to the state
    dtype, as JAX's `cast_time` does."""
    slope = _rows((t - t0) / (t1 - t0), y0)
    y = y0 + slope * (y1 - y0)
    y = torch.where(_rows(t == t0, y0, torch.bool), y0, y)
    return torch.where(_rows(t == t1, y0, torch.bool), y1, y)


def cubic_hermite_interp(t0, y0, f0, t1, y1, f1, t):
    """Cubic Hermite interpolation (reference solvers.py:166-173; JAX
    `cubic_hermite_interp`, ops/interp.py:142-154), for T outputs at once
    as `linear_interp`: h and the interval's width are cast to the state
    dtype and the basis is evaluated there."""
    h = _rows((t - t0) / (t1 - t0), y0)
    dt = _rows(t1 - t0, y0)
    h00 = (1 + 2 * h) * (1 - h) * (1 - h)
    h10 = h * (1 - h) * (1 - h)
    h01 = h * h * (3 - 2 * h)
    h11 = h * h * (h - 1)
    return h00 * y0 + h10 * dt * f0 + h01 * y1 + h11 * dt * f1

