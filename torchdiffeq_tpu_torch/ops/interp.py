"""Quartic dense output of the adaptive RK solver (counterpart of
``torchdiffeq_tpu/ops/interp.py``; reference torchdiffeq/_impl/interp.py).

Coefficients are one ``(5, *state.shape)`` tensor ``[e, d, c, b, a]`` in
ascending powers of the normalised time x in [0, 1], in the state dtype
(float32 or float64: the JAX package's float32 fit for 16-bit states is
not part of this slice).
"""
from __future__ import annotations

import torch

from ..misc import np_dtype
from .rk_step import weighted_sum


def interp_fit_step(y0, y1, k, dt, tableau):
    """Quartic fit from one accepted step's stage slopes, with the
    reference's y-form and accumulation order (rk_common.py:363-369 then
    interp.py:1-22): ``y_mid = y0 + sum((c_mid * dt) * k)``."""
    sd = np_dtype(y0.dtype)
    dt = sd(dt)
    y_mid = weighted_sum(tableau.c_mid, k, dt, base=y0)
    f0, f1 = k[0], k[-1]
    dtf = float(dt)
    a = float(sd(2) * dt) * (f1 - f0) - 8 * (y1 + y0) + 16 * y_mid
    b = dtf * (5 * f0 - 3 * f1) + 18 * y0 + 14 * y1 - 32 * y_mid
    c = dtf * (f1 - 4 * f0) - 11 * y0 - 5 * y1 + 16 * y_mid
    return torch.stack([y0, dtf * f0, c, b, a])


def interp_evaluate(coefficients, t0, t1, t):
    """Evaluate the fitted polynomial at host time `t` in [t0, t1]
    (reference interp.py:25-48), with the guard for a zero-width step.
    Horner-style in ascending powers; the powers of x are host scalars in
    the state dtype, as the JAX package computes them."""
    sd = np_dtype(coefficients.dtype)
    denom = t1 - t0 if t1 > t0 else 1.0
    x = sd((t - t0) / denom)
    total = coefficients[0] + float(x) * coefficients[1]
    x_power = x
    for i in range(2, coefficients.shape[0]):
        x_power = x_power * x
        total = total + float(x_power) * coefficients[i]
    return total


def interp_evaluate_at(coefficients, t0, t1, t):
    """`interp_evaluate` at float64 TENSOR times `t` on the coefficients'
    device, with no host read: JAX's `interp_evaluate`
    (torchdiffeq_tpu/ops/interp.py:106-127), x formed in float64 and cast
    to the state dtype.  As there, there is no zero-width guard: an
    interval with ``t1 == t0`` gives NaN.  `t` may have leading axes that
    the coefficient rows share (one interval per time, `t0` and `t1`
    broadcasting with `t`)."""
    x = ((t - t0) / (t1 - t0)).to(coefficients.dtype)
    x = x.reshape(x.shape + (1,) * (coefficients.dim() - 1 - x.dim()))
    total = coefficients[0] + x * coefficients[1]
    x_power = x
    for i in range(2, coefficients.shape[0]):
        x_power = x_power * x
        total = total + x_power * coefficients[i]
    return total
