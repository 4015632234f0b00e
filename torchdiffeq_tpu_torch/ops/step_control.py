"""Step-size control: initial step, error ratio, the I, PI and PID
controllers (counterpart of ``torchdiffeq_tpu/ops/step_control.py``;
reference misc.py:36-95).

The norms are tensor reductions; the scalar control arithmetic runs on the
host in scalars of the same dtype the JAX package computes it in: the
state dtype for the initial step (`misc.scalar_type`, bfloat16 included),
float64, the time dtype, for the controllers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..misc import Perturb, coef, scalar_type, smax, smin, tcast, tval


def _tol(tol, like):
    """A scalar tolerance rounded to `like`'s dtype, as JAX's weakly typed
    ``rtol * x`` rounds it (a tensor tolerance is used as it is)."""
    return tol if isinstance(tol, torch.Tensor) else coef(tol, like.dtype)


def error_scale(rtol, atol, y0, y1=None):
    """``atol + rtol * |y0|`` or ``atol + rtol * max(|y0|, |y1|)``
    (reference misc.py:80-82)."""
    rtol, atol = _tol(rtol, y0), _tol(atol, y0)
    if y1 is None:
        return atol + y0.abs() * rtol
    return atol + rtol * torch.maximum(y0.abs(), y1.abs())


def select_initial_step(func, t0, y0, order, rtol, atol, norm, f0):
    """Hairer, Norsett & Wanner's initial step ("Solving ODEs I", II.4;
    reference misc.py:36-77).  `order` is `solver_order - 1`, as at the
    reference call site (rk_common.py:219).  Costs one field evaluation and
    two host reads.  Returns the step as a float64 host scalar, or, when
    `t0` is a tensor (``forward_grad``), as a 0-d float64 CPU tensor that
    carries the tangents of the norms it is made of (JAX's step is a traced
    value, so its tangent flows into the solve)."""
    sd = scalar_type(y0.dtype)
    tiny = sd(torch.finfo(y0.dtype).tiny)
    scale = error_scale(rtol, atol, y0)
    timed = isinstance(t0, torch.Tensor)

    ds = torch.stack([norm(y0 / scale), norm(f0 / scale)]).abs()
    d0, d1 = ds.cpu() if timed else (sd(v) for v in ds.tolist())
    if d0 < sd(1e-5) or d1 < sd(1e-5):
        h0 = sd(1e-6)
    else:
        h0 = sd(0.01) * d0 / smax(d1, tiny)
    h0 = abs(h0)

    y1 = y0 + tval(h0) * f0
    f1 = func(tcast(t0, y0.dtype) + h0, y1, perturb=Perturb.NONE)

    n2 = norm((f1 - f0) / scale)
    d2 = abs((n2.cpu() if timed else sd(n2.item())) / h0)
    d_max = smax(d1, d2)
    if d1 <= sd(1e-15) and d2 <= sd(1e-15):
        h1 = smax(sd(1e-6), h0 * sd(1e-3))
    else:
        h1 = (sd(0.01) / smax(d_max, tiny)) ** sd(1.0 / float(order + 1))
    h1 = abs(h1)
    h = smin(sd(100) * h0, h1)
    if timed:
        return torch.as_tensor(h).to(torch.float64)
    return np.float64(float(h))


def compute_error_ratio(error_estimate, rtol, atol, y0, y1, norm):
    """``norm(err / (atol + rtol * max(|y0|, |y1|)))`` as a 0-d tensor
    (reference misc.py:80-82)."""
    return norm(error_estimate / error_scale(rtol, atol, y0, y1)).abs()


def _f64(x):
    """A float64 host scalar, or a 0-d tensor (``forward_grad``) cast to
    float64 with its tangent."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return np.float64(x)


def optimal_step_size(last_step, error_ratio, safety, ifactor, dfactor,
                      order):
    """I-controller step update (reference misc.py:85-95) on float64 host
    scalars, or on 0-d float64 tensors carrying tangents (``forward_grad``;
    the branches read their primal values):

        factor = min(ifactor, max(safety * ratio^(-1/order), dfactor))

    with dfactor ignored (set to 1) on accepted steps, and a full `ifactor`
    increase when the error is exactly zero.
    """
    f64 = np.float64
    error_ratio = _f64(error_ratio)
    if error_ratio < 1:
        dfactor = 1.0
    safe_ratio = smax(error_ratio, f64(np.finfo(f64).tiny))
    factor = smin(smax(f64(safety) / safe_ratio ** f64(1.0 / order),
                       f64(dfactor)), f64(ifactor))
    if error_ratio == 0:
        factor = f64(ifactor)
    return _f64(last_step) * factor


def _ratio(x):
    """An error ratio in float64, floored at its smallest normal."""
    return smax(_f64(x), np.finfo(np.float64).tiny)


def _clip(factor, dfactor, ifactor):
    """``jnp.clip(factor, dfactor, ifactor)``."""
    return smin(smax(factor, np.float64(dfactor)), np.float64(ifactor))


def optimal_step_size_pi(last_step, error_ratio, prev_error_ratio, safety,
                         ifactor, dfactor, order, pcoeff=0.4, icoeff=0.7):
    """Proportional-integral step update (JAX `optimal_step_size_pi`,
    ops/step_control.py:90-113) on float64 host scalars or tensors, as
    `optimal_step_size`:

        factor = safety * ratio^(-icoeff/order) * prev^(pcoeff/order)

    clamped to [dfactor, ifactor], both ratios floored at float64's
    smallest normal, and a full `ifactor` increase on a zero error."""
    f64 = np.float64
    err, prev = _ratio(error_ratio), _ratio(prev_error_ratio)
    ki, kp = f64(icoeff / order), f64(pcoeff / order)
    factor = _clip(f64(safety) * err ** (-ki) * prev ** kp, dfactor, ifactor)
    if _f64(error_ratio) == 0:
        factor = f64(ifactor)
    return _f64(last_step) * factor


def optimal_step_size_pid(last_step, error_ratio, prev_error_ratio,
                          prev2_error_ratio, safety, ifactor, dfactor, order,
                          pcoeff=0.4, icoeff=0.7, dcoeff=0.0):
    """Proportional-integral-derivative step update (JAX
    `optimal_step_size_pid`, ops/step_control.py:116-143):

        factor = safety * ratio^(-icoeff/order) * prev^(pcoeff/order)
                        * prev2^(-dcoeff/order)

    clamped and floored as `optimal_step_size_pi`; ``dcoeff=0`` is the PI
    controller."""
    f64 = np.float64
    err, prev = _ratio(error_ratio), _ratio(prev_error_ratio)
    prev2 = _ratio(prev2_error_ratio)
    ki, kp, kd = f64(icoeff / order), f64(pcoeff / order), f64(dcoeff / order)
    factor = _clip(f64(safety) * err ** (-ki) * prev ** kp * prev2 ** (-kd),
                   dfactor, ifactor)
    if _f64(error_ratio) == 0:
        factor = f64(ifactor)
    return _f64(last_step) * factor
