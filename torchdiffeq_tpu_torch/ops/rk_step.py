"""Explicit Runge-Kutta step (counterpart of ``torchdiffeq_tpu/ops/rk_step.py``).

The step's timelike scalars (t0, dt, t1, the stage times and every
``coefficient * dt`` product) are computed on the host in the state dtype
(`misc.scalar_type`: numpy's scalar type, or a 0-d tensor for bfloat16),
which rounds exactly as the JAX package's device arithmetic in the state
dtype does; each product then enters the tensor arithmetic as a Python
float that the state dtype represents exactly.  Float16 and bfloat16
states included.

The fixed-grid steps (`rk4_alt_step_func` and the others, JAX
rk_step.py:117-180) take their time scalars in the TIME dtype, which JAX
keeps strongly typed: float64 on the fixed grid (a Python float, or a 0-d
float64 tensor when time carries a gradient), or the state dtype in a
fixed-grid event solve (a numpy scalar, or a 0-d bfloat16 tensor).  So,
as in JAX, ``dt * k`` is computed in the promoted dtype of the two --
float64 for a float32 or 16-bit state on the float64 grid -- and so are
the stage states built from it, which the field then receives (`tmul`).
A Python coefficient times a slope stays in the slope's dtype (`scale`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..misc import (Perturb, carries_derivative, coef, real_dtype, scalar_type,
                    tcast)
from .tableaus import ButcherTableau


def weighted_sum(coeffs, vecs, dt=None, base=None):
    """``base + sum_i (coeffs[i] * dt) * vecs[i]``, skipping zero
    coefficients.  `dt` is a host scalar (or None), cast to the dtype of
    `vecs` as JAX's `cast_time` casts it, or a 0-d tensor carrying a time
    derivative (the implicit fixed-grid tier's gradient, `forward_grad`'s
    tangent), cast the same way.

    Each coefficient is scaled by dt BEFORE the multiply-accumulate, as the
    reference does (``sum(k * (beta_i * dt))``, rk_common.py:79; JAX
    rk_step.py:24-46): matching that rounding order keeps single steps
    bitwise equal, which step-count parity depends on.
    """
    dtype = vecs[0].dtype
    sd = scalar_type(dtype)
    timed = isinstance(dt, torch.Tensor) and carries_derivative(dt)
    if timed:
        dt = dt.to(real_dtype(dtype))
    elif dt is not None:
        dt = sd(float(dt))
    total = None
    for c, v in zip(coeffs, vecs):
        if c == 0.0:
            continue
        if dt is None:
            scale = float(sd(c))
        elif timed:
            scale = dt * coef(c, dtype)
        else:
            scale = float(sd(c) * dt)
        term = scale * v
        total = term if total is None else total + term
    if total is None:
        total = vecs[0].new_zeros(vecs[0].shape)
    if base is not None:
        total = base + total
    return total


def runge_kutta_step(func, y0, f0, t0, dt, t1, tableau: ButcherTableau,
                     error_dtype=None):
    """One explicit RK step with its embedded error estimate (reference
    ``_runge_kutta_step``, rk_common.py:43-90): FSAL shortcut, and
    `Perturb.PREV` at stages with alpha == 1.

    Args:
        func: perturb-aware field ``func(t, y, perturb=...)``.
        y0, f0: state and derivative at t0.
        t0, dt, t1: host time scalars, or 0-d tensors carrying tangents
            (``forward_grad``); cast to the state dtype here.
        error_dtype: optional dtype of the embedded error: every slope is
            cast to it before the error sum (JAX rk_step.py:105-109), e.g.
            float32 for a bfloat16 state, whose near-cancelling error sum
            would otherwise drown in rounding.

    Returns:
        (y1, f1, y1_error, k) with k the tuple of stage slopes.
    """
    sd = scalar_type(y0.dtype)
    t0, dt, t1 = (tcast(x, y0.dtype) for x in (t0, dt, t1))

    k = [f0]
    yi = y0
    for i in range(len(tableau.alpha)):
        alpha_i = float(tableau.alpha[i])
        if alpha_i == 1.0:
            # Step to just before the end time in case of discontinuities.
            ti, perturb = t1, Perturb.PREV
        else:
            ti, perturb = t0 + sd(alpha_i) * dt, Perturb.NONE
        yi = weighted_sum(tableau.beta[i, :i + 1], k[:i + 1], dt, base=y0)
        k.append(func(ti, yi, perturb=perturb))

    if tableau.is_fsal:
        y1 = yi   # the last stage already evaluated f at (t1, y1)
    else:
        y1 = weighted_sum(tableau.c_sol, k, dt, base=y0)
    if error_dtype is None:
        y1_error = weighted_sum(tableau.c_error, k, dt)
    else:
        y1_error = weighted_sum(tableau.c_error,
                                [ki.to(error_dtype) for ki in k], dt)
    return y1, k[-1], y1_error, tuple(k)


# ---------------------------------------------------------------------------
# Standalone fixed-step functions (JAX ops/rk_step.py:117-180; reference
# rk_common.py:99-158), with JAX's order of operations and constants.
# ---------------------------------------------------------------------------

_ONE_THIRD = 1 / 3
_TWO_THIRDS = 2 / 3
_ONE_SIXTH = 1 / 6

_TIME_DTYPES = {np.float16: torch.float16, np.float32: torch.float32,
                np.float64: torch.float64, float: torch.float64}


def time_dtype(t):
    """The dtype of a time scalar: that of a 0-d tensor or numpy scalar;
    float64 for a Python float."""
    if isinstance(t, torch.Tensor):
        return t.dtype
    return _TIME_DTYPES[type(t)]


def tscale(dt, c):
    """``dt * c`` in the time dtype, `c` a weakly typed Python float."""
    if isinstance(dt, torch.Tensor):
        return dt * coef(c, dt.dtype)
    if isinstance(dt, float):
        return dt * c
    return dt * type(dt)(c)


def tmul(dt, x):
    """``dt * x`` with JAX's promotion of a tensor against a strongly typed
    time scalar: in ``promote_types(x.dtype, time_dtype(dt))``."""
    x = x.to(torch.promote_types(x.dtype, time_dtype(dt)))
    return x * (dt if isinstance(dt, torch.Tensor) else float(dt))


def scale(x, c):
    """``x * c`` for a Python coefficient `c`, in `x`'s dtype."""
    return x * coef(c, x.dtype)


def _first(func, t0, y0, f0, perturb):
    if f0 is not None:
        return f0
    return func(t0, y0, perturb=Perturb.NEXT if perturb else Perturb.NONE)


def _last(perturb):
    return Perturb.PREV if perturb else Perturb.NONE


def rk4_step_func(func, t0, dt, t1, y0, f0=None, perturb=False):
    """Classic RK4 (reference rk_common.py:99-107); returns the increment."""
    k1 = _first(func, t0, y0, f0, perturb)
    half_dt = tscale(dt, 0.5)
    k2 = func(t0 + half_dt, y0 + tmul(half_dt, k1))
    k3 = func(t0 + half_dt, y0 + tmul(half_dt, k2))
    k4 = func(t1, y0 + tmul(dt, k3), perturb=_last(perturb))
    return scale(tmul(dt, k1 + 2 * (k2 + k3) + k4), _ONE_SIXTH)


def rk4_alt_step_func(func, t0, dt, t1, y0, f0=None, perturb=False):
    """RK4 by the 3/8 rule, the registry's `rk4` (reference
    rk_common.py:110-118); returns the increment."""
    k1 = _first(func, t0, y0, f0, perturb)
    k2 = func(t0 + tscale(dt, _ONE_THIRD),
              y0 + scale(tmul(dt, k1), _ONE_THIRD))
    k3 = func(t0 + tscale(dt, _TWO_THIRDS),
              y0 + tmul(dt, k2 - scale(k1, _ONE_THIRD)))
    k4 = func(t1, y0 + tmul(dt, k1 - k2 + k3), perturb=_last(perturb))
    return scale(tmul(dt, k1 + 3 * (k2 + k3) + k4), 0.125)


def rk3_step_func(func, t0, dt, t1, y0, butcher_tableu, f0=None,
                  perturb=False):
    """A 3-stage RK step from a ``[[0, ...], [c2, a21, ...], ...]`` table
    (reference rk_common.py:121-139); returns the increment.  Zero entries
    are multiplied as JAX multiplies them."""
    bt = butcher_tableu
    k1 = _first(func, t0, y0, f0, perturb)
    k2 = func(t0 + tscale(dt, bt[1][0]), y0 + scale(tmul(dt, k1), bt[1][1]))
    k3 = func(t0 + tscale(dt, bt[2][0]),
              y0 + tmul(dt, scale(k1, bt[2][1]) + scale(k2, bt[2][2])))
    return tmul(dt, scale(k1, bt[3][1]) + scale(k2, bt[3][2])
                + scale(k3, bt[3][3]))


def rk2_step_func(func, t0, dt, t1, y0, butcher_tableu, f0=None,
                  perturb=False):
    """A 2-stage RK step (reference rk_common.py:142-158); returns the
    increment."""
    bt = butcher_tableu
    k1 = _first(func, t0, y0, f0, perturb)
    k2 = func(t0 + tscale(dt, bt[1][0]), y0 + scale(tmul(dt, k1), bt[1][1]),
              perturb=_last(perturb))
    return tmul(dt, scale(k1, bt[2][1]) + scale(k2, bt[2][2]))
