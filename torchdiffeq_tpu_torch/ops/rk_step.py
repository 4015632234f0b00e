"""Explicit Runge-Kutta step (counterpart of ``torchdiffeq_tpu/ops/rk_step.py``).

The step's timelike scalars (t0, dt, t1, the stage times and every
``coefficient * dt`` product) are computed on the host in the state dtype
(`misc.scalar_type`: numpy's scalar type, or a 0-d tensor for bfloat16),
which rounds exactly as the JAX package's device arithmetic in the state
dtype does; each product then enters the tensor arithmetic as a Python
float that the state dtype represents exactly.  The step takes float16 and
bfloat16 states too; the solvers around it do not yet (ROADMAP A2).
"""
from __future__ import annotations

from ..misc import Perturb, scalar_type
from .tableaus import ButcherTableau


def weighted_sum(coeffs, vecs, dt=None, base=None):
    """``base + sum_i (coeffs[i] * dt) * vecs[i]``, skipping zero
    coefficients.  `dt` is a host scalar (or None), cast to the dtype of
    `vecs` as JAX's `cast_time` casts it.

    Each coefficient is scaled by dt BEFORE the multiply-accumulate, as the
    reference does (``sum(k * (beta_i * dt))``, rk_common.py:79; JAX
    rk_step.py:24-46): matching that rounding order keeps single steps
    bitwise equal, which step-count parity depends on.
    """
    sd = scalar_type(vecs[0].dtype)
    dt = None if dt is None else sd(float(dt))
    total = None
    for c, v in zip(coeffs, vecs):
        if c == 0.0:
            continue
        scale = float(sd(c)) if dt is None else float(sd(c) * dt)
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
        t0, dt, t1: host time scalars; cast to the state dtype here.
        error_dtype: optional dtype of the embedded error: every slope is
            cast to it before the error sum (JAX rk_step.py:105-109), e.g.
            float32 for a bfloat16 state, whose near-cancelling error sum
            would otherwise drown in rounding.

    Returns:
        (y1, f1, y1_error, k) with k the tuple of stage slopes.
    """
    sd = scalar_type(y0.dtype)
    t0, dt, t1 = sd(t0), sd(dt), sd(t1)

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
