"""The adaptive implicit (stiff) tier: step functions for the adaptive loop
(counterpart of ``torchdiffeq_tpu/solvers/adaptive_implicit.py``).

`make_esdirk_step_fn` (kvaerno3, kvaerno5) and `make_firk_step_fn`
(radau5a) build a `step_fn` for `adaptive_rk.AdaptiveConfig`, with the
contract of `ops.rk_step.runge_kutta_step`: ``(y1, f1, y1_error, k)``.

* ESDIRK: the first stage is the carried slope f0; each later stage solves
  ``k = f(t_i, base + dt*gamma*k)`` by Newton's method, from the previous
  stage's slope.  FIRK: the collocation stages are one stacked Newton
  system, from f0 repeated.  Both tableaus are stiffly accurate, so the
  last stage is f(t1, y1) and carries to the next step: one evaluation a
  step is the reported NFE (the implicit convention).
* Newton's method is the fixed-grid tier's (`fixed_grid_implicit`), with
  the exact Jacobian each iteration, to ``stage_tol`` (1e-8 for float64,
  1e-6 otherwise) within ``max_iters`` iterations; time is in the state
  dtype.  A stage solve that does not converge adds 1e10 to the error
  estimate, so the controller rejects the step and shrinks it instead of
  failing the solve.
* ``error_dtype`` forms the error estimate from the slopes cast to it.
* The Newton iterations record no derivative.  Under autograd (the
  replay of ``replay_grad``, `replay.py`) or with forward-mode tangents
  (``forward_grad``) a converged stage carries the implicit-function-
  theorem derivative of `fixed_grid_implicit.root_solve`, as JAX's
  ``custom_root`` does; the continuous adjoint's solves run with no graph
  and take none.
"""
from __future__ import annotations

import numpy as np
import torch

from ..misc import (Perturb, coef, real_dtype, scalar_type, stage_jacobian,
                    tcast, tval)
from ..ops.rk_step import weighted_sum
from .fixed_grid_implicit import root_solve, solve_tol


def _error_sum(tab, k, dtc, error_dtype):
    """The embedded error's weighted sum, of the slopes cast to
    `error_dtype` when it is given (JAX `_error_sum`,
    adaptive_implicit.py:105-113)."""
    if error_dtype is None:
        return weighted_sum(tab.c_error, k, dtc)
    return weighted_sum(tab.c_error, [ki.to(error_dtype) for ki in k], dtc)


def _times(t0, dt, t1, dtype):
    """The step's times in the state dtype: host scalars, or tensors with
    their tangents (``forward_grad``)."""
    return (scalar_type(dtype), tcast(t0, dtype), tcast(dt, dtype),
            tcast(t1, dtype))


def _stage_time(alpha_i, sd, t0c, dtc, t1c):
    """The evaluation time of a stage and its perturbation: just below t1
    at alpha 1, as the explicit step does."""
    if alpha_i == 1.0:
        return t1c, Perturb.PREV
    return t0c + sd(alpha_i) * dtc, Perturb.NONE


def _reject_unconverged(y1_error, converged):
    # force error_ratio > 1 (JAX adaptive_implicit.py:150-156)
    return y1_error if converged else y1_error + 1e10


def make_esdirk_step_fn(stage_tol=None, max_iters=100, error_dtype=None):
    """A `step_fn` for an ESDIRK tableau (implicit, an explicit first stage,
    stiffly accurate; JAX adaptive_implicit.py:116-160)."""

    def step_fn(func, y0, f0, t0, dt, t1, tab):
        sd, t0c, dtc, t1c = _times(t0, dt, t1, y0.dtype)
        tol = solve_tol(y0.dtype) if stage_tol is None else stage_tol
        alpha, beta = np.asarray(tab.alpha), np.asarray(tab.beta)
        if not (tab.implicit and float(alpha[0]) == 0.0
                and not np.any(beta[0])):
            raise ValueError("step_fn requires an ESDIRK tableau")
        shape = y0.shape
        k = [f0]
        converged = True
        for i in range(1, tab.n_stages):
            base = y0 + weighted_sum(beta[i, :i], k, dtc)
            ti, perturb = _stage_time(float(alpha[i]), sd, t0c, dtc, t1c)
            dt_gamma = tval(dtc * sd(float(beta[i, i])))

            def residual(kf, base=base, ti=ti, perturb=perturb,
                         dt_gamma=dt_gamma):
                kk = kf.view(shape)
                return (kk - func(ti, base + dt_gamma * kk,
                                  perturb=perturb)).reshape(-1)

            # the previous stage's slope is the predictor
            k_i, conv = root_solve(residual, k[i - 1].reshape(-1), tol,
                                   max_iters, newton=True,
                                   jacobian=stage_jacobian(func))
            k.append(k_i.view(shape))
            converged = converged and conv
        y1 = y0 + weighted_sum(tab.c_sol, k, dtc)
        y1_error = _error_sum(tab, k, dtc, error_dtype)
        return y1, k[-1], _reject_unconverged(y1_error, converged), tuple(k)

    return step_fn


def make_firk_step_fn(stage_tol=None, max_iters=100, error_dtype=None):
    """A `step_fn` for a fully coupled implicit tableau whose stage 0 is the
    carried f0 (RADAU5A; JAX adaptive_implicit.py:163-235)."""

    def step_fn(func, y0, f0, t0, dt, t1, tab):
        sd, t0c, dtc, t1c = _times(t0, dt, t1, y0.dtype)
        tol = solve_tol(y0.dtype) if stage_tol is None else stage_tol
        alpha, beta = np.asarray(tab.alpha), np.asarray(tab.beta)
        if not (tab.implicit and float(alpha[0]) == 0.0
                and not np.any(beta[0])):
            raise ValueError("step_fn expects a carried-f0 tableau")
        s = tab.n_stages
        m = s - 1                        # coupled stages
        shape = y0.shape
        y0f, f0f = y0.reshape(-1), f0.reshape(-1)
        n = y0f.shape[0]
        times = [_stage_time(float(alpha[i]), sd, t0c, dtc, t1c)
                 for i in range(1, s)]

        def residual(Kr):
            K = list(Kr.view(m, n).unbind(0))
            stages = [f0f] + K
            res = []
            for i in range(1, s):
                yi = weighted_sum(beta[i, :s], stages, dtc, base=y0f)
                ti, perturb = times[i - 1]
                res.append(K[i - 1] - func(ti, yi.view(shape),
                                           perturb=perturb).reshape(-1))
            return torch.cat(res)

        Kr, converged = root_solve(residual, f0f.repeat(m), tol, max_iters,
                                   newton=True, jacobian=stage_jacobian(func))
        k = tuple([f0] + [x.view(shape) for x in Kr.view(m, n).unbind(0)])
        y1 = weighted_sum(tab.c_sol, k, dtc, base=y0)
        y1_error = _error_sum(tab, k, dtc, error_dtype)
        return y1, k[-1], _reject_unconverged(y1_error, converged), k

    return step_fn


# ---- the per-sample step functions (the batched driver's) -------------------

def _lane_stage_time(alpha_i, t0c, dtc, t1c):
    if alpha_i == 1.0:
        return t1c, Perturb.PREV
    return t0c + coef(alpha_i, t0c.dtype) * dtc, Perturb.NONE


def _lane_error(tab, k, dtc, error_dtype, converged):
    """The embedded error of every sample, 1e10 added where a sample's
    stage solve did not converge (`_error_sum`, `_reject_unconverged`)."""
    from .batched_rk import lane_weighted_sum, lanes
    if error_dtype is not None:
        k = [ki.to(error_dtype) for ki in k]
    err = lane_weighted_sum(tab.c_error, k, dtc)
    return torch.where(lanes(converged, err), err, err + 1e10)


def make_lane_step_fn(tab, stage_tol=None, max_iters=100, error_dtype=None):
    """The `step_fn` of `tab` for `batched_rk`: JAX's ESDIRK or FIRK step
    (`make_esdirk_step_fn`, `make_firk_step_fn`) under vmap.  Its times are
    (B,) float64, cast to the state dtype; each sample solves its own stage
    systems by Newton's method (`fixed_grid_implicit.root_solve`'s lanes,
    with per-sample convergence, Jacobians and linear solves), and a sample
    whose solve did not converge gets its own 1e10 on its error.  `active`
    (B,) leaves the samples that do not step out of the Newton iterations.
    Returns ``step_fn(func, y0, f0, t0, dt, t1, tab, active=None) -> (y1,
    f1, y1_error, k)``."""
    from .batched_rk import lane_weighted_sum, lanes
    alpha, beta = np.asarray(tab.alpha), np.asarray(tab.beta)
    if not (tab.implicit and float(alpha[0]) == 0.0 and not np.any(beta[0])):
        raise ValueError("the per-sample step function takes an implicit "
                         "tableau whose first stage is the carried slope")
    s = tab.n_stages

    def step_fn(func, y0, f0, t0, dt, t1, tab_, active=None):
        dtype = y0.dtype
        t0c, dtc, t1c = (v.to(real_dtype(dtype)) for v in (t0, dt, t1))
        tol = solve_tol(dtype) if stage_tol is None else stage_tol
        B, shape = y0.shape[0], y0.shape
        converged = torch.ones(B, dtype=torch.bool, device=y0.device)

        def solve(residual, x0):
            return root_solve(residual, x0, tol, max_iters, newton=True,
                              lanes=True, active=active,
                              jacobian=stage_jacobian(func))

        if tab.sdirk:
            k = [f0]
            for i in range(1, s):
                base = lane_weighted_sum(beta[i, :i], k, dtc, base=y0)
                ti, perturb = _lane_stage_time(float(alpha[i]), t0c, dtc,
                                               t1c)
                dt_gamma = lanes(dtc * coef(float(beta[i, i]), dtype), y0)

                def residual(kf, base=base, ti=ti, perturb=perturb,
                             dt_gamma=dt_gamma):
                    kk = kf.view(shape)
                    return (kk - func(ti, base + dt_gamma * kk,
                                      perturb=perturb)).reshape(B, -1)

                # the previous stage's slope is the predictor
                k_i, conv = solve(residual, k[i - 1].reshape(B, -1))
                k.append(k_i.view(shape))
                converged = converged & conv
        else:
            m = s - 1
            y0f, f0f = y0.reshape(B, -1), f0.reshape(B, -1)
            n = y0f.shape[1]
            times = [_lane_stage_time(float(alpha[i]), t0c, dtc, t1c)
                     for i in range(1, s)]

            def residual(Kr):
                K = list(Kr.view(B, m, n).unbind(1))
                stages = [f0f] + K
                res = []
                for i in range(1, s):
                    yi = lane_weighted_sum(beta[i, :s], stages, dtc,
                                           base=y0f)
                    ti, perturb = times[i - 1]
                    res.append(K[i - 1] - func(ti, yi.view(shape),
                                               perturb=perturb).reshape(B, -1))
                return torch.cat(res, dim=1)

            Kr, converged = solve(residual, f0f.repeat(1, m))
            k = [f0] + [x.view(shape) for x in Kr.view(B, m, n).unbind(1)]
        y1 = lane_weighted_sum(tab.c_sol, k, dtc, base=y0)
        return (y1, k[-1], _lane_error(tab, k, dtc, error_dtype, converged),
                tuple(k))

    return step_fn
