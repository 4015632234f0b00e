"""Fixed-grid implicit Runge-Kutta solvers, FIRK and DIRK (counterpart of
``torchdiffeq_tpu/solvers/fixed_grid_implicit.py``; reference
torchdiffeq/_impl/rk_common.py:378-558).

* **Stage solves.**  Broyden's method (the default: identity initial
  Jacobian, rank-1 updates, the update's denominator floored at the dtype's
  `tiny`) or Newton's (``root_solver='newton'``: the exact Jacobian,
  `misc.jacobian`, each iteration), on the flat stage residual, to an
  absolute tolerance on its 2-norm (1e-8 for float64, 1e-6 otherwise).  A
  step that is not finite ends the iteration where it stands (JAX's
  bail-out, in place of the reference's try/except).  Each iteration reads
  the residual norm back to the host, and the linear solves are
  `ops.linsolve.solve`.
* **FIRK** solves all ``s`` stages as one ``(s*n)`` system; **DIRK** one
  ``n`` system per stage.  A stage at alpha 1 evaluates the field just
  below t1 (`misc.nextafter_down`); a stage with alpha 0 and no coupling is
  pinned to ``f(t0, y0)`` (FIRK) or to the step's first slope (DIRK).
  Time is in the state dtype (JAX's ``real_dtype``), not the grid's
  float64.
* **Gradients.**  The iterations run with no graph.  Under autograd the
  residual is evaluated once more at the converged stages ``K*``, recording
  how it depends on y0, the times and the field's parameters, and the
  stages become ``K*.detach() + _IFT.apply(r, J)``: the function's forward
  returns zeros, so the values are the solver's bit for bit, and its
  backward returns ``-solve(J^T, g)`` with J the exact Jacobian at ``K*``.
  Autograd then carries ``-(dr/daux)^T J^{-T} g`` to every input: the
  implicit-function-theorem gradient of JAX's custom_vjp.  Backprop
  through the fixed-grid loop does the rest.
* **Stats.**  One evaluation a step (stage-solve evaluations are not
  user-visible NFE, the reference's convention); a step whose stage solve
  did not converge leaves ``error_code`` 4 (`ERR_IMPLICIT_NO_CONVERGENCE`;
  the reference warns and continues with the same values).
"""
from __future__ import annotations

import numpy as np
import torch

from ..misc import (Perturb, carries_derivative, coef, jacobian,
                    nextafter_down, scalar_type)
from ..ops import linsolve
from ..ops.rk_step import weighted_sum
from .fixed_grid import FixedStepMethod, construct_grid, integrate_fixed_grid
from .solution import (OK, ERR_IMPLICIT_NO_CONVERGENCE,
                       IMPLICIT_COUNTS as COUNTS)


def solve_tol(dtype):
    """The stage solves' absolute tolerance (reference rk_common.py:425-429)."""
    return 1e-8 if dtype == torch.float64 else 1e-6


def _norm_read(f, *more):
    """The 2-norm of `f` and the values of `more` (0-d tensors), read to
    the host together: one read."""
    COUNTS['host_reads'] += 1
    return torch.stack([torch.linalg.vector_norm(f).to(f.dtype)]
                       + [m.to(f.dtype) for m in more]).tolist()


def _iterate(residual, x0, tol, max_iters, newton):
    """Broyden's (JAX `_broyden`, fixed_grid_implicit.py:41-69) or Newton's
    (`_newton`, :72-98) method on ``residual: (m,) -> (m,)`` from `x0`, with
    no graph.  Returns (x, converged)."""
    # the norm is compared in its dtype, as JAX's weakly typed tolerance
    tol = float(scalar_type(x0.dtype)(tol))
    x = x0
    f = residual(x)
    (norm_f,) = _norm_read(f)
    J = None if newton else torch.eye(x.shape[0], dtype=x.dtype,
                                      device=x.device)
    tiny = torch.finfo(x.dtype).tiny
    it = 0
    # NaN >= tol is False: a NaN residual stops the loop unconverged
    while norm_f >= tol and it < max_iters:
        if newton:
            COUNTS['jacobians'] += 1
            J = jacobian(residual, x)
        s = -linsolve.solve(J, f)
        COUNTS['linear_solves'] += 1
        COUNTS['iterations'] += 1
        x_new = x + s
        f_new = residual(x_new)
        norm_new, finite = _norm_read(f_new, torch.isfinite(s).all())
        it += 1
        if not finite:
            break
        if not newton:
            denom = torch.clamp(s @ s, min=tiny)
            J = J + torch.outer(f_new - f - J @ s, s) / denom
        x, f, norm_f = x_new, f_new, norm_new
    return x, norm_f < tol


class _IFT(torch.autograd.Function):
    """``(r, jac) -> zeros_like(r)``, whose backward is ``-solve(J^T, g)``
    and whose forward-mode derivative is ``-solve(J, r')``, with ``J =
    jac()``: added to the converged stages it routes their derivatives
    through the residual `r`, as the implicit function theorem prescribes
    (JAX's ``custom_root``, in both modes)."""

    @staticmethod
    def forward(r, jac):
        return torch.zeros_like(r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.jac = inputs[1]

    @staticmethod
    def backward(ctx, g):
        J = ctx.jac()
        COUNTS['jacobians'] += 1
        COUNTS['linear_solves'] += 1
        return -linsolve.solve(J.T, g), None

    @staticmethod
    def jvp(ctx, r_t, jac_t):
        J = ctx.jac()
        COUNTS['jacobians'] += 1
        COUNTS['linear_solves'] += 1
        return -linsolve.solve(J, r_t)


def root_solve(residual, x0, tol, max_iters, newton):
    """Solve ``residual(x) = 0`` from `x0`; under autograd, or when the
    problem carries forward-mode tangents (``forward_grad``), the root
    carries the implicit-function-theorem derivative (module docstring),
    not that of the iterations.  Returns (x, converged)."""
    with torch.no_grad():
        x, conv = _iterate(residual, x0.detach(), tol, max_iters, newton)
    if torch.is_grad_enabled() or carries_derivative(x0):
        x = x.detach()
        r = residual(x)
        if carries_derivative(r):
            def jac(root=x):
                with torch.no_grad():
                    return jacobian(residual, root)
            x = x + _IFT.apply(r, jac)
    return x, conv


def _stage_times(tableau):
    """The per-stage plan (JAX `_stage_times`, fixed_grid_implicit.py:160-
    178): ``('prev_t1', None)`` at alpha 1, ``('pinned', None)`` at alpha 0
    with an all-zero coupling row, else ``('at', alpha)``."""
    plan = []
    for i in range(tableau.n_stages):
        alpha_i = float(tableau.alpha[i])
        if alpha_i == 1.0:
            plan.append(('prev_t1', None))
        elif alpha_i == 0.0 and np.all(np.asarray(tableau.beta[i]) == 0.0):
            plan.append(('pinned', None))
        else:
            plan.append(('at', alpha_i))
    return plan


def _cast_time(t, dtype):
    """A grid time in the state dtype (JAX's ``astype(real_dtype)``): a host
    scalar, or a 0-d tensor when it carries a gradient."""
    if isinstance(t, torch.Tensor) and t.requires_grad:
        return t.to(dtype)
    return scalar_type(dtype)(float(t))


def _stage_time(plan_i, t0, dt, t1, dtype):
    kind, a = plan_i
    if kind == 'prev_t1':
        return nextafter_down(t1)
    if isinstance(dt, torch.Tensor):
        return t0 + dt * coef(a, dtype)
    return t0 + scalar_type(dtype)(a) * dt


def make_fixed_step_method(prob, tableau, sequential):
    """The implicit `FixedStepMethod` of `tableau` (JAX
    `make_fixed_step_method`, fixed_grid_implicit.py:180-288):
    ``sequential=False`` FIRK, ``True`` DIRK.  Options ``max_iters``
    (100) and ``root_solver`` ('broyden' or 'newton')."""
    opts = dict(prob.options)
    max_iters = int(opts.get('max_iters', 100))
    # any other value is Broyden's method, as in JAX
    newton = opts.get('root_solver', 'broyden') == 'newton'
    s = tableau.n_stages
    beta = np.asarray(tableau.beta)
    plan = _stage_times(tableau)

    def prepare(func, t0, dt, t1, y0, perturb):
        f0 = func(t0, y0, perturb=Perturb.NEXT if perturb else Perturb.NONE)
        td = y0.dtype
        t0c, dtc, t1c = (_cast_time(v, td) for v in (t0, dt, t1))
        shape = y0.shape

        def eval_f(ti, yf):
            return func(ti, yf.view(shape), perturb=Perturb.NONE).reshape(-1)

        times = [None if kind == 'pinned'
                 else _stage_time((kind, a), t0c, dtc, t1c, td)
                 for kind, a in plan]
        return f0, t0c, dtc, eval_f, times

    tol = solve_tol(prob.y0.dtype)

    if not sequential:
        def step(func, t0, dt, t1, y0, perturb, state):
            f0, t0c, dtc, eval_f, times = prepare(func, t0, dt, t1, y0,
                                                  perturb)
            y0f = y0.reshape(-1)
            n = y0f.shape[0]
            pinned = (eval_f(t0c, y0f) if any(k == 'pinned' for k, _ in plan)
                      else None)

            def residual(Kf):
                K = list(Kf.view(s, n).unbind(0))
                res = []
                for i in range(s):
                    if plan[i][0] == 'pinned':
                        res.append(K[i] - pinned)
                        continue
                    yi = y0f + weighted_sum(beta[i], K, dtc)
                    res.append(K[i] - eval_f(times[i], yi))
                return torch.cat(res)

            Kf, conv = root_solve(residual, f0.reshape(-1).repeat(s), tol,
                                  max_iters, newton)
            dy = weighted_sum(tableau.c_sol, list(Kf.view(s, n).unbind(0)),
                              dtc)
            return dy.view(y0.shape), f0, state and conv
    else:
        def step(func, t0, dt, t1, y0, perturb, state):
            f0, t0c, dtc, eval_f, times = prepare(func, t0, dt, t1, y0,
                                                  perturb)
            y0f, f0f = y0.reshape(-1), f0.reshape(-1)
            K, conv_all = [], state
            for i in range(s):
                if plan[i][0] == 'pinned':
                    K.append(f0f)
                    continue

                def residual_i(k, i=i, prev=tuple(K)):
                    yi = y0f + weighted_sum(beta[i, :i + 1], list(prev) + [k],
                                            dtc)
                    return k - eval_f(times[i], yi)

                ki, conv = root_solve(residual_i, f0f, tol, max_iters, newton)
                conv_all = conv_all and conv
                K.append(ki)
            return weighted_sum(tableau.c_sol, K, dtc).view(y0.shape), f0, \
                conv_all

    return FixedStepMethod(
        step, order=tableau.order, nfe_per_step=1,
        init_state=lambda func_, y0, t0: True,
        error_from_state=lambda st: OK if st else ERR_IMPLICIT_NO_CONVERGENCE)


IMPLICIT_OPTIONS = {'step_size', 'grid_constructor', 'num_steps', 'perturb',
                    'interp', 'max_iters', 'root_solver', 'dtype'}


def integrate_implicit(prob, tableau, sequential, ts=None):
    """The implicit fixed-grid solve of a normalised problem (JAX
    `integrate_implicit`, fixed_grid_implicit.py:291-303); `ts` replaces
    ``prob.t`` when the output times carry a gradient."""
    from ..odeint import _warn_unused
    opts = dict(prob.options)
    _warn_unused('implicit fixed-grid solver', opts, IMPLICIT_OPTIONS)
    method = make_fixed_step_method(prob, tableau, sequential)
    ts = prob.t if ts is None else ts
    grid = construct_grid(prob.func, prob.y0, ts, opts.get('step_size'),
                          opts.get('grid_constructor'), opts.get('num_steps'))
    return integrate_fixed_grid(method, prob.func, prob.y0, ts, grid,
                                interp=opts.get('interp', 'linear'),
                                perturb=opts.get('perturb', False))
