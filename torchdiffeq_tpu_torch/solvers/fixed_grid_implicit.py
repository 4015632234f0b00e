"""Fixed-grid implicit Runge-Kutta solvers, FIRK and DIRK (counterpart of
``torchdiffeq_tpu/solvers/fixed_grid_implicit.py``; reference
torchdiffeq/_impl/rk_common.py:378-558).

* **Stage solves.**  Broyden's method (the default: identity initial
  Jacobian, rank-1 updates, the update's denominator floored at the dtype's
  `tiny`) or Newton's (``root_solver='newton'``: the exact Jacobian,
  `misc.lane_jacobian`, each iteration), on the flat stage residual, to an
  absolute tolerance on its 2-norm (1e-8 for float64, 1e-6 otherwise).  A
  step that is not finite ends the iteration where it stands (JAX's
  bail-out, in place of the reference's try/except).  One solve is a
  batch of one of the per-sample solves (`_iterate`): each iteration
  makes one host read, and the linear solves are `ops.linsolve.solve`.
* **FIRK** solves all ``s`` stages as one ``(s*n)`` system; **DIRK** one
  ``n`` system per stage.  A stage at alpha 1 evaluates the field just
  below t1 (`misc.nextafter_down`); a stage with alpha 0 and no coupling is
  pinned to ``f(t0, y0)`` (FIRK) or to the step's first slope (DIRK).
  Time is in the state's real dtype (JAX's ``real_dtype``), not the
  grid's float64.  A complex state's stage systems are solved on their
  stacked real view (`_complex_root_solve`).
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

from ..misc import (Perturb, carries_derivative, coef, data_axis,
                    lane_jacobian, nextafter_down, real_dtype, scalar_type,
                    stage_jacobian)
from ..ops import linsolve
from ..ops.rk_step import weighted_sum
from .fixed_grid import FixedStepMethod, construct_grid, integrate_fixed_grid
from .solution import (OK, ERR_IMPLICIT_NO_CONVERGENCE,
                       IMPLICIT_COUNTS as COUNTS)


def solve_tol(dtype):
    """The stage solves' absolute tolerance (reference rk_common.py:425-429)."""
    return 1e-8 if dtype == torch.float64 else 1e-6


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
        return -linsolve.solve(J.mT, g), None

    @staticmethod
    def jvp(ctx, r_t, jac_t):
        J = ctx.jac()
        COUNTS['jacobians'] += 1
        COUNTS['linear_solves'] += 1
        return -linsolve.solve(J, r_t)


def _iterate(residual, x0, tol, max_iters, newton, active=None,
             jacobian=lane_jacobian, axis=None):
    """Broyden's (JAX `_broyden`, fixed_grid_implicit.py:41-69) or Newton's
    (`_newton`, :72-98) method for every sample of a batch at once (JAX's
    solves under vmap), with no graph: ``residual: (B, m) -> (B, m)`` row
    by row, and each sample carries its own x, residual, Broyden matrix
    (B, m, m), iteration count and non-finite bail-out.  A sample iterates
    while its own 2-norm is at least `tol`, it has not bailed out and it
    has taken fewer than `max_iters` iterations; then it keeps its values,
    as a lane of JAX's batched while_loop keeps its carry.  Newton's
    Jacobians are `jacobian` (`misc.lane_jacobian` unless the field names
    its own, `misc.stage_jacobian`), the linear solves one batched
    `ops.linsolve.solve`.  One host read an iteration: whether any sample
    still iterates, and whether all have converged.  `active` (B,) bool
    leaves the other samples out from the start (an adaptive step's
    finished samples).

    `axis` (`misc.data_axis`, a batch of one) is the data axis of a
    data-parallel solve, whose rank holds one block of each stage vector:
    Newton's norm is the global 2-norm, each rank's sum of squares
    all-reduced with its bail-out flag, while its Jacobian and linear solve
    stay the block's (a row-wise field's Jacobian is block-diagonal).
    Broyden's update couples the blocks, so its residuals are gathered
    (rank-major: the single device's vector permuted, which leaves the
    iterates from the identity matrix unchanged) and its matrix, solve and
    norm are global, the same on every rank; each rank steps its block.

    An implicit adjoint method's backward (`axis.parts`, the augmented
    state's layout: `parallel.sharding._AugmentedAxis`) also holds
    replicated entries, vjp_t and theta_bar, which the augmented field
    never reads: the stage Jacobian is block-triangular, the replicated
    rows' block the identity.  Newton then solves the block rows with the
    block's own matrix and takes the replicated increment as ``-f_rep -
    sum_ranks J_rep,blk s_blk``, one all-reduce of every rank's share
    (its Jacobian is of the rank's unsummed field), and its norm counts
    the replicated entries once, after the all-reduce; Broyden gathers
    the blocks rank-major and the replicated entries once, again a
    permutation of the single device's vector.
    Returns (x, converged (B,), all converged: a bool)."""
    # the norm is compared in its dtype, as JAX's weakly typed tolerance
    tol = float(scalar_type(x0.dtype)(tol))
    B = x0.shape[0]
    wide = axis is not None and not newton   # Broyden over the whole state
    # (block, replicated) entries, or None when every entry is the block's
    parts = None if axis is None else axis.parts(x0.shape[1], x0.device)

    def whole(v):
        """Broyden's global vector: every rank's block, then the
        replicated entries once."""
        if parts is None:
            return axis.gather(v, 1)
        return torch.cat([axis.gather(v[:, parts[0]], 1), v[:, parts[1]]], 1)

    def own(s):
        """This rank's entries of a global step (`whole`'s inverse)."""
        if parts is None:
            return axis.block(s, 1)
        nb = axis.n * parts[0].numel()
        out = torch.empty_like(x0)
        out[:, parts[0]] = axis.block(s[:, :nb], 1)
        out[:, parts[1]] = s[:, nb:]
        return out

    def global_norm(v, flags):
        """Newton's global 2-norm of `v` and the OR of every rank's
        `flags`, in one all-reduce."""
        blk = v if parts is None else v[:, parts[0]]
        red = axis.sum(torch.cat([(blk * blk).sum(1), flags.to(v.dtype)]))
        sq = red[:B]
        if parts is not None:
            rep = v[:, parts[1]]
            sq = sq + (rep * rep).sum(1)
        return torch.sqrt(sq), red[B:] > 0

    def newton_step(J, v):
        if parts is None:
            return -linsolve.solve(J, v)
        b, r = parts
        s_b = -linsolve.solve(J[:, b][:, :, b], v[:, b])
        share = (J[:, r][:, :, b] @ s_b[:, :, None])[:, :, 0]
        s = torch.empty_like(v)
        s[:, b] = s_b
        s[:, r] = -v[:, r] - axis.sum(share)
        return s

    x = x0
    f = whole(residual(x)) if wide else residual(x)
    if axis is not None and newton:
        norm_f = global_norm(f, f.new_zeros(0))[0]
    else:
        norm_f = torch.linalg.vector_norm(f, dim=1)
    m = f.shape[1]
    J = None if newton else torch.eye(
        m, dtype=x.dtype, device=x.device).expand(B, m, m)
    tiny = torch.finfo(x.dtype).tiny
    it = torch.zeros(B, dtype=torch.int32, device=x.device)
    bailed = (torch.zeros(B, dtype=torch.bool, device=x.device)
              if active is None else ~active)
    while True:
        # NaN >= tol is False: a NaN residual stops the sample unconverged
        live = (norm_f >= tol) & ~bailed & (it < max_iters)
        COUNTS['host_reads'] += 1
        any_live, all_conv = torch.stack(
            [live.any(), (norm_f < tol).all()]).tolist()
        if not any_live:
            break
        if newton:
            COUNTS['jacobians'] += 1
            J = jacobian(residual, x)
        s = newton_step(J, f) if newton else -linsolve.solve(J, f)
        COUNTS['linear_solves'] += 1
        COUNTS['iterations'] += 1
        bail = ~torch.isfinite(s).all(1)
        s = torch.where(bail[:, None], torch.zeros_like(s), s)
        x_new = x + (own(s) if wide else s)
        f_new = residual(x_new)
        if wide:
            f_new = whole(f_new)
        if axis is not None and newton:
            norm_new, bail = global_norm(f_new, bail)
        else:
            norm_new = torch.linalg.vector_norm(f_new, dim=1)
        upd = live & ~bail
        if not newton:
            denom = torch.clamp((s * s).sum(1), min=tiny)
            u = f_new - f - (J @ s[:, :, None])[:, :, 0]
            J_new = J + u[:, :, None] * s[:, None, :] / denom[:, None, None]
            J = torch.where(upd[:, None, None], J_new, J)
        x = torch.where(upd[:, None], x_new, x)
        f = torch.where(upd[:, None], f_new, f)
        norm_f = torch.where(upd, norm_new, norm_f)
        it = it + live.to(torch.int32)
        bailed = bailed | (live & bail)
    return x, norm_f < tol, bool(all_conv)


def root_solve(residual, x0, tol, max_iters, newton, lanes=False,
               active=None, jacobian=lane_jacobian):
    """Solve ``residual(x) = 0`` from `x0` (`_iterate`); under autograd,
    or when the problem carries forward-mode tangents (``forward_grad``),
    the root carries the implicit-function-theorem derivative (module
    docstring), not that of the iterations.  `x0` is (m,), a batch of one;
    with `lanes` it is (B, m) and every sample solves its own system
    (`active` as `_iterate`'s), its implicit-function derivative through
    its own Jacobian.  `jacobian(fn, x)` takes the Jacobians
    (`misc.stage_jacobian`).  Returns (x, converged: a bool, or (B,) with
    `lanes`)."""
    if x0.is_complex():
        return _complex_root_solve(residual, x0, tol, max_iters, newton,
                                   lanes, active, jacobian)
    axis = None
    if not lanes:
        one, residual = residual, lambda xb: one(xb[0])[None]
        x0 = x0[None]
        axis = data_axis()
    with torch.no_grad():
        x, conv, all_conv = _iterate(residual, x0.detach(), tol, max_iters,
                                     newton, active, jacobian, axis)
    if torch.is_grad_enabled() or carries_derivative(x0):
        x = x.detach()
        r = residual(x)
        if carries_derivative(r):
            def jac(root=x):
                with torch.no_grad():
                    return jacobian(residual, root)
            x = x + _IFT.apply(r, jac)
    return (x, conv) if lanes else (x[0], all_conv)


def _complex_root_solve(residual, x0, tol, max_iters, newton, lanes, active,
                        jacobian):
    """`root_solve` of a complex system on its stacked real view ``[Re x,
    Im x]`` (JAX `_make_root_solver(complex_state=True)`,
    fixed_grid_implicit.py:102-126; `_stage_root`, adaptive_implicit.py:70-
    103): Newton's Jacobian, Broyden's rank-1 update and the implicit-
    function derivative are then those of a real function, with no
    assumption that the field is holomorphic (``torch.func`` would take a
    complex function's derivative as if it were).  The packing and
    unpacking stay outside `_IFT`, which sees real tensors only; autograd
    carries derivatives through them in its own convention."""
    m = x0.shape[-1]

    def pack(z):
        return torch.cat([z.real, z.imag], dim=-1)

    def unpack(xr):
        return torch.complex(xr[..., :m], xr[..., m:])

    xr, conv = root_solve(lambda xr: pack(residual(unpack(xr))), pack(x0),
                          tol, max_iters, newton, lanes, active, jacobian)
    return unpack(xr), conv


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
    """A grid time in the state's real dtype (JAX's ``astype(real_dtype)``):
    a host scalar, or a 0-d tensor when it carries a gradient."""
    if isinstance(t, torch.Tensor) and t.requires_grad:
        return t.to(real_dtype(dtype))
    return scalar_type(dtype)(float(t))


def _stage_time(plan_i, t0, dt, t1, dtype):
    kind, a = plan_i
    if kind == 'prev_t1':
        return nextafter_down(t1)
    if isinstance(dt, torch.Tensor):
        return t0 + dt * coef(a, dtype)
    return t0 + scalar_type(dtype)(a) * dt


def make_fixed_step_method(prob, tableau, sequential, lanes=False):
    """The implicit `FixedStepMethod` of `tableau` (JAX
    `make_fixed_step_method`, fixed_grid_implicit.py:180-288):
    ``sequential=False`` FIRK, ``True`` DIRK.  Options ``max_iters``
    (100) and ``root_solver`` ('broyden' or 'newton').  With `lanes` the
    state is a batch (B, ...) on a shared grid, the field batched, and
    each sample solves its own stage systems (`root_solve`'s lanes, JAX's
    solve under vmap); the stepper's state is then each sample's
    all-converged flag (B,), and so is its error code."""
    opts = dict(prob.options)
    max_iters = int(opts.get('max_iters', 100))
    # any other value is Broyden's method, as in JAX
    newton = opts.get('root_solver', 'broyden') == 'newton'
    s = tableau.n_stages
    beta = np.asarray(tableau.beta)
    plan = _stage_times(tableau)
    # the stage vectors: flat per sample, (n,) or (B, n)
    lead = 1 if lanes else 0

    def prepare(func, t0, dt, t1, y0, perturb):
        f0 = func(t0, y0, perturb=Perturb.NEXT if perturb else Perturb.NONE)
        td = y0.dtype
        t0c, dtc, t1c = (_cast_time(v, td) for v in (t0, dt, t1))
        shape = y0.shape

        def eval_f(ti, yf):
            return func(ti, yf.view(shape), perturb=Perturb.NONE).reshape(
                yf.shape)

        times = [None if kind == 'pinned'
                 else _stage_time((kind, a), t0c, dtc, t1c, td)
                 for kind, a in plan]
        return f0, t0c, dtc, eval_f, times

    tol = solve_tol(prob.y0.dtype)

    def flat(x):
        return x.reshape(x.shape[:lead] + (-1,))

    def solve(func, residual, x0):
        return root_solve(residual, x0, tol, max_iters, newton, lanes=lanes,
                          jacobian=stage_jacobian(func))

    if not sequential:
        def step(func, t0, dt, t1, y0, perturb, state):
            f0, t0c, dtc, eval_f, times = prepare(func, t0, dt, t1, y0,
                                                  perturb)
            y0f = flat(y0)
            n = y0f.shape[-1]
            pinned = (eval_f(t0c, y0f) if any(k == 'pinned' for k, _ in plan)
                      else None)

            def residual(Kf):
                K = list(Kf.unflatten(-1, (s, n)).unbind(-2))
                res = []
                for i in range(s):
                    if plan[i][0] == 'pinned':
                        res.append(K[i] - pinned)
                        continue
                    yi = y0f + weighted_sum(beta[i], K, dtc)
                    res.append(K[i] - eval_f(times[i], yi))
                return torch.cat(res, dim=-1)

            Kf, conv = solve(func, residual, flat(f0).repeat(
                *((1,) * lead), s))
            dy = weighted_sum(tableau.c_sol,
                              list(Kf.unflatten(-1, (s, n)).unbind(-2)), dtc)
            return dy.view(y0.shape), f0, state & conv
    else:
        def step(func, t0, dt, t1, y0, perturb, state):
            f0, t0c, dtc, eval_f, times = prepare(func, t0, dt, t1, y0,
                                                  perturb)
            y0f, f0f = flat(y0), flat(f0)
            K, conv_all = [], state
            for i in range(s):
                if plan[i][0] == 'pinned':
                    K.append(f0f)
                    continue

                def residual_i(k, i=i, prev=tuple(K)):
                    yi = y0f + weighted_sum(beta[i, :i + 1], list(prev) + [k],
                                            dtc)
                    return k - eval_f(times[i], yi)

                ki, conv = solve(func, residual_i, f0f)
                conv_all = conv_all & conv
                K.append(ki)
            return weighted_sum(tableau.c_sol, K, dtc).view(y0.shape), f0, \
                conv_all

    if lanes:
        return FixedStepMethod(
            step, order=tableau.order, nfe_per_step=1,
            init_state=lambda func_, y0, t0: torch.ones(
                y0.shape[0], dtype=torch.bool, device=y0.device),
            error_from_state=lambda st: torch.where(
                st, OK, ERR_IMPLICIT_NO_CONVERGENCE).to(torch.int32))
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
