"""Per-sample batched adaptive step control (counterpart of
``torchdiffeq_tpu/parallel/batched.py``).

The reference shares one error norm across the whole batch, so one stiff
sample shrinks every sample's steps.  Here every sample gets its own
accept/reject sequence and step size.  This slice carries the kernel route
(``options=dict(pallas=True)``): the whole batched solve is the per-lane
kernel `ops/kernels.dopri5_integrate_batched` on CUDA (an `MLPField`
field), or its plain version on the CPU (any per-sample field).  With
``event_fn`` each sample integrates until its own event fires, in
`ops/kernels.dopri5_events_batched` (an `MLPField` field and a
`LinearEvent` event on CUDA; any per-sample functions on the CPU).  The
JAX package's vmap route is ROADMAP A6, and so are per-sample args
(``args_axes=-1``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..misc import host_times, nan_sign, needs_autograd, np_dtype
from ..models.neural_ode import LinearEvent, MLPField
from ..solvers.solution import Stats, OK, ERR_MAX_NUM_STEPS

# options the per-lane kernel route understands (the JAX set, less the
# Pallas interpreter switch)
_PALLAS_OPTS = {'pallas', 'first_step', 'safety', 'ifactor', 'dfactor',
                'max_num_steps'}


def _kernel_route(y0, t, rtol, atol, method, options, args_axes, kwargs):
    """The JAX `_pallas_qualifies` rules (batched.py:57-78); a problem that
    would take the vmap route there raises here.  Returns the host times."""
    from ..ops.kernels import PER_LANE_METHODS
    todo = "the vmap route of odeint_per_sample is not ported yet (ROADMAP A6)"
    if args_axes is not None and any(a is not None for a in args_axes):
        raise NotImplementedError(
            "per-sample args (args_axes) are not ported yet (ROADMAP A6)")
    if kwargs:
        raise NotImplementedError(f"{todo}: options {sorted(kwargs)}")
    if not isinstance(options, dict) or not options.get('pallas'):
        raise NotImplementedError(
            f"{todo}; pass options=dict(pallas=True) for the kernel route")
    if method is not None and method not in PER_LANE_METHODS:
        raise NotImplementedError(f"{todo}: method {method!r}")
    if set(options) - _PALLAS_OPTS:
        raise NotImplementedError(
            f"{todo}: options {sorted(set(options) - _PALLAS_OPTS)}")
    if np.ndim(rtol) != 0 or np.ndim(atol) != 0:
        raise NotImplementedError(f"{todo}: per-element tolerances")
    if not isinstance(y0, torch.Tensor) or y0.dim() != 2 or y0.is_complex():
        raise NotImplementedError(f"{todo}: state that is not a real (B, D) "
                                  "tensor")
    t_np = host_times(t)
    if t_np.shape[0] < 2 or not (np.diff(t_np) > 0).all():
        raise NotImplementedError(f"{todo}: output times that are not "
                                  "increasing")
    return t_np


def _lane_field(func, args):
    """Lane-vectorise a per-sample ``func(t, y_i, *args)`` to the kernel
    layout: t (1, B), y (D, B) with the batch on the last axis."""
    per_sample = torch.func.vmap(
        lambda tt, yy: func(tt, yy, *args), in_dims=(0, 1), out_dims=1)
    return lambda tv, yv: per_sample(tv[0], yv)


def _lane_event(event_fn):
    """Lane-vectorise a per-sample event function and sign-combine its
    outputs per sample: ``min_k(e_k * sign0_k)`` with sign0 (K, B), the
    kernel's event layout (JAX `_pallas_per_sample_event`'s `ev`)."""
    if isinstance(event_fn, LinearEvent):
        return event_fn     # combined with sign0 in the kernel
    one = lambda tt, yy, s_i: torch.min(
        torch.atleast_1d(event_fn(tt, yy)) * s_i)
    per_sample = torch.func.vmap(one, in_dims=(0, 1, 1), out_dims=0)
    return lambda tv, yv, sign0: per_sample(tv[0], yv, sign0)[None]


def _per_step_nfe(method):
    from ..ops.kernels import _tableau_consts
    alpha, _, _, _, _, _, fsal = _tableau_consts(method, np.float32)
    return len(alpha) + (0 if fsal else 1)


def odeint_per_sample(func, y0, t, args=(), args_axes=None, **kwargs):
    """Batched solve with independent per-sample step-size controllers.

    Args:
        func: vector field per sample, ``func(t, y_i, *args)`` with `y_i`
            one sample (no batch axis).  An `MLPField` runs in the CUDA
            kernel; any other field runs on CPU tensors only.
        y0: (B, D) initial states.
        t: (T,) shared increasing output times.
        **kwargs: ``rtol``, ``atol``, ``method`` and ``options``, which
            must include ``pallas=True`` (the kernel route).

    Returns:
        ys of shape (B, T, D).
    """
    ys, _ = odeint_per_sample_with_stats(func, y0, t, args=args,
                                         args_axes=args_axes, **kwargs)
    return ys


def odeint_per_sample_with_stats(func, y0, t, args=(), args_axes=None, *,
                                 rtol=1e-7, atol=1e-9, method=None,
                                 options=None, event_fn=None, **kwargs):
    """Like `odeint_per_sample`, also returning per-sample `Stats`, each
    counter a (B,) int32 tensor: ``nfe = per_step_nfe * n_steps + init``,
    ``n_rejected = n_steps - n_accepted``, and ``ERR_MAX_NUM_STEPS`` where
    a sample used all `max_num_steps` steps (JAX batched.py:114-147).

    With ``event_fn`` (a per-sample ``event_fn(t, y_i)`` with one or more
    outputs; a `LinearEvent` on CUDA) and `t` of shape (2,), each sample
    integrates until its own event fires, and the result is
    ``((event_t (B,), ys (B, 2, D)), Stats)`` with ``ys[:, 1]`` the state
    at the event; a sample whose event did not fire within `max_num_steps`
    steps has ``event_t`` NaN and ``ERR_MAX_NUM_STEPS``."""
    from ..ops.kernels import dopri5_integrate_batched, dopri5_events_batched

    t_np = _kernel_route(y0, t, rtol, atol, method, options, args_axes,
                         kwargs)
    if needs_autograd(func, y0, *args) or (event_fn is not None
                                            and needs_autograd(event_fn)):
        raise RuntimeError(
            "the per-sample kernel route is forward-only (as in the JAX "
            "package): call it under torch.no_grad(); differentiable "
            "per-sample solves come with the batched driver (ROADMAP A6)")
    method = method or 'dopri5'
    ts = t_np.astype(np_dtype(y0.dtype))
    if isinstance(func, MLPField) and not args:
        field = func   # the kernel's field family, evaluated in-kernel
    else:
        field = _lane_field(func, tuple(args))
    max_steps = int(options.get('max_num_steps', 10_000))
    control = dict(rtol=float(rtol), atol=float(atol), method=method,
                   max_steps=max_steps,
                   safety=float(options.get('safety', 0.9)),
                   ifactor=float(options.get('ifactor', 10.0)),
                   dfactor=float(options.get('dfactor', 0.2)),
                   first_step=options.get('first_step'))
    init_nfe = 1 if options.get('first_step') is not None else 2

    if event_fn is not None:
        # JAX `_pallas_per_sample_event` (batched.py:150-200): t is (t0, a
        # point giving the direction), and every sample stops at its own
        # event; the outputs are sign-combined with the signs at t0
        if t_np.shape[0] != 2:
            raise ValueError(
                "per-sample event solves require t of shape (2,) "
                f"(t0 and a horizon/direction point), got {t_np.shape}")
        t0 = torch.full((), float(ts[0]), dtype=y0.dtype, device=y0.device)
        sign0 = nan_sign(torch.func.vmap(
            lambda yy: torch.atleast_1d(event_fn(t0, yy)))(y0)).T.contiguous()
        et, ye, found, acc, stp = dopri5_events_batched(
            field, y0.T.contiguous(), ts[0], _lane_event(event_fn),
            ev_params=(sign0,), **control)
        result = (et[0], torch.stack([y0, ye.T], dim=1))
        failed = found[0] == 0
    else:
        ys, acc, stp = dopri5_integrate_batched(field, y0.T.contiguous(),
                                                ts[0], ts[-1], ts=ts,
                                                **control)
        result = ys.permute(2, 0, 1)   # (S, D, B) -> (B, S, D)
        failed = stp[0] >= max_steps

    stp_b, acc_b = stp[0], acc[0]
    stats = Stats.make(
        nfe=_per_step_nfe(method) * stp_b + init_nfe, n_steps=stp_b,
        n_accepted=acc_b, n_rejected=stp_b - acc_b,
        error_code=torch.where(failed, ERR_MAX_NUM_STEPS, OK).to(torch.int32))
    return result, stats
