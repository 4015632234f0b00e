"""Per-sample solves as one masked host loop over the batch: the batched
driver of ``parallel/batched.py`` (counterpart of the JAX package's
``jax.vmap(odeint_with_stats)``, torchdiffeq_tpu/parallel/batched.py:252-260).

JAX vmaps its whole solve: XLA lowers the solver's `while_loop` to one
batched loop whose body steps every lane and keeps a lane's old carry
wherever that lane's own loop condition is false, so lanes that finish
early idle until the last one finishes.  This module is that loop on the
host.  The carry holds (B,) tensors where `adaptive_rk._Carry` holds host
scalars: the times, the step size, the accept and active masks, the
counters, the error codes, ``steps_in_interval`` and the PI/PID ratios,
all on the state's device (times and ratios in float64).  Each iteration
steps every sample, updates only the samples still running with
``torch.where``, and makes ONE host read: whether any sample is still
running.  Every decision `adaptive_rk._adaptive_step` takes on the host is
a mask here, with the same arithmetic in the same order (dt-scaled
coefficients before the multiply-accumulate, the controllers in float64,
the initial step in the state dtype), so each sample's values and counters
are those of its own solve.

A field here is batched: ``func(t (B,), y (B, ...), perturb)`` (`LaneField`
over a per-sample ``fn(t_i, y_i, *args_i)``, whose time is a 0-d tensor in
the state dtype, as the host loop hands it), and so is a norm (``norm(x)
-> (B,)``, `lane_norm`).  Samples are never compacted out of the batch:
each sample's arithmetic sees the same shapes from the first step to the
last.  An accepted step that ends on a ``jump_t`` time re-evaluates the
slope (and runs ``jump_state_fn(k (B,), t1 (B,), y1)``, which gets every
sample's jump index, on every sample, and is kept where a sample jumped)
when some sample jumped: a second host read on such iterations.

The step is the tableau's explicit RK step (`lane_rk_step`), or an
implicit tableau's `AdaptiveConfig.step_fn`
(`adaptive_implicit.make_lane_step_fn`: each sample's own Newton solves,
one more host read an iteration of them), which the samples that do not
step skip.  A field's callbacks (`LaneField.callbacks`) fire per sample on
that sample's own steps (`fire_lanes`).  The same loop records every
sample's accepted steps for ``replay_grad`` (`record_lanes`), and
`replay_lanes` replays them differentiably, each iteration one segment of
every sample that has one.  The fixed-grid event loop
(`integrate_lanes_until_event_fixed_grid`) steps every sample on the shared
grid with any fixed-grid, Adams or implicit stepper, counting a stepper's
own NFE only while its sample steps.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..misc import (Perturb, _nextafter, coef, nan_sign, real_dtype, rms_norm,
                    scalar_type)
from ..ops.interp import coeff_dtype, cubic_hermite_interp, linear_interp
from ..ops.step_control import error_scale
from .adaptive_rk import (AdaptiveConfig, _check_no_duplicates,
                          _merged_step_t, _prep_tvals)
from .solution import (Stats, OK, ERR_DT_UNDERFLOW, ERR_NONFINITE_STATE,
                       ERR_MAX_NUM_STEPS)

F64 = torch.float64
_TINY64 = float(np.finfo(np.float64).tiny)

# the driver's work since `reset_lane_counts`: loop iterations (each steps
# every sample of the batch) and host reads
LANE_COUNTS = dict(iterations=0, host_reads=0)


def reset_lane_counts():
    for k in LANE_COUNTS:
        LANE_COUNTS[k] = 0


def _any(mask):
    """The one host read of an iteration: whether any sample is set."""
    LANE_COUNTS['host_reads'] += 1
    return bool(mask.any())


def lanes(v, x):
    """A (B,) tensor shaped to broadcast against a (B, ...) tensor `x`."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


class LaneField:
    """The batched field ``field(t (B,), y (B, ...), perturb)`` of a
    per-sample ``fn(t_i, y_i, *args_i)``, vectorised by ``torch.func.vmap``
    with `in_dims` for the args (None: shared).  As `misc.PerturbedFunc`,
    the time is cast to the state's real dtype and nudged one ULP for a
    perturbed evaluation, and `t_sign` maps the internal frame to the
    user's."""

    def __init__(self, fn, args=(), in_dims=(), t_sign=1.0, callbacks=None):
        self.vm = torch.func.vmap(fn, in_dims=(0, 0) + tuple(in_dims))
        self.args = tuple(args)
        self.t_sign = t_sign
        # {name: fire(t0, y_i, dt)}, each sample's own (`fire_lanes`)
        self.callbacks = callbacks or {}

    def __call__(self, t, y, perturb=Perturb.NONE):
        t = t.to(real_dtype(y.dtype))
        if perturb is not Perturb.NONE:
            t = _nextafter(t, perturb is Perturb.NEXT)
        if self.t_sign < 0:
            return -self.vm(-t, y, *self.args)
        return self.vm(t, y, *self.args)


def fire_lanes(func, name, mask, t0, y, dt):
    """Fire callback `name` of a batched field (`LaneField.callbacks`) for
    every sample in `mask`, with that sample's start time, state and step
    size, as its own solve fires it (JAX calls a callback back once per
    sample under vmap).  One host read, and only when the callback is
    there."""
    fire = getattr(func, 'callbacks', {}).get(name)
    if fire is None:
        return
    LANE_COUNTS['host_reads'] += 1
    m, ts, dts = (torch.stack([mask.to(F64), t0.to(F64), dt.to(F64)])
                  .tolist())
    for b, on in enumerate(m):
        if on:
            fire(ts[b], y[b], dts[b])


def lane_norm(norm):
    """A per-sample norm over a (B, ...) tensor, (B,): the RMS norm over
    every axis but the batch axis, else ``torch.func.vmap`` of `norm`, so
    that a user norm gets one sample, as JAX's vmap hands it one."""
    if norm is rms_norm:
        def rms(x):
            sq = x.abs() ** 2
            # a scalar sample is its own mean (`dim=()` would reduce all)
            return torch.sqrt(sq if x.dim() == 1 else torch.mean(
                sq, dim=tuple(range(1, x.dim()))))
        return rms
    return torch.func.vmap(norm)


# ---- the step's arithmetic on (B,) step sizes ------------------------------

def lane_weighted_sum(coeffs, vecs, dt=None, base=None):
    """`ops.rk_step.weighted_sum` with a (B,) `dt`: ``base + sum_i
    (coeffs[i] * dt) * vecs[i]``, each coefficient rounded to the dtype of
    `vecs` and scaled by its sample's dt (cast to that dtype) before the
    multiply-accumulate."""
    dtype = vecs[0].dtype
    if dt is not None:
        dt = dt.to(real_dtype(dtype))
    total = None
    for c, v in zip(coeffs, vecs):
        if c == 0.0:
            continue
        if dt is None:
            term = coef(c, dtype) * v
        else:
            term = lanes(coef(c, dtype) * dt, v) * v
        total = term if total is None else total + term
    if total is None:
        total = vecs[0].new_zeros(vecs[0].shape)
    return total if base is None else base + total


def lane_rk_step(func, y0, f0, t0, dt, t1, tableau, error_dtype=None):
    """`ops.rk_step.runge_kutta_step` with (B,) float64 times `t0`, `dt`,
    `t1`, cast to the state's real dtype as there.  Returns (y1, f1,
    y1_error, k)."""
    dtype = y0.dtype
    t0, dt, t1 = (x.to(real_dtype(dtype)) for x in (t0, dt, t1))
    k = [f0]
    yi = y0
    for i in range(len(tableau.alpha)):
        alpha_i = float(tableau.alpha[i])
        if alpha_i == 1.0:
            ti, perturb = t1, Perturb.PREV
        else:
            ti, perturb = t0 + coef(alpha_i, dtype) * dt, Perturb.NONE
        yi = lane_weighted_sum(tableau.beta[i, :i + 1], k[:i + 1], dt,
                               base=y0)
        k.append(func(ti, yi, perturb=perturb))
    y1 = yi if tableau.is_fsal else lane_weighted_sum(tableau.c_sol, k, dt,
                                                      base=y0)
    if error_dtype is not None:
        k_err = [x.to(error_dtype) for x in k]
    else:
        k_err = k
    return y1, k[-1], lane_weighted_sum(tableau.c_error, k_err, dt), tuple(k)


def lane_interp_fit_step(y0, y1, k, dt, tableau):
    """`ops.interp.interp_fit_step` with a (B,) float64 `dt`: the quartic's
    coefficients (5, B, ...)."""
    if coeff_dtype(y0.dtype) != y0.dtype:
        f32 = torch.float32
        dtf = dt.to(f32)
        kf = [x.to(f32) for x in k]
        d1 = lane_weighted_sum(tableau.c_sol, kf, dtf)
        dmid = lane_weighted_sum(tableau.c_mid, kf, dtf)
        dtb = lanes(dtf, kf[0])
        dtf0, dtf1 = dtb * kf[0], dtb * kf[-1]
        a = 2 * (dtf1 - dtf0) - 8 * d1 + 16 * dmid
        b = (5 * dtf0 - 3 * dtf1) + 14 * d1 - 32 * dmid
        c = (dtf1 - 4 * dtf0) - 5 * d1 + 16 * dmid
        return torch.stack([y0.to(f32), dtf0, c, b, a])
    return _lane_yform_fit(y0, y1, k, dt, tableau)


def _lane_yform_fit(y0, y1, k, dt, tableau):
    """The quartic's y-form coefficients in the state dtype
    (`ops.interp.interp_fit` of ``y_mid = y0 + sum((c_mid * dt) * k)``)."""
    dt = dt.to(real_dtype(y0.dtype))
    y_mid = lane_weighted_sum(tableau.c_mid, k, dt, base=y0)
    f0, f1 = k[0], k[-1]
    two_dt = lanes(coef(2.0, y0.dtype) * dt, y0)
    dtf = lanes(dt, y0)
    a = two_dt * (f1 - f0) - 8 * (y1 + y0) + 16 * y_mid
    b = dtf * (5 * f0 - 3 * f1) + 18 * y0 + 14 * y1 - 32 * y_mid
    c = dtf * (f1 - 4 * f0) - 11 * y0 - 5 * y1 + 16 * y_mid
    return torch.stack([y0, dtf * f0, c, b, a])


def _horner(coeff, x):
    """The quartic at normalised times `x` (leading axes that the
    coefficient rows broadcast against), in ascending powers."""
    total = coeff[0] + x * coeff[1]
    x_power = x
    for i in range(2, coeff.shape[0]):
        x_power = x_power * x
        total = total + x_power * coeff[i]
    return total


def lane_interp_at(coeff, t0, t1, t):
    """`ops.interp.interp_evaluate_at` with (B,) float64 `t0`, `t1`, `t`:
    no zero-width guard, as there."""
    x = ((t - t0) / (t1 - t0)).to(real_dtype(coeff.dtype))
    return _horner(coeff, lanes(x, coeff[0]))


def _lane_outputs(coeff, t0, t1, ts):
    """Every sample's quartic at every output time (`ts` (T,) or a row a
    sample, (B, T)): (B, T, ...), with the
    zero-width guard of `ops.interp.interp_evaluate` (a rejected step has
    ``t1 == t0``)."""
    denom = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
    ts = ts if ts.dim() == 2 else ts[None, :]
    x = ((ts - t0[:, None]) / denom[:, None]).to(
        real_dtype(coeff.dtype))
    rows = coeff[:, :, None]
    return _horner(rows, x.reshape(x.shape + (1,) * (rows.dim() - 3)))


def lane_initial_step(func, t0, y0, order, rtol, atol, norm, f0):
    """`ops.step_control.select_initial_step` for every sample: its norms
    over that sample alone, the arithmetic in the state's real dtype.  `t0`
    (B,) float64; returns the (B,) float64 steps (one field evaluation, no
    host read)."""
    dtype = real_dtype(y0.dtype)

    def c(v):
        return torch.full_like(d0, coef(v, dtype))

    scale = error_scale(rtol, atol, y0)
    d0 = norm(y0 / scale).abs().to(dtype)
    d1 = norm(f0 / scale).abs().to(dtype)
    tiny = c(torch.finfo(dtype).tiny)
    small = (d0 < c(1e-5)) | (d1 < c(1e-5))
    h0 = torch.where(small, c(1e-6),
                     c(0.01) * d0 / torch.maximum(d1, tiny)).abs()
    y1 = y0 + lanes(h0, f0) * f0
    f1 = func(t0.to(dtype) + h0, y1, perturb=Perturb.NONE)
    d2 = (norm((f1 - f0) / scale).to(dtype) / h0).abs()
    d_max = torch.maximum(d1, d2)
    flat = (d1 <= c(1e-15)) & (d2 <= c(1e-15))
    h1 = torch.where(
        flat, torch.maximum(c(1e-6), h0 * c(1e-3)),
        (c(0.01) / torch.maximum(d_max, tiny)) ** c(1.0 / float(order + 1)))
    return torch.minimum(c(100) * h0, h1.abs()).to(F64)


def _lane_next_dt(cfg, dt, ratio, prev, prev2):
    """`ops.step_control.optimal_step_size(_pi/_pid)` on (B,) float64
    tensors, in the same order of operations."""
    order = cfg.tableau.order

    def full(v):
        return torch.full_like(ratio, float(v))

    if cfg.controller == 'i':
        dfactor = torch.where(ratio < 1, full(1.0), full(cfg.dfactor))
        safe = torch.maximum(ratio, full(_TINY64))
        factor = torch.minimum(
            torch.maximum(full(cfg.safety) / safe ** (1.0 / order), dfactor),
            full(cfg.ifactor))
    else:
        err = torch.maximum(ratio, full(_TINY64))
        ki, kp = cfg.icoeff / order, cfg.pcoeff / order
        factor = float(cfg.safety) * err ** (-ki) * torch.maximum(
            prev, full(_TINY64)) ** kp
        if cfg.controller == 'pid':
            factor = factor * torch.maximum(
                prev2, full(_TINY64)) ** (-(cfg.dcoeff / order))
        factor = torch.minimum(torch.maximum(factor, full(cfg.dfactor)),
                               full(cfg.ifactor))
    factor = torch.where(ratio == 0, full(cfg.ifactor), factor)
    return dt * factor


# ---- the carry and one iteration --------------------------------------------

def _lane_tvals(tvals, t0):
    """A step_t or jump_t array on the device, (B, K) with each row sorted,
    and each sample's index of its first entry past the sample's start `t0`
    (B,) (`adaptive_rk._prep_tvals` per sample).  `tvals` is one array the
    samples share, or a (B, K) array, a row a sample (per-sample output
    times, `integrate_lanes`)."""
    if tvals is None or np.size(tvals) == 0:
        return None, None
    B, dev = t0.shape[0], t0.device
    tv = np.asarray(tvals, dtype=np.float64)
    if tv.ndim < 2:
        tv = torch.tensor(_prep_tvals(tv, 0.0)[0], dtype=F64, device=dev)
        idx = torch.searchsorted(tv, t0, right=True)
        tv = tv.expand(B, -1)
    else:
        tv = torch.tensor(np.sort(tv, axis=1), dtype=F64, device=dev)
        idx = torch.searchsorted(tv, t0[:, None].contiguous(), right=True)[:, 0]
    return tv, torch.clamp(idx, 0, tv.shape[1] - 1)


def _next_tval(tvals, idx):
    """Each sample's entry `idx` (B,) of its row of `tvals` (B, K)."""
    return tvals.gather(1, idx[:, None])[:, 0]


def _lane_carry(func, y0, t0, cfg: AdaptiveConfig, norm):
    """The per-sample carry after the initial slope and step (JAX
    `_setup` for every sample; `t0` one start time or a (B,) float64
    tensor of them, ``first_step`` a number or a (B,) tensor)."""
    B, dev = y0.shape[0], y0.device
    i32 = dict(dtype=torch.int32, device=dev)
    if isinstance(t0, torch.Tensor):
        t0_b = t0.to(device=dev, dtype=F64)
    else:
        t0_b = torch.full((B,), float(t0), dtype=F64, device=dev)
    f0 = func(t0_b, y0, perturb=Perturb.NONE)
    if cfg.first_step is None:
        dt = lane_initial_step(func, t0_b, y0, cfg.tableau.order - 1,
                               cfg.rtol, cfg.atol, norm, f0)
        nfe0 = 2
    else:
        dt = torch.as_tensor(cfg.first_step, dtype=F64).to(dev).expand(B)
        nfe0 = 1
    c = SimpleNamespace(
        y=y0, f=f0, t0=t0_b, t1=t0_b, dt=dt,
        coeff=None if cfg.step_to_end else y0.new_zeros(
            (5,) + tuple(y0.shape), dtype=coeff_dtype(y0.dtype)),
        nfe=torch.full((B,), nfe0, **i32), n_steps=torch.zeros(B, **i32),
        n_acc=torch.zeros(B, **i32), n_rej=torch.zeros(B, **i32),
        sii=torch.zeros(B, **i32), err=torch.full((B,), OK, **i32),
        prev=torch.ones(B, dtype=F64, device=dev),
        prev2=torch.ones(B, dtype=F64, device=dev))
    c.step_t, c.step_idx = _lane_tvals(cfg.step_t, t0_b)
    c.jump_t, c.jump_idx = _lane_tvals(cfg.jump_t, t0_b)
    return c


def _advance(idx, mask, tvals):
    if tvals is None:
        return idx
    return torch.where(mask & (idx != tvals.shape[1] - 1), idx + 1, idx)


def _lane_step(c, func, cfg: AdaptiveConfig, norm, run):
    """One accept-or-reject step of every sample in `run` (JAX
    `_adaptive_step` under vmap; the port's `adaptive_rk._adaptive_step`
    with masks).  The other samples' carry is kept as it was.  Returns the
    mask of samples that stepped (no guard tripped)."""
    tab = cfg.tableau
    min_step, max_step = float(cfg.min_step), float(cfg.max_step)
    t0 = c.t1
    dt = torch.where(torch.isfinite(c.dt), c.dt,
                     torch.full_like(c.dt, min_step))
    dt = torch.clamp(dt, min_step, max_step)
    fire_lanes(func, 'callback_step', run, t0, c.y, dt)  # rk_common.py:272

    # --- guards (reference asserts, rk_common.py:286-287) -----------------
    t1 = t0 + dt
    finite = torch.isfinite(c.y).reshape(c.y.shape[0], -1).all(1)
    err = torch.where(c.sii >= cfg.max_num_steps, ERR_MAX_NUM_STEPS, OK)
    err = torch.where((err == OK) & ~(t1 > t0), ERR_DT_UNDERFLOW, err)
    err = torch.where((err == OK) & ~finite, ERR_NONFINITE_STATE, err)
    c.err = torch.where(run, err.to(torch.int32), c.err)
    ok = run & (err == OK)
    # a sample's tripped guard fires its reject callback, as its own solve
    fire_lanes(func, 'callback_reject_step', run & ~ok, t0, c.y, dt)

    # --- step_t / jump_t truncation (JAX adaptive_rk.py:212-258) ----------
    on_step = on_jump = None
    if c.step_t is not None:
        v = _next_tval(c.step_t, c.step_idx)
        on_step = (t0 < v) & (v < t1)
        t1 = torch.where(on_step, v, t1)
    if c.jump_t is not None:
        v = _next_tval(c.jump_t, c.jump_idx)
        on_jump = (t0 < v) & (v < t1)
        if cfg.jump_state_fn is not None:
            on_jump = on_jump | ((t0 < v) & (v == t1))
        if on_step is not None:
            on_step = on_step & ~on_jump
        t1 = torch.where(on_jump, v, t1)
    truncated = [m for m in (on_step, on_jump) if m is not None]
    if truncated:
        dt = torch.where(truncated[0] | truncated[-1], t1 - t0, dt)

    # --- the RK step and its error ratio ----------------------------------
    if cfg.step_fn is None:
        y1, f1, y1_err, k = lane_rk_step(func, c.y, c.f, t0, dt, t1, tab,
                                         cfg.error_dtype)
    else:
        # an implicit tableau's step (`adaptive_implicit.make_lane_step_fn`):
        # the samples that do not step take no Newton iteration
        y1, f1, y1_err, k = cfg.step_fn(func, c.y, c.f, t0, dt, t1, tab,
                                        active=ok)
    # an implicit step reports its one explicit evaluation (JAX :266-269)
    c.nfe = c.nfe + torch.where(ok, 1 if tab.implicit else len(tab.alpha),
                                0).to(torch.int32)
    y0, ye0, ye1 = c.y, c.y, y1
    if cfg.error_dtype is not None:
        ye0, ye1 = y0.to(cfg.error_dtype), y1.to(cfg.error_dtype)
    ratio = norm(y1_err / error_scale(cfg.rtol, cfg.atol, ye0, ye1)).abs()
    ratio = ratio.to(F64)
    accept = ratio <= 1
    accept = torch.where(dt > max_step, False, accept)
    accept = torch.where(dt <= min_step, True, accept)
    accept = accept & ok

    # --- the quartic of the pre-jump step, then the far side of a jump ----
    if not cfg.step_to_end:
        fit = lane_interp_fit_step(y0, y1, k, dt, tab)
        c.coeff = torch.where(lanes(accept, fit[0])[None], fit, c.coeff)
    if on_jump is not None:
        jumped = accept & on_jump
        if _any(jumped):
            y_j = y1 if cfg.jump_state_fn is None else cfg.jump_state_fn(
                c.jump_idx, t1, y1)
            f_j = func(t1, y_j, perturb=Perturb.NEXT)
            y1 = torch.where(lanes(jumped, y1), y_j, y1)
            f1 = torch.where(lanes(jumped, f1), f_j, f1)
            c.nfe = c.nfe + jumped.to(torch.int32)

    # rk_common.py:339,354
    fire_lanes(func, 'callback_accept_step', accept, t0, y0, dt)
    fire_lanes(func, 'callback_reject_step', ok & ~accept, t0, y0, dt)
    keep = lanes(accept, y1)
    c.y = torch.where(keep, y1, y0)
    c.f = torch.where(keep, f1, c.f)
    c.t0 = torch.where(ok, t0, c.t0)
    c.t1 = torch.where(accept, t1, t0)
    dt_next = torch.clamp(_lane_next_dt(cfg, dt, ratio, c.prev, c.prev2),
                          min_step, max_step)
    if cfg.controller != 'i':
        if cfg.controller == 'pid':
            c.prev2 = torch.where(accept, c.prev, c.prev2)
        c.prev = torch.where(accept, ratio, c.prev)
    c.dt = torch.where(ok, dt_next, c.dt)
    if on_step is not None:
        c.step_idx = _advance(c.step_idx, accept & on_step, c.step_t)
    if on_jump is not None:
        c.jump_idx = _advance(c.jump_idx, accept & on_jump, c.jump_t)
    ok_i = ok.to(torch.int32)
    c.n_steps = c.n_steps + ok_i
    c.sii = c.sii + ok_i
    c.n_acc = c.n_acc + accept.to(torch.int32)
    c.n_rej = c.n_rej + (ok & ~accept).to(torch.int32)
    return ok


def _stats(c):
    return Stats.make(nfe=c.nfe, n_steps=c.n_steps, n_accepted=c.n_acc,
                      n_rejected=c.n_rej, error_code=c.err, final_dt=c.dt)


# ---- the solves ---------------------------------------------------------------

def _row(tvals, b):
    """Sample b's step_t or jump_t: its row of a (B, K) array, or the one
    array every sample shares."""
    return tvals[b] if tvals is not None and np.ndim(tvals) == 2 else tvals


def _lane_merged_cfg(cfg, ts_np):
    """The configuration of a solve with per-sample output times `ts_np`
    (B, T): step_to_end's forced boundaries (`_merged_step_t`) a row a
    sample, each row checked for a time in both step_t and jump_t."""
    rows = []
    for b in range(ts_np.shape[0]):
        cfg_b = cfg._replace(step_t=_row(cfg.step_t, b),
                             jump_t=_row(cfg.jump_t, b))
        _check_no_duplicates(cfg_b.step_t, cfg_b.jump_t)
        if cfg.step_to_end:
            rows.append(_merged_step_t(cfg_b, ts_np[b]))
    return cfg._replace(step_t=np.stack(rows)) if rows else cfg


def integrate_lanes(func, y0, ts, cfg: AdaptiveConfig, norm, t0=None,
                    ts_t=None):
    """Integrate every sample of `y0` (B, ...) to every time in `ts`, each
    with its own controller: `adaptive_rk.integrate` per sample.  `ts` is
    one increasing float64 host array that the samples share, or a (B, T)
    float64 tensor, a row of increasing times a sample, from which each
    sample starts, to which it emits and at whose end it stops (JAX's vmap
    of a solve over per-sample `t`, the fine sweep of Parareal).  `func`
    and `norm` are batched (module docstring).  Each sample writes output
    j when its accepted step covers its time j, from its own quartic (or
    copies its state, with ``step_to_end``); a sample whose error code is
    set has its unwritten outputs NaN.  `t0`, (B,) float64, starts each
    sample at its own time in place of ``ts[0]`` (the backward solve of a
    per-sample event, from each sample's event time).  `ts_t`, the shared
    times as a float64 tensor carrying tangents (``forward_grad``), gives
    the start and the emission times theirs, as `adaptive_rk.integrate`'s
    `ts_d`.  Returns (ys (B, T, ...), Stats of (B,) counters)."""
    B, dev = y0.shape[0], y0.device
    if isinstance(ts, torch.Tensor):
        ts_d = ts.to(device=dev, dtype=F64)
        cfg = _lane_merged_cfg(cfg, ts_d.cpu().numpy())
        t0 = ts_d[:, 0] if t0 is None else t0
        t_end = ts_d[:, -1]
    else:
        _check_no_duplicates(cfg.step_t, cfg.jump_t)
        if cfg.step_to_end:
            cfg = cfg._replace(step_t=_merged_step_t(cfg, ts))
        if ts_t is not None:
            ts_d = ts_t.to(device=dev, dtype=F64)
            t0 = ts_d[0].expand(B)
        else:
            ts_d = torch.tensor(ts, dtype=F64, device=dev)
        t_end = float(ts[-1])
    T = ts_d.shape[-1]
    c = _lane_carry(func, y0, ts[0] if t0 is None else t0, cfg, norm)
    out = y0.new_zeros((B, T) + tuple(y0.shape[1:]))
    out[:, 0] = y0
    i_out = torch.ones(B, dtype=torch.long, device=dev)
    while True:
        run = (c.t1 < t_end) & (c.err == OK)
        if not _any(run):
            break
        LANE_COUNTS['iterations'] += 1
        ok = _lane_step(c, func, cfg, norm, run)
        # --- emit every output time each sample's step covered -----------
        emit = (ts_d > c.t0[:, None]) & (ts_d <= c.t1[:, None]) & ok[:, None]
        if cfg.step_to_end:
            vals = c.y[:, None]
        else:
            vals = _lane_outputs(c.coeff, c.t0, c.t1, ts_d)
        out = torch.where(lanes(emit, out), vals.to(out.dtype), out)
        i_out = i_out + emit.sum(1)
        # max_num_steps bounds steps per output interval
        c.sii = torch.where(emit.any(1), 0, c.sii)
    # poison each failed sample's unwritten tail (adaptive_rk.integrate)
    rows = torch.arange(T, device=dev)
    poison = (c.err != OK)[:, None] & (rows[None, :] >= i_out[:, None])
    ys = torch.where(lanes(poison, out), float('nan'), out)
    return ys, _stats(c)


def record_lanes(func, y0, ts, cfg: AdaptiveConfig, norm, max_segments):
    """`replay.record_segments` for every sample: the batched loop with no
    graph (no emission, no callbacks), keeping each sample's accepted
    step boundaries, its own sequence and count.  `max_num_steps` is a
    budget for the whole span, as there.  Returns (times (B, K + 1) float64
    on the host, each row padded with its last time, counts (B,), Stats);
    a sample that needed more than `max_segments` steps has
    ``ERR_SEGMENT_OVERFLOW``."""
    from .replay import _bare
    from .solution import ERR_SEGMENT_OVERFLOW
    n_iv = max(ts.shape[0] - 1, 1)
    if cfg.max_num_steps < 2 ** 31 - 1:
        cfg = cfg._replace(
            max_num_steps=min(cfg.max_num_steps * n_iv, 2 ** 31 - 1))
    # no quartic: the recording emits nothing
    cfg = cfg._replace(step_to_end=True)
    bare = _bare(func)
    if isinstance(func, LaneField):
        bare = LaneField.__new__(LaneField)
        bare.__dict__.update(func.__dict__, callbacks={})
    t_end = float(ts[-1])
    with torch.no_grad():
        c = _lane_carry(bare, y0.detach(), ts[0], cfg, norm)
        t1s, accs = [c.t1], [torch.ones_like(c.t1, dtype=torch.bool)]
        while True:
            run = ((c.t1 < t_end) & (c.err == OK)
                   & (c.n_acc < max_segments))
            if not _any(run):
                break
            LANE_COUNTS['iterations'] += 1
            before = c.n_acc
            _lane_step(c, bare, cfg, norm, run)
            t1s.append(c.t1)
            accs.append(c.n_acc > before)
        t1s, accs = torch.stack(t1s, 1).cpu(), torch.stack(accs, 1).cpu()
    counts = accs.sum(1) - 1
    K = int(counts.max())
    times = np.empty((y0.shape[0], K + 1))
    for b in range(y0.shape[0]):
        row = t1s[b][accs[b]].numpy()
        times[b, :row.shape[0]] = row
        times[b, row.shape[0]:] = row[-1]
    over = (c.t1 < t_end) & (c.err == OK)
    c.err = torch.where(over, ERR_SEGMENT_OVERFLOW, c.err).to(torch.int32)
    # the recording's Stats carry no final step size, as `replay._stats`
    return times, counts.numpy(), _stats(c)._replace(
        final_dt=torch.zeros_like(c.dt))


def replay_lanes(func, y0, ts_d, cfg: AdaptiveConfig, times, counts):
    """`replay.replay_integrate` for every sample: iteration i replays
    segment i of every sample that has one (its own times, a constant) and
    keeps the others' state, as a lane of JAX's vmapped replay is masked;
    output j is emitted from the quartic of the segment of each sample that
    owns it.  Differentiable; an implicit tableau's stages carry their
    implicit-function derivatives (`cfg.step_fn`).  `ts_d` (T,) float64,
    which may carry derivatives.  Returns (B, T, ...)."""
    from .adaptive_rk import _prep_tvals
    B, dev = y0.shape[0], y0.device
    T = ts_d.shape[0]
    ts_np = ts_d.detach().cpu().numpy()
    tab = cfg.tableau
    seg = np.stack([np.searchsorted(times[b, :counts[b] + 1], ts_np,
                                    side='left') - 1 for b in range(B)])
    times_d = torch.from_numpy(times).to(dev)
    jump = None
    if cfg.jump_t is not None and np.size(cfg.jump_t):
        jump = _prep_tvals(cfg.jump_t, ts_np[0])[0]
    ts_dev = ts_d.to(dev)
    y = y0
    f = func(ts_dev[0].expand(B), y0, perturb=Perturb.NONE)
    outs = [y0] + [torch.zeros_like(y0)] * (T - 1)
    # every decision is the host's, from the recorded times: no host read
    for i in range(int(counts.max())):
        act = counts > i
        active = torch.from_numpy(act).to(dev)
        t0, t1 = times_d[:, i], times_d[:, i + 1]
        dt = t1 - t0
        if cfg.step_fn is None:
            y1, f1, _, k = lane_rk_step(func, y, f, t0, dt, t1, tab)
        else:
            y1, f1, _, k = cfg.step_fn(func, y, f, t0, dt, t1, tab,
                                       active=active)
        if jump is not None:
            at_jump = act & np.isin(times[:, i + 1], jump)
            if at_jump.any():
                f1 = torch.where(
                    lanes(torch.from_numpy(at_jump).to(dev), f1),
                    func(t1, y1, perturb=Perturb.NEXT), f1)
        emit = (seg == i) & act[:, None]
        if emit[:, 1:].any():
            coeff = _lane_yform_fit(y, y1, k, dt, tab)
            # a finished sample's empty segment would divide by zero, and
            # its unselected NaN would reach the gradient
            t1_safe = torch.where(active, t1, t0 + 1.0)
            for j in range(1, T):
                if emit[:, j].any():
                    val = lane_interp_at(coeff, t0, t1_safe,
                                         ts_dev[j].expand(B))
                    outs[j] = torch.where(
                        lanes(torch.from_numpy(emit[:, j]).to(dev), val),
                        val.to(y0.dtype), outs[j])
        keep = lanes(active, y1)
        y = torch.where(keep, y1, y)
        f = torch.where(keep, f1, f)
    return torch.stack(outs, 1)


def _lane_tol(tol):
    """The bisection tolerance: a per-element tolerance counts by its max
    (`events.find_event`)."""
    if isinstance(tol, torch.Tensor):
        return float(tol.max())
    return float(tol)


def integrate_lanes_until_event(func, y0, t0, event_fn, cfg: AdaptiveConfig,
                                norm):
    """Step every sample until its own event changes sign, then bisect its
    own last quartic (`adaptive_rk.integrate_until_event` per sample).

    `event_fn(t (B,) float64, y (B, ...)) -> (B,)` is the batched,
    sign-combined event function.  Each sample bisects
    ``ceil(log2(span_i / tol))`` times, its own count, as JAX's vmapped
    `fori_loop` with a traced trip count does: the loop runs the largest
    count and freezes each sample at its own.  A sample whose event is
    zero at `t0` takes ``(t0, y0)`` without a step.  Returns (event_t (B,)
    float64, y_event (B, ...), Stats)."""
    cfg = cfg._replace(step_to_end=False)
    c = _lane_carry(func, y0, t0, cfg, norm)
    t0_b = c.t0
    ev0 = event_fn(t0_b, y0)
    sign0 = nan_sign(ev0)
    at_event = ev0 == 0
    while True:
        # NaN == NaN is False: a NaN sign stops the sample, as in JAX
        run = ((nan_sign(event_fn(c.t1, c.y)) == sign0) & (c.err == OK)
               & ~at_event)
        if not _any(run):
            break
        LANE_COUNTS['iterations'] += 1
        _lane_step(c, func, cfg, norm, run)

    def interp(t):
        return lane_interp_at(c.coeff, c.t0, c.t1, t).to(y0.dtype)

    span = (c.t1 - c.t0).abs()
    nitrs = torch.ceil(torch.log2(torch.clamp_min(
        span / torch.full_like(span, _lane_tol(cfg.atol)), 1.0)))
    lo, hi = c.t0, c.t1
    LANE_COUNTS['host_reads'] += 1
    for i in range(int(nitrs.max())):
        t_mid = (lo + hi) / 2.0
        same = sign0 == nan_sign(event_fn(t_mid, interp(t_mid)))
        live = nitrs > i
        lo = torch.where(live & same, t_mid, lo)
        hi = torch.where(live & ~same, t_mid, hi)
    event_t = (lo + hi) / 2.0
    y_event = interp(event_t)
    event_t = torch.where(at_event, t0_b, event_t)
    y_event = torch.where(lanes(at_event, y0), y0, y_event)
    return event_t, y_event, _stats(c)


def integrate_lanes_until_event_fixed_grid(method, func, y0, t0, event_fn, *,
                                           step_size, interp="linear",
                                           perturb=False, atol=1e-9,
                                           max_itrs=20000):
    """`fixed_grid.integrate_until_event_fixed_grid` per sample: every
    sample steps on the same grid from `t0` until its own event changes
    sign (a sample that changed keeps its bracketing step), then bisects
    its own last interval's interpolant ``ceil(log2(span_i / tol))`` times
    in the state dtype, as `integrate_lanes_until_event`.

    `func(t, y (B, ...), perturb)` takes one time for the batch (the
    samples still stepping share it); `event_fn(t (B,), y)` takes the
    state dtype's times.  Returns (event_t (B,) float64, y_event, Stats)."""
    if step_size is None:
        raise ValueError(
            "Event handling for fixed step solvers currently requires "
            "`step_size` to be provided in options.")
    if interp not in ("linear", "cubic"):
        raise ValueError(f"Unknown interpolation method {interp}")
    cubic = interp == "cubic"
    B, dev, tdt = y0.shape[0], y0.device, y0.dtype
    sd = scalar_type(tdt)
    i32 = dict(dtype=torch.int32, device=dev)

    def times(t):
        return torch.full((B,), float(t), dtype=tdt, device=dev)

    t_now, dt = sd(t0), sd(step_size)
    sign0 = nan_sign(event_fn(times(t_now), y0))
    state = method.init_state(func, y0, t_now)
    # the NFE a stepper's state counts (the Adams corrector's), each
    # sample's only while it steps
    state_nfe = method.nfe_from_state
    extra_nfe = torch.zeros(B, **i32)
    ta, tb = times(t_now), times(t_now)
    ya = yb = y0
    fa = fb = torch.zeros_like(y0)
    itr = torch.zeros(B, **i32)
    changed = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        run = ~changed & (itr < max_itrs)
        if not _any(run):
            break
        LANE_COUNTS['iterations'] += 1
        t1 = t_now + dt
        nfe_before = None if state_nfe is None else state_nfe(state)
        dy, f0, state = method.step(func, t_now, dt, t1, ya, perturb, state)
        if state_nfe is not None:
            extra_nfe = extra_nfe + torch.where(
                run, torch.as_tensor(state_nfe(state) - nfe_before,
                                     device=dev), 0).to(torch.int32)
        y1 = ya + dy.to(tdt)
        f1 = func(t1, y1, perturb=Perturb.NONE) if cubic else fb
        # NaN != NaN: a NaN sign ends the sample's loop, as in JAX
        ch = nan_sign(event_fn(times(t1), y1)) != sign0
        keep = lanes(run, y1)
        tb = torch.where(run, times(t1), tb)
        yb = torch.where(keep, y1, yb)
        fa = torch.where(keep, f0.to(tdt), fa)
        fb = torch.where(keep, f1, fb)
        adv = run & ~ch
        ta = torch.where(adv, times(t1), ta)
        ya = torch.where(lanes(adv, y1), y1, ya)
        itr = itr + run.to(torch.int32)
        changed = changed | (run & ch)
        t_now = t1

    if cubic:
        def interp_fn(t):
            return cubic_hermite_interp(ta, ya, fa, tb, yb, fb, t)
    else:
        def interp_fn(t):
            return linear_interp(ta, tb, ya, yb, t)

    span = (tb - ta).abs()
    nitrs = torch.ceil(torch.log2(torch.maximum(
        span / torch.full_like(span, float(sd(_lane_tol(atol)))),
        torch.ones_like(span))))
    lo, hi = ta, tb
    LANE_COUNTS['host_reads'] += 1
    for i in range(int(nitrs.max())):
        t_mid = (lo + hi) / 2.0
        same = sign0 == nan_sign(event_fn(t_mid, interp_fn(t_mid)))
        live = nitrs > i
        lo = torch.where(live & same, t_mid, lo)
        hi = torch.where(live & ~same, t_mid, hi)
    event_t = (lo + hi) / 2.0
    y_event = interp_fn(event_t)
    nfe = itr * (method.nfe_per_step + (1 if cubic else 0)) + extra_nfe
    stats = Stats.make(nfe=nfe, n_steps=itr, n_accepted=itr,
                       n_rejected=torch.zeros_like(itr),
                       error_code=torch.where(changed, OK, ERR_MAX_NUM_STEPS
                                              ).to(torch.int32),
                       final_dt=torch.zeros(B, dtype=F64, device=dev))
    return event_t.to(F64), y_event, stats
