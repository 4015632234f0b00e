"""The port's CUDA kernels, each with its plain PyTorch version (counterpart
of ``torchdiffeq_tpu/ops/pallas_kernels.py``).

* `rk4_integrate` runs the whole fixed-grid RK4 (3/8 rule) loop in one
  kernel (``csrc/rk4.cu``), replacing the Pallas kernel of the same name.
* `dopri5_integrate_batched` runs adaptive explicit RK with a step-size
  controller per trajectory (``csrc/dopri5_lanes.cu``), replacing the
  Pallas kernel of the same name.

A Pallas kernel traces any JAX field into itself; a CUDA kernel cannot run
a Python callable.  So the kernels take one field family, `MLPField` with
one tanh hidden layer (ROADMAP B, "Field interface"), while the plain
versions `*_ref` take any callable.  A wrapper takes the plain version only
for tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
Both kernels are forward-only, as in the JAX package.

`launch_counts` counts kernel launches per wrapper, so a run can show that
a path went through the kernels.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..misc import host_times, needs_autograd, np_dtype
from ..models.neural_ode import MLPField
from . import tableaus
from . import _build

# explicit adaptive tableaus the per-lane solve takes (as in the JAX
# package); the CUDA kernel holds those of at most 7 stages
PER_LANE_METHODS = ('dopri5', 'tsit5', 'bosh3', 'fehlberg2',
                    'adaptive_heun', 'dopri8')
_KERNEL_MAX_D = 8
_KERNEL_MAX_ALPHA = 6
_SMEM_LIMIT = 48 * 1024

launch_counts = {'rk4_integrate': 0, 'dopri5_integrate_batched': 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _refuse_grad(field, y0, params):
    if needs_autograd(field, y0, *params):
        raise RuntimeError(
            "this solve is forward-only (as the JAX kernels are): call it "
            "under torch.no_grad(), or use requires_grad=False inputs")


def _kernel_mlp(field, params, y_dtype, device, D, kernel):
    """Check that `field` is what the CUDA kernels take and return its
    contiguous (w1, b1, w2, b2)."""
    if not isinstance(field, MLPField) or params:
        raise TypeError(
            f"the CUDA {kernel} kernel takes an MLPField with no extra "
            "params (the one field family a CUDA kernel can evaluate: "
            "tanh(y**p @ W1 + b1) @ W2 + b2); got "
            f"{type(field).__name__} with {len(params)} params")
    if len(field.weights) != 2:
        raise ValueError(f"the CUDA {kernel} kernel takes an MLPField with "
                         f"one hidden layer, got sizes {field.sizes}")
    w1, w2 = field.weights
    b1, b2 = field.biases
    H = w1.shape[1]
    if w1.shape[0] != D or w2.shape != (H, D):
        raise ValueError(f"MLPField sizes {field.sizes} do not map the "
                         f"state dimension {D} to itself")
    if not 1 <= D <= _KERNEL_MAX_D:
        raise ValueError(f"the CUDA {kernel} kernel takes 1 <= D <= "
                         f"{_KERNEL_MAX_D}, got D={D}")
    ws = [w.detach() for w in (w1, b1, w2, b2)]
    for w in ws:
        if w.dtype != y_dtype or w.device != device:
            raise ValueError(f"MLPField weights ({w.dtype}, {w.device}) must "
                             f"match the state ({y_dtype}, {device})")
    return [w.contiguous() for w in ws], H


def _check_cuda_state(y, kernel):
    if y.device.type != 'cuda':
        raise ValueError(f"{kernel}: tensors on {y.device} are neither CPU "
                         "(plain version) nor CUDA (kernel)")
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: the kernel takes float32 or float64 "
                        f"state, got {y.dtype}")
    if y.dim() != 2 or not y.is_contiguous():
        raise ValueError(f"{kernel}: the kernel takes a contiguous 2-D "
                         f"state, got shape {tuple(y.shape)}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# K-rk4: fixed-grid RK4 (3/8 rule) over the whole time loop.
# ---------------------------------------------------------------------------

def _rk4_step(field, t0, dt, y, params):
    """One RK4 3/8-rule step in `_rk4_step_inline`'s exact operation order
    (pallas_kernels.py:45-53); t0 and dt are numpy scalars in the state
    dtype."""
    sd = type(dt)
    third = sd(1.0 / 3)
    k1 = field(torch.as_tensor(t0, dtype=y.dtype), y, *params)
    k2 = field(torch.as_tensor(t0 + dt * third, dtype=y.dtype),
               y + float(dt * third) * k1, *params)
    k3 = field(torch.as_tensor(t0 + dt * sd(2) * third, dtype=y.dtype),
               y + float(dt) * (k2 - float(third) * k1), *params)
    k4 = field(torch.as_tensor(t0 + dt, dtype=y.dtype),
               y + float(dt) * (k1 - k2 + k3), *params)
    return y + float(dt * sd(0.125)) * (k1 + 3 * (k2 + k3) + k4)


def rk4_integrate_ref(field, y0, t0, dt, n_steps, params=(), *,
                      out_every=None):
    """Plain PyTorch version of `rk4_integrate`: the JAX kernel's scan
    fallback (pallas_kernels.py:108-117), for any ``field(t, y, *params)``
    on a (B, D) state."""
    sd = np_dtype(y0.dtype)
    t0, dt, n_steps = sd(t0), sd(dt), int(n_steps)
    out_every = _check_out_every(n_steps, out_every)
    y = y0
    rows = [y0]
    for i in range(n_steps):
        y = _rk4_step(field, t0 + sd(i) * dt, dt, y, params)
        if out_every is not None and (i + 1) % out_every == 0:
            rows.append(y)
    return y if out_every is None else torch.stack(rows)


def _check_out_every(n_steps, out_every):
    if out_every is None:
        return None
    out_every = int(out_every)
    if out_every <= 0 or n_steps % out_every != 0:
        raise ValueError("out_every must be a positive divisor of "
                         f"n_steps ({n_steps}), got {out_every}")
    return out_every


def rk4_integrate(field, y0, t0, dt, n_steps, params=(), *, out_every=None):
    """Integrate ``dy/dt = field(t, y, *params)`` with `n_steps` RK4 steps
    of size `dt` from `t0` (JAX ``rk4_integrate``, pallas_kernels.py:56).

    Args:
        field: an `MLPField` (CPU or CUDA), or any callable (CPU only).
        y0: (B, D) initial states.
        t0, dt: scalars, cast to the state dtype.
        out_every: optional stride dividing `n_steps`: return the
            (n_steps // out_every + 1, B, D) trajectory with row 0 = y0.

    Returns:
        (B, D) final states, or the trajectory with `out_every`.
    """
    _refuse_grad(field, y0, params)
    if y0.device.type == 'cpu':
        return rk4_integrate_ref(field, y0, t0, dt, n_steps, params,
                                 out_every=out_every)
    _check_cuda_state(y0, 'rk4_integrate')
    B, D = y0.shape
    (w1, b1, w2, b2), H = _kernel_mlp(field, params, y0.dtype, y0.device, D,
                                      'rk4_integrate')
    sd = np_dtype(y0.dtype)
    n_steps = int(n_steps)
    out_every = _check_out_every(n_steps, out_every)
    shared = (2 * D * H + H + D) * y0.element_size()
    if shared > _SMEM_LIMIT:
        raise ValueError(f"rk4_integrate: MLP of {shared} bytes exceeds the "
                         f"kernel's {_SMEM_LIMIT}-byte shared memory")
    if out_every is None:
        out = torch.empty_like(y0)
    else:
        out = y0.new_empty((n_steps // out_every + 1, B, D))
    if B == 0:
        return out
    lib = _build.library()
    code = lib.tdt_rk4(
        0 if y0.dtype == torch.float32 else 1, B, D, H, field.power,
        _ptr(y0), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), float(sd(dt)),
        n_steps, out_every or 0, _ptr(out), _stream(y0.device))
    _build.check(lib, code, 'rk4_integrate')
    launch_counts['rk4_integrate'] += 1
    return out


# ---------------------------------------------------------------------------
# K-dopri5: per-lane adaptive explicit RK.
# ---------------------------------------------------------------------------

def _tableau_consts(method, sd):
    """The tableau in the state dtype (JAX `_tableau_consts`,
    pallas_kernels.py:182)."""
    if method not in PER_LANE_METHODS:
        raise ValueError(f"per-lane method must be one of {PER_LANE_METHODS},"
                         f" got {method!r}")
    tab = getattr(tableaus, method.upper())
    return (np.asarray(tab.alpha, sd), np.asarray(tab.beta, sd),
            np.asarray(tab.c_sol, sd), np.asarray(tab.c_error, sd),
            np.asarray(tab.c_mid, sd), int(tab.order), bool(tab.is_fsal))


def _as_lane_field(field):
    """An `MLPField` maps (..., D) rows; the per-lane solve evaluates its
    field on the (D, B) lane layout."""
    if isinstance(field, MLPField):
        return lambda tv, yv: field(tv, yv.T).T
    return field


def _lincomb(coeffs, ks):
    """``sum_j coeffs[j] * ks[j]`` over the nonzero coefficients."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        term = float(c) * k
        acc = term if acc is None else acc + term
    return acc


def dopri5_integrate_batched_ref(field, y0, t0, t1, *, ts=None, rtol=1e-4,
                                 atol=1e-6, method='dopri5', params=(),
                                 max_steps=10_000, safety=0.9, ifactor=10.0,
                                 dfactor=0.2, first_step=None):
    """Plain PyTorch version of `dopri5_integrate_batched`: the TPU
    kernel's lane arithmetic (pallas_kernels.py:238-333, :424-534) on the
    whole batch at once, with one host read per step.

    `field(t, y, *params)` takes t of shape (1, B) and y of shape (D, B)
    (an `MLPField` is applied to the rows of ``y.T``).  A lane steps while
    ``t < t1`` and it has taken fewer than `max_steps` steps.
    """
    f_lane = _as_lane_field(field)
    f = lambda tv, yv: f_lane(tv, yv, *params)
    D, B = y0.shape
    sd = np_dtype(y0.dtype)
    alpha, beta, c_sol, c_err, c_mid, order, fsal = _tableau_consts(method, sd)
    t_start, t_end = sd(t0), sd(t1)
    emit_ts = [t_end] if ts is None else [sd(v) for v in host_times(ts)]
    rtol, atol = float(sd(rtol)), float(sd(atol))
    tiny = float(np.finfo(sd).tiny)
    inv_order = float(sd(1.0 / order))

    def lane_rms(v):
        return torch.sqrt((v * v).sum(dim=0, keepdim=True) / float(D))

    y = y0
    t = y0.new_full((1, B), float(t_start))
    fc = f(t, y)
    if first_step is not None:
        dt = y0.new_full((1, B), float(sd(first_step)))
    else:   # `hairer_dt`
        scale = atol + rtol * y.abs()
        d0 = lane_rms(y / scale)
        d1 = lane_rms(fc / scale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                         torch.full_like(d0, 1e-6),
                         0.01 * d0 / torch.clamp_min(d1, tiny))
        fp = f(t + h0, y + h0 * fc)
        d2 = lane_rms((fp - fc) / scale) / torch.clamp_min(h0, tiny)
        d_max = torch.maximum(d1, d2)
        h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                         torch.clamp_min(h0 * 1e-3, 1e-6),
                         (0.01 / torch.clamp_min(d_max, tiny)) ** inv_order)
        dt = torch.minimum(100.0 * h0, h1)

    out = [torch.where(t >= float(t_s), y, torch.zeros_like(y))
           for t_s in emit_ts]
    n_acc = torch.zeros((1, B), dtype=torch.int32, device=y0.device)
    n_steps = torch.zeros_like(n_acc)
    while True:
        active = (t < float(t_end)) & (n_steps < max_steps)
        if not bool(active.any()):
            break
        dt_c = torch.where(active, dt, torch.zeros_like(dt))
        t_prop = t + dt_c

        # stage sweep: coefficient sums first, then the dt multiply
        ks = [fc]
        yi = y
        for i in range(len(alpha)):
            yi = y + dt_c * _lincomb(beta[i, :i + 1], ks)
            ks.append(f(t + float(alpha[i]) * dt_c, yi))
        y1 = yi if fsal else y + dt_c * _lincomb(c_sol, ks)
        f1 = ks[-1] if fsal else f(t_prop, y1)
        err = dt_c * _lincomb(c_err, ks)

        tol = atol + rtol * torch.maximum(y.abs(), y1.abs())
        ratio = lane_rms(err / tol)
        accept = (ratio <= 1.0) & active

        # dense output for every output time this step covers
        y_mid = y + dt_c * _lincomb(c_mid, ks)
        ca = 2 * dt_c * (f1 - fc) - 8 * (y1 + y) + 16 * y_mid
        cb = dt_c * (5 * fc - 3 * f1) + 18 * y + 14 * y1 - 32 * y_mid
        cc = dt_c * (f1 - 4 * fc) - 11 * y - 5 * y1 + 16 * y_mid
        cd = dt_c * fc
        dt_safe = torch.where(dt_c > 0, dt_c, torch.ones_like(dt_c))
        for s, t_s in enumerate(emit_ts):
            covered = accept & (t < float(t_s)) & (t_prop >= float(t_s))
            x = (float(t_s) - t) / dt_safe
            xp = x * x
            val = (y + x * cd) + xp * cc
            xp = xp * x
            val = val + xp * cb
            xp = xp * x
            val = val + xp * ca
            out[s] = torch.where(covered, val, out[s])

        y = torch.where(accept, y1, y)
        fc = torch.where(accept, f1, fc)
        t = torch.where(accept, t_prop, t)
        dfac = torch.where(ratio < 1.0, torch.ones_like(ratio),
                           torch.full_like(ratio, dfactor))
        factor = torch.clamp_max(
            torch.maximum(safety / torch.clamp_min(ratio, tiny) ** inv_order,
                          dfac), ifactor)
        dt = torch.where(active, dt_c * factor, dt)
        n_acc += accept.to(torch.int32)
        n_steps += active.to(torch.int32)

    ys = torch.stack([torch.where(t >= float(t_s), o,
                                  torch.full_like(o, float('nan')))
                      for t_s, o in zip(emit_ts, out)])
    return (ys[0] if ts is None else ys), n_acc, n_steps


def dopri5_integrate_batched(field, y0, t0, t1, *, ts=None, rtol=1e-4,
                             atol=1e-6, method='dopri5', params=(),
                             max_steps=10_000, safety=0.9, ifactor=10.0,
                             dfactor=0.2, first_step=None):
    """Adaptive explicit RK over a batch of independent ODEs, each lane with
    its own step-size controller (JAX ``dopri5_integrate_batched``,
    pallas_kernels.py:336).

    Args:
        field: an `MLPField` (CPU or CUDA), or any lane-layout callable
            ``field(t (1, B), y (D, B), *params)`` (CPU only).
        y0: (D, B) initial states, batch on the LAST axis.
        t0, t1: scalars; ts: optional increasing (S,) output times in
            [t0, t1] (default: t1 only).
        rtol, atol, max_steps, safety/ifactor/dfactor, first_step:
            controller settings shared by all lanes.

    Returns:
        (ys (S, D, B), or (D, B) without `ts`; n_accepted (1, B) int32;
        n_steps (1, B) int32).  Rows a lane never reached are NaN.

    Deviation from the JAX kernel: a lane stops after `max_steps` steps.
    The JAX kernel loops while ANY lane of its tile is live, so a lane that
    ran out of steps keeps stepping while others run; its counts then
    depend on the tile it shares (they agree whenever every lane that runs
    out does so at the same time, e.g. when the others are done).
    """
    _refuse_grad(field, y0, params)
    if ts is not None:
        ts = host_times(ts)
        if not (np.diff(ts) > 0).all():
            raise ValueError("ts must be strictly increasing")
    if y0.device.type == 'cpu':
        return dopri5_integrate_batched_ref(
            field, y0, t0, t1, ts=ts, rtol=rtol, atol=atol, method=method,
            params=params, max_steps=max_steps, safety=safety,
            ifactor=ifactor, dfactor=dfactor, first_step=first_step)
    _check_cuda_state(y0, 'dopri5_integrate_batched')
    D, B = y0.shape
    (w1, b1, w2, b2), H = _kernel_mlp(field, params, y0.dtype, y0.device, D,
                                      'dopri5_integrate_batched')
    sd = np_dtype(y0.dtype)
    alpha, beta, c_sol, c_err, c_mid, order, fsal = _tableau_consts(method, sd)
    n_alpha = len(alpha)
    if n_alpha > _KERNEL_MAX_ALPHA:
        raise ValueError(
            f"the CUDA per-lane kernel holds tableaus of at most "
            f"{_KERNEL_MAX_ALPHA + 1} stages; {method} has {n_alpha + 1}")
    packed = np.zeros(_KERNEL_MAX_ALPHA * (_KERNEL_MAX_ALPHA + 1)
                      + 3 * (_KERNEL_MAX_ALPHA + 1), sd)
    packed[:n_alpha] = alpha
    m = _KERNEL_MAX_ALPHA
    packed[m:m + m * m].reshape(m, m)[:n_alpha, :n_alpha] = beta
    for i, vec in enumerate((c_sol, c_err, c_mid)):
        start = m + m * m + i * (m + 1)
        packed[start:start + n_alpha + 1] = vec
    emit_ts = np.array([t1] if ts is None else ts, dtype=sd)
    S = emit_ts.shape[0]
    shared = (2 * D * H + H + D + packed.size + S) * y0.element_size()
    if shared > _SMEM_LIMIT:
        raise ValueError(f"dopri5_integrate_batched: MLP, tableau and {S} "
                         f"output times need {shared} bytes of shared "
                         f"memory, above the kernel's {_SMEM_LIMIT}")
    dev = y0.device
    tab_d = torch.from_numpy(packed).to(dev)
    ts_d = torch.from_numpy(emit_ts).to(dev)
    ys = y0.new_empty((S, D, B))
    n_acc = torch.empty((1, B), dtype=torch.int32, device=dev)
    n_steps = torch.empty((1, B), dtype=torch.int32, device=dev)
    if B > 0:
        lib = _build.library()
        code = lib.tdt_dopri5_lanes(
            0 if y0.dtype == torch.float32 else 1, B, D, H, field.power,
            _ptr(y0), _ptr(ts_d), S, float(sd(t0)), float(sd(t1)),
            float(sd(rtol)), float(sd(atol)), float(sd(safety)),
            float(sd(ifactor)), float(sd(dfactor)),
            0.0 if first_step is None else float(sd(first_step)),
            int(first_step is not None), int(max_steps), _ptr(tab_d),
            n_alpha, order, int(fsal), _ptr(w1), _ptr(b1), _ptr(w2),
            _ptr(b2), _ptr(ys), _ptr(n_acc), _ptr(n_steps), _stream(dev))
        _build.check(lib, code, 'dopri5_integrate_batched')
        launch_counts['dopri5_integrate_batched'] += 1
    return (ys[0] if ts is None else ys), n_acc, n_steps
