"""The port's CUDA kernels, each with its plain PyTorch version (counterpart
of ``torchdiffeq_tpu/ops/pallas_kernels.py``).

* `rk4_integrate` runs the whole fixed-grid RK4 (3/8 rule) loop in one
  kernel (``csrc/rk4.cu``), replacing the Pallas kernel of the same name.
* `dopri5_integrate_batched` runs adaptive explicit RK with a step-size
  controller per trajectory (``csrc/dopri5_lanes.cuh``), replacing the
  Pallas kernel of the same name.
* `dopri5_events_batched` runs the same per-trajectory solve until each
  trajectory's event changes sign and bisects its event time
  (``csrc/dopri5_events.cuh``), replacing the Pallas kernel of the same name.
  Both take float32, float64, bfloat16 and float16 states; the 16-bit
  instances are compiled by ``csrc/dopri5_lanes_16bit.cu`` and
  ``csrc/dopri5_events_16bit.cu``.

A Pallas kernel traces any JAX field into itself; a CUDA kernel cannot run
a Python callable.  So the kernels take two kinds of field on the card:

* `MLPField` with one tanh hidden layer (and, for K-events, a `LinearEvent`),
  evaluated by hand-tuned device code (``csrc/mlp_field.cuh``) in every
  dtype, a group of lanes splitting its hidden units; K-rk4 takes this
  family alone;
* for K-dopri5 and K-events, any per-sample field ``func(t, y_i, *args_i)``
  (`ops.traced.PerSampleField`, with shared and per-lane args) and event
  function (`ops.traced.PerSampleEvent`), traced by ``torch.fx`` into a
  C++ functor and compiled at first use into an instance of its own (every
  dtype, a 16-bit one on ``tdt::Lo``; the traced op set is in
  ``ops/traced.py``: indexing, stack,
  + - * / and powers, sin cos exp log tanh sqrt abs minimum maximum where,
  @ by a shared matrix and sum).  A field outside the set raises
  ``TypeError`` naming the operation.

The plain versions `*_ref` take any lane-layout callable.  A wrapper takes
the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.  The kernels are forward-only, as in the JAX
package.

`launch_counts` counts kernel launches per wrapper, and
`traced_launch_counts` the traced instances' launches, so a run can show
that a path went through the kernels; the first also counts the fused-step
kernel of `ops/fused_field.py`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..misc import coef, host_times, nan_sign, needs_autograd, np_dtype
from ..models.neural_ode import LinearEvent, MLPField, is_kernel_mlp
from . import tableaus
from . import _build
from . import traced
from .traced import PerSampleEvent, PerSampleField

# explicit adaptive tableaus the per-lane solve takes (as in the JAX
# package), all of them in the CUDA kernels
PER_LANE_METHODS = ('dopri5', 'tsit5', 'bosh3', 'fehlberg2',
                    'adaptive_heun', 'dopri8')
# K-rk4's state sizes and shared memory (csrc/rk4.cu)
_KERNEL_MAX_D = 8
_SMEM_LIMIT = 48 * 1024
# K-dopri5 and K-events: the packed tableau holds up to 14 stages (dopri8's
# 13 alphas; csrc/lane_ops.cuh); problems of D <= 8 and at most 7 stages run
# the instances that hold a trajectory in registers, all others the
# shared-memory instances (`_lane_plan`)
_PACK_ALPHA = 13
_REG_MAX_D = 8
_REG_MAX_ALPHA = 6
_LANE_THREADS = 128
# K-rk4, K-dopri5 and K-events give a trajectory a group of lanes until the
# batch has this many threads (512 on each of an H100's 132 SMs, rounded
# down to a power of two)
_RK4_THREADS = 65536

launch_counts = {'rk4_integrate': 0, 'dopri5_integrate_batched': 0,
                 'dopri5_events_batched': 0, 'fused_stage_step': 0}
# the traced instances' launches, by the wrapper that launched them
traced_launch_counts = {'dopri5_integrate_batched': 0,
                        'dopri5_events_batched': 0}
# a traced instance's trajectories a block (one lane each): blocks of a warp
# until the batch fills every SM of an H100 with one, then 128
_TRACED_SMS = 132


def reset_launch_counts():
    for counts in (launch_counts, traced_launch_counts):
        for name in counts:
            counts[name] = 0


def _refuse_grad(field, y0, params):
    if needs_autograd(field, y0, *params):
        raise RuntimeError(
            "this solve is forward-only (as the JAX kernels are): call it "
            "under torch.no_grad(), or use requires_grad=False inputs")


def _kernel_mlp(field, params, y_dtype, device, D, kernel, max_d=None):
    """Check that `field` is what the CUDA kernels take (and D at most
    `max_d`, where the kernel has such a bound) and return its contiguous
    (w1, b1, w2, b2)."""
    if not is_kernel_mlp(field) or params:
        what = (f"an MLPField with activation {field.activation!r}"
                if isinstance(field, MLPField) else type(field).__name__)
        raise TypeError(
            f"the CUDA {kernel} kernel takes an MLPField with tanh and no "
            "extra params (the field family its hand-written code "
            "evaluates: tanh(y**p @ W1 + b1) @ W2 + b2)"
            + ("" if kernel == 'rk4_integrate' else
               ", or a traced per-sample field (ops.traced.PerSampleField, "
               "what odeint_per_sample(..., options=dict(pallas=True)) "
               "passes)")
            + f"; got {what} with {len(params)} params")
    # read from the lists' parameter dicts, in order: indexing an
    # nn.ParameterList costs microseconds an entry, and this runs per launch
    weights, biases = (tuple(p._parameters.values())
                       for p in (field.weights, field.biases))
    if len(weights) != 2:
        raise ValueError(f"the CUDA {kernel} kernel takes an MLPField with "
                         f"one hidden layer, got sizes {field.sizes}")
    (w1, w2), (b1, b2) = weights, biases
    H = w1.shape[1]
    if w1.shape[0] != D or w2.shape != (H, D):
        raise ValueError(f"MLPField sizes {field.sizes} do not map the "
                         f"state dimension {D} to itself")
    if max_d is not None and not 1 <= D <= max_d:
        raise ValueError(f"the CUDA {kernel} kernel takes 1 <= D <= "
                         f"{max_d}, got D={D}")
    return _kernel_tensors((w1, b1, w2, b2), y_dtype, device,
                           "MLPField weights"), H


def _kernel_tensors(ws, y_dtype, device, what):
    """`ws` as the kernels read them (contiguous), after checking that they
    match the state's dtype and device.  The kernels read them in place, so
    an in-place update between calls is seen by the next launch."""
    for w in ws:
        if w.dtype != y_dtype or w.device != device:
            raise ValueError(f"{what} ({w.dtype}, {w.device}) must match the "
                             f"state ({y_dtype}, {device})")
    return [w if w.is_contiguous() else w.detach().contiguous() for w in ws]


def _check_cuda_state(y, kernel, dtypes=(torch.float32, torch.float64)):
    if y.device.type != 'cuda':
        raise ValueError(f"{kernel}: tensors on {y.device} are neither CPU "
                         "(plain version) nor CUDA (kernel)")
    if y.dtype not in dtypes:
        names = ', '.join(str(d).replace('torch.', '') for d in dtypes)
        raise TypeError(f"{kernel}: the kernel takes a state of {names}, "
                        f"got {y.dtype}")
    if y.dim() != 2 or not y.is_contiguous():
        raise ValueError(f"{kernel}: the kernel takes a contiguous 2-D "
                         f"state, got shape {tuple(y.shape)}")


def _ptr(x):
    """A tensor's address for a `c_void_p` argument (ctypes takes the int)."""
    return x.data_ptr()


def _row_ptrs(x):
    """The addresses of the rows of a contiguous tensor (no views made)."""
    step = x.stride(0) * x.element_size()
    return [x.data_ptr() + i * step for i in range(x.shape[0])]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


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


def _rk4_group_width(B, H):
    """Lanes a trajectory for K-rk4 (``csrc/rk4.cu``): the least power of
    two L, from 4 to 32 and at most H, for which B * L threads fill the
    card (`_RK4_THREADS`), and L=1 where 2 would do.  A small batch gets
    wide groups (L=32 at B=1024), whose lanes split the H hidden units; a
    large one a lane a trajectory (from B=32768), where every lane's
    redundant stage sums cost more than the shorter chain saves.  Groups
    of 2 are never taken: on an H100 they ran slower than one lane at
    B=16384, 32768 and 65536 (kernel_variants.py; PERF.md)."""
    L = 1
    while L < 32 and 2 * L <= H and B * L < _RK4_THREADS:
        L *= 2
    return 1 if L <= 2 else L


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
                                      'rk4_integrate', _KERNEL_MAX_D)
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
        n_steps, out_every or 0, _rk4_group_width(B, H), _ptr(out),
        _stream(y0.device))
    _build.check(lib, code, 'rk4_integrate')
    launch_counts['rk4_integrate'] += 1
    return out


# ---------------------------------------------------------------------------
# Per-lane numerics shared by the plain versions of K-dopri5 and K-events
# (JAX `_make_lane_ops`, pallas_kernels.py:238-333; the kernels' share is
# csrc/lane_ops.cuh), and the tableau and output times on the device.
# ---------------------------------------------------------------------------

# the state dtypes of K-dopri5 and K-events (K-rk4 takes the first two)
LANE_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


def _rounded(values, dtype):
    """`values` rounded to the torch `dtype`, as a float64 array (numpy has
    no bfloat16): each the value JAX's ``np.asarray(values, dtype)``
    holds."""
    v = np.asarray(values, dtype=np.float64)
    return np.array([coef(x, dtype) for x in v.ravel()]).reshape(v.shape)


def _tableau_consts(method, dtype):
    """The tableau rounded to the torch state `dtype` (JAX
    `_tableau_consts`, pallas_kernels.py:182)."""
    if method not in PER_LANE_METHODS:
        raise ValueError(f"per-lane method must be one of {PER_LANE_METHODS},"
                         f" got {method!r}")
    tab = getattr(tableaus, method.upper())
    return (_rounded(tab.alpha, dtype), _rounded(tab.beta, dtype),
            _rounded(tab.c_sol, dtype), _rounded(tab.c_error, dtype),
            _rounded(tab.c_mid, dtype), int(tab.order), bool(tab.is_fsal))


@functools.lru_cache(maxsize=None)
def packed_tableau(method, dtype, device):
    """The tableau of `method` in the kernels' packed layout
    (csrc/lane_ops.cuh), in `dtype` on `device`, made and copied once per
    key so that a repeated launch copies nothing host to device.  Returns
    (tableau tensor, n_alpha, order, fsal)."""
    alpha, beta, c_sol, c_err, c_mid, order, fsal = _tableau_consts(
        method, dtype)
    n_alpha = len(alpha)
    m = _PACK_ALPHA
    packed = np.zeros(m * (m + 1) + 3 * (m + 1))
    packed[:n_alpha] = alpha
    packed[m:m + m * m].reshape(m, m)[:n_alpha, :n_alpha] = beta
    for i, vec in enumerate((c_sol, c_err, c_mid)):
        start = m + m * m + i * (m + 1)
        packed[start:start + n_alpha + 1] = vec
    return (torch.from_numpy(packed).to(dtype).to(device), n_alpha, order,
            fsal)


@functools.lru_cache(maxsize=64)
def _device_times(values, dtype, device):
    """Output times (a tuple of floats) as a tensor on `device`, cached by
    their values."""
    return torch.tensor(values, dtype=dtype).to(device)


def _lincomb(coeffs, ks):
    """``sum_j coeffs[j] * ks[j]`` over the nonzero coefficients."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        term = float(c) * k
        acc = term if acc is None else acc + term
    return acc


def _lane_rms(v):
    """RMS over the state rows of each lane, (D, B) -> (1, B)."""
    return torch.sqrt((v * v).sum(dim=0, keepdim=True) / float(v.shape[0]))


def _hairer_dt(f, t, y, fc, rtol, atol, tiny, inv_order):
    """`hairer_dt` (pallas_kernels.py:305-321): each lane's initial step.
    Its constants are JAX's weakly typed ones, rounded to the state dtype;
    a constant over a tensor is one division (torch's ``c / x`` would be a
    reciprocal and a product)."""
    def c(v, like):
        return torch.full_like(like, coef(v, like.dtype))

    scale = atol + rtol * y.abs()
    d0 = _lane_rms(y / scale)
    d1 = _lane_rms(fc / scale)
    h0 = torch.where((d0 < c(1e-5, d0)) | (d1 < c(1e-5, d1)), c(1e-6, d0),
                     c(0.01, d0) * d0 / torch.clamp_min(d1, tiny))
    fp = f(t + h0, y + h0 * fc)
    d2 = _lane_rms((fp - fc) / scale) / torch.clamp_min(h0, tiny)
    d_max = torch.maximum(d1, d2)
    h1 = torch.where((d1 <= c(1e-15, d1)) & (d2 <= c(1e-15, d2)),
                     torch.maximum(h0 * c(1e-3, h0), c(1e-6, h0)),
                     (c(0.01, d_max) / torch.clamp_min(d_max, tiny))
                     ** inv_order)
    return torch.minimum(100.0 * h0, h1)


def _stage_sweep(f, t, dt_c, y, fc, alpha, beta, c_sol, c_err, fsal):
    """`stage_sweep` (pallas_kernels.py:250-279), the coefficient sums
    formed before the dt multiply.  Returns (y1, f1, err, ks)."""
    ks = [fc]
    yi = y
    for i in range(len(alpha)):
        yi = y + dt_c * _lincomb(beta[i, :i + 1], ks)
        ks.append(f(t + float(alpha[i]) * dt_c, yi))
    y1 = yi if fsal else y + dt_c * _lincomb(c_sol, ks)
    f1 = ks[-1] if fsal else f(t + dt_c, y1)
    return y1, f1, dt_c * _lincomb(c_err, ks), ks


def _error_ratio(y, y1, err, rtol, atol):
    return _lane_rms(err / (atol + rtol * torch.maximum(y.abs(), y1.abs())))


def _next_dt(dt_c, ratio, safety, ifactor, dfactor, tiny, inv_order):
    """The I-controller, NaN-propagating like the TPU kernel's (`safety`,
    `ifactor` and `dfactor` in the state dtype)."""
    dfac = torch.where(ratio < 1.0, torch.ones_like(ratio),
                       torch.full_like(ratio, dfactor))
    return dt_c * torch.minimum(
        torch.maximum(torch.full_like(ratio, safety)
                      / torch.clamp_min(ratio, tiny) ** inv_order, dfac),
        torch.full_like(ratio, ifactor))


def _quartic(y, y1, fc, f1, ks, dt_c, c_mid):
    """`y_mid_of` and `interp_coeffs` (pallas_kernels.py:281-294): the
    step's quartic in ascending powers of x in [0, 1]."""
    y_mid = y + dt_c * _lincomb(c_mid, ks)
    ca = 2 * dt_c * (f1 - fc) - 8 * (y1 + y) + 16 * y_mid
    cb = dt_c * (5 * fc - 3 * f1) + 18 * y + 14 * y1 - 32 * y_mid
    cc = dt_c * (f1 - 4 * fc) - 11 * y - 5 * y1 + 16 * y_mid
    return (y, dt_c * fc, cc, cb, ca)


def _quartic_at(coefs, x):
    """`interp_at`: the powers of x formed by repeated multiplication."""
    e, d, c, b, a = coefs
    val = e + x * d
    xp = x * x
    val = val + xp * c
    xp = xp * x
    val = val + xp * b
    xp = xp * x
    return val + xp * a


def _as_lane_field(field):
    """An `MLPField` maps (..., D) rows; the per-lane solve evaluates its
    field on the (D, B) lane layout."""
    if isinstance(field, MLPField):
        return lambda tv, yv: field(tv, yv.T).T
    return field


def _lane_setup(f, y0, t0, method, rtol, atol, first_step):
    """What both per-lane solves start from: the tableau, the start time row,
    f(y0), each lane's first step, and the controller constants, all
    rounded to the state dtype."""
    D, B = y0.shape
    dtype = y0.dtype
    consts = _tableau_consts(method, dtype)
    rtol, atol = coef(rtol, dtype), coef(atol, dtype)
    tiny = torch.finfo(dtype).tiny
    inv_order = coef(1.0 / consts[5], dtype)
    t = y0.new_full((1, B), coef(t0, dtype))
    fc = f(t, y0)
    if first_step is not None:
        dt = y0.new_full((1, B), coef(first_step, dtype))
    else:
        dt = _hairer_dt(f, t, y0, fc, rtol, atol, tiny, inv_order)
    return consts, rtol, atol, tiny, inv_order, t, fc, dt


def _lane_group_width(B, H):
    """Lanes a trajectory for K-dopri5 and K-events (``csrc/dopri5_lanes.cuh``,
    ``csrc/dopri5_events.cuh``): K-rk4's rule (`_rk4_group_width`), the least
    power of two L from 4 to 32 and at most H for which B * L threads fill
    the card, and L=1 where 2 would do.

    Chosen from the kernels' device times on an "NVIDIA H100 80GB HBM3,
    700.00 W" (kernel_variants.py, section lanes: chip_smoke.py's spiral
    problems, float32, H=64), ms at L = 1, 2, 4, 8, 16, 32:
    K-dopri5 B=1024: 0.131, 0.124, 0.082, 0.067, 0.056, 0.042;
    B=16384: 0.144, 0.161, 0.114, 0.134, 0.161, 0.208;
    B=32768: 0.180, 0.202, 0.204, 0.225, 0.293, 0.395;
    B=65536: 0.279, 0.362, 0.350, 0.413, 0.552, 0.768.
    K-events B=1024: 0.166, 0.149, 0.105, 0.084, 0.064, 0.046;
    B=16384: 0.177, 0.187, 0.143, 0.177, 0.199, 0.247;
    B=32768: 0.218, 0.227, 0.259, 0.295, 0.366, 0.476;
    B=65536: 0.316, 0.414, 0.450, 0.548, 0.709, 0.932.
    The rule picks the fastest width of both kernels at each of these
    batches: 32, 4, 1 and 1.  Groups of 2 never won, as for K-rk4."""
    return _rk4_group_width(B, H)


def _check_group(group):
    """Refuse, before any launch, a group width that the per-trajectory
    kernels cannot take; None leaves the choice to `_lane_group_width`."""
    if group is not None and not (isinstance(group, int) and 1 <= group <= 32
                                  and group & (group - 1) == 0):
        raise ValueError("group must be None or a power of two from 1 to 32 "
                         f"(lanes a trajectory), got {group!r}")


def _group_for(B, H, group, kernel):
    """The group width a launch runs: `group`, or the host's choice."""
    if group is None:
        return _lane_group_width(B, H)
    if group > H:
        raise ValueError(f"{kernel}: a group of {group} lanes splits the H={H} "
                         "hidden units; it must be at most H")
    return group


def _dtype_code(y):
    """The C entry points' dtype code (csrc/dopri5_lanes.cu)."""
    return LANE_DTYPES.index(y.dtype)


def _state_scalars(dtype, *values):
    """`values` rounded to the state dtype, as Python floats for ctypes."""
    return [coef(v, dtype) for v in values]


@functools.lru_cache(maxsize=None)
def _max_shared_bytes(device):
    """The card's limit on a block's dynamic shared memory (its opt-in
    maximum: 227 KB on an H100)."""
    lib = _build.library()
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device):
        _build.check(lib, lib.tdt_max_shared_bytes(out),
                     "tdt_max_shared_bytes")
    return int(out[0])


def _lane_plan(kernel, D, H, n_alpha, L, block_elems, element_size, device,
               quartic):
    """Block size of a K-dopri5 or K-events launch.

    The register instances (D <= 8, at most 7 stages) run 128 threads.  The
    shared-memory instances add a slice of ``wide_slice_elems`` elements
    per trajectory (csrc/lane_ops.cuh) to the block's `block_elems` (the
    MLP, the tableau and the output times or event weights), so the block
    holds 128 / L trajectories, halved until it fits the card's shared
    memory.  Raises where one trajectory group does not fit: that is the
    only bound on D and H.  Returns (threads, shared bytes).
    """
    limit = _max_shared_bytes(device)
    if D <= _REG_MAX_D and n_alpha <= _REG_MAX_ALPHA:
        threads, need = _LANE_THREADS, block_elems * element_size
    else:
        per_traj = (n_alpha + 1 + 6 + (5 if quartic else 0)) * D + H
        threads = _LANE_THREADS
        while True:
            need = (block_elems + threads // L * per_traj) * element_size
            if need <= limit or threads == L:
                break
            threads //= 2
    if need > limit:
        raise ValueError(
            f"{kernel}: one trajectory group (D={D}, H={H}, {n_alpha + 1} "
            f"stages) needs {need} bytes of shared memory for the MLP, the "
            "tableau, the output times or event weights and its state and "
            f"slopes, above the card's {limit} bytes a block")
    return threads, need


# ---------------------------------------------------------------------------
# K-dopri5: per-lane adaptive explicit RK.
# ---------------------------------------------------------------------------

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
    B = y0.shape[1]
    ((alpha, beta, c_sol, c_err, c_mid, order, fsal), rtol, atol, tiny,
     inv_order, t, fc, dt) = _lane_setup(f, y0, t0, method, rtol, atol,
                                         first_step)
    t_end = coef(t1, y0.dtype)
    emit_ts = ([t_end] if ts is None
               else [coef(v, y0.dtype) for v in host_times(ts)])

    y = y0
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
        y1, f1, err, ks = _stage_sweep(f, t, dt_c, y, fc, alpha, beta, c_sol,
                                       c_err, fsal)
        ratio = _error_ratio(y, y1, err, rtol, atol)
        accept = (ratio <= 1.0) & active

        # dense output for every output time this step covers
        coefs = _quartic(y, y1, fc, f1, ks, dt_c, c_mid)
        dt_safe = torch.where(dt_c > 0, dt_c, torch.ones_like(dt_c))
        for s, t_s in enumerate(emit_ts):
            covered = accept & (t < float(t_s)) & (t_prop >= float(t_s))
            val = _quartic_at(coefs, (float(t_s) - t) / dt_safe)
            out[s] = torch.where(covered, val, out[s])

        y = torch.where(accept, y1, y)
        fc = torch.where(accept, f1, fc)
        t = torch.where(accept, t_prop, t)
        dt = torch.where(active, _next_dt(dt_c, ratio, safety, ifactor,
                                          dfactor, tiny, inv_order), dt)
        n_acc += accept.to(torch.int32)
        n_steps += active.to(torch.int32)

    ys = torch.stack([torch.where(t >= float(t_s), o,
                                  torch.full_like(o, float('nan')))
                      for t_s, o in zip(emit_ts, out)])
    return (ys[0] if ts is None else ys), n_acc, n_steps


def dopri5_integrate_batched(field, y0, t0, t1, *, ts=None, rtol=1e-4,
                             atol=1e-6, method='dopri5', params=(),
                             max_steps=10_000, safety=0.9, ifactor=10.0,
                             dfactor=0.2, first_step=None, group=None):
    """Adaptive explicit RK over a batch of independent ODEs, each lane with
    its own step-size controller (JAX ``dopri5_integrate_batched``,
    pallas_kernels.py:336).

    Args:
        field: an `MLPField` (CPU or CUDA; on CUDA tanh), a
            `traced.PerSampleField` (CPU or CUDA: on CUDA a traced instance,
            any of the four dtypes, group 1), or any lane-layout callable
            ``field(t (1, B), y (D, B), *params)`` (CPU only).
        y0: (D, B) initial states, batch on the LAST axis.
        t0, t1: scalars; ts: optional increasing (S,) output times in
            [t0, t1] (default: t1 only).
        rtol, atol, max_steps, safety/ifactor/dfactor, first_step:
            controller settings shared by all lanes.
        group: the kernel's lanes a trajectory, a power of two from 1 to 32
            and at most the field's H (default `_lane_group_width`).  It
            changes only the summation order of the field's hidden units
            (in the register instances; the shared-memory instance that runs
            dopri8 and D > 8 gives the same bits at every width).

    Returns:
        (ys (S, D, B), or (D, B) without `ts`; n_accepted (1, B) int32;
        n_steps (1, B) int32).  Rows a lane never reached are NaN.

    Deviation from the JAX kernel: a lane stops after `max_steps` steps.
    The JAX kernel loops while ANY lane of its tile is live, so a lane that
    ran out of steps keeps stepping while others run; its counts then
    depend on the tile it shares (they agree whenever every lane that runs
    out does so at the same time, e.g. when the others are done).

    Exactness of the counts (ROADMAP C7): the kernel sums the field's
    hidden units in another order than the plain version's products, so
    its float64 per-lane steps and accepts equal the plain version's only
    away from accept boundaries.  A lane whose error ratio comes within
    rounding of 1 on some step can flip that accept and then take other
    steps, at every group width, L=1 included; tests/test_torch_cuda.py
    (test_float64_counts_near_accept_boundaries) bounds the share of such
    lanes.  dopri8's error estimate is rounding noise on steps over which
    the field is nearly linear, and its next step follows that noise, so
    there the two take steps of slightly different sizes; a `first_step`
    where the estimate is truncation (e.g. 0.2 on [0, 1]) avoids most.
    """
    _refuse_grad(field, y0, params)
    _check_group(group)
    if ts is not None:
        ts = host_times(ts)
        if not (ts[1:] > ts[:-1]).all():
            raise ValueError("ts must be strictly increasing")
    if y0.device.type == 'cpu':
        return dopri5_integrate_batched_ref(
            field, y0, t0, t1, ts=ts, rtol=rtol, atol=atol, method=method,
            params=params, max_steps=max_steps, safety=safety,
            ifactor=ifactor, dfactor=dfactor, first_step=first_step)
    launch, (ys, n_acc, n_steps) = _lanes_launch(
        field, y0, t0, t1, ts=ts, rtol=rtol, atol=atol, method=method,
        params=params, max_steps=max_steps, safety=safety, ifactor=ifactor,
        dfactor=dfactor, first_step=first_step, group=group)
    launch()
    return (ys[0] if ts is None else ys), n_acc, n_steps


def _lanes_launch(field, y0, t0, t1, *, ts=None, rtol=1e-4, atol=1e-6,
                  method='dopri5', params=(), max_steps=10_000, safety=0.9,
                  ifactor=10.0, dfactor=0.2, first_step=None, group=None):
    """Check the inputs of K-dopri5 (`ts` increasing, as the wrapper has
    checked) and allocate its outputs; return a function that launches it
    (counted) and the outputs (ys (S, D, B), n_acc, n_steps) it writes.
    `dopri5_integrate_batched` calls the function once; a timing of the
    launch alone can call it again."""
    kernel = 'dopri5_integrate_batched'
    if isinstance(field, PerSampleField):
        return _traced_lanes_launch(
            field, y0, t0, t1, ts=ts, rtol=rtol, atol=atol, method=method,
            params=params, max_steps=max_steps, safety=safety,
            ifactor=ifactor, dfactor=dfactor, first_step=first_step,
            group=group)
    _check_cuda_state(y0, kernel, LANE_DTYPES)
    D, B = y0.shape
    dev = y0.device
    (w1, b1, w2, b2), H = _kernel_mlp(field, params, y0.dtype, dev, D, kernel)
    L = _group_for(B, H, group, kernel)
    tab_d, n_alpha, order, fsal = packed_tableau(method, y0.dtype, dev)
    emit_ts = tuple(_rounded([t1] if ts is None else ts, y0.dtype).tolist())
    S = len(emit_ts)
    threads, _ = _lane_plan(kernel, D, H, n_alpha, L,
                            2 * D * H + H + D + tab_d.numel() + S,
                            y0.element_size(), dev, quartic=False)
    ts_d = _device_times(emit_ts, y0.dtype, dev)
    ys = y0.new_empty((S, D, B))
    counts = torch.empty((2, B), dtype=torch.int32, device=dev)
    args = (_dtype_code(y0), B, D, H, field.power, _ptr(y0), _ptr(ts_d), S,
            *_state_scalars(y0.dtype, t0, t1, rtol, atol, safety, ifactor,
                            dfactor,
                            0.0 if first_step is None else first_step),
            int(first_step is not None), int(max_steps), _ptr(tab_d), n_alpha,
            order, int(fsal), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), L,
            threads, _ptr(ys), *_row_ptrs(counts), _stream(dev))
    lib = _build.library() if B > 0 else None

    def launch():
        if B > 0:
            _build.check(lib, lib.tdt_dopri5_lanes(*args), kernel)
            launch_counts[kernel] += 1

    # every tensor whose address `args` holds lives as long as the launch
    launch.keep = (y0, ts_d, tab_d, w1, b1, w2, b2, ys, counts)
    return launch, (ys, counts[0:1], counts[1:2])


# ---------------------------------------------------------------------------
# K-events: per-lane adaptive explicit RK until each lane's event fires.
# ---------------------------------------------------------------------------

def _as_lane_event(event_fn):
    """A `LinearEvent` is sign-combined per lane with ``ev_params=(sign0,)``
    (the combination of parallel/batched.py): the lane's event is
    ``min_k(e_k * sign0_k)``.  Any other event function already takes the
    lane layout."""
    if isinstance(event_fn, LinearEvent):
        return lambda tv, yv, sign0: (event_fn.lanes(tv, yv) * sign0).amin(
            dim=0, keepdim=True)
    return event_fn


def dopri5_events_batched_ref(field, y0, t0, event_fn, *, rtol=1e-4,
                              atol=1e-6, method='dopri5', params=(),
                              ev_params=(), max_steps=10_000, safety=0.9,
                              ifactor=10.0, dfactor=0.2, first_step=None,
                              bisect_iters=40):
    """Plain PyTorch version of `dopri5_events_batched`: the TPU kernel's
    lane arithmetic (pallas_kernels.py:645-765) on the whole batch at once,
    with one host read per step.  The field and the event take the lane
    layout, as in `dopri5_integrate_batched_ref`."""
    f_lane = _as_lane_field(field)
    f = lambda tv, yv: f_lane(tv, yv, *params)
    ev_lane = _as_lane_event(event_fn)
    ev = lambda tv, yv: ev_lane(tv, yv, *ev_params)
    B = y0.shape[1]
    ((alpha, beta, c_sol, c_err, c_mid, order, fsal), rtol, atol, tiny,
     inv_order, t, fc, dt) = _lane_setup(f, y0, t0, method, rtol, atol,
                                         first_step)
    s0 = nan_sign(ev(t, y0))

    y = y0
    zeros = torch.zeros_like(y0)
    brk_t, brk_dt = torch.zeros_like(t), torch.zeros_like(t)
    coefs = (y0, zeros, zeros, zeros, zeros)
    found = torch.zeros((1, B), dtype=torch.bool, device=y0.device)
    n_acc = torch.zeros((1, B), dtype=torch.int32, device=y0.device)
    n_steps = torch.zeros_like(n_acc)
    while True:
        active = ~found & (n_steps < max_steps)
        if not bool(active.any()):
            break
        dt_c = torch.where(active, dt, torch.zeros_like(dt))
        t_prop = t + dt_c
        y1, f1, err, ks = _stage_sweep(f, t, dt_c, y, fc, alpha, beta, c_sol,
                                       c_err, fsal)
        ratio = _error_ratio(y, y1, err, rtol, atol)
        accept = (ratio <= 1.0) & active
        hit = accept & (nan_sign(ev(t_prop, y1)) != s0)

        # a hit freezes the lane: keep its bracket and quartic
        coefs = tuple(torch.where(hit, new, old) for new, old in
                      zip(_quartic(y, y1, fc, f1, ks, dt_c, c_mid), coefs))
        brk_t = torch.where(hit, t, brk_t)
        brk_dt = torch.where(hit, dt_c, brk_dt)
        found = found | hit
        y = torch.where(accept, y1, y)
        fc = torch.where(accept, f1, fc)
        t = torch.where(accept, t_prop, t)
        dt = torch.where(active, _next_dt(dt_c, ratio, safety, ifactor,
                                          dfactor, tiny, inv_order), dt)
        n_acc += accept.to(torch.int32)
        n_steps += active.to(torch.int32)

    # bisection on each lane's bracket: x in [0, 1] maps to
    # [brk_t, brk_t + brk_dt]
    lo, hi = torch.zeros_like(t), torch.ones_like(t)
    for _ in range(int(bisect_iters)):
        xm = 0.5 * (lo + hi)
        same = nan_sign(ev(brk_t + xm * brk_dt, _quartic_at(coefs, xm))) == s0
        lo = torch.where(same, xm, lo)
        hi = torch.where(same, hi, xm)
    x = 0.5 * (lo + hi)
    event_t = torch.where(found, brk_t + x * brk_dt,
                          torch.full_like(x, float('nan')))
    y_event = torch.where(found, _quartic_at(coefs, x), y)
    return event_t, y_event, found.to(torch.int32), n_acc, n_steps


def _kernel_event(event_fn, ev_params, y_dtype, device, D, B):
    """Check that `event_fn` is what the CUDA event kernel takes and return
    its contiguous (W, c, b, sign0) and K."""
    if not isinstance(event_fn, LinearEvent):
        raise TypeError(
            "the CUDA dopri5_events_batched kernel takes a LinearEvent (the "
            "event family its hand-written code evaluates: y @ W.T + c * t "
            f"+ b, K <= {LinearEvent.MAX_OUTPUTS} outputs), or a traced "
            "per-sample event (ops.traced.PerSampleEvent, what "
            "odeint_per_sample(..., event_fn=..., options=dict(pallas=True)) "
            f"passes); got {type(event_fn).__name__}")
    K = event_fn.weight.shape[0]
    if event_fn.weight.shape[1] != D:
        raise ValueError(f"LinearEvent weight {tuple(event_fn.weight.shape)} "
                         f"does not take the state dimension {D}")
    if len(ev_params) != 1 or tuple(ev_params[0].shape) != (K, B):
        raise ValueError(f"a LinearEvent takes ev_params=(sign0,) with sign0 "
                         f"of shape ({K}, {B})")
    return _kernel_tensors((event_fn.weight, event_fn.time_coef,
                            event_fn.bias, ev_params[0]), y_dtype, device,
                           "LinearEvent weights and sign0"), K


def dopri5_events_batched(field, y0, t0, event_fn, *, rtol=1e-4, atol=1e-6,
                          method='dopri5', params=(), ev_params=(),
                          max_steps=10_000, safety=0.9, ifactor=10.0,
                          dfactor=0.2, first_step=None, bisect_iters=40,
                          group=None):
    """Per-lane adaptive explicit RK until each lane's own event changes
    sign, then a fixed-count bisection of each event time on the bracketing
    step's quartic (JAX ``dopri5_events_batched``, pallas_kernels.py:580).

    Args:
        field: as in `dopri5_integrate_batched`.
        y0: (D, B) initial states, batch on the LAST axis.
        t0: scalar start time.
        event_fn: a `LinearEvent` with ``ev_params=(sign0,)``, sign0 of
            shape (K, B), whose lane event is ``min_k(e_k * sign0_k)`` (CPU
            or CUDA); a `traced.PerSampleEvent`, the same with sign0 its
            (K, B) signs at t0 (CPU or CUDA: with a `PerSampleField`, or
            with an `MLPField` or `LinearEvent` traced beside it, a traced
            instance); or any lane-layout callable ``event_fn(t (1, B),
            y (D, B), *ev_params) -> (1, B)`` (CPU only).
        bisect_iters: bisection count on x in [0, 1] over the bracket.
        (other args, `group` included, as in `dopri5_integrate_batched`.)

    A lane is live while it has found no event and has taken fewer than
    `max_steps` steps; a hit is an accepted step whose end has another
    event sign than the start (NaN counting as a sign of its own).  Time,
    including the event time, is kept in the state dtype, as in the TPU
    kernel.

    Returns:
        (event_t (1, B), NaN where no event was found; y_event (D, B), the
        last accepted state there; found, n_accepted, n_steps, each (1, B)
        int32).

    The float64 per-lane counts (and `found`) equal the plain version's
    only away from accept boundaries, as for `dopri5_integrate_batched`
    (ROADMAP C7).
    """
    _refuse_grad(field, y0, params)
    _refuse_grad(event_fn, y0, ev_params)
    _check_group(group)
    if y0.device.type == 'cpu':
        return dopri5_events_batched_ref(
            field, y0, t0, event_fn, rtol=rtol, atol=atol, method=method,
            params=params, ev_params=ev_params, max_steps=max_steps,
            safety=safety, ifactor=ifactor, dfactor=dfactor,
            first_step=first_step, bisect_iters=bisect_iters)
    launch, outs = _events_launch(
        field, y0, t0, event_fn, rtol=rtol, atol=atol, method=method,
        params=params, ev_params=ev_params, max_steps=max_steps,
        safety=safety, ifactor=ifactor, dfactor=dfactor,
        first_step=first_step, bisect_iters=bisect_iters, group=group)
    launch()
    return outs


def _events_launch(field, y0, t0, event_fn, *, rtol=1e-4, atol=1e-6,
                   method='dopri5', params=(), ev_params=(), max_steps=10_000,
                   safety=0.9, ifactor=10.0, dfactor=0.2, first_step=None,
                   bisect_iters=40, group=None):
    """Check the inputs of K-events and allocate its outputs; return a
    function that launches it (counted) and the outputs (event_t, y_event,
    found, n_acc, n_steps) it writes, as `_lanes_launch` does for
    K-dopri5."""
    kernel = 'dopri5_events_batched'
    if isinstance(field, PerSampleField) or isinstance(event_fn,
                                                       PerSampleEvent):
        return _traced_events_launch(
            field, y0, t0, event_fn, rtol=rtol, atol=atol, method=method,
            params=params, ev_params=ev_params, max_steps=max_steps,
            safety=safety, ifactor=ifactor, dfactor=dfactor,
            first_step=first_step, bisect_iters=bisect_iters, group=group)
    _check_cuda_state(y0, kernel, LANE_DTYPES)
    D, B = y0.shape
    dev = y0.device
    (w1, b1, w2, b2), H = _kernel_mlp(field, params, y0.dtype, dev, D, kernel)
    (ev_w, ev_c, ev_b, sign0), K = _kernel_event(event_fn, ev_params,
                                                 y0.dtype, dev, D, B)
    L = _group_for(B, H, group, kernel)
    tab_d, n_alpha, order, fsal = packed_tableau(method, y0.dtype, dev)
    threads, _ = _lane_plan(kernel, D, H, n_alpha, L,
                            2 * D * H + H + D + tab_d.numel() + K * D + 2 * K,
                            y0.element_size(), dev, quartic=True)
    values = y0.new_empty((1 + D, B))   # event_t | y_event
    counts = torch.empty((3, B), dtype=torch.int32, device=dev)
    args = (_dtype_code(y0), B, D, H, field.power, _ptr(y0),
            *_state_scalars(y0.dtype, t0, rtol, atol, safety, ifactor,
                            dfactor,
                            0.0 if first_step is None else first_step),
            int(first_step is not None), int(max_steps), _ptr(tab_d), n_alpha,
            order, int(fsal), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), K,
            _ptr(ev_w), _ptr(ev_c), _ptr(ev_b), _ptr(sign0),
            int(bisect_iters), L, threads, *_row_ptrs(values)[:2],
            *_row_ptrs(counts), _stream(dev))
    lib = _build.library() if B > 0 else None

    def launch():
        if B > 0:
            _build.check(lib, lib.tdt_dopri5_events(*args), kernel)
            launch_counts[kernel] += 1

    launch.keep = (y0, tab_d, w1, b1, w2, b2, ev_w, ev_c, ev_b, sign0, values,
                   counts)

    return launch, (values[0:1], values[1:], counts[0:1], counts[1:2],
                    counts[2:3])


# ---------------------------------------------------------------------------
# The traced instances of K-dopri5 and K-events (ops/traced.py).
# ---------------------------------------------------------------------------

def _traced_threads(B):
    """Trajectories a block of a traced instance: a warp, until B of them
    fill every SM of an H100 with a block; then 128."""
    return 32 if B < _TRACED_SMS * 128 else 128


def _traced_common(field, y0, params, group, kernel):
    """Checks shared by both traced launches (the method is checked where
    its tableau is compiled into the instance, `traced.tableau_struct`)."""
    _check_cuda_state(y0, kernel, LANE_DTYPES)
    if params:
        raise TypeError(f"{kernel}: a traced field carries its own args "
                        f"(PerSampleField(func, args, axes)), not params")
    if group not in (None, 1):
        raise ValueError(f"{kernel}: a traced field runs one lane a "
                         f"trajectory (group 1), got group={group}")


def _traced_lanes_launch(field, y0, t0, t1, *, ts, rtol, atol, method,
                         params, max_steps, safety, ifactor, dfactor,
                         first_step, group):
    """`_lanes_launch` for a traced field: trace `field` (a
    `PerSampleField`), build its instance at first use, and return the
    launch (counted in `traced_launch_counts`) and the
    outputs."""
    kernel = 'dopri5_integrate_batched'
    _traced_common(field, y0, params, group, kernel)
    D, B = y0.shape
    dev = y0.device
    src = traced.field_source(field, y0, method)
    lib = _build.traced_library(src.source)
    lane = src.lane_buffer(B, y0.dtype, dev)
    shared = src.buffer(src.shared, y0.dtype, dev)
    emit_ts = tuple(_rounded([t1] if ts is None else ts, y0.dtype).tolist())
    S = len(emit_ts)
    ts_d = _device_times(emit_ts, y0.dtype, dev)
    ys = y0.new_empty((S, D, B))
    counts = torch.empty((2, B), dtype=torch.int32, device=dev)
    args = (B, _ptr(y0), _ptr(ts_d), S,
            *_state_scalars(y0.dtype, t0, t1, rtol, atol, safety, ifactor,
                            dfactor, 0.0 if first_step is None else first_step),
            int(first_step is not None), int(max_steps),
            None if lane is None else _ptr(lane),
            None if shared is None else _ptr(shared), _traced_threads(B),
            _ptr(ys), *_row_ptrs(counts), _stream(dev))

    def launch():
        if B > 0:
            _build.check(lib, lib.tdt_traced_lanes(*args), kernel)
            traced_launch_counts[kernel] += 1

    launch.keep = (y0, ts_d, lane, shared, ys, counts)
    launch.source = src
    return launch, (ys, counts[0:1], counts[1:2])


def _traced_events_launch(field, y0, t0, event_fn, *, rtol, atol, method,
                          params, ev_params, max_steps, safety, ifactor,
                          dfactor, first_step, bisect_iters, group):
    """`_events_launch` for a traced field and event: `field` a
    `PerSampleField` or an `MLPField`, `event_fn` a `PerSampleEvent` or a
    `LinearEvent` (both traced), ``ev_params=(sign0,)`` with sign0 (K, B);
    counted in `traced_launch_counts`."""
    kernel = 'dopri5_events_batched'
    if not isinstance(field, PerSampleField):
        if not isinstance(field, MLPField):
            _kernel_mlp(field, params, y0.dtype, y0.device, y0.shape[0],
                        kernel)   # raises, naming what is taken
        field = PerSampleField(field)
    if not isinstance(event_fn, PerSampleEvent):
        if not isinstance(event_fn, LinearEvent):
            _kernel_event(event_fn, ev_params, y0.dtype, y0.device,
                          *y0.shape)   # raises, naming what is taken
        event_fn = PerSampleEvent(event_fn)
    _traced_common(field, y0, params, group, kernel)
    D, B = y0.shape
    dev = y0.device
    src = traced.events_source(field, event_fn, y0, method)
    if len(ev_params) != 1 or tuple(ev_params[0].shape) != (src.K, B):
        raise ValueError(f"{kernel}: a traced event of {src.K} outputs takes "
                         f"ev_params=(sign0,) with sign0 of shape "
                         f"({src.K}, {B})")
    sign0 = _kernel_tensors(ev_params[:1], y0.dtype, dev, "sign0")[0]
    lib = _build.traced_library(src.source)
    lane = src.lane_buffer(B, y0.dtype, dev)
    shared = src.buffer(src.shared, y0.dtype, dev)
    ev_shared = src.buffer(src.ev_shared, y0.dtype, dev)
    values = y0.new_empty((1 + D, B))   # event_t | y_event
    counts = torch.empty((3, B), dtype=torch.int32, device=dev)
    args = (B, _ptr(y0),
            *_state_scalars(y0.dtype, t0, rtol, atol, safety, ifactor,
                            dfactor, 0.0 if first_step is None else first_step),
            int(first_step is not None), int(max_steps),
            None if lane is None else _ptr(lane),
            None if shared is None else _ptr(shared), _ptr(sign0),
            None if ev_shared is None else _ptr(ev_shared), int(bisect_iters),
            _traced_threads(B), *_row_ptrs(values)[:2], *_row_ptrs(counts),
            _stream(dev))

    def launch():
        if B > 0:
            _build.check(lib, lib.tdt_traced_events(*args), kernel)
            traced_launch_counts[kernel] += 1

    launch.keep = (y0, lane, shared, ev_shared, sign0, values, counts)
    launch.source = src
    return launch, (values[0:1], values[1:], counts[0:1], counts[1:2],
                    counts[2:3])
