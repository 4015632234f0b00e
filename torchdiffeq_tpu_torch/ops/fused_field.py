"""One explicit adaptive RK step with every stage in one kernel (counterpart
of ``benchmarks/fused_field.py``, the TPU kernel `fused_stage_step`).

The JAX package never wired this step into a solver: its one caller is the
bench ``benchmarks/bench_fused_field.py``, which chains dopri5 steps of it
over a tanh MLP field (`mlp_field`) at B=4096, D=256, H=1024, in float32
and bfloat16, against the same chain of the stock `runge_kutta_step` with
``error_dtype=float32``.  The port keeps it the standalone function it is.

* `fused_stage_step_ref` is the plain PyTorch version: the JAX portable
  fallback's arithmetic operation for operation (fused_field.py:119-130,
  163-184).  Slopes are kept in float32, each stage combination is
  ``y0 + sum((c * dt32) * k)`` in float32 with ``c * dt32`` formed in
  numpy float32, and the field runs in the state dtype.  There are no
  ``Perturb`` nudges: a stage at alpha == 1 is evaluated at ``t0 + dt``.
* `fused_stage_step` runs the plain version for CPU tensors and the CUDA
  kernel K-fused (``csrc/fused_step.cu``) for CUDA tensors.  The kernel
  cannot run a Python callable, so on CUDA it takes `mlp_field` only, and
  raises on anything else.

The TPU version sizes its batch tile for 16 MB of VMEM (`_pick_block_b`)
and takes it as ``block_b``.  A Hopper block has at most 227 KB of shared
memory, so the CUDA kernel sets its own 32-row tile and handles a ragged
last tile; the port takes no tile argument.  `fused_plan` states the
kernel's launch for a (dtype, D, H, B): its tiles, its ring of weight
tiles, its shared memory and what it streams.

`kernel_bounds` states how far the kernel may lie from the plain version
on the same inputs (the card's checks in chip_smoke.py and the GPU tests
use it).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .kernels import _ptr, _refuse_grad, _stream, launch_counts
from . import _build

# what the CUDA kernel takes: tableaus of at most 7 stages, the state
# widths it is built for (multiples of its 32 lanes, up to 4 wgmma M tiles
# of 64) and a hidden width that is a multiple of its 128-unit hidden chunk
# (csrc/fused_step.cu)
KERNEL_MAX_STAGES = 7
KERNEL_D = (32, 64, 128, 256)
KERNEL_H_MULTIPLE = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# How far a kernel slope may lie from the plain version's, each with its
# reason.  float32: the kernel sums each product's D=256 and H=1024 terms
# one after the other and cuBLAS in blocks, and tanhf may differ in its
# last ULP; a sequential sum of 1024 products drifts by up to about 1e-5
# at |f| ~ 4 (some 20 float32 ULPs), so a slope is held to KERNEL_F32_SLOPE.
# bfloat16: that difference can also flip the rounding of a hidden unit
# (one bfloat16 ULP, <= 2**-8 for |h| < 1, times its |W2| row; up to
# KERNEL_BF16_FLIPS hidden units a row) or of the slope itself (one
# bfloat16 ULP of its value).
KERNEL_F32_SLOPE = 2e-5
KERNEL_BF16_FLIPS = 2

# the kernel's launch (csrc/fused_step.cu `Plan`): a block owns
# KERNEL_ROWS batch rows; the weights stream through a ring of 32 KB slots,
# filled by cp.async in float32 and in bfloat16 by TMA, each tile read once
# for a cluster of blocks
KERNEL_ROWS = 32
_TILE_BYTES = 32768


def fused_plan(dtype, D, H, B):
    """The CUDA kernel's launch for a (B, D) state of `dtype` and H hidden
    units, as ``csrc/fused_step.cu`` makes it (its `Plan`): the instance,
    how its two products run, the blocks and their threads, the rows of a
    W1 tile (of D) and of a W2 tile (of the 128-unit chunk), the tiles a
    chunk, the ring's slots, the shared memory, the cluster size (the
    blocks that share each weight tile) and the weight bytes read from L2
    per field evaluation (each tile once a cluster)."""
    if dtype not in _KERNEL_DTYPES or D not in KERNEL_D \
            or H % KERNEL_H_MULTIPLE or H <= 0 or B <= 0:
        raise ValueError(f"no fused_stage_step kernel for dtype={dtype}, "
                         f"D={D}, H={H}, B={B}")
    tensor_cores = dtype == torch.bfloat16
    size = 2 if tensor_cores else 4
    elems = _TILE_BYTES // size
    rows1 = min(D, elems // KERNEL_H_MULTIPLE)
    rows2 = min(KERNEL_H_MULTIPLE, elems // D)
    ring = 4
    pad = 0 if tensor_cores else 4      # words a float32 row is padded by
    cluster = 2 if tensor_cores else 1
    blocks = -(-B // (KERNEL_ROWS * cluster)) * cluster
    return dict(
        instance=f"fused_step<{'bf16' if tensor_cores else 'f32'},D={D}>",
        products=("wgmma m64n32k16 (bf16 operands, float32 accumulators), "
                  "an M tile a warpgroup; weight tiles by TMA multicast from a "
                  "producer warp"
                  if tensor_cores else "float32 FMAs, 4 rows x 4 units a "
                  "thread; weight tiles by cp.async"),
        blocks=blocks, threads=288 if tensor_cores else 256,
        rows=KERNEL_ROWS, w1_tile_rows=rows1, w2_tile_rows=rows2,
        tiles_per_chunk=D // rows1 + KERNEL_H_MULTIPLE // rows2, ring=ring,
        shared_bytes=(ring * _TILE_BYTES + KERNEL_ROWS
                      * (D + KERNEL_H_MULTIPLE + 2 * pad) * size
                      + (2 * ring * 8 if tensor_cores else 0)),  # mbarriers
        cluster=cluster,
        weight_bytes_per_eval=blocks // cluster * 2 * D * H * size)


def _dot32(a, b):
    """``a @ b`` with products and sums in float32 (JAX's
    ``preferred_element_type=float32``).  On the card a 16-bit product goes
    to the tensor cores with a float32 output; elsewhere both operands are
    widened, which is the same arithmetic (a product of two 16-bit values is
    exact in float32) in another summation order."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def mlp_field(t, y, w1, b1, w2, b2):
    """The bench's field (bench_fused_field.py:39-46), on (B, D) rows:
    ``h = tanh(y @ w1 + b1)`` and ``h @ w2 + b2``, each product and bias add
    in float32 and each result cast to the state dtype.  `t` is unused.  In
    float32 it is `MLPField` with power 1 and one hidden layer."""
    h = torch.tanh(_dot32(y, w1) + b1.float()).to(y.dtype)
    return (_dot32(h, w2) + b2.float()).to(y.dtype)


def _comb(coeffs, ks, dt32):
    """``sum_i (coeffs[i] * dt32) * ks[i]`` in float32, zero coefficients
    skipped (fused_field.py:119-130); ``c * dt32`` rounds in float32."""
    total = None
    for c, v in zip(coeffs, ks):
        c = float(c)
        if c == 0.0:
            continue
        term = float(np.float32(c) * dt32) * v
        total = term if total is None else total + term
    if total is None:
        total = torch.zeros_like(ks[0])
    return total


def _state_time(t32, dtype):
    """A float32 host time cast to the state dtype, as a 0-d CPU tensor."""
    return torch.tensor(float(t32), dtype=torch.float32).to(dtype)


def _check_tableau(tableau):
    if tableau.c_mid is None:
        raise ValueError("fused_stage_step requires a tableau with "
                         "dense-output c_mid coefficients")


def fused_stage_step_ref(field, params, y0, f0, t0, dt, tableau, *,
                         error_dtype=None):
    """Plain PyTorch version of `fused_stage_step`, for any callable
    ``field(t, y, *params)`` on (B, D) rows; same arguments and results."""
    _check_tableau(tableau)
    err_dt = torch.float32 if error_dtype is None else error_dtype
    state_dt = y0.dtype
    t32, dt32 = np.float32(float(t0)), np.float32(float(dt))
    y0v = y0.float()
    k = [f0.float()]
    for i, a in enumerate(tableau.alpha):
        a = float(a)
        ti = t32 + dt32 if a == 1.0 else t32 + np.float32(a) * dt32
        yi = (y0v + _comb(tableau.beta[i, :i + 1], k, dt32)).to(state_dt)
        k.append(field(_state_time(ti, state_dt), yi, *params).float())
    if tableau.is_fsal:
        y1 = y0v + _comb(tableau.c_sol[:-1], k[:-1], dt32)
        f1 = k[-1]
    else:
        y1 = y0v + _comb(tableau.c_sol, k, dt32)
        f1 = field(_state_time(t32 + dt32, state_dt), y1.to(state_dt),
                   *params).float()
    return (y1.to(state_dt), f1.to(state_dt),
            _comb(tableau.c_error, k, dt32).to(err_dt),
            _comb(tableau.c_mid, k, dt32))


def _packed_coefs(tableau, dt32):
    """The step's coefficients times dt32 in the kernel's layout (float32
    ``[beta (6, 7), c_sol (7), c_error (7), c_mid (7)]``) and a mask of the
    nonzero coefficients (int32, one bit per slope, same rows)."""
    m = KERNEL_MAX_STAGES
    n_alpha = len(tableau.alpha)
    rows = [tableau.beta[i, :i + 1] for i in range(n_alpha)]
    rows += [[]] * (m - 1 - n_alpha)
    rows += [tableau.c_sol, tableau.c_error, tableau.c_mid]
    coefs = np.zeros((len(rows), m), np.float32)
    masks = np.zeros(len(rows), np.int32)
    for r, row in enumerate(rows):
        for j, c in enumerate(row):
            if float(c) != 0.0:
                coefs[r, j] = np.float32(float(c)) * dt32
                masks[r] |= 1 << j
    return coefs, masks


def _check_kernel_args(field, params, y0, f0, tableau):
    """Raise unless the CUDA kernel takes these inputs; return (w1, b1, w2,
    b2), H."""
    if field is not mlp_field:
        raise TypeError("the CUDA fused_stage_step kernel takes "
                        "field=mlp_field (the bench's tanh MLP, the one field "
                        f"a CUDA kernel can evaluate); got {field!r}")
    if y0.dtype not in _KERNEL_DTYPES:
        raise TypeError("fused_stage_step: the kernel takes a float32 or "
                        f"bfloat16 state, got {y0.dtype}")
    if y0.dim() != 2 or not y0.is_contiguous() or f0.shape != y0.shape \
            or not f0.is_contiguous() or f0.dtype != y0.dtype \
            or f0.device != y0.device:
        raise ValueError("fused_stage_step: the kernel takes contiguous 2-D "
                         "y0 and f0 of one shape, dtype and device, got "
                         f"{tuple(y0.shape)} and {tuple(f0.shape)}")
    B, D = y0.shape
    if len(params) != 4:
        raise ValueError("mlp_field takes params (w1, b1, w2, b2), got "
                         f"{len(params)} tensors")
    w1, b1, w2, b2 = params
    H = w1.shape[-1]
    if (tuple(w1.shape), tuple(b1.shape), tuple(w2.shape),
            tuple(b2.shape)) != ((D, H), (H,), (H, D), (D,)):
        raise ValueError(f"mlp_field params of shapes {[tuple(p.shape) for p in params]} "
                         f"do not map the state width {D} to itself")
    if D not in KERNEL_D or H % KERNEL_H_MULTIPLE != 0 or H == 0:
        raise ValueError(f"the CUDA fused_stage_step kernel takes D in "
                         f"{KERNEL_D} and H a multiple of "
                         f"{KERNEL_H_MULTIPLE}; got D={D}, H={H}")
    for p in params:
        if p.dtype != y0.dtype or p.device != y0.device:
            raise ValueError(f"mlp_field params ({p.dtype}, {p.device}) "
                             f"must match the state ({y0.dtype}, "
                             f"{y0.device})")
    if tableau.n_stages > KERNEL_MAX_STAGES:
        raise ValueError(f"the CUDA fused_stage_step kernel holds tableaus "
                         f"of at most {KERNEL_MAX_STAGES} stages, got "
                         f"{tableau.n_stages}")
    # the kernel's 16-byte copies need W1 and W2 16-byte aligned
    return [p if p.data_ptr() % 16 == 0 else p.clone()
            for p in (q.detach().contiguous() for q in params)], H


def fused_stage_step(field, params, y0, f0, t0, dt, tableau, *,
                     error_dtype=None):
    """One explicit adaptive RK step, all stages fused into one kernel (JAX
    ``fused_stage_step``, benchmarks/fused_field.py:69).

    Args:
        field: `mlp_field` (CPU or CUDA), or any ``field(t, y, *params)`` on
            (B, D) rows (CPU only).
        params: tuple of the field's parameter tensors; for `mlp_field`
            ``(w1 (D, H), b1 (H,), w2 (H, D), b2 (D,))`` in the state dtype.
        y0: (B, D) state; f0: (B, D) slope at (t0, y0) (FSAL input).
        t0, dt: scalars, rounded to float32.
        tableau: explicit ``ButcherTableau`` with ``c_mid``; the kernel
            holds up to 7 stages (dopri5, tsit5, bosh3, fehlberg2,
            adaptive_heun).
        error_dtype: dtype of the embedded-error output (default float32;
            the error is always summed in float32).

    Returns:
        (y1, f1, y1_err, dmid): y1 and f1 in the state dtype; y1_err in
        `error_dtype`; ``dmid = sum((c_mid * dt) * k)`` in float32 (the
        dense-output midpoint increment).
    """
    _check_tableau(tableau)
    _refuse_grad(field, y0, tuple(params) + (f0,))
    if y0.device.type == 'cpu':
        return fused_stage_step_ref(field, params, y0, f0, t0, dt, tableau,
                                    error_dtype=error_dtype)
    launch, (y1, f1, err, dmid) = _kernel_launch(field, params, y0, f0, dt,
                                                 tableau)
    launch()
    err_dt = torch.float32 if error_dtype is None else error_dtype
    return y1, f1, err.to(err_dt), dmid


def _kernel_launch(field, params, y0, f0, dt, tableau):
    """Check the inputs of the CUDA kernel and allocate its outputs and
    scratch; return a function that launches it (counted) and the outputs
    (y1, f1, err float32, dmid) it writes.  `fused_stage_step` calls the
    function once; a timing of the kernel alone can call it again."""
    if y0.device.type != 'cuda':
        raise ValueError(f"fused_stage_step: tensors on {y0.device} are "
                         "neither CPU (plain version) nor CUDA (kernel)")
    (w1, b1, w2, b2), H = _check_kernel_args(field, params, y0, f0, tableau)
    # the kernel reads y0 and f0 four elements at a time
    y0, f0 = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (y0, f0))
    B, D = y0.shape
    coefs, masks = _packed_coefs(tableau, np.float32(float(dt)))
    n_alpha = len(tableau.alpha)
    y1, f1 = torch.empty_like(y0), torch.empty_like(y0)
    err = y0.new_empty((B, D), dtype=torch.float32)
    dmid = torch.empty_like(err)
    scratch = y0.new_empty((n_alpha, B, D), dtype=torch.float32)

    def launch():
        if B == 0:
            return
        lib = _build.library()
        code = lib.tdt_fused_step(
            _KERNEL_DTYPES[y0.dtype], B, D, H, _ptr(y0), _ptr(f0), _ptr(w1),
            _ptr(b1), _ptr(w2), _ptr(b2),
            coefs.ctypes.data_as(ctypes.c_void_p),
            masks.ctypes.data_as(ctypes.c_void_p), n_alpha,
            int(tableau.is_fsal), _ptr(scratch), _ptr(y1), _ptr(f1),
            _ptr(err), _ptr(dmid), _stream(y0.device))
        _build.check(lib, code, 'fused_stage_step')
        launch_counts['fused_stage_step'] += 1

    return launch, (y1, f1, err, dmid)


def _pow2_floor(x):
    """2**floor(log2|x|) (the power of two at or below |x|), at least the
    float32 normal minimum."""
    a = x.float().abs().clamp_min(float(np.finfo(np.float32).tiny))
    return torch.exp2(torch.floor(torch.log2(a)))


def kernel_bounds(want, w2, dt, tableau):
    """Bounds on |kernel - plain| for one step's (y1, f1, y1_err, dmid),
    given the plain version's outputs `want`, the field's `w2` and the
    step's `dt`: a slope may move by KERNEL_F32_SLOPE and, in bfloat16, by
    the flips above; y1 may flip its own rounding (one ULP of the state
    dtype at |y1|) and moves with the slopes times |dt| * sum|c_sol|;
    y1_err and dmid move by |dt| * sum|c| times the largest slope bound.
    y1 and f1 get one bound per element, y1_err and dmid one number each."""
    y1, f1 = want[0], want[1]
    if y1.dtype == torch.float32:
        slope = torch.full_like(f1, KERNEL_F32_SLOPE, dtype=torch.float32)
        ulp_y = _pow2_floor(y1) * 2.0 ** -23
    else:
        flips = KERNEL_BF16_FLIPS * 2.0 ** -8 * float(w2.float().abs().max())
        slope = _pow2_floor(f1) * 2.0 ** -7 + flips + KERNEL_F32_SLOPE
        ulp_y = _pow2_floor(y1) * 2.0 ** -7
    s_max, adt = float(slope.max()), abs(float(dt))
    return (ulp_y + adt * float(np.abs(tableau.c_sol).sum()) * s_max, slope,
            adt * float(np.abs(tableau.c_error).sum()) * s_max + 1e-12,
            adt * float(np.abs(tableau.c_mid).sum()) * s_max + 1e-12)
