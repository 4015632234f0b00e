"""The port's fused stage-chain step (`ops/fused_field.py`) and the 16-bit
single step (`ops/rk_step.py`) against the JAX package on the CPU.

The JAX `fused_stage_step` (benchmarks/fused_field.py) runs here both as its
portable fallback and as the Pallas kernel in `interpret=True` mode, with a
`block_b` that divides B (the port takes no tile argument: its kernel sets
its own); the port's plain version `fused_stage_step_ref` must match both.  The CUDA kernel itself is held against the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, each with its reason:
- float32: the field's two products sum D and H terms in another order in
  each framework, so a slope differs by a few ULPs of |f| <= ~4 (F32_F).
  y1 = y0 + dt * (...) adds one ULP of |y| (F32_Y).  y1_err and dmid are
  sums of (c * dt) * k, so they move by at most |dt| * sum|c| * F32_F.
- bfloat16: the products accumulate in float32, so their summation order
  can flip one bfloat16 rounding of h or of a slope: y1 and f1 are held to
  one bfloat16 ULP of their value, and y1_err and dmid to |dt| * sum|c|
  times one bfloat16 ULP of max|f|, plus the float32 bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fused_field import fused_stage_step as j_fused
import torchdiffeq_tpu as tde
from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
from torchdiffeq_tpu.ops import tableaus as jtab
from torchdiffeq_tpu.ops.rk_step import runge_kutta_step as j_rk_step
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.ops import fused_field, kernels, tableaus as ttab
from torchdiffeq_tpu_torch.ops.fused_field import (
    _check_kernel_args, fused_stage_step, fused_stage_step_ref,
    kernel_bounds, mlp_field)
from torchdiffeq_tpu_torch.ops.rk_step import runge_kutta_step

F32_F = 2e-6
F32_Y = 5e-7
J_DTYPES = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16,
            'float16': jnp.float16}
T_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
            'float16': torch.float16, 'float64': torch.float64}


def _inputs(dtype, B=16, D=8, H=32, seed=0, scale=0.3):
    """MLP weights, y0 and f0 = field(y0) from a numpy seed, in JAX (the
    bench's cast: float32 first, then the state dtype) and in the port."""
    rng = np.random.RandomState(seed)
    w1 = rng.randn(D, H) * scale
    b1 = rng.randn(H) * 0.1
    w2 = rng.randn(H, D) * scale
    b2 = rng.randn(D) * 0.1
    jd = J_DTYPES[dtype]
    jp = tuple(jnp.asarray(x, jnp.float32).astype(jd) for x in (w1, b1, w2, b2))
    jy0 = jnp.asarray(rng.randn(B, D), jnp.float32).astype(jd)
    jf0 = j_mlp_field(0.0, jy0, *jp)
    tp = fused_params_from_jax(jp)
    ty0, tf0 = fused_params_from_jax((jy0, jf0))
    return jp, jy0, jf0, tp, ty0, tf0


def fused_params_from_jax(params, *, device=None):
    """The JAX tuple ``(w1, b1, w2, b2)`` (any arrays numpy can read) as
    torch tensors of the same dtype on `device`.  A JAX bfloat16 array reads
    as an ``ml_dtypes`` array, which ``torch.from_numpy`` refuses, so its
    bits cross as int16 and are viewed as bfloat16."""
    out = []
    for p in params:
        a = np.array(p)
        if a.dtype.name == 'bfloat16':
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device))
    return tuple(out)


def j_mlp_field(t, y, w1, b1, w2, b2):
    """bench_fused_field.py:39-46."""
    h = jnp.tanh(jnp.dot(y, w1, preferred_element_type=jnp.float32)
                 + b1.astype(jnp.float32)).astype(y.dtype)
    return (jnp.dot(h, w2, preferred_element_type=jnp.float32)
            + b2.astype(jnp.float32)).astype(y.dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _bf16_ulp(x):
    """One bfloat16 ULP at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _assert_step_close(got, want, dtype, dt, tableau):
    """`got` and `want` are (y1, f1, y1_err, dmid); the module docstring
    gives each bound."""
    y1, f1, err, dmid = map(_np, got)
    wy1, wf1, werr, wdmid = map(_np, want)
    sum_err = float(np.abs(tableau.c_error).sum())
    sum_mid = float(np.abs(tableau.c_mid).sum())
    if dtype == 'float32':
        np.testing.assert_allclose(y1, wy1, rtol=0, atol=F32_Y)
        np.testing.assert_allclose(f1, wf1, rtol=0, atol=F32_F)
        slope = F32_F
    else:
        assert np.all(np.abs(y1 - wy1) <= _bf16_ulp(wy1))
        assert np.all(np.abs(f1 - wf1) <= _bf16_ulp(wf1))
        slope = float(_bf16_ulp(np.abs(wf1).max())) + F32_F
    np.testing.assert_allclose(err, werr, rtol=0,
                               atol=abs(dt) * sum_err * slope + 1e-12)
    np.testing.assert_allclose(dmid, wdmid, rtol=0,
                               atol=abs(dt) * sum_mid * slope + 1e-12)


# ---- the plain version against the JAX fallback and the Pallas interpreter

@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
@pytest.mark.parametrize("method", ['dopri5', 'bosh3', 'fehlberg2',
                                    'adaptive_heun'])
@pytest.mark.parametrize("interpret", [False, True])
def test_fused_ref_matches_jax(dtype, method, interpret):
    """FSAL (dopri5, bosh3) and non-FSAL (fehlberg2, adaptive_heun)
    tableaus, both JAX routes."""
    jp, jy0, jf0, tp, ty0, tf0 = _inputs(dtype)
    t0, dt = 0.3, 0.05
    kw = dict(block_b=8, interpret=True) if interpret else {}
    want = j_fused(j_mlp_field, jp, jy0, jf0, t0, dt,
                   getattr(jtab, method.upper()), **kw)
    tab = getattr(ttab, method.upper())
    got = fused_stage_step_ref(mlp_field, tp, ty0, tf0, t0, dt, tab)
    assert [g.dtype for g in got] == [T_DTYPES[dtype], T_DTYPES[dtype],
                                      torch.float32, torch.float32]
    assert [tuple(g.shape) for g in got] == [(16, 8)] * 4
    _assert_step_close(got, want, dtype, dt, tab)


@pytest.mark.parametrize("error_dtype", ['float32', 'float64'])
def test_fused_ref_error_dtype(error_dtype):
    """The error is summed in float32 either way; `error_dtype` sets only
    the dtype it is returned in (fused_field.py:79-81)."""
    jp, jy0, jf0, tp, ty0, tf0 = _inputs('float32', seed=3)
    jd = jnp.float64 if error_dtype == 'float64' else jnp.float32
    want = j_fused(j_mlp_field, jp, jy0, jf0, 0.0, -0.02, jtab.DOPRI5,
                   error_dtype=jd)
    got = fused_stage_step_ref(mlp_field, tp, ty0, tf0, 0.0, -0.02,
                               ttab.DOPRI5,
                               error_dtype=T_DTYPES[error_dtype])
    assert got[2].dtype == T_DTYPES[error_dtype]
    assert np.asarray(want[2]).dtype == np.dtype(error_dtype)
    _assert_step_close(got, want, 'float32', -0.02, ttab.DOPRI5)


@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
def test_fused_ref_matches_jax_at_the_bench_width(dtype):
    """D=256, H=1024 (bench_fused_field.py:25) with weights at the bench's
    scale 0.05 and dt=1e-4, at a small batch."""
    jp, jy0, jf0, tp, ty0, tf0 = _inputs(dtype, B=8, D=256, H=1024,
                                         scale=0.05)
    dt = 1e-4
    for kw in ({}, dict(block_b=4, interpret=True)):
        want = j_fused(j_mlp_field, jp, jy0, jf0, 0.0, dt, jtab.DOPRI5, **kw)
        got = fused_stage_step_ref(mlp_field, tp, ty0, tf0, 0.0, dt,
                                   ttab.DOPRI5)
        _assert_step_close(got, want, dtype, dt, ttab.DOPRI5)


@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
def test_fused_chain_and_stock_chain_match_jax(dtype):
    """The bench's comparison at a small size: a chain of fused dopri5
    steps and the same chain of the stock step with error_dtype=float32,
    each against its JAX chain, and the two chains' sum|y| against each
    other (bench_fused_field.py:98-103)."""
    jp, jy0, jf0, tp, ty0, tf0 = _inputs(dtype, B=16, D=32, H=128,
                                         scale=0.1)
    dt, n = 1e-3, 5

    def j_stock(t, y, perturb=None):
        return j_mlp_field(t, y, *jp)

    def t_stock(t, y, perturb=None):
        return mlp_field(t, y, *tp)

    jy, jf, ty, tf = jy0, jf0, ty0, tf0
    sy, sf, jsy, jsf = ty0, tf0, jy0, jf0
    for i in range(n):
        t0 = np.float32(i) * np.float32(dt)
        jy, jf, _, _ = j_fused(j_mlp_field, jp, jy, jf, t0, dt, jtab.DOPRI5)
        ty, tf, _, _ = fused_stage_step(mlp_field, tp, ty, tf, t0, dt,
                                        ttab.DOPRI5)
        jsy, jsf, _, _ = j_rk_step(j_stock, jsy, jsf, t0, dt, t0 + dt,
                                   jtab.DOPRI5, error_dtype=jnp.float32)
        sy, sf, err, _ = runge_kutta_step(t_stock, sy, sf, t0, dt, t0 + dt,
                                          ttab.DOPRI5,
                                          error_dtype=torch.float32)
        assert err.dtype == torch.float32
    # n steps of a per-step bound, each of dt * |f| ~ 1e-3 on |y| ~ 3
    tol = n * (F32_Y if dtype == 'float32' else float(_bf16_ulp(4.0)))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(sy), _np(jsy), rtol=0, atol=tol)
    fused_sum = float(ty.float().abs().sum())
    stock_sum = float(sy.float().abs().sum())
    assert abs(fused_sum - stock_sum) <= 16 * 32 * tol


# ---- the 16-bit single step, error_dtype -----------------------------------

@pytest.mark.parametrize("dtype", ['bfloat16', 'float16', 'float32'])
@pytest.mark.parametrize("method", ['dopri5', 'fehlberg2'])
@pytest.mark.parametrize("error_dtype", [None, 'float32'])
def test_runge_kutta_step_matches_jax(dtype, method, error_dtype):
    """The stock step in the state dtype, with and without a float32 error
    sum.  Every stage combination is elementwise in the same order as JAX,
    so 16-bit states agree exactly; float32 differs only through the
    field's products (F32_F), the error by |dt| * sum|c_error| * F32_F."""
    jp, jy0, jf0, tp, ty0, tf0 = _inputs(dtype, seed=1)
    t0, dt = 0.3, 0.05

    def j_func(t, y, perturb=None):
        return j_mlp_field(t, y, *jp)

    def t_func(t, y, perturb=None):
        return mlp_field(t, y, *tp)

    want = j_rk_step(j_func, jy0, jf0, t0, dt, t0 + dt,
                     getattr(jtab, method.upper()),
                     error_dtype=None if error_dtype is None
                     else jnp.float32)
    tab = getattr(ttab, method.upper())
    got = runge_kutta_step(t_func, ty0, tf0, t0, dt, t0 + dt, tab,
                           error_dtype=None if error_dtype is None
                           else torch.float32)
    err_dtype = T_DTYPES[error_dtype or dtype]
    assert got[0].dtype == T_DTYPES[dtype] and got[2].dtype == err_dtype
    assert len(got[3]) == tab.n_stages
    if dtype == 'float32':
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0,
                                   atol=F32_Y)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=0,
                                   atol=F32_F)
        bound = dt * float(np.abs(tab.c_error).sum()) * F32_F
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=0,
                                   atol=bound)
    else:
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(_np(g), _np(w))


def test_16bit_state_refused_by_the_solvers():
    """The adaptive loop takes 16-bit states: the same Stats as JAX's on
    the same call (a float16 solve at the default rtol=1e-7 underflows its
    step in both, error code 1), and the same bfloat16 values
    (tests/test_torch_dtypes.py holds the rest); the per-lane kernels'
    route takes them as JAX's does."""
    y0 = np.ones((4, 2))
    t = np.linspace(0.0, 1.0, 3)
    for j_dt, t_dt in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float16, torch.float16)):
        ys_j, st_j = tde.odeint_with_stats(lambda t_, y: -y,
                                           jnp.asarray(y0, j_dt),
                                           jnp.asarray(t))
        ys_t, st_t = tt.odeint_with_stats(lambda t_, y: -y,
                                          torch.tensor(y0, dtype=t_dt),
                                          torch.from_numpy(t))
        assert ys_t.dtype == t_dt
        assert list(st_t[:5]) == [int(x) for x in st_j[:5]]
        if t_dt == torch.bfloat16:
            np.testing.assert_array_equal(
                ys_t.float().numpy(), np.asarray(ys_j.astype(jnp.float32)))
    # the per-lane kernels' route takes them too: bfloat16 counts and
    # values JAX's kernel's in interpret mode (compiled with XLA's excess
    # precision off, as tests/test_torch_lanes_16bit.py explains)
    kw = dict(rtol=1e-2, atol=1e-3,
              options=dict(pallas=True, interpret=True, max_num_steps=100))
    y0_16 = np.linspace(0.5, 1.5, 8).reshape(4, 2)
    ys_j, st_j = jax.jit(lambda y: j_per_sample(
        lambda t_, y_: -y_, y, t, **kw)).lower(
        jnp.asarray(y0_16, jnp.bfloat16)).compile(
        compiler_options={'xla_allow_excess_precision': False})(
        jnp.asarray(y0_16, jnp.bfloat16))
    ys_t, st_t = tt.odeint_per_sample_with_stats(
        lambda t_, y: -y, torch.tensor(y0_16).bfloat16(),
        torch.from_numpy(t), **kw)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ys_t.float().numpy(),
                                  np.asarray(ys_j.astype(jnp.float32)))


# ---- the wrapper, the parameters' crossing and the refusals ----------------

def test_fused_stage_step_on_cpu_runs_the_plain_version():
    jp, jy0, jf0, tp, ty0, tf0 = _inputs('bfloat16')
    before = dict(kernels.launch_counts)
    got = fused_stage_step(mlp_field, tp, ty0, tf0, 0.1, 0.01, ttab.TSIT5,
                           error_dtype=torch.float64)
    want = fused_stage_step_ref(mlp_field, tp, ty0, tf0, 0.1, 0.01,
                                ttab.TSIT5, error_dtype=torch.float64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert kernels.launch_counts == before


def test_fused_ref_takes_any_callable():
    """The plain version runs any field(t, y, *params), time included:
    stage times are formed in float32 and cast to the state dtype, with
    t0 + dt at alpha == 1 and no Perturb nudge (fused_field.py:145-146)."""
    def j_field(t, y, a):
        return -a * y + t

    def t_field(t, y, a):
        return -a * y + t

    rng = np.random.RandomState(2)
    y0 = rng.randn(8, 4).astype(np.float32)
    a = np.float32(0.7)
    jy0 = jnp.asarray(y0)
    want = j_fused(j_field, (jnp.asarray(a),), jy0, j_field(0.5, jy0, a),
                   0.5, 0.125, jtab.DOPRI5)
    ty0 = torch.from_numpy(y0)
    got = fused_stage_step_ref(t_field, (torch.tensor(a),), ty0,
                               t_field(torch.tensor(0.5), ty0, a), 0.5,
                               0.125, ttab.DOPRI5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
def test_fused_params_from_jax_keeps_the_bits(dtype):
    jp = _inputs(dtype, D=4, H=16)[0]
    tp = fused_params_from_jax(jp)
    for j, t in zip(jp, tp):
        assert t.dtype == T_DTYPES[dtype] and tuple(t.shape) == j.shape
        bits_j = np.asarray(j).view(np.int16 if dtype == 'bfloat16'
                                    else np.int32)
        bits_t = t.view(torch.int16 if dtype == 'bfloat16'
                        else torch.int32).numpy()
        np.testing.assert_array_equal(bits_t, bits_j)


def test_fused_step_refusals():
    """No c_mid raises as in JAX, and a parameter that needs a gradient
    raises (the step is forward-only)."""
    jp, jy0, jf0, tp, ty0, tf0 = _inputs('float32')
    no_mid = dataclasses.replace(ttab.BOSH3, c_mid=None)
    j_no_mid = dataclasses.replace(jtab.BOSH3, c_mid=None)
    with pytest.raises(ValueError, match="c_mid"):
        j_fused(j_mlp_field, jp, jy0, jf0, 0.0, 0.1, j_no_mid)
    for fn in (fused_stage_step, fused_stage_step_ref):
        with pytest.raises(ValueError, match="c_mid"):
            fn(mlp_field, tp, ty0, tf0, 0.0, 0.1, no_mid)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_stage_step(mlp_field, tuple(p.requires_grad_() for p in tp),
                         ty0, tf0, 0.0, 0.1, ttab.DOPRI5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bounds_catch_a_wrong_error_estimate(dtype):
    """The card holds K-fused to `kernel_bounds` and its y1_err also by its
    median (chip_smoke.py phase 9): in float32 at dt=0.75, the bench's
    width and weight scale, the y1_err bound is at most a tenth of the
    median |y1_err|; in bfloat16 at dt=1e-4 the median |y1_err| is not
    zero.  Either way an estimate with its first c_error term dropped, or
    all zeros, fails its check.  Here the plain version stands in for the
    kernel."""
    rng = np.random.RandomState(1)
    w1, w2 = (torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))
              .to(dtype) for s in ((256, 1024), (1024, 256)))
    params = (w1, torch.zeros(1024, dtype=dtype), w2,
              torch.zeros(256, dtype=dtype))
    y0 = torch.from_numpy(rng.randn(8, 256).astype(np.float32)).to(dtype)
    f0 = mlp_field(0.0, y0, *params)
    dt = np.float32(0.75 if dtype == torch.float32 else 1e-4)
    tab = ttab.DOPRI5
    want = fused_stage_step_ref(mlp_field, params, y0, f0, 0.0, dt, tab)
    bounds = kernel_bounds(want, w2, dt, tab)
    assert [tuple(b.shape) for b in bounds[:2]] == [(8, 256)] * 2
    median_err = float(want[2].abs().median())
    dropped = want[2] - float(np.float32(tab.c_error[0]) * dt) * f0.float()
    for wrong in (torch.zeros_like(want[2]), dropped):
        d = (wrong - want[2]).abs()
        if dtype == torch.float32:
            assert bounds[2] <= 0.1 * median_err
            assert float((d > bounds[2]).float().mean()) > 0.5
        else:
            assert float(d.median()) > 0.1 * median_err > 0


def test_fused_kernel_refuses_what_it_cannot_run():
    """What the CUDA route would refuse, through the check it runs before
    a launch (the kernel itself needs the card)."""
    tp, ty0, tf0 = _inputs('float32', D=32, H=128)[3:]
    assert _check_kernel_args(mlp_field, tp, ty0, tf0, ttab.DOPRI5)[1] == 128
    with pytest.raises(TypeError, match="mlp_field"):
        _check_kernel_args(lambda t, y, *p: -y, tp, ty0, tf0, ttab.DOPRI5)
    with pytest.raises(ValueError, match="at most 7 stages"):
        _check_kernel_args(mlp_field, tp, ty0, tf0, ttab.DOPRI8)
    with pytest.raises(TypeError, match="bfloat16"):
        _check_kernel_args(mlp_field, [p.double() for p in tp], ty0.double(),
                           tf0.double(), ttab.DOPRI5)
    with pytest.raises(ValueError, match="contiguous"):
        _check_kernel_args(mlp_field, tp, ty0.T, tf0.T, ttab.DOPRI5)
    tp8, ty8, tf8 = _inputs('float32', D=8, H=128)[3:]
    with pytest.raises(ValueError, match="D in"):
        _check_kernel_args(mlp_field, tp8, ty8, tf8, ttab.DOPRI5)
    tp_h, ty_h, tf_h = _inputs('float32', D=32, H=96)[3:]
    with pytest.raises(ValueError, match="multiple of 128"):
        _check_kernel_args(mlp_field, tp_h, ty_h, tf_h, ttab.DOPRI5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fused_field.KERNEL_D)
@pytest.mark.parametrize("H,B", [(128, 1), (384, 1000), (1024, 4096)])
def test_fused_plan(dtype, D, H, B):
    """The kernel's launch for every (dtype, D) it is built for: 32 KB
    weight tiles that cut D and the 128-unit chunk evenly (into wgmma K
    steps of 16 in bfloat16, 4-deep FMA steps in float32), shared memory
    within a Hopper block's 227 KB, one block a 32-row tile, and in
    bfloat16 clusters of two blocks that share each tile."""
    plan = fused_field.fused_plan(dtype, D, H, B)
    size = 4 if dtype == torch.float32 else 2
    r1, r2 = plan['w1_tile_rows'], plan['w2_tile_rows']
    step = 16 if dtype == torch.bfloat16 else 4
    assert D % r1 == 0 and 128 % r2 == 0 and r1 % step == 0 and r2 % step == 0
    assert r1 * 128 * size <= 32768 and r2 * D * size <= 32768
    assert plan['tiles_per_chunk'] == D // r1 + 128 // r2
    cluster = 2 if dtype == torch.bfloat16 else 1
    assert plan['cluster'] == cluster
    assert plan['threads'] == (288 if dtype == torch.bfloat16 else 256)
    assert plan['blocks'] % cluster == 0
    assert plan['blocks'] - cluster < -(-B // 32) <= plan['blocks']
    assert plan['shared_bytes'] <= 227 * 1024
    assert (plan['weight_bytes_per_eval']
            == plan['blocks'] // cluster * 2 * D * H * size)
    assert ('wgmma' in plan['products']) == (dtype == torch.bfloat16)
    assert plan['instance'] == (f"fused_step<{'f32' if size == 4 else 'bf16'}"
                                f",D={D}>")


def test_fused_plan_at_the_bench_width():
    """B=4096, D=256, H=1024: 128 blocks for the H100's 132 SMs; per
    dopri5 step 384 MiB of bfloat16 weights read from L2 for 64 clusters
    of two, 1.5 GiB of float32 ones for 128 blocks."""
    f32 = fused_field.fused_plan(torch.float32, 256, 1024, 4096)
    bf16 = fused_field.fused_plan(torch.bfloat16, 256, 1024, 4096)
    assert f32['blocks'] == bf16['blocks'] == 128
    assert (f32['w1_tile_rows'], f32['w2_tile_rows']) == (64, 32)
    assert (bf16['w1_tile_rows'], bf16['w2_tile_rows']) == (128, 64)
    assert 6 * bf16['weight_bytes_per_eval'] == 384 * 2 ** 20
    assert 6 * f32['weight_bytes_per_eval'] == 1536 * 2 ** 20
    assert (f32['shared_bytes'], bf16['shared_bytes']) == (181248, 155712)


@pytest.mark.parametrize("dtype,D,H,B", [
    (torch.float64, 32, 128, 8), (torch.float32, 48, 128, 8),
    (torch.bfloat16, 32, 100, 8), (torch.float32, 32, 128, 0)])
def test_fused_plan_refuses_what_the_kernel_cannot_run(dtype, D, H, B):
    with pytest.raises(ValueError, match="no fused_stage_step kernel"):
        fused_field.fused_plan(dtype, D, H, B)


def test_packed_coefs_layout_unchanged():
    """The coefficients the kernel is given: beta rows, c_sol, c_error,
    c_mid times dt32 (rounded in float32), zeros skipped in the masks."""
    dt32 = np.float32(1e-3)
    coefs, masks = fused_field._packed_coefs(ttab.DOPRI5, dt32)
    assert coefs.shape == (9, 7) and coefs.dtype == np.float32
    assert masks.dtype == np.int32
    tab = ttab.DOPRI5
    for i in range(len(tab.alpha)):
        for j in range(i + 1):
            c = float(tab.beta[i, j])
            assert coefs[i, j] == (np.float32(c) * dt32 if c else 0.0)
            assert bool(masks[i] >> j & 1) == (c != 0.0)
    for r, vec in zip((6, 7, 8), (tab.c_sol, tab.c_error, tab.c_mid)):
        want = [np.float32(float(c)) * dt32 for c in vec]
        np.testing.assert_array_equal(coefs[r, :len(vec)], want)
        assert masks[r] == sum(1 << j for j, c in enumerate(vec) if float(c))
