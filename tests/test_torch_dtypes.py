"""16-bit states in the PyTorch port's adaptive and fixed-grid loops, and
`error_dtype`, against the JAX package (mirrors the bfloat16/float16 cases
of tests/test_dtypes.py and the error_dtype cases of
tests/test_fastpath.py:151-207).

The host loops round every scalar product JAX makes in the state dtype
through `misc.scalar_type` (bfloat16 as 0-d tensors, numpy has none), a
16-bit state's dense output is fit in float32 on the step's increments,
and the controller runs in float64, the time dtype.  So the `Stats` are
exactly JAX's, and on fields of plain arithmetic the values too; where the
field or a float32 reduction rounds differently (the error norm's
summation order), values are held to one unit in the last place of the
state dtype (bfloat16: 2^-7 relative; float16: 2^-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt

DTYPES = {'bfloat16': (jnp.bfloat16, torch.bfloat16, 2.0 ** -7),
          'float16': (jnp.float16, torch.float16, 2.0 ** -10)}


def _counters(st):
    return [int(x) for x in st[:5]]


def _f(t, y):
    return -y + 0.5 * y * y


Y0 = np.array([1.0, 0.5, -0.3, 2.0])


def _both(dtype, t, *, y0=Y0, func=_f, options=None, **kw):
    j_dt, t_dt, _ = DTYPES[dtype]
    opts_j = dict(options or {})
    opts_t = dict(options or {})
    if opts_j.get('error_dtype'):
        opts_j['error_dtype'], opts_t['error_dtype'] = (jnp.float32,
                                                        torch.float32)
    ys_j, st_j = tde.odeint_with_stats(func, jnp.asarray(y0, j_dt),
                                       jnp.asarray(t), options=opts_j, **kw)
    ys_t, st_t = tt.odeint_with_stats(func, torch.tensor(y0, dtype=t_dt),
                                      torch.tensor(t, dtype=torch.float64),
                                      options=opts_t, **kw)
    return (np.asarray(ys_j.astype(jnp.float32)), st_j), (ys_t, st_t)


def _close(ys_t, ys_j, ulp):
    np.testing.assert_allclose(ys_t.float().numpy(), ys_j, rtol=ulp,
                               atol=ulp * 1e-3)


@pytest.mark.parametrize("error_dtype", [None, 'float32'])
@pytest.mark.parametrize("method", ['dopri5', 'bosh3', 'tsit5',
                                    'adaptive_heun'])
@pytest.mark.parametrize("dtype", ['bfloat16', 'float16'])
def test_adaptive_16bit_matches_jax(dtype, method, error_dtype):
    """The adaptive loop on a 16-bit state, with and without float32 error
    control: the state dtype out, Stats exactly JAX's, values within one
    unit in the last place.  float16 runs at rtol=1e-2: its initial-step
    norm squares |y / scale|, which overflows float16 past 256 (in both
    packages; at rtol=1e-3 both report ERR_DT_UNDERFLOW).  Its values are
    held to three times the solve's tolerance, 3 (rtol |y| + atol), the
    global error two solves at that tolerance may each carry: XLA's CPU
    code for a chain of float16 operations need not round after each one
    as torch's eager operations do, so a step's error ratio, and with it
    the next step size, can differ (by 2% on dopri5 here) while every
    decision agrees (measured: 0.0048 at most, against a bound of 0.0096).
    """
    _, t_dt, ulp = DTYPES[dtype]
    opts = dict(error_dtype=error_dtype) if error_dtype else None
    tol = (dict(rtol=1e-3, atol=1e-4) if dtype == 'bfloat16'
           else dict(rtol=1e-2, atol=1e-3))
    (ys_j, st_j), (ys_t, st_t) = _both(dtype, np.linspace(0.0, 1.0, 4),
                                       method=method, options=opts, **tol)
    assert ys_t.dtype == t_dt
    assert _counters(st_t) == _counters(st_j)
    assert st_t.error_code == 0 and st_t.n_steps > 2
    if dtype == 'float16':
        np.testing.assert_allclose(ys_t.float().numpy(), ys_j,
                                   rtol=3 * tol['rtol'], atol=3 * tol['atol'])
    else:
        _close(ys_t, ys_j, ulp)


@pytest.mark.parametrize("interp", ['linear', 'cubic'])
@pytest.mark.parametrize("method", ['euler', 'midpoint', 'heun2', 'heun3',
                                    'rk4'])
@pytest.mark.parametrize("dtype", ['bfloat16', 'float16'])
def test_fixed_grid_16bit_matches_jax(dtype, method, interp):
    """A 16-bit state on the float64 grid: the stages after the first are
    float64 and the increment is rounded back, as in JAX."""
    _, t_dt, ulp = DTYPES[dtype]
    (ys_j, st_j), (ys_t, st_t) = _both(
        dtype, np.linspace(0.0, 1.0, 4), method=method,
        options=dict(step_size=0.1, interp=interp))
    assert ys_t.dtype == t_dt
    assert _counters(st_t) == _counters(st_j)
    _close(ys_t, ys_j, ulp)


def test_bfloat16_state():
    """JAX test_dtypes.py::test_bfloat16_state."""
    ys = tt.odeint(lambda t, y: -y, torch.tensor([1.0], dtype=torch.bfloat16),
                   torch.linspace(0.0, 1.0, 3), rtol=1e-2, atol=1e-2)
    assert ys.dtype == torch.bfloat16
    assert abs(float(ys[-1, 0]) - np.exp(-1)) < 0.02


def test_float32_state_f64_time():
    """JAX test_dtypes.py::test_float32_state_f64_time."""
    ys = tt.odeint(lambda t, y: -y, torch.tensor([1.0], dtype=torch.float32),
                   torch.linspace(0.0, 1.0, 3, dtype=torch.float64))
    assert ys.dtype == torch.float32
    np.testing.assert_allclose(float(ys[-1, 0]), np.exp(-1), rtol=1e-5)


def test_error_dtype_reduces_bf16_churn():
    """JAX test_fastpath.py::test_error_dtype_reduces_bf16_churn: float32
    error control of a bfloat16 state takes fewer steps at rtol=1e-5, with
    JAX's counts on both runs."""
    y0 = np.ones((4, 2))
    t = np.linspace(0.0, 1.0, 3)
    f = lambda t_, y: -y
    (_, st_plain_j), (_, st_plain) = _both('bfloat16', t, y0=y0, func=f,
                                           rtol=1e-5, atol=1e-7)
    (_, st_mixed_j), (_, st_mixed) = _both(
        'bfloat16', t, y0=y0, func=f, rtol=1e-5, atol=1e-7,
        options=dict(error_dtype='float32'))
    assert st_mixed.error_code == 0
    assert st_mixed.n_steps < st_plain.n_steps
    assert _counters(st_plain) == _counters(st_plain_j)
    assert _counters(st_mixed) == _counters(st_mixed_j)


@pytest.mark.parametrize("error_dtype", [None, 'float32'])
def test_bf16_interpolated_outputs_accurate(error_dtype):
    """JAX test_fastpath.py::test_bf16_interpolated_outputs_accurate: the
    float32 increment-form fit keeps interpolated outputs within 3% of
    exp(-t); the values equal JAX's."""
    t = np.linspace(0.0, 2.0, 9)
    opts = dict(error_dtype=error_dtype) if error_dtype else None
    (ys_j, st_j), (ys_t, st_t) = _both('bfloat16', t, y0=np.array([1.0]),
                                       func=lambda t_, y: -y, rtol=1e-3,
                                       atol=1e-5, options=opts)
    assert ys_t.dtype == torch.bfloat16
    rel = np.abs(ys_t[:, 0].double().numpy() / np.exp(-t) - 1).max()
    assert rel < 0.03, rel
    assert _counters(st_t) == _counters(st_j)
    _close(ys_t, ys_j, DTYPES['bfloat16'][2])


def test_bf16_event_time_accurate():
    """JAX test_fastpath.py::test_bf16_event_time_accurate: the event is
    bisected on the float32 interpolant, y_event is bfloat16, and the
    event time is JAX's."""
    kw = dict(event_fn=lambda t, y: y[0] - 0.5, rtol=1e-3, atol=1e-5)
    ev_j, y_j = tde.odeint_event(lambda t, y: -y,
                                 jnp.array([1.0], jnp.bfloat16),
                                 jnp.array(0.0), **kw)
    ev_t, y_t = tt.odeint_event(lambda t, y: -y,
                                torch.tensor([1.0], dtype=torch.bfloat16),
                                0.0, **kw)
    assert y_t.dtype == torch.bfloat16
    assert abs(float(ev_t) - np.log(2)) < 0.02
    assert abs(float(ev_t) - float(ev_j)) <= 1e-12
    np.testing.assert_array_equal(y_t.float().numpy(),
                                  np.asarray(y_j.astype(jnp.float32)))


def test_error_dtype_noop_on_f32():
    """JAX test_fastpath.py::test_error_dtype_noop_on_f32."""
    y0 = torch.tensor([1.0, 2.0], dtype=torch.float32)
    t = torch.linspace(0.0, 2.0, 5)
    ys_a, st_a = tt.odeint_with_stats(lambda t_, y: -y, y0, t, rtol=1e-6,
                                      atol=1e-8)
    ys_b, st_b = tt.odeint_with_stats(lambda t_, y: -y, y0, t, rtol=1e-6,
                                      atol=1e-8,
                                      options=dict(error_dtype=torch.float32))
    assert st_a.n_steps == st_b.n_steps
    assert torch.equal(ys_a, ys_b)


@pytest.mark.parametrize("controller", ['pi', 'pid'])
def test_bf16_with_error_dtype_and_a_controller(controller):
    """The options together: a bfloat16 state, float32 error control and the
    PI/PID controller, Stats exactly JAX's."""
    opts = dict(error_dtype='float32', controller=controller, dcoeff=0.2)
    (ys_j, st_j), (ys_t, st_t) = _both('bfloat16', np.linspace(0.0, 1.0, 3),
                                       rtol=1e-4, atol=1e-6, options=opts)
    assert _counters(st_t) == _counters(st_j)
    _close(ys_t, ys_j, DTYPES['bfloat16'][2])


def test_bf16_fixed_grid_gradient_through_the_loop():
    """Backprop through a bfloat16 fixed-grid solve: the gradient of the
    final state of y' = -y to y0 is exp(-1) within the bfloat16 noise."""
    y0 = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    ys = tt.odeint(lambda t, y: -y, y0, torch.tensor([0.0, 1.0]),
                   method='rk4', options=dict(num_steps=10))
    ys[-1].float().sum().backward()
    assert y0.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(y0.grad.double().numpy(), np.exp(-1.0),
                               rtol=0.02)


def test_complex_state_still_refused():
    """Formerly the refusal of complex states; the port now takes them
    (tests/test_torch_complex.py has the rest), so the same call is held to
    JAX's: complex128 values within 1e-12 of max|y|, the counters exactly.
    (The name is kept so that the test's history stays in one place.)"""
    t = np.linspace(0.0, 1.0, 3)
    ys_j, st_j = tde.odeint_with_stats(lambda t_, y: 1j * y,
                                       jnp.ones(1, jnp.complex128),
                                       jnp.asarray(t))
    ys_t, st_t = tt.odeint_with_stats(lambda t_, y: 1j * y,
                                      torch.ones(1, dtype=torch.complex128),
                                      torch.from_numpy(t))
    assert ys_t.dtype == torch.complex128
    assert _counters(st_t) == _counters(st_j)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)
