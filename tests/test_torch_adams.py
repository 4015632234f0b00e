"""The Adams tier of the PyTorch port (explicit_adams, implicit_adams and
its alias fixed_adams) against the JAX package on the same numpy inputs
(CPU, x64).  Mirrors the Adams rows of tests/test_convergence.py,
tests/test_events.py, tests/test_gradients.py (gradcheck_y0/t, as parity
with `jax.grad`) and tests/test_odeint.py, plus the options JAX takes
(max_order, max_iters, implicit, perturb, interp) and tuple states.

Bounds: float64 values within 1e-10 and `Stats` exactly equal (nfe is
JAX's count, though the port's corrector stops at convergence, ROADMAP
C3); gradients within 1e-9 of the largest entry; float32 values within
1e-5, its reason in its test.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import (assert_grads_close, construct_problem, counters,
                            grads_pair, solve_pair)

ADAMS = ['explicit_adams', 'implicit_adams', 'fixed_adams']
VALUE_TOL = 1e-10
GRAD_TOL = 1e-9


def _field_j(t, y):
    return -0.7 * y + 0.3 * jnp.sin(t) * y * y


def _field_t(t, y):
    return -0.7 * y + 0.3 * torch.sin(t) * y * y


Y0 = np.array([0.5, -0.25, 1.0])


@pytest.mark.parametrize("opts,reverse", [
    (dict(step_size=0.05), False),
    (dict(num_steps=17, interp='cubic'), True),
    (dict(step_size=0.05, max_order=4, perturb=True), False),
    (dict(step_size=0.2, max_iters=1), False),
], ids=['step_size', 'cubic-rev', 'order4-perturb', 'max_iters1'])
@pytest.mark.parametrize("method", ADAMS)
def test_values_and_stats_match_jax(method, opts, reverse):
    """Every option JAX's Adams solver takes; `max_iters=1` leaves the
    corrector unconverged on most steps, which drops the oldest history
    entry (fixed_adams.py:219-221) and holds the order down."""
    t = np.linspace(0.0, 1.5, 4)
    if reverse:
        t = t[::-1].copy()
    ys_j, st_j, ys_t, st_t = solve_pair(_field_j, _field_t, Y0, t,
                                        method=method, options=opts)
    assert st_t == st_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)


def test_implicit_option_and_tuple_state_match_jax():
    """``implicit=False`` turns implicit_adams into the explicit one, and a
    tuple state is flattened as JAX ravels it."""
    t = np.linspace(0.0, 1.0, 3)
    kw = dict(method='implicit_adams', options=dict(step_size=0.1,
                                                    implicit=False))
    _, st_j, ys_t, st_t = solve_pair(_field_j, _field_t, Y0, t, **kw)
    _, _, ys_e, st_e = solve_pair(_field_j, _field_t, Y0, t,
                                  method='explicit_adams',
                                  options=dict(step_size=0.1))
    assert st_t == st_j == st_e
    np.testing.assert_array_equal(ys_t, ys_e)

    y0 = (np.array([0.5, -0.25]), np.array([[1.0, 2.0]]))
    fj = lambda s, y: (_field_j(s, y[0]), -1.3 * y[1] + jnp.cos(s))
    ft = lambda s, y: (_field_t(s, y[0]), -1.3 * y[1] + torch.cos(s))
    kw = dict(method='implicit_adams', options=dict(step_size=0.05))
    ys_j, st_j = tde.odeint_with_stats(fj, tuple(map(jnp.asarray, y0)),
                                       jnp.asarray(t), **kw)
    ys_p, st_p = tt.odeint_with_stats(ft, tuple(map(torch.from_numpy, y0)),
                                      torch.from_numpy(t), **kw)
    assert counters(st_p) == counters(st_j)
    for a, b in zip(ys_p, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=VALUE_TOL)


def test_max_order_below_four_is_rk4():
    """max_order < 4 warns and every step is the RK4 bootstrap (3 more
    evaluations a step), in both packages."""
    t = np.linspace(0.0, 1.0, 3)
    with pytest.warns(UserWarning, match="reduces to `rk4`"):
        ys_t = tt.odeint(_field_t, torch.from_numpy(Y0), torch.from_numpy(t),
                         method='implicit_adams',
                         options=dict(step_size=0.1, max_order=3))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ys_j, st_j, ys_p, st_p = solve_pair(
            _field_j, _field_t, Y0, t, method='implicit_adams',
            options=dict(step_size=0.1, max_order=3))
    assert st_p == st_j and st_p[0] == 4 * st_p[1]
    np.testing.assert_allclose(ys_p, ys_j, rtol=0, atol=VALUE_TOL)
    np.testing.assert_array_equal(ys_t.numpy(), ys_p)


def test_float32_matches_jax():
    """float32 state: dt and the slopes' sums are formed in float64 from
    the float32 values and rounded back (JAX's promotion) and the field
    runs in float32 on both sides, where XLA's fused kernels may round a
    product or a sine otherwise; over 20 steps on |y| <= 1 the two agree
    to 1e-5, and the corrector's convergence decisions, so Stats,
    exactly."""
    t = np.linspace(0.0, 1.0, 3)
    y0 = Y0.astype(np.float32)
    kw = dict(method='implicit_adams', options=dict(step_size=0.05))
    ys_j, st_j = tde.odeint_with_stats(_field_j, jnp.asarray(y0),
                                       jnp.asarray(t), **kw)
    ys_t, st_t = tt.odeint_with_stats(_field_t, torch.from_numpy(y0),
                                      torch.from_numpy(t), **kw)
    assert ys_t.dtype == torch.float32
    assert counters(st_t) == counters(st_j)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("method,p", [('explicit_adams', 3),
                                      ('implicit_adams', 4)])
def test_convergence_order(method, p):
    """tests/test_convergence.py's Adams rows (y' = y cos t on [0, 1],
    max_order 4, h = 1/32 and 1/64): the endpoint errors equal JAX's to
    1e-10 and the measured order is JAX's expectation."""
    t = np.array([0.0, 1.0])
    y0 = np.array([1.0])
    errs = []
    for h in (1 / 32, 1 / 64):
        ys_j, st_j, ys_t, st_t = solve_pair(
            lambda s, y: y * jnp.cos(s), lambda s, y: y * torch.cos(s), y0,
            t, method=method, options=dict(step_size=h, max_order=4))
        assert st_t == st_j
        np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
        errs.append(abs(float(ys_t[-1, 0]) - np.exp(np.sin(1.0))))
    assert np.log2(errs[0] / errs[1]) > p - 0.4, errs


@pytest.mark.parametrize("method", ['explicit_adams', 'implicit_adams'])
def test_event_matches_jax(method):
    """tests/test_events.py:24-50 for Adams (the circle's sin t crossing 0
    at pi, step_size 0.01, cubic, max_order 6): the event time and state
    equal JAX's to 1e-10, Stats exactly, and the crossing is pi's."""
    y0 = np.array([np.sin(0.5), np.cos(0.5)])
    kw = dict(method=method, rtol=1e-8, atol=1e-10,
              options=dict(step_size=0.01, interp='cubic', max_order=6))
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        lambda t, y: jnp.stack([y[1], -y[0]]), jnp.asarray(y0),
        jnp.asarray([0.5, 1.5]), event_fn=lambda t, y: y[0], **kw)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        lambda t, y: torch.stack([y[1], -y[0]]), torch.from_numpy(y0),
        torch.tensor([0.5, 1.5], dtype=torch.float64),
        event_fn=lambda t, y: y[0], **kw)
    assert counters(st_t) == counters(st_j)
    assert abs(float(et_t) - float(et_j)) <= VALUE_TOL
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=VALUE_TOL)
    assert abs(float(et_t) - np.pi) < 2e-4


@pytest.mark.parametrize("method", ADAMS)
def test_gradcheck_y0_matches_jax(method):
    """tests/test_gradients.py::test_gradcheck_y0's Adams cases (the
    10-dim linear problem, num_steps 70, max_order 4): the gradient
    through the loop equals `jax.grad`'s within 1e-9 of its largest
    entry."""
    f_j, f_t, y0, t = construct_problem(ode='linear', npts=3)
    w = np.arange(1.0, 1.0 + y0.shape[0])
    g_j, g_t = grads_pair(
        f_j, f_t, y0, t, lambda ys: jnp.sum(ys[-1] * w),
        lambda ys: (ys[-1] * torch.from_numpy(w)).sum(), method=method,
        options=dict(num_steps=70, max_order=4))
    assert_grads_close(g_t, g_j, GRAD_TOL)


@pytest.mark.parametrize("method", ADAMS)
def test_gradcheck_t_matches_jax(method):
    """tests/test_gradients.py::test_gradcheck_t's Adams cases (the sine
    problem, its output times as the grid, max_order 4): the gradients to
    y0 and to the times equal `jax.grad`'s within 1e-9 of the largest
    entry."""
    f_j, f_t, y0, t = construct_problem(ode='sine', npts=4)
    g_j, g_t = grads_pair(f_j, f_t, y0, t, lambda ys: jnp.sum(ys ** 2),
                          lambda ys: (ys ** 2).sum(), method=method,
                          options=dict(max_order=4))
    assert_grads_close(g_t, g_j, GRAD_TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=['fwd', 'rev'])
@pytest.mark.parametrize("method", ['explicit_adams', 'implicit_adams'])
def test_odeint_accuracy_matches_jax(method, reverse):
    """tests/test_odeint.py::test_odeint_accuracy's Adams rows (the
    constant problem on its output grid): values and Stats equal JAX's, and
    within the reference's 3e-4 relative budget of the exact solution."""
    f_j, f_t, y0, t = construct_problem(ode='constant', reverse=reverse)
    ys_j, st_j, ys_t, st_t = solve_pair(f_j, f_t, y0, t, method=method)
    assert st_t == st_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    exact = 0.2 * t[:, None] + 3.0
    assert np.max(np.abs(exact - ys_t) / (1e-6 + np.abs(exact))) < 3e-4


def test_single_time_point():
    """tests/test_odeint.py::test_single_time_point for implicit_adams."""
    y = torch.tensor([3.2], dtype=torch.float64)
    ys = tt.odeint(lambda t, yy: -yy, y, torch.tensor([1.0]),
                   method='implicit_adams', options=dict(step_size=0.1))
    assert ys.shape == (1, 1) and float(ys[0, 0]) == 3.2


def test_spiral_parameter_gradients_match_jax():
    """The spiral MLP field (B=4, H=8, float64): implicit_adams through the
    loop, the gradients of mean(ys**2) to y0 and the parameters equal
    `jax.grad`'s within 1e-9 of the largest entry."""
    from torchdiffeq_tpu.models import spiral_field
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    rng = np.random.RandomState(0)
    params = [dict(w=rng.randn(2, 8) * 0.5, b=rng.randn(8) * 0.1),
              dict(w=rng.randn(8, 2) * 0.5, b=rng.randn(2) * 0.1)]
    y0 = rng.randn(4, 2)
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method='implicit_adams', options=dict(num_steps=18))
    gj = jax.grad(lambda p, y: jnp.mean(tde.odeint(
        lambda s, yy, pp: spiral_field(pp, s, yy), y, jnp.asarray(t),
        args=(p,), **kw) ** 2), argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(y0))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    y = torch.from_numpy(y0).requires_grad_()
    (tt.odeint(model, y, torch.from_numpy(t), **kw) ** 2).mean().backward()
    want = [gj[1], gj[0][0]['w'], gj[0][1]['w'], gj[0][0]['b'],
            gj[0][1]['b']]
    got = [y.grad] + [p.grad for p in model.parameters()]
    assert_grads_close([g.numpy() for g in got],
                       [np.asarray(w) for w in want], GRAD_TOL)
