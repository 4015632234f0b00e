"""The adaptive implicit (stiff) tier of the PyTorch port -- kvaerno3,
kvaerno5 (ESDIRK) and radau5a (Radau IIA 5(3)) on the adaptive loop --
against the JAX package on the same numpy inputs (CPU, x64).  Mirrors
tests/test_stiff.py (its gradient tests are in test_torch_stiff_adjoint.py;
test_replay_gradients_and_jvp is ROADMAP A10), the stiff rows of
tests/test_convergence.py and tests/test_odeint.py, and
tests/test_dense.py:33 for the three methods.

Bounds: float64 values within 1e-10 and `Stats` exactly equal; event times
within 2 * atol (the bisection's tolerance: a sign decision at the root
can go either way on a rounding difference).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import construct_problem, counters, solve_pair

STIFF = ['kvaerno3', 'kvaerno5', 'radau5a']
VALUE_TOL = 1e-10


def _decay_j(t, y):
    return -y


def _decay_t(t, y):
    return -y


@pytest.mark.parametrize('method', STIFF)
def test_accuracy(method):
    """y' = -y to rtol 1e-8: values and Stats equal JAX's, within 1e-6 of
    exp(-t)."""
    t = np.linspace(0.0, 2.0, 5)
    ys_j, st_j, ys_t, st_t = solve_pair(_decay_j, _decay_t, np.array([1.0]),
                                        t, method=method, rtol=1e-8,
                                        atol=1e-10)
    assert st_t == st_j and st_t[4] == 0
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    assert np.abs(ys_t[:, 0] - np.exp(-t)).max() < 1e-6


@pytest.mark.parametrize('method,order', [('kvaerno3', 3), ('kvaerno5', 5),
                                          ('radau5a', 5)])
def test_convergence_order(method, order):
    """Pinned step sizes (min = max = first = h) on y' = -y and, as in
    tests/test_convergence.py's stiff rows, on y' = y cos t: endpoint
    values equal JAX's, and the measured order is the method's."""
    for fj, ft, t1, exact, hs in (
            (_decay_j, _decay_t, 2.0, np.exp(-2.0), (0.2, 0.1)),
            (lambda s, y: y * jnp.cos(s), lambda s, y: y * torch.cos(s), 1.0,
             np.exp(np.sin(1.0)),
             (1 / 16, 1 / 32) if method == 'kvaerno3' else (1 / 8, 1 / 16))):
        errs = []
        for h in hs:
            ys_j, st_j, ys_t, st_t = solve_pair(
                fj, ft, np.array([1.0]), np.array([0.0, t1]), method=method,
                rtol=1e3, atol=1e3,
                options=dict(min_step=h, max_step=h, first_step=h))
            assert st_t == st_j
            np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
            errs.append(abs(float(ys_t[-1, 0]) - exact))
        assert np.log2(errs[0] / errs[1]) > order - 0.5, errs


_LAM = 1e4


def _stiff_j(t, y):
    return -_LAM * (y - jnp.cos(t)) - jnp.sin(t)


def _stiff_t(t, y):
    return -_LAM * (y - torch.cos(t)) - torch.sin(t)


@pytest.mark.parametrize('method,bound', [('kvaerno5', 1e-3),
                                          ('radau5a', 1e-5)])
def test_stiff_step_count_advantage(method, bound):
    """lambda = 1e4 (test_stiff_step_count_advantage and
    test_radau5a_stiff_advantage_and_accuracy): values and Stats equal
    JAX's, 50x fewer steps than dopri5 (the port's dopri5 takes JAX's
    7540 steps; held with radau5a), and the error against the exact
    solution within the JAX tests' bounds."""
    t = np.linspace(0.0, 2.0, 3)
    y0 = np.array([1.5])
    kw = dict(rtol=1e-6, atol=1e-8)
    ys_j, st_j, ys_t, st_t = solve_pair(_stiff_j, _stiff_t, y0, t,
                                        method=method, **kw)
    assert st_t == st_j and st_t[4] == 0
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    _, st_exp = tde.odeint_with_stats(_stiff_j, jnp.asarray(y0),
                                      jnp.asarray(t), method='dopri5', **kw)
    if method == 'radau5a':
        with torch.no_grad():
            _, st_exp_t = tt.odeint_with_stats(
                _stiff_t, torch.from_numpy(y0), torch.from_numpy(t),
                method='dopri5', **kw)
        assert counters(st_exp_t) == counters(st_exp)
    assert st_t[1] * 50 < int(st_exp.n_steps)
    exact = np.cos(t) + 0.5 * np.exp(-_LAM * t)
    assert np.abs(ys_t[:, 0] - exact).max() < bound


def test_van_der_pol():
    """Stiff van der Pol (mu = 100) over one excursion with kvaerno5:
    values equal JAX's within 1e-10 of |y| ~ 2 (203 steps, 58 rejected,
    each step's stage solves ending within 1e-8 of their roots), Stats
    exactly, and the limit cycle's bound."""
    mu = 100.0
    fj = lambda t, y: jnp.stack([y[1], mu * ((1 - y[0] ** 2) * y[1]) - y[0]])
    ft = lambda t, y: torch.stack([y[1], mu * ((1 - y[0] ** 2) * y[1])
                                   - y[0]])
    ys_j, st_j, ys_t, st_t = solve_pair(
        fj, ft, np.array([2.0, 0.0]), np.linspace(0.0, 100.0, 5),
        method='kvaerno5', rtol=1e-6, atol=1e-8)
    assert st_t == st_j and st_t[4] == 0
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    assert np.isfinite(ys_t).all() and np.abs(ys_t[:, 0]).max() < 2.5


@pytest.mark.parametrize('method', ['kvaerno3', 'radau5a'])
def test_event_solve(method):
    """odeint_event on y' = -y to y = 0.5 (rtol 1e-9, atol 1e-11): the event
    time and state equal JAX's within 2 * atol, Stats exactly, and the time
    is log 2's."""
    kw = dict(event_fn=lambda t, y: y[0] - 0.5, method=method, rtol=1e-9,
              atol=1e-11)
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        _decay_j, jnp.array([1.0]), jnp.asarray([0.0, 1.0]), **kw)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        _decay_t, torch.tensor([1.0], dtype=torch.float64),
        torch.tensor([0.0, 1.0], dtype=torch.float64), **kw)
    assert counters(st_t) == counters(st_j)
    assert abs(float(et_t) - float(et_j)) <= 2e-11
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=2e-11)
    et = tt.odeint_event(_decay_t, torch.tensor([1.0], dtype=torch.float64),
                         0.0, **kw)[0]
    np.testing.assert_allclose(float(et), np.log(2), rtol=1e-7)


def test_nonconvergence_rejects_not_errors():
    """y' = 1 - exp(2y) from y = 2 at a first step of 1: the Newton stage
    solve fails, the inflated error estimate rejects the step, and the
    controller recovers; Stats (with the rejections) and values equal
    JAX's."""
    fj = lambda t, y: -jnp.exp(2.0 * y) + 1.0
    ft = lambda t, y: -torch.exp(2.0 * y) + 1.0
    ys_j, st_j, ys_t, st_t = solve_pair(
        fj, ft, np.array([2.0]), np.linspace(0.0, 1.0, 2), method='kvaerno3',
        rtol=1e-6, atol=1e-8, options=dict(first_step=1.0))
    assert st_t == st_j and st_t[4] == 0 and st_t[3] > 0
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    assert np.isfinite(ys_t).all()


def test_jump_t_stiff():
    """A discontinuous field with its jump in jump_t (kvaerno3): values and
    Stats equal JAX's, and the exact value within 1e-6."""
    fj = lambda t, y: jnp.where(t < 0.5, -y, -3.0 * y)
    ft = lambda t, y: torch.where(t < 0.5, -y, -3.0 * y)
    t = np.linspace(0.0, 1.0, 3)
    ys_j, st_j = tde.odeint_with_stats(
        fj, jnp.array([1.0]), jnp.asarray(t), method='kvaerno3', rtol=1e-8,
        atol=1e-10, options=dict(jump_t=jnp.array([0.5])))
    with torch.no_grad():
        ys_t, st_t = tt.odeint_with_stats(
            ft, torch.tensor([1.0], dtype=torch.float64), torch.from_numpy(t),
            method='kvaerno3', rtol=1e-8, atol=1e-10,
            options=dict(jump_t=torch.tensor([0.5])))
    assert counters(st_t) == counters(st_j)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=VALUE_TOL)
    np.testing.assert_allclose(float(ys_t[-1, 0]), np.exp(-0.5 - 1.5),
                               rtol=1e-6)


@pytest.mark.parametrize('method', STIFF)
def test_dense_value_and_derivative(method):
    """tests/test_dense.py:33 (kvaerno3 there; kvaerno5 and radau5a too):
    the dense solution and its derivative at 0.3, 1.1 and 1.9 equal JAX's
    within 1e-10 and the exact ones within the JAX test's 1e-4 and 1e-2;
    Stats and the segment count exactly."""
    sol_j, st_j = tde.odeint_dense(_decay_j, jnp.array([1.0]), 0.0, 2.0,
                                   method=method, _return_stats=True)
    sol_t, st_t = tt.odeint_dense(_decay_t,
                                  torch.tensor([1.0], dtype=torch.float64),
                                  0.0, 2.0, method=method, _return_stats=True)
    assert counters(st_t) == counters(st_j)
    assert sol_t.count == int(sol_j.count)
    tq = np.array([0.3, 1.1, 1.9])
    for got, want, exact, tol in (
            (sol_t(torch.from_numpy(tq)), sol_j(jnp.asarray(tq)),
             np.exp(-tq), 1e-4),
            (sol_t.derivative(torch.from_numpy(tq)),
             sol_j.derivative(jnp.asarray(tq)), -np.exp(-tq), 1e-2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=VALUE_TOL)
        np.testing.assert_allclose(got.numpy()[:, 0], exact, atol=tol)


@pytest.mark.parametrize("reverse", [False, True], ids=['fwd', 'rev'])
@pytest.mark.parametrize('method', STIFF)
def test_odeint_accuracy_matches_jax(method, reverse):
    """tests/test_odeint.py::test_odeint_accuracy's stiff rows (the
    constant, linear, sine and exp problems at the default tolerances):
    values and Stats equal JAX's."""
    for ode in ('constant', 'linear', 'sine', 'exp'):
        f_j, f_t, y0, t = construct_problem(ode=ode, reverse=reverse)
        ys_j, st_j, ys_t, st_t = solve_pair(f_j, f_t, y0, t, method=method)
        assert st_t == st_j, ode
        scale = max(1.0, float(np.abs(ys_j).max()))
        np.testing.assert_allclose(ys_t, ys_j, rtol=0,
                                   atol=VALUE_TOL * scale, err_msg=ode)


def test_options_match_jax():
    """stage_tol, max_iters, error_dtype and the PI controller on the stiff
    tier: values and Stats equal JAX's.  error_dtype (float32 for a float64
    state) rounds the error estimate and its norm in float32 in both
    packages; torch and XLA may round a float32 RMS norm apart in its last
    bit, which moves later steps at the 1e-9 level without changing a
    decision: values within 1e-8 there."""
    t = np.linspace(0.0, 1.0, 3)
    y0 = np.array([0.5, -0.25, 1.0])
    fj = lambda s, y: -0.7 * y + 0.3 * jnp.sin(s) * y * y
    ft = lambda s, y: -0.7 * y + 0.3 * torch.sin(s) * y * y
    for method, opts in (('kvaerno5', dict(stage_tol=1e-11, max_iters=8)),
                         ('radau5a', dict(controller='pi')),
                         ('kvaerno3', dict(error_dtype='float32'))):
        opts_j, opts_t = dict(opts), dict(opts)
        if 'error_dtype' in opts:
            opts_j['error_dtype'] = jnp.float32
            opts_t['error_dtype'] = torch.float32
        ys_j, st_j = tde.odeint_with_stats(fj, jnp.asarray(y0),
                                           jnp.asarray(t), method=method,
                                           options=opts_j)
        with torch.no_grad():
            ys_t, st_t = tt.odeint_with_stats(ft, torch.from_numpy(y0),
                                              torch.from_numpy(t),
                                              method=method, options=opts_t)
        assert counters(st_t) == counters(st_j), method
        np.testing.assert_allclose(
            ys_t.numpy(), np.asarray(ys_j), rtol=0,
            atol=1e-8 if 'error_dtype' in opts else VALUE_TOL)
