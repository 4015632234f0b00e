"""The fixed-grid implicit tier of the PyTorch port (FIRK: implicit_euler,
implicit_midpoint, trapezoid, radauIIA3, gl4, radauIIA5, gl6; DIRK:
sdirk2, trbdf2) against the JAX package on the same numpy inputs (CPU,
x64): values and `Stats` with both root solvers, the options, events,
convergence order, the error code of a stage solve that does not converge,
and gradients through the loop, whose stage solves differentiate by the
implicit function theorem.  Mirrors the implicit rows of
tests/test_convergence.py, tests/test_odeint.py, tests/test_events.py and
tests/test_gradients.py (gradcheck_y0/t, as parity with `jax.grad`).

Bounds: float64 values within 1e-10 and `Stats` exactly equal; gradients
within 1e-9 of the largest entry; float32 values within the bound its test
states.  The problems keep n <= 10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import (assert_grads_close, construct_problem, counters,
                            grads_pair, solve_pair)

FIRK = ['implicit_euler', 'implicit_midpoint', 'trapezoid', 'radauIIA3',
        'gl4', 'radauIIA5', 'gl6']
DIRK = ['sdirk2', 'trbdf2']
IMPLICIT = FIRK + DIRK
VALUE_TOL = 1e-10
GRAD_TOL = 1e-9


def _field_j(t, y):
    return -0.7 * y + 0.3 * jnp.sin(t) * y * y


def _field_t(t, y):
    return -0.7 * y + 0.3 * torch.sin(t) * y * y


Y0 = np.array([0.5, -0.25, 1.0])


@pytest.mark.parametrize("root_solver", ['broyden', 'newton'])
@pytest.mark.parametrize("method", IMPLICIT)
def test_values_and_stats_match_jax(method, root_solver):
    """Both root solvers: the converged stages follow JAX's iterates to
    rounding, so the values agree to 1e-10 and the Stats (one evaluation a
    step, error code 0) exactly."""
    t = np.linspace(0.0, 1.0, 4)
    ys_j, st_j, ys_t, st_t = solve_pair(
        _field_j, _field_t, Y0, t, method=method,
        options=dict(step_size=0.1, root_solver=root_solver))
    assert st_t == st_j and st_t[4] == 0
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("method", ['gl4', 'trbdf2'])
def test_options_and_tuple_state_match_jax(method):
    """num_steps with cubic output over reversed time, perturb and
    max_iters, a grid_constructor, and a tuple state (flattened as JAX
    ravels it), for one FIRK and one DIRK method."""
    t = np.linspace(0.0, 1.0, 4)
    for opts, ts in ((dict(num_steps=7, interp='cubic'), t[::-1].copy()),
                     (dict(step_size=0.15, perturb=True, max_iters=30), t)):
        ys_j, st_j, ys_t, st_t = solve_pair(_field_j, _field_t, Y0, ts,
                                            method=method, options=opts)
        assert st_t == st_j
        np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    frac = np.linspace(0.0, 1.0, 6) ** 1.5
    ys_j, st_j = tde.odeint_with_stats(
        _field_j, jnp.asarray(Y0), jnp.asarray(t), method=method,
        options=dict(grid_constructor=lambda f, y, s: s[0] + (s[-1] - s[0])
                     * jnp.asarray(frac)))
    with torch.no_grad():
        ys_t, st_t = tt.odeint_with_stats(
            _field_t, torch.from_numpy(Y0), torch.from_numpy(t),
            method=method, options=dict(
                grid_constructor=lambda f, y, s: s[0] + (s[-1] - s[0])
                * torch.from_numpy(frac)))
    assert counters(st_t) == counters(st_j)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=VALUE_TOL)

    y0 = (np.array([0.5, -0.25]), np.array([[1.0, 2.0]]))
    fj = lambda s, y: (_field_j(s, y[0]), -1.3 * y[1] + jnp.cos(s))
    ft = lambda s, y: (_field_t(s, y[0]), -1.3 * y[1] + torch.cos(s))
    kw = dict(method=method, options=dict(step_size=0.1))
    ys_j, st_j = tde.odeint_with_stats(fj, tuple(map(jnp.asarray, y0)),
                                       jnp.asarray(t), **kw)
    ys_p, st_p = tt.odeint_with_stats(ft, tuple(map(torch.from_numpy, y0)),
                                      torch.from_numpy(t), **kw)
    assert counters(st_p) == counters(st_j)
    for a, b in zip(ys_p, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=VALUE_TOL)


@pytest.mark.parametrize("root_solver", ['broyden', 'newton'])
def test_float32_matches_jax(root_solver):
    """float32 state at n=3: the stage tolerance is 1e-6 and time is
    float32, on both sides; the field's float32 rounding differs between
    XLA and torch by an ULP now and then, and a stage solve ends within
    its 1e-6 of the root, so the values agree to 1e-5 and the Stats
    exactly."""
    t = np.linspace(0.0, 1.0, 3)
    y0 = Y0.astype(np.float32)
    for method in ('radauIIA3', 'sdirk2'):
        kw = dict(method=method, options=dict(step_size=0.1,
                                              root_solver=root_solver))
        ys_j, st_j = tde.odeint_with_stats(_field_j, jnp.asarray(y0),
                                           jnp.asarray(t), **kw)
        ys_t, st_t = tt.odeint_with_stats(_field_t, torch.from_numpy(y0),
                                          torch.from_numpy(t), **kw)
        assert ys_t.dtype == torch.float32
        assert counters(st_t) == counters(st_j)
        np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                                   atol=1e-5)


def test_nonconvergence_error_code():
    """tests/test_odeint.py::test_implicit_nonconvergence_error_code: a
    stage solve that runs out of max_iters leaves error code 4, with JAX's
    values; enough steps converge (error code 0)."""
    fj = lambda t, y: -1e4 * (y - jnp.cos(10 * t))
    ft = lambda t, y: -1e4 * (y - torch.cos(10 * t))
    y0, t = np.array([0.0]), np.linspace(0.0, 1.0, 2)
    ys_j, st_j, ys_t, st_t = solve_pair(
        fj, ft, y0, t, method='implicit_midpoint',
        options=dict(num_steps=2, max_iters=1))
    assert st_t == st_j and st_t[4] == 4
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
    with torch.no_grad():
        _, st = tt.odeint_with_stats(ft, torch.from_numpy(y0),
                                     torch.from_numpy(t),
                                     method='implicit_midpoint',
                                     options=dict(num_steps=2, max_iters=1))
    with pytest.raises(RuntimeError, match="did not converge"):
        st.raise_if_error()
    _, st_j, _, st_t = solve_pair(fj, ft, y0, t, method='implicit_euler',
                                  options=dict(num_steps=200))
    assert st_t == st_j and st_t[4] == 0


CONVERGENCE = [('implicit_euler', 1, 1 / 64), ('implicit_midpoint', 2, 1 / 32),
               ('trapezoid', 2, 1 / 32), ('sdirk2', 2, 1 / 32),
               ('trbdf2', 2, 1 / 32), ('radauIIA3', 3, 1 / 16),
               ('gl4', 4, 1 / 8), ('radauIIA5', 5, 1 / 2), ('gl6', 6, 1.0)]


@pytest.mark.parametrize("method,p,h", CONVERGENCE,
                         ids=[c[0] for c in CONVERGENCE])
def test_convergence_order(method, p, h):
    """tests/test_convergence.py's implicit rows (y' = y cos t on [0, 1],
    step sizes h and h/2): the endpoint errors equal JAX's to 1e-10 and
    the measured order is JAX's expectation."""
    t, y0 = np.array([0.0, 1.0]), np.array([1.0])
    errs = []
    for hh in (h, h / 2):
        ys_j, st_j, ys_t, st_t = solve_pair(
            lambda s, y: y * jnp.cos(s), lambda s, y: y * torch.cos(s), y0,
            t, method=method, options=dict(step_size=hh))
        assert st_t == st_j
        np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL)
        errs.append(abs(float(ys_t[-1, 0]) - np.exp(np.sin(1.0))))
    assert np.log2(errs[0] / errs[1]) > p - 0.4, errs


@pytest.mark.parametrize("method", IMPLICIT)
def test_event_matches_jax(method):
    """tests/test_events.py:24-50 for the implicit methods (sin t crossing
    0 at pi, step_size 0.01, cubic): event time and state equal JAX's to
    1e-10, Stats exactly, and the crossing is pi's to the test's budget."""
    y0 = np.array([np.sin(0.5), np.cos(0.5)])
    kw = dict(method=method, rtol=1e-8, atol=1e-10,
              options=dict(step_size=0.01, interp='cubic'))
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
    tol = 2e-2 if method == 'implicit_euler' else 2e-4
    assert abs(float(et_t) - np.pi) < tol


@pytest.mark.parametrize("reverse", [False, True], ids=['fwd', 'rev'])
@pytest.mark.parametrize("method", IMPLICIT)
def test_odeint_accuracy_matches_jax(method, reverse):
    """tests/test_odeint.py::test_odeint_accuracy's implicit rows (the
    constant and exp problems on their output grids): values and Stats
    equal JAX's."""
    for ode in ('constant', 'exp'):
        f_j, f_t, y0, t = construct_problem(ode=ode, reverse=reverse)
        ys_j, st_j, ys_t, st_t = solve_pair(f_j, f_t, y0, t, method=method)
        assert st_t == st_j, ode
        np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=VALUE_TOL,
                                   err_msg=ode)


@pytest.mark.parametrize("method", IMPLICIT)
def test_gradcheck_y0_matches_jax(method):
    """tests/test_gradients.py::test_gradcheck_y0's implicit cases (the
    10-dim linear problem; num_steps 70 for the first-order-like methods,
    else the output grid): the IFT gradient through the loop equals
    `jax.grad`'s (JAX's custom_vjp) within 1e-9 of its largest entry."""
    f_j, f_t, y0, t = construct_problem(ode='linear', npts=3)
    w = np.arange(1.0, 1.0 + y0.shape[0])
    opts = (dict(num_steps=70) if method in ('implicit_euler',
                                             'implicit_midpoint') else {})
    g_j, g_t = grads_pair(
        f_j, f_t, y0, t, lambda ys: jnp.sum(ys[-1] * w),
        lambda ys: (ys[-1] * torch.from_numpy(w)).sum(), method=method,
        options=opts)
    assert_grads_close(g_t, g_j, GRAD_TOL)


@pytest.mark.parametrize("method", IMPLICIT)
def test_gradcheck_t_matches_jax(method):
    """tests/test_gradients.py::test_gradcheck_t's implicit cases (the sine
    problem on its output grid): the gradients to y0 and to the output
    times -- through the stage times, the step sizes and nextafter -- equal
    `jax.grad`'s within 1e-9 of the largest entry."""
    f_j, f_t, y0, t = construct_problem(ode='sine', npts=4)
    g_j, g_t = grads_pair(f_j, f_t, y0, t, lambda ys: jnp.sum(ys ** 2),
                          lambda ys: (ys ** 2).sum(), method=method)
    assert_grads_close(g_t, g_j, GRAD_TOL)


def _spiral(B=4, H=8):
    rng = np.random.RandomState(0)
    params = [dict(w=rng.randn(2, H) * 0.5, b=rng.randn(H) * 0.1),
              dict(w=rng.randn(H, 2) * 0.5, b=rng.randn(2) * 0.1)]
    return params, rng.randn(B, 2)


@pytest.mark.parametrize("method,root_solver", [('gl4', 'broyden'),
                                                ('trbdf2', 'newton')])
def test_spiral_parameter_gradients_match_jax(method, root_solver):
    """The spiral MLP field (B=4, H=8, float64), one FIRK and one DIRK
    method: the gradients of mean(ys**2) to y0, the output times and the
    parameters, through the loop and the IFT of every stage solve, equal
    `jax.grad`'s within 1e-9 of the largest entry."""
    from torchdiffeq_tpu.models import spiral_field
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    params, y0 = _spiral()
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method=method, options=dict(num_steps=9,
                                          root_solver=root_solver))
    gj = jax.grad(lambda p, y, s: jnp.mean(tde.odeint(
        lambda tt_, yy, pp: spiral_field(pp, tt_, yy), y, s, args=(p,),
        **kw) ** 2), argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(y0),
        jnp.asarray(t))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    y = torch.from_numpy(y0).requires_grad_()
    s = torch.from_numpy(t).requires_grad_()
    (tt.odeint(model, y, s, **kw) ** 2).mean().backward()
    want = [gj[1], gj[2], gj[0][0]['w'], gj[0][1]['w'], gj[0][0]['b'],
            gj[0][1]['b']]
    got = [y.grad, s.grad] + [p.grad for p in model.parameters()]
    assert_grads_close([g.numpy() for g in got],
                       [np.asarray(w) for w in want], GRAD_TOL)


def test_field_that_reads_the_host_raises():
    """Newton's Jacobian, and the IFT gradient of a Broyden solve, take
    the field through torch.func.jacrev; a field that reads a tensor to
    the host would get a Jacobian without those terms, so it raises,
    naming the requirement, instead."""
    y0 = torch.tensor([0.5, -0.25], dtype=torch.float64)
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)

    def reads(tt_, y):
        return -y * float(y.abs().sum())

    with pytest.raises(RuntimeError, match="torch.func.jacrev"):
        tt.odeint(reads, y0, t, method='gl4',
                  options=dict(step_size=0.1, root_solver='newton'))
    ys = tt.odeint(reads, y0.requires_grad_(), t, method='gl4',
                   options=dict(step_size=0.1))
    assert torch.isfinite(ys).all()      # Broyden needs no Jacobian
    with pytest.raises(RuntimeError, match="no .item"):
        ys[-1].sum().backward()
