"""The SciPy bridge, ``method='scipy_solver'``, against the JAX package's
(tests/test_odeint.py:96 and the compat matrix's scipy row), on the same
numpy inputs in float64.

Both packages hand SciPy's ``solve_ivp`` the same float64 function, so the
solver takes the same steps: values equal JAX's to 1e-12 and `Stats.nfe`
(SciPy's ``nfev``) exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import construct_problem, counters


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


@pytest.mark.parametrize('solver', ['LSODA', 'RK45', 'BDF'])
@pytest.mark.parametrize('reverse', [False, True])
def test_scipy_solvers_match_jax(solver, reverse):
    """test_scipy_solvers on the constant problem (forward and reversed
    time): values to 1e-12 of JAX's and to 1e-3 of the exact solution;
    the Stats are nfe alone, JAX's."""
    f_j, f_t, y0, t = construct_problem(ode='constant', reverse=reverse)
    kw = dict(method='scipy_solver', options=dict(solver=solver))
    ys_j, st_j = tde.odeint_with_stats(f_j, jnp.asarray(y0), jnp.asarray(t),
                                       **kw)
    ys_t, st_t = tt.odeint_with_stats(f_t, _t(y0), _t(t), **kw)
    assert counters(st_t) == counters(st_j)
    assert st_t.nfe > 0 and st_t[1:5] == (0, 0, 0, 0)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12 * float(np.abs(ys_j).max()))
    exact = 0.2 * t + 3.0
    assert float(np.abs(ys_t.numpy()[:, 0] - exact).max()
                 / np.abs(exact).max()) < 1e-3


def test_state_shape_dtype_tolerances_and_options():
    """A (2, 3) float32 state keeps its shape and dtype (the solve runs in
    float64 on the host); per-leaf atol of a tuple state and min_step and
    max_step pass through as in JAX; the result is detached."""
    A = np.random.RandomState(0).randn(3, 3) * 0.3
    y0 = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method='scipy_solver', rtol=1e-6, atol=1e-8,
              options=dict(solver='RK45', max_step=0.1))
    ys_j, st_j = tde.odeint_with_stats(
        lambda s, y: y @ jnp.asarray(A, jnp.float32), jnp.asarray(y0),
        jnp.asarray(t), **kw)
    y = torch.from_numpy(y0).requires_grad_()
    ys_t, st_t = tt.odeint_with_stats(
        lambda s, y_: y_ @ torch.from_numpy(A).float(), y, _t(t), **kw)
    assert ys_t.shape == (4, 2, 3) and ys_t.dtype == torch.float32
    assert not ys_t.requires_grad
    assert counters(st_t) == counters(st_j)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-6)

    f_j = lambda s, y: (-y[0], -2.0 * y[1])
    f_t = lambda s, y: (-y[0], -2.0 * y[1])
    kw = dict(method='scipy_solver', rtol=1e-8, atol=[1e-10, 1e-6])
    ys_j, st_j = tde.odeint_with_stats(
        f_j, (jnp.ones(2), jnp.ones(1)), jnp.asarray(t), **kw)
    ys_t, st_t = tt.odeint_with_stats(f_t, (_t([1., 1.]), _t([1.])), _t(t),
                                      **kw)
    assert counters(st_t) == counters(st_j)
    for a, b in zip(ys_t, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_refusals():
    """JAX's refusals: a per-leaf rtol, and an event solve (the compat
    matrix's test_scipy_solver_rejects_events); the dense output takes
    adaptive methods only."""
    f = lambda s, y: (-y[0], -y[1])
    with pytest.raises(ValueError, match="scalar rtol"):
        tt.odeint(f, (_t([1.0]), _t([2.0])), _t([0.0, 1.0]),
                  method='scipy_solver', rtol=[1e-6, 1e-7])
    with pytest.raises(ValueError, match="does not support event"):
        tt.odeint_event(lambda s, y: -0.5 * y, _t([1.0, 2.0]), 0.0,
                        event_fn=lambda s, y: y[0] - 0.5,
                        method='scipy_solver')
    with pytest.raises(ValueError, match="adaptive method"):
        tt.odeint_dense(lambda s, y: -y, _t([1.0]), 0.0, 1.0,
                        method='scipy_solver')
    # the gradient options are dropped, as JAX drops them
    ys = tt.odeint(lambda s, y: -y, _t([1.0], True), _t([0.0, 1.0]),
                   method='scipy_solver', options=dict(forward_grad=True))
    assert not ys.requires_grad
    np.testing.assert_allclose(float(ys[-1, 0]), np.exp(-1.0), rtol=1e-3)
