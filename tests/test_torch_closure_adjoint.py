"""An implicit adjoint method with a field that closes over its tensors
(C20): the tensors given in `adjoint_params`, the backward's stage
Jacobians taken by one batched torch.autograd.grad
(`misc.autograd_lane_jacobian`, the augmented field's own route),
against the JAX package, which
closure-converts any field (torchdiffeq_tpu/adjoint.py:241-244), on the
same numpy inputs (CPU, float64).

Gradients agree to 1e-9 of their largest entry, and the forward and every
backward solve take the same steps (Stats counters equal; the backward's
recorded by wrapping each package's `_raw_odeint`).  The JAX gradients
run under `jax.jit`, whose compile costs less than its eager loops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu.adjoint as jadj
import torchdiffeq_tpu_torch as tt
import torchdiffeq_tpu_torch.adjoint as tadj


@pytest.fixture
def bwd_stats(monkeypatch):
    """The backward solves' counters of both packages: (jax, port); JAX's
    read by `jax.debug.callback`, as its gradients run under `jax.jit`."""
    got = ([], [])

    def j_wrapped(*a, _raw=jadj._raw_odeint, **k):
        ys, st = _raw(*a, **k)
        jax.debug.callback(lambda *c: got[0].append([int(x) for x in c]),
                           *st[:5], ordered=True)
        return ys, st

    def t_wrapped(*a, _raw=tadj._raw_odeint, **k):
        ys, st = _raw(*a, **k)
        got[1].append([int(x) for x in st[:5]])
        return ys, st
    monkeypatch.setattr(jadj, '_raw_odeint', j_wrapped)
    monkeypatch.setattr(tadj, '_raw_odeint', t_wrapped)
    return got


def _rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, got, want)


# adaptive implicit, and fixed-grid FIRK/DIRK (each with its grid)
METHODS = [('kvaerno5', None), ('radau5a', None), ('kvaerno3', None),
           ('trbdf2', dict(num_steps=24)), ('radauIIA5', dict(num_steps=12)),
           ('implicit_euler', dict(num_steps=30))]


@pytest.mark.parametrize("method,options", METHODS)
def test_closure_decay_matches_jax(method, options, bwd_stats):
    """``lambda s, y: -w * y`` with w captured: d/dw against JAX."""
    y0, t = np.array([1.0, 2.0]), np.linspace(0.0, 1.5, 4)
    kw = dict(method=method, options=options, rtol=1e-8, atol=1e-10)

    def j_loss(w):
        ys = tde.odeint_adjoint(lambda s, y: -w * y, jnp.asarray(y0),
                                jnp.asarray(t), **kw)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[1])

    g_j = float(jax.jit(jax.grad(j_loss))(0.8))
    w = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    ys = tt.odeint_adjoint(lambda s, y: -w * y, torch.from_numpy(y0),
                           torch.from_numpy(t), adjoint_params=(w,), **kw)
    ((ys[-1] ** 2).sum() + ys[1].sum()).backward()
    _rel(float(w.grad), g_j, 1e-9)
    assert bwd_stats[1] == bwd_stats[0] and bwd_stats[1]


@pytest.mark.parametrize("method,options", METHODS[:2] + METHODS[3:4])
def test_closure_matrix_field_matches_jax(method, options, bwd_stats):
    """A nonlinear field closing over a matrix and a vector, with a tensor
    in `args` beside them in `adjoint_params`: every gradient, and y0's."""
    rng = np.random.RandomState(4)
    W, b, c = rng.randn(3, 3) * 0.6, rng.randn(3) * 0.2, np.array(0.5)
    y0, t = rng.randn(3), np.linspace(0.0, 1.0, 3)
    kw = dict(method=method, options=options, rtol=1e-8, atol=1e-10)

    def j_loss(W_, b_, c_, y0_):
        f = lambda s, y, cc: jnp.tanh(W_ @ y + b_) - cc * y  # noqa: E731
        ys = tde.odeint_adjoint(f, y0_, jnp.asarray(t), args=(c_,), **kw)
        return jnp.sum(ys[-1] ** 2)

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(W), jnp.asarray(b), jnp.asarray(c), jnp.asarray(y0))
    Wt, bt, ct, y0t = (torch.tensor(x, dtype=torch.float64,
                                     requires_grad=True)
                       for x in (W, b, c, y0))
    f = lambda s, y, cc: torch.tanh(Wt @ y + bt) - cc * y  # noqa: E731
    ys = tt.odeint_adjoint(f, y0t, torch.from_numpy(t), args=(ct,),
                           adjoint_params=(Wt, bt, ct), **kw)
    (ys[-1] ** 2).sum().backward()
    for got, want in zip((Wt, bt, ct, y0t), g_j):
        _rel(got.grad.numpy(), want, 1e-9)
    assert bwd_stats[1] == bwd_stats[0]


def test_closure_interpolated_adjoint_matches_jax():
    """The interpolated adjoint with kvaerno5 backward and a captured w
    (its y(s) read from the recorded interpolant)."""
    y0, t = np.array([1.0, 0.5]), np.linspace(0.0, 1.0, 3)
    kw = dict(method='kvaerno5', rtol=1e-8, atol=1e-10,
              adjoint_options=dict(interpolated=True))

    def j_loss(w):
        ys = tde.odeint_adjoint(lambda s, y: -w * y * y, jnp.asarray(y0),
                                jnp.asarray(t), **kw)
        return jnp.sum(ys[-1])

    g_j = float(jax.jit(jax.grad(j_loss))(1.3))
    w = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    ys = tt.odeint_adjoint(lambda s, y: -w * y * y, torch.from_numpy(y0),
                           torch.from_numpy(t), adjoint_params=(w,), **kw)
    ys[-1].sum().backward()
    _rel(float(w.grad), g_j, 1e-9)


def test_closure_under_dopri5_and_kvaerno5_agree():
    """The explicit adjoint reaches a captured tensor by autograd already;
    the implicit one now gives the same gradient to the solves'
    tolerance, and no longer refuses."""
    t = torch.linspace(0.0, 2.0, 3, dtype=torch.float64)
    grads = []
    for method in ('dopri5', 'kvaerno5'):
        w = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
        ys = tt.odeint_adjoint(lambda s, y: -w * y,
                               torch.tensor([1.0, 2.0], dtype=torch.float64),
                               t, method=method, adjoint_params=(w,),
                               rtol=1e-10, atol=1e-12)
        ys[-1].sum().backward()
        grads.append(float(w.grad))
    exact = -2.0 * 3.0 * np.exp(-1.2)
    np.testing.assert_allclose(grads, [exact, exact], rtol=1e-7)


def test_roadmap_value_under_kvaerno5():
    """`odeint_adjoint(lambda s, y: -w * y, ..., method='kvaerno5')` with w
    captured, on a problem whose d/dw is the -1.99186 that ROADMAP's C20
    quotes from JAX (y0 = [1, 1], t = linspace(0, 1, 3), w = 0.5, loss the
    sum of every output): the port's answer, JAX's and the closed form."""
    t = np.linspace(0.0, 1.0, 3)

    def j_loss(w):
        return jnp.sum(tde.odeint_adjoint(lambda s, y: -w * y, jnp.ones(2),
                                          jnp.asarray(t), method='kvaerno5'))

    g_j = float(jax.jit(jax.grad(j_loss))(0.5))
    w = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    tt.odeint_adjoint(lambda s, y: -w * y, torch.ones(2, dtype=torch.float64),
                      torch.from_numpy(t), method='kvaerno5',
                      adjoint_params=(w,)).sum().backward()
    _rel(float(w.grad), g_j, 1e-9)
    exact = -2.0 * (0.5 * np.exp(-0.25) + np.exp(-0.5))
    np.testing.assert_allclose([float(w.grad), exact], -1.99186, atol=5e-6)
