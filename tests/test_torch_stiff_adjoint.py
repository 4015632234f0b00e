"""Gradients of the adaptive implicit (stiff) tier of the PyTorch port --
kvaerno3, kvaerno5, radau5a -- against the JAX package on the same numpy
inputs (CPU, x64): the continuous adjoint, whose backward solves run the
same implicit method on the augmented field (its Jacobian forward over
reverse, `adjoint._functional_aug_dyn`).  Mirrors the gradient tests of
tests/test_stiff.py (test_adjoint_gradients, test_param_gradients_closure;
test_replay_gradients_and_jvp is ROADMAP A10).

Bounds: float64 values within 1e-10 and `Stats` exactly equal; gradients
within 1e-9 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import assert_grads_close, counters

STIFF = ['kvaerno3', 'kvaerno5', 'radau5a']
VALUE_TOL = 1e-10
GRAD_TOL = 1e-9


def _decay_j(t, y):
    return -y


def _decay_t(t, y):
    return -y


@pytest.mark.parametrize('method', STIFF)
def test_adjoint_gradients(method):
    """The continuous adjoint with the same implicit method backward (its
    stage solves on the augmented field, whose Jacobian is forward over
    reverse): d sum y(2) / d y0 equals `jax.grad`'s within 1e-9 and
    exp(-2) within 1e-5."""
    t = np.linspace(0.0, 2.0, 3)
    kw = dict(method=method, rtol=1e-8, atol=1e-10)
    g_j = jax.grad(lambda y: jnp.sum(tde.odeint(_decay_j, y, jnp.asarray(t),
                                                **kw)[-1]))(jnp.array([1.0]))
    y = torch.tensor([1.0], dtype=torch.float64, requires_grad=True)
    tt.odeint(_decay_t, y, torch.from_numpy(t), **kw)[-1].sum().backward()
    assert_grads_close([y.grad.numpy()], [np.asarray(g_j)], GRAD_TOL)
    np.testing.assert_allclose(float(y.grad), np.exp(-2.0), rtol=1e-5)


def test_param_gradients_match_jax():
    """test_param_gradients_closure: the field's parameter reaches the
    port's adjoint through `args` (a closure's capture gets no gradient in
    PyTorch); the gradient equals JAX's closure-converted one within 1e-9
    and -exp(-a) within 1e-5."""
    t = np.linspace(0.0, 1.0, 3)
    kw = dict(method='kvaerno5', rtol=1e-8, atol=1e-10)
    a0 = 1.3
    g_j = jax.grad(lambda a: jnp.sum(tde.odeint(
        lambda s, y: -a * y, jnp.ones((1,)), jnp.asarray(t), **kw)[-1]))(a0)
    a = torch.tensor(a0, dtype=torch.float64, requires_grad=True)
    tt.odeint(lambda s, y, a_: -a_ * y, torch.ones(1, dtype=torch.float64),
              torch.from_numpy(t), args=(a,), **kw)[-1].sum().backward()
    assert abs(float(a.grad) - float(g_j)) <= GRAD_TOL * abs(float(g_j))
    np.testing.assert_allclose(float(a.grad), -np.exp(-a0), rtol=1e-5)


@pytest.mark.parametrize('method', ['kvaerno5', 'radau5a'])
def test_spiral_values_and_adjoint_gradients_match_jax(method):
    """The spiral MLP field (B=4, H=8, float64): the forward values and
    Stats, and the adjoint gradients of mean(ys**2) to y0, the output times
    and the parameters, equal JAX's (values within 1e-10, gradients within
    1e-9 of the largest entry)."""
    from torchdiffeq_tpu.models import spiral_field
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    rng = np.random.RandomState(0)
    params = [dict(w=rng.randn(2, 8) * 0.5, b=rng.randn(8) * 0.1),
              dict(w=rng.randn(8, 2) * 0.5, b=rng.randn(2) * 0.1)]
    y0 = rng.randn(4, 2)
    t = np.linspace(0.0, 0.5, 3)
    kw = dict(method=method, rtol=1e-6, atol=1e-8)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    fj = lambda s, y, p: spiral_field(p, s, y)
    ys_j, st_j = tde.odeint_with_stats(fj, jnp.asarray(y0), jnp.asarray(t),
                                       args=(pj,), **kw)
    gj = jax.grad(lambda p, y, s: jnp.mean(tde.odeint(
        fj, y, s, args=(p,), **kw) ** 2), argnums=(0, 1, 2))(
        pj, jnp.asarray(y0), jnp.asarray(t))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    y = torch.from_numpy(y0).requires_grad_()
    s = torch.from_numpy(t).requires_grad_()
    ys_t, st_t = tt.odeint_with_stats(model, y, s, **kw)
    assert counters(st_t) == counters(st_j)
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               rtol=0, atol=VALUE_TOL)
    (ys_t ** 2).mean().backward()
    want = [gj[1], gj[2], gj[0][0]['w'], gj[0][1]['w'], gj[0][0]['b'],
            gj[0][1]['b']]
    got = [y.grad, s.grad] + [p.grad for p in model.parameters()]
    assert_grads_close([g.numpy() for g in got],
                       [np.asarray(w) for w in want], GRAD_TOL)
