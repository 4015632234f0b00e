"""The examples' optimizers (`torchdiffeq_tpu_torch/examples/_optim.py`)
against optax, and the `activation` of `mlp_apply` and `mlp_vector_field`
against the JAX package's, in float64.

* RMSprop, Adam and SGD with momentum: 5 steps on the same gradients (a
  quadratic's, which move with the parameters), the parameters to 1e-12
  relative of optax's.
* `mlp_apply` and `mlp_vector_field` with elu (latent_ode's latent field)
  and with the default tanh, to 1e-12; the default stays bit for bit what
  it was (an `MLPField` evaluates the same as before the argument).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdiffeq_tpu.models import mlp_apply as j_mlp_apply
from torchdiffeq_tpu.models import mlp_vector_field as j_mlp_vector_field
from torchdiffeq_tpu_torch.examples._optim import SGD, Adam, RMSprop
from torchdiffeq_tpu_torch.models import (MLPField, mlp_apply,
                                          mlp_params_from_jax,
                                          mlp_vector_field)
from test_torch_examples import one_thread  # noqa: F401 (autouse)

RULES = {
    "rmsprop": (lambda: optax.rmsprop(1e-2), lambda p: RMSprop(p, 1e-2)),
    "adam": (lambda: optax.adam(5e-2), lambda p: Adam(p, 5e-2)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda p: SGD(p, 0.1, momentum=0.9)),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_optimizer_matches_optax(rule):
    rng = np.random.RandomState(0)
    A = rng.randn(6, 6)
    A = A @ A.T / 6 + np.eye(6)
    params = dict(w=jnp.asarray(rng.randn(6)), b=jnp.asarray(rng.randn(3)))

    def loss(p):
        return 0.5 * p['w'] @ jnp.asarray(A) @ p['w'] + jnp.sum(
            jnp.sin(p['b'])) + jnp.sum(p['w'][:3] * p['b'])

    make_j, make_t = RULES[rule]
    opt = make_j()
    state = opt.init(params)
    tw = torch.tensor(np.asarray(params['w']), requires_grad=True)
    tb = torch.tensor(np.asarray(params['b']), requires_grad=True)
    topt = make_t([tw, tb])
    At = torch.from_numpy(A)
    for _ in range(5):
        grads = jax.grad(loss)(params)
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        (0.5 * tw @ At @ tw + torch.sum(torch.sin(tb))
         + torch.sum(tw[:3] * tb)).backward()
        topt.step()
    for got, want in ((tw, params['w']), (tb, params['b'])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-12 * float(np.abs(want).max()))


def _params(rng, sizes):
    return [dict(w=rng.randn(m, n) * 0.8, b=rng.randn(n) * 0.3)
            for m, n in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("name,j_act,t_act", [
    ("elu", jax.nn.elu, torch.nn.functional.elu),
    ("tanh", jnp.tanh, torch.tanh)])
def test_mlp_apply_activation_matches_jax(name, j_act, t_act):
    rng = np.random.RandomState(4)
    params = _params(rng, [4, 20, 20, 4])
    x = rng.randn(16, 4) * 2.0
    want = np.asarray(j_mlp_apply(params, jnp.asarray(x), activation=j_act))
    model = mlp_params_from_jax(params, device="cpu", activation=t_act)
    got = mlp_apply(model, torch.from_numpy(x), t_act).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * float(np.abs(want).max()))
    # the module carries its activation
    got_m = model(torch.tensor(0.0), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got_m, got)


@pytest.mark.parametrize("time_dependent", [False, True])
def test_mlp_vector_field_activation_matches_jax(time_dependent):
    rng = np.random.RandomState(5)
    params = _params(rng, [3 if time_dependent else 2, 16, 2])
    y = rng.randn(8, 2)
    want = np.asarray(j_mlp_vector_field(params, 0.7, jnp.asarray(y),
                                         activation=jax.nn.elu,
                                         time_dependent=time_dependent))
    got = mlp_vector_field(mlp_params_from_jax(params, device="cpu"),
                           torch.tensor(0.7, dtype=torch.float64),
                           torch.from_numpy(y),
                           activation=torch.nn.functional.elu,
                           time_dependent=time_dependent)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-12 * float(np.abs(want).max()))


def test_default_activation_is_tanh_bit_for_bit():
    rng = np.random.RandomState(6)
    model = mlp_params_from_jax(_params(rng, [2, 32, 2]), power=3,
                                device="cpu")
    y = torch.from_numpy(rng.randn(32, 2))
    assert model.activation is torch.tanh
    w1, w2 = model.weights
    b1, b2 = model.biases
    by_hand = torch.tanh((y ** 3) @ w1 + b1) @ w2 + b2
    assert torch.equal(model(torch.tensor(0.0), y), by_hand)
    assert torch.equal(mlp_apply(model, y ** 3), by_hand)
    assert isinstance(model, MLPField)
