"""`MLPField` and friends against the JAX model functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.models import (init_mlp as j_init_mlp,
                                    init_spiral_model as j_init_spiral,
                                    mlp_apply as j_mlp_apply,
                                    spiral_field as j_spiral_field)
from torchdiffeq_tpu_torch.models import (MLPField, init_mlp, init_spiral_model,
                                          mlp_apply, mlp_params_from_jax,
                                          spiral_field)


def _params(rng, sizes, dtype):
    return [dict(w=(rng.randn(a, b) * 0.5).astype(dtype),
                 b=(rng.randn(b) * 0.1).astype(dtype))
            for a, b in zip(sizes[:-1], sizes[1:])]


# float64: both sides do the same operations and differ only in the matmul
# summation order and tanh's last ULP, so 1e-13 relative; float32: the same
# at float32's 1.2e-7 epsilon, so 1e-5 relative.
TOL = {np.float64: 1e-13, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sizes", [[2, 16, 2], [3, 8, 8, 3]])
def test_mlp_apply_matches_jax(dtype, sizes):
    rng = np.random.RandomState(0)
    params = _params(rng, sizes, dtype)
    x = rng.randn(8, sizes[0]).astype(dtype)
    want = np.asarray(j_mlp_apply(params, jnp.asarray(x)))
    model = mlp_params_from_jax(params, device='cpu')
    got = mlp_apply(model, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    got_field = model(torch.tensor(0.0), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got_field, got)   # power 1: the MLP itself


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spiral_field_matches_jax(dtype):
    rng = np.random.RandomState(1)
    params = _params(rng, [2, 16, 2], dtype)
    y = rng.randn(8, 2).astype(dtype)
    want = np.asarray(j_spiral_field(params, 0.0, jnp.asarray(y)))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    yt = torch.from_numpy(y)
    got = model(torch.tensor(0.0), yt).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_array_equal(
        spiral_field(model, 0.0, yt).detach().numpy(), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_spiral_model_shapes_match_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jp = j_init_spiral(jax.random.PRNGKey(0), hidden=12, dtype=jdt)
    model = init_spiral_model(hidden=12, dtype=dtype, device='cpu',
                              generator=torch.Generator().manual_seed(0))
    assert model.power == 3
    assert model.sizes == [2, 12, 2]
    for layer, w, b in zip(jp, model.weights, model.biases):
        assert tuple(w.shape) == layer['w'].shape
        assert tuple(b.shape) == layer['b'].shape
        assert w.dtype == b.dtype == dtype
        assert not b.detach().any()          # biases start at zero, as in JAX
    # weights at scale 0.1 (JAX: normal * 0.1)
    w = torch.cat([w.detach().flatten() for w in model.weights])
    assert 0.03 < float(w.std()) < 0.3


def test_init_mlp_default_scale_and_generator():
    sizes = [4, 64, 4]
    jp = j_init_mlp(jax.random.PRNGKey(0), sizes)
    a = init_mlp(sizes, device='cpu', generator=torch.Generator().manual_seed(3))
    b = init_mlp(sizes, device='cpu', generator=torch.Generator().manual_seed(3))
    assert isinstance(a, MLPField) and a.power == 1
    for layer, wa, wb in zip(jp, a.weights, b.weights):
        assert tuple(wa.shape) == layer['w'].shape
        torch.testing.assert_close(wa, wb, rtol=0, atol=0)   # seeded
    # default scale 1/sqrt(fan_in), as in JAX
    assert abs(float(a.weights[1].detach().std()) * 8 - 1) < 0.2


def test_mlp_field_rejects_unsupported_power():
    with pytest.raises(ValueError, match="power"):
        MLPField([2, 4, 2], power=4)


@pytest.mark.parametrize("build", [
    lambda: MLPField([2, 4, 2]),
    lambda: init_mlp([2, 4, 2]),
    lambda: init_spiral_model(hidden=4),
    lambda: mlp_params_from_jax([dict(w=np.ones((2, 4)), b=np.zeros(4)),
                                 dict(w=np.ones((4, 2)), b=np.zeros(2))]),
], ids=["MLPField", "init_mlp", "init_spiral_model", "mlp_params_from_jax"])
def test_models_default_to_the_card(build):
    """With `device` left at None a model goes on the CUDA device; with no
    CUDA device (as here) that raises, naming device='cpu', rather than
    build CPU tensors quietly."""
    if torch.cuda.is_available():
        model = build()
        assert all(p.is_cuda for p in model.parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


@pytest.mark.parametrize("time_dependent", [False, True])
def test_mlp_vector_field_matches_jax(time_dependent):
    """`mlp_vector_field`: the MLP over y, or over [y, t] (JAX
    models/neural_ode.py:37-47)."""
    from torchdiffeq_tpu.models.neural_ode import (
        mlp_vector_field as j_mlp_vector_field)
    from torchdiffeq_tpu_torch.models import mlp_vector_field
    rng = np.random.RandomState(2)
    params = _params(rng, [3 if time_dependent else 2, 16, 2], np.float64)
    y = rng.randn(8, 2)
    want = np.asarray(j_mlp_vector_field(params, 0.7, jnp.asarray(y),
                                         time_dependent=time_dependent))
    got = mlp_vector_field(mlp_params_from_jax(params, device='cpu'),
                           torch.tensor(0.7, dtype=torch.float64),
                           torch.from_numpy(y), time_dependent=time_dependent)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("use_adjoint", [True, False])
def test_ode_block_gradients_match_jax(use_adjoint):
    """`ode_block` (JAX models/neural_ode.py:58-66) on the spiral field:
    the trajectory and the parameters' gradients of a loss on it, through
    odeint_adjoint or plain odeint (both the adjoint), float64."""
    from torchdiffeq_tpu.models.neural_ode import ode_block as j_ode_block
    from torchdiffeq_tpu_torch.models import ode_block
    rng = np.random.RandomState(3)
    params = _params(rng, [2, 16, 2], np.float64)
    y0 = rng.randn(8, 2) * 0.5
    t = np.linspace(0.0, 1.0, 4)

    def loss_j(p):
        ys = j_ode_block(p, jnp.asarray(y0), jnp.asarray(t),
                         field=j_spiral_field, use_adjoint=use_adjoint)
        return jnp.sum(ys ** 2), ys

    (_, ys_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    ys_t = ode_block(model, torch.from_numpy(y0), torch.from_numpy(t),
                     field=spiral_field, use_adjoint=use_adjoint)
    (ys_t ** 2).sum().backward()
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               rtol=0, atol=1e-12)
    for got, want in ((model.weights[0].grad, g_j[0]['w']),
                      (model.biases[0].grad, g_j[0]['b']),
                      (model.weights[1].grad, g_j[1]['w']),
                      (model.biases[1].grad, g_j[1]['b'])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-11)
