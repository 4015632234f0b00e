"""The port's training loops (`torchdiffeq_tpu_torch.training`) against the
JAX package's (`torchdiffeq_tpu.training`, with optax) on the same numpy
inputs, in float64; mirrors tests/test_training.py.

Bounds: the spiral's `odeint_adjoint` losses to 1e-10 relative and its
parameters after 6 SGD steps to 1e-9 (adjoint solves at rtol 1e-3, whose
gradients both packages compute to about 1e-12); the port's optimizers
against optax's after 5 steps to 1e-12 (the same arithmetic in the same
order); a loop on a linear loss to 1e-12; the scan against the port's own
step-by-step loop, and `fit`'s chunks against one scan, bit for bit.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdiffeq_tpu import odeint_adjoint as j_odeint_adjoint
from torchdiffeq_tpu import training as j_training
from torchdiffeq_tpu.models.neural_ode import (init_spiral_model,
                                               spiral_field)
from torchdiffeq_tpu_torch import odeint_adjoint, training
from torchdiffeq_tpu_torch.models.neural_ode import mlp_apply
from test_torch_examples import one_thread  # noqa: F401 (autouse)

F64 = torch.float64


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _trees_close(got, want, tol):
    for g, w in zip(training.tree_leaves(got), jax.tree_util.tree_leaves(
            want)):
        _close(g, w, tol)


def _spiral():
    """test_training.py's spiral problem in float64: (params as numpy, the
    JAX loss, the port's loss); the params a list of {'w', 'b'} layers."""
    params = jax.tree_util.tree_map(np.asarray, init_spiral_model(
        jax.random.PRNGKey(0), hidden=16, dtype=jnp.float64))
    t_np = np.linspace(0.0, 1.0, 5)
    target = np.stack([2.0 * np.cos(t_np), 2.0 * np.sin(t_np)], axis=-1)

    def j_loss(p, _batch):
        ys = j_odeint_adjoint(lambda tt_, yy, pp: spiral_field(pp, tt_, yy),
                              jnp.array([2.0, 0.0]), jnp.asarray(t_np),
                              rtol=1e-3, atol=1e-4, method='dopri5',
                              args=(p,))
        return jnp.mean((ys - target) ** 2)

    y0, t, tg = (torch.tensor([2.0, 0.0], dtype=F64), torch.from_numpy(t_np),
                 torch.from_numpy(target))

    def field(tt_, yy, p):
        mlp = SimpleNamespace(weights=[layer['w'] for layer in p],
                              biases=[layer['b'] for layer in p])
        return mlp_apply(mlp, yy ** 3)

    def t_loss(p, _batch):
        ys = odeint_adjoint(field, y0, t, rtol=1e-3, atol=1e-4,
                            method='dopri5', args=(p,))
        return ((ys - tg) ** 2).mean()

    return params, j_loss, t_loss


def _torch_tree(tree):
    return training.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def test_sgd_scan_matches_jax_and_python_loop():
    params, j_loss, t_loss = _spiral()
    j_p, j_losses = j_training.scan_steps(
        j_training.make_sgd_step(j_loss, lr=1e-2),
        jax.tree_util.tree_map(jnp.asarray, params), length=6)
    step = training.make_sgd_step(t_loss, lr=1e-2)
    p_scan, losses = training.scan_steps(step, _torch_tree(params), length=6)
    assert losses.shape == (6,) and losses[-1] < losses[0]
    _close(losses, j_losses, 1e-10)
    _trees_close(p_scan, j_p, 1e-9)
    # the same step by hand, one call a step: the same bits
    p_loop = _torch_tree(params)
    loop_losses = []
    for _ in range(6):
        p_loop, loss = step(p_loop, None)
        loop_losses.append(loss)
    assert torch.equal(losses, torch.stack(loop_losses))
    for a, b in zip(training.tree_leaves(p_scan),
                    training.tree_leaves(p_loop)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("make_t,make_j", [
    (lambda: training.adam(1e-2), lambda: optax.adam(1e-2)),
    (lambda: training.rmsprop(1e-2), lambda: optax.rmsprop(1e-2)),
    (lambda: training.sgd(1e-2, momentum=0.9),
     lambda: optax.sgd(1e-2, momentum=0.9))],
    ids=["adam", "rmsprop", "sgd"])
def test_optax_step_matches_optax(make_t, make_j):
    """The port's optimizers against optax's through `make_optax_step` on
    the spiral loss: 5 steps, the carry keeping the params' structure."""
    params, j_loss, t_loss = _spiral()
    j_init, j_step = j_training.make_optax_step(j_loss, make_j())
    (j_p, _), j_losses = j_training.scan_steps(
        j_step, j_init(jax.tree_util.tree_map(jnp.asarray, params)),
        length=5)
    init, step = training.make_optax_step(t_loss, make_t())
    (p, state), losses = training.scan_steps(step, init(_torch_tree(params)),
                                             length=5)
    assert len(p) == len(params) and set(p[0]) == {'w', 'b'}
    assert losses.shape == (5,) and losses[-1] < losses[0]
    _close(losses, j_losses, 1e-12)
    _trees_close(p, j_p, 1e-12)


def _linear_batches():
    rng = np.random.RandomState(1)
    return rng.randn(7, 8, 3), np.ones((7, 8))


def test_scan_steps_over_batches():
    """Per-step data drives the loss: 7 steps of (8, 3)/(8,) batches."""
    xs_np = _linear_batches()
    j_w, j_losses = j_training.scan_steps(
        j_training.make_sgd_step(
            lambda w, b: jnp.mean((b[0] @ w - b[1]) ** 2), lr=0.1),
        jnp.zeros(3), tuple(jnp.asarray(x) for x in xs_np))
    step = training.make_sgd_step(
        lambda w, b: ((b[0] @ w - b[1]) ** 2).mean(), lr=0.1)
    xs = tuple(torch.from_numpy(x) for x in xs_np)
    w1, losses = training.scan_steps(step, torch.zeros(3, dtype=F64), xs)
    assert losses.shape == (7,) and bool(torch.isfinite(losses).all())
    _close(w1, j_w, 1e-12)
    _close(losses, j_losses, 1e-12)
    w2 = torch.zeros(3, dtype=F64)
    for i in range(7):
        w2, _ = step(w2, (xs[0][i], xs[1][i]))
    assert torch.equal(w1, w2)


def test_scan_steps_requires_xs_or_length():
    step = training.make_sgd_step(lambda p, b: (p ** 2).sum())
    with pytest.raises(ValueError):
        training.scan_steps(step, torch.ones(2))


def test_fit_chunks_match_single_scan():
    """fit in chunks of 4 (4 + 4 + 2: the short last chunk) against one
    scan over all 10, bit for bit, and against JAX's fit."""
    xs_np = np.random.RandomState(2).randn(10, 4, 3)
    step = training.make_sgd_step(
        lambda w, b: ((b @ w - 1.0) ** 2).mean(), lr=0.05)
    xs = torch.from_numpy(xs_np)
    w_fit, losses_fit = training.fit(step, torch.zeros(3, dtype=F64),
                                     batches=iter(list(xs)), num_steps=10,
                                     steps_per_dispatch=4)
    w_one, losses_one = training.scan_steps(step, torch.zeros(3, dtype=F64),
                                            xs)
    assert isinstance(losses_fit, np.ndarray) and losses_fit.shape == (10,)
    np.testing.assert_array_equal(losses_fit, losses_one.numpy())
    assert torch.equal(w_fit, w_one)
    j_w, j_losses = j_training.fit(
        j_training.make_sgd_step(lambda w, b: jnp.mean((b @ w - 1.0) ** 2),
                                 lr=0.05),
        jnp.zeros(3), batches=iter(list(jnp.asarray(xs_np))), num_steps=10,
        steps_per_dispatch=4)
    _close(w_fit, j_w, 1e-12)
    _close(losses_fit, j_losses, 1e-12)


def test_fit_exhausted_iterator_stops_early():
    step = training.make_sgd_step(lambda w, b: ((b @ w) ** 2).mean(), lr=0.1)
    w, losses = training.fit(step, torch.ones(3, dtype=F64),
                             batches=iter([torch.ones(4, 3, dtype=F64)] * 5),
                             num_steps=12, steps_per_dispatch=4)
    assert losses.shape == (5,)


def test_fit_batchfree_matches_jax():
    params, j_loss, t_loss = _spiral()
    p, losses = training.fit(training.make_sgd_step(t_loss, lr=1e-2),
                             _torch_tree(params), num_steps=5,
                             steps_per_dispatch=2)
    assert losses.shape == (5,) and losses[-1] < losses[0]
    j_p, j_losses = j_training.fit(
        j_training.make_sgd_step(j_loss, lr=1e-2),
        jax.tree_util.tree_map(jnp.asarray, params), num_steps=5,
        steps_per_dispatch=2)
    _close(losses, j_losses, 1e-10)
    _trees_close(p, j_p, 1e-9)


def test_fit_rejects_nonpositive_steps():
    step = training.make_sgd_step(lambda p, b: (p ** 2).sum())
    with pytest.raises(ValueError):
        training.fit(step, torch.ones(2), num_steps=0)


def test_fit_rejects_nonpositive_steps_per_dispatch():
    step = training.make_sgd_step(lambda p, b: (p ** 2).sum())
    with pytest.raises(ValueError):
        training.fit(step, torch.ones(2), num_steps=4, steps_per_dispatch=0)


def test_fit_empty_pipeline_returns_empty_losses():
    step = training.make_sgd_step(lambda w, b: ((b @ w) ** 2).mean(), lr=0.1)
    w0 = torch.ones(3, dtype=F64)
    w, losses = training.fit(step, w0, batches=iter([]), num_steps=4)
    assert losses.shape == (0,)
    assert torch.equal(w, w0)


def test_optax_step_keeps_bf16_param_dtype():
    """Adam's float32 arithmetic on a bfloat16 param is cast back, as
    optax's apply_updates does: the carry stays bfloat16, and its values
    are JAX's to bfloat16's resolution."""
    j_init, j_step = j_training.make_optax_step(
        lambda w, _: jnp.sum((w - 1.0) ** 2).astype(jnp.float32),
        optax.adam(1e-2))
    (j_w, _), _ = j_training.scan_steps(
        j_step, j_init(jnp.zeros((4,), jnp.bfloat16)), length=3)
    init, step = training.make_optax_step(
        lambda w, _: ((w - 1.0) ** 2).sum().float(), training.adam(1e-2))
    (w1, _), losses = training.scan_steps(
        step, init(torch.zeros(4, dtype=torch.bfloat16)), length=3)
    assert w1.dtype == torch.bfloat16 and losses.shape == (3,)
    np.testing.assert_allclose(_np(w1), np.asarray(j_w, np.float64),
                               rtol=0, atol=2 ** -8)


def test_has_aux_outputs_are_stacked():
    step = training.make_sgd_step(
        lambda w, b: (((b @ w) ** 2).mean(), dict(norm=w.norm())), lr=0.1,
        has_aux=True)
    xs = torch.ones(3, 4, 2, dtype=F64)
    _, (losses, aux) = training.scan_steps(step, torch.ones(2, dtype=F64), xs)
    assert losses.shape == (3,) and aux['norm'].shape == (3,)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_donate_contract(kind):
    """donate=False leaves the caller's carry as it was; donate=True updates
    the caller's parameter tensors in place (the same storage, holding the
    final values)."""
    loss = lambda w, b: ((b @ w - 1.0) ** 2).mean()   # noqa: E731
    xs = torch.from_numpy(np.random.RandomState(4).randn(5, 4, 3))
    if kind == "sgd":
        step, init = training.make_sgd_step(loss, lr=0.05), (lambda w: w)
    else:
        init, step = training.make_optax_step(loss, training.adam(0.05))

    def params(carry):
        return carry if kind == "sgd" else carry[0]

    w0 = torch.zeros(3, dtype=F64)
    out, _ = training.scan_steps(step, init(w0), xs, donate=False)
    assert torch.equal(w0, torch.zeros(3, dtype=F64))
    assert not torch.equal(params(out), w0)
    w1 = torch.zeros(3, dtype=F64)
    ptr = w1.data_ptr()
    out1, _ = training.scan_steps(step, init(w1), xs, donate=True)
    assert params(out1).data_ptr() == ptr
    assert torch.equal(w1, params(out))
