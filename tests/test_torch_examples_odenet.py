"""The port's odenet_mnist example against the JAX package's
(``examples/odenet_mnist.py``), in float64: the loss, its gradients and 3
SGD-momentum steps for the ODE-Net (plain `odeint` and ``--adjoint``) and the
residual network, and the NFE meter's Stats.  Bounds and conventions as in
test_torch_examples.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_examples import (PARAMS, VALUES, all_close, close, f64,
                                 grads_close, jax_example, one_thread,
                                 stats_equal)
from torchdiffeq_tpu_torch.examples import odenet_mnist
from torchdiffeq_tpu_torch.examples._optim import SGD


def _odenet_leaves(model, network):
    """A `Model`'s tensors in the JAX dict's leaf order (keys sorted)."""
    def conv(p):
        return [p['b'], p['w']]
    out = conv(model.down1) + conv(model.down2) + [model.fc['b'],
                                                   model.fc['w']]
    if network == 'odenet':
        f = model.odefunc
        return out + [f.conv1['b'], f.conv1['w'], f.conv2['b'], f.conv2['w']]
    for blk in model.res:
        out += conv(blk['conv1']) + conv(blk['conv2'])
    return out


def _jax_leaves_oihw(tree):
    """JAX leaves with every 4-D (HWIO) kernel transposed to OIHW."""
    return [np.asarray(a).transpose(3, 2, 0, 1) if np.ndim(a) == 4
            else np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("network,adjoint", [("odenet", False),
                                             ("odenet", True),
                                             ("resnet", False)])
def test_odenet_mnist_matches_jax(network, adjoint):
    jx = jax_example("odenet_mnist")
    flags = ["--hidden", "8", "--batch_size", "4", "--network", network] \
        + (["--adjoint"] if adjoint else [])
    jargs = jx.parser.parse_args(flags)
    pargs = odenet_mnist.parser.parse_args(flags + ["--device", "cpu"])
    key = jax.random.PRNGKey(jargs.seed)
    key, dkey = jax.random.split(key)
    xs, ys = jx.synthetic_digits(dkey, 3 * jargs.batch_size)
    key, mkey = jax.random.split(key)
    params = f64(jx.init_model(mkey, jargs))
    model = odenet_mnist.params_from_jax(params, device="cpu")

    # examples/odenet_mnist.py:161-164, the loss_fn of its main
    def loss_fn(model, x, y):
        logits, _ = jx.forward(model, x, jargs)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, y))

    opt = optax.sgd(jargs.lr, momentum=0.9)
    opt_state = opt.init(params)
    popt = SGD(model.parameters(), jargs.lr, momentum=0.9)
    for step in range(3):
        sl = slice(step * jargs.batch_size, (step + 1) * jargs.batch_size)
        x, y = xs[sl], ys[sl]
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        ploss = odenet_mnist.train_step(
            model, popt, torch.from_numpy(np.asarray(x)),
            torch.from_numpy(np.asarray(y)).long(), pargs)
        close(ploss, loss, VALUES, f"loss, step {step}")
        if step == 0:
            grads_close([p.grad for p in _odenet_leaves(model, network)],
                        _jax_leaves_oihw(grads))
    all_close(_odenet_leaves(model, network), _jax_leaves_oihw(params),
              PARAMS, "parameters after 3 steps")
    if network == "odenet":
        # the NFE-F meter: odeint_with_stats of the ODE block
        logits_j, st_j = jx.forward(params, xs[:8], jargs, with_stats=True)
        with torch.no_grad():
            logits_p, st_p = odenet_mnist.forward(
                model, torch.from_numpy(np.asarray(xs[:8])), pargs,
                with_stats=True)
        close(logits_p, logits_j, VALUES, "logits")
        stats_equal(st_p, st_j)
