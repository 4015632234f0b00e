"""The port's examples (`torchdiffeq_tpu_torch/examples/`) against the JAX
package's (`examples/*.py`, loaded with importlib, their `main` not run),
in float64, on the same data and parameters: ode_demo and cnf here, and
the helpers the other example files share (latent_ode in
test_torch_examples_latent.py, odenet_mnist in test_torch_examples_odenet.py,
bouncing_ball, learn_physics and ensemble in test_torch_examples_events.py).

`jax.random`'s stream cannot be reproduced in torch, so the JAX side draws
every random input with the example's own key splits and hands the arrays
to the port's functions, which take their draws as arguments.  A loss the
JAX example defines inside its `main` is written out here, its lines cited.

Bounds: the data, losses and values to 1e-10 relative; gradients to 1e-8
relative (these chain adjoint solves, and for latent_ode a per-trajectory
solve, a hypernetwork's jvp probes for cnf); the parameters after 3
optimizer steps to 1e-9 relative.  Relative is to each tensor's own
largest value, floored at 1e-6 of the largest over the whole gradient or
parameter set (`all_close`): a tensor that is zero but for rounding has no
scale of its own;
`Stats` exactly, where the example reads them (odenet_mnist's NFE meter,
latent_ode's per-trajectory solves).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdiffeq_tpu import odeint as j_odeint
from torchdiffeq_tpu.adjoint import odeint_adjoint as j_odeint_adjoint
from torchdiffeq_tpu.models import mlp_apply as j_mlp_apply
from torchdiffeq_tpu_torch.examples import cnf, ode_demo
from torchdiffeq_tpu_torch.examples._optim import Adam, RMSprop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUES, GRADS, PARAMS = 1e-10, 1e-8, 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread for each test of the example files (which import
    this fixture): the test workers share the machine's cores, and torch's
    threads of several workers oversubscribe them (odenet_mnist's whole run
    took 103 s so, 1.8 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_example(name):
    """The JAX example `name` as a module, its `main` not run."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def close(got, want, rel, what, scale=None):
    """max|got - want| within `rel` of max|want| (or of `scale`)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max|d|={err} > {rel} * {scale}"


def all_close(got, want, rel, what):
    """Each tensor within `rel` of its own max|w|, floored at 1e-6 of the
    largest over all of them: a tensor that is zero but for rounding (the
    gradient of a conv bias ahead of a GroupNorm, 1e-19, and that bias after
    a few steps) has no scale of its own."""
    want = [np.asarray(w) for w in want]
    floor = 1e-6 * max(float(np.max(np.abs(w))) for w in want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, rel, f"{what} {i}", max(float(np.max(np.abs(w))), floor))


def grads_close(got, want):
    all_close(got, want, GRADS, "gradient")


def mlp_leaves(model):
    """An `MLPField`'s tensors in JAX's ``[{'b', 'w'}, ...]`` leaf order."""
    out = []
    for w, b in zip(model.weights, model.biases):
        out += [b, w]
    return out


def stats_equal(got, want):
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(np.asarray(g.cpu() if isinstance(
            g, torch.Tensor) else g), np.asarray(w))


# ---------------------------------------------------------------------------
# ode_demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adjoint", [False, True])
def test_ode_demo_matches_jax(adjoint):
    jx = jax_example("ode_demo")
    flags = ["--data_size", "60", "--batch_size", "4", "--batch_time", "5"]
    jargs = jx.parser.parse_args(flags + (["--adjoint"] if adjoint else []))
    pargs = ode_demo.parser.parse_args(
        flags + ["--device", "cpu"] + (["--adjoint"] if adjoint else []))
    true_y0, t, true_y = jx.make_data(jargs)
    p_y0, p_t, p_y = ode_demo.make_data(pargs, "cpu", torch.float64)
    close(p_y, true_y, VALUES, "true_y")

    key = jax.random.PRNGKey(0)
    key, pkey = jax.random.split(key)
    params = f64(jx.init_mlp(pkey, [2, 50, 2], scale=0.1))
    model = ode_demo.params_from_jax(params, device="cpu")
    solver = j_odeint_adjoint if adjoint else j_odeint

    def field(tt, yy, p):
        return j_mlp_apply(p, yy ** 3)

    # examples/ode_demo.py:81-83, the loss_fn of its main
    def loss_fn(params, batch_y0, batch_t, batch_y):
        pred_y = solver(field, batch_y0, batch_t, args=(params,),
                        method=jargs.method, rtol=1e-7, atol=1e-9)
        return jnp.mean(jnp.abs(pred_y - batch_y))

    opt = optax.rmsprop(1e-3)
    opt_state = opt.init(params)
    popt = RMSprop(model.parameters(), 1e-3)
    for step in range(3):
        key, bkey = jax.random.split(key)
        jbatch = jx.get_batch(bkey, jargs, t, true_y)
        s = jax.random.choice(bkey, jargs.data_size - jargs.batch_time,
                              (jargs.batch_size,), replace=False)
        pbatch = ode_demo.get_batch(torch.from_numpy(np.asarray(s)), pargs,
                                    p_t, p_y)
        for g, w in zip(pbatch, jbatch):
            close(g, w, VALUES, "batch")
        loss, grads = jax.value_and_grad(loss_fn)(params, *jbatch)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        ploss = ode_demo.train_step(model, popt, pbatch, pargs)
        close(ploss, loss, VALUES, f"loss, step {step}")
        if step == 0:
            grads_close([p.grad for p in mlp_leaves(model)],
                        jax.tree.leaves(grads))
    all_close(mlp_leaves(model), jax.tree.leaves(params), PARAMS,
              "parameters after 3 steps")


# ---------------------------------------------------------------------------
# cnf
# ---------------------------------------------------------------------------

def test_cnf_matches_jax():
    jx = jax_example("cnf")
    flags = ["--num_samples", "16", "--width", "4", "--hidden_dim", "8"]
    jargs = jx.parser.parse_args(flags)
    pargs = cnf.parser.parse_args(flags + ["--device", "cpu"])
    key = jax.random.PRNGKey(jargs.seed)
    key, pkey = jax.random.split(key)
    params = f64(jx.init_hyper_net(pkey, 2, jargs.hidden_dim, jargs.width))
    func = cnf.CNF(cnf.params_from_jax(params, 2, jargs.width))
    t_span = jnp.array([jargs.t1, jargs.t0])

    # examples/cnf.py:112-120, the loss_fn of its main (plain odeint)
    def loss_fn(params, x):
        logp_init = jnp.zeros((x.shape[0], 1))
        f = lambda tt, state, p: jx.augmented_dynamics(tt, state, p, 2,
                                                       jargs.width)
        z_t, logp_diff_t = j_odeint(f, (x, logp_init), t_span,
                                    args=(params,), atol=1e-5, rtol=1e-5)
        z0, logp_diff0 = z_t[-1], logp_diff_t[-1]
        logp_x = jx.std_normal_logprob(z0) - logp_diff0
        return -jnp.mean(logp_x)

    opt = optax.adam(jargs.lr)
    opt_state = opt.init(params)
    popt = Adam(func.parameters(), jargs.lr)
    leaves = lambda: [t for w, b in zip(func.hyper.weights, func.hyper.biases)
                      for t in (b, w)]
    for step in range(3):
        key, dkey = jax.random.split(key)
        x = jx.sample_circles(dkey, jargs.num_samples)
        loss, grads = jax.value_and_grad(loss_fn)(params, x)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        ploss = cnf.train_step(func, popt, torch.from_numpy(np.asarray(x)),
                               pargs)
        close(ploss, loss, VALUES, f"NLL, step {step}")
        if step == 0:
            grads_close([p.grad for p in leaves()], jax.tree.leaves(grads))
    all_close(leaves(), jax.tree.leaves(params), PARAMS,
              "parameters after 3 steps")


def test_cnf_adjoint_flag_takes_the_same_gradient():
    """``--adjoint`` (`odeint_adjoint`) and plain `odeint` differentiate
    through the same continuous adjoint (ROADMAP C4)."""
    gen = torch.Generator().manual_seed(0)
    hyper = cnf.init_hyper_net(2, 8, 4, gen, "cpu", torch.float64)
    x = cnf.sample_circles(16, gen, dtype=torch.float64)
    grads = []
    for flag in ([], ["--adjoint"]):
        args = cnf.parser.parse_args(["--device", "cpu"] + flag)
        func = cnf.CNF(hyper)
        func.zero_grad()
        cnf.loss_fn(func, x, args).backward()
        grads.append([p.grad.clone() for p in func.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


