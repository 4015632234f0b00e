"""The port's latent_ode example against the JAX package's
(``examples/latent_ode.py``), in float64: the ELBO, its gradients and 3 Adam
steps, each trajectory's own solve and its counters (the port's per-sample
route against JAX's ``jax.vmap`` of one solve a trajectory), and the
extrapolation.  Bounds and conventions as in test_torch_examples.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from test_torch_examples import (PARAMS, VALUES, all_close, close, f64,
                                 grads_close, jax_example, mlp_leaves,
                                 stats_equal, one_thread)
from torchdiffeq_tpu.adjoint import odeint_adjoint as j_odeint_adjoint
from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
from torchdiffeq_tpu_torch.examples import latent_ode
from torchdiffeq_tpu_torch.examples._optim import Adam


def _latent_setup():
    jx = jax_example("latent_ode")
    flags = ["--nspiral", "4", "--ntotal", "30", "--nsample", "10"]
    jargs = jx.parser.parse_args(flags)
    pargs = latent_ode.parser.parse_args(flags + ["--device", "cpu"])
    key = jax.random.PRNGKey(jargs.seed)
    trajs32, ts32 = jx.generate_spirals(key, jargs)
    p_trajs, p_ts = latent_ode.generate_spirals(pargs, "cpu")
    # the same float32 data, drawn by numpy's RandomState on both sides
    np.testing.assert_array_equal(p_trajs.numpy(), np.asarray(trajs32))
    np.testing.assert_array_equal(p_ts.numpy(), np.asarray(ts32))
    key, pkey = jax.random.split(key)
    params = f64(jx.init_params(pkey, jargs))
    return (jx, jargs, key, f64(trajs32), f64(ts32), params,
            latent_ode.params_from_jax(params, device="cpu"),
            torch.from_numpy(np.asarray(trajs32)).double(),
            torch.from_numpy(np.asarray(ts32)).double())


def _latent_leaves(p):
    """A `LatentODE`'s tensors in the JAX dict's leaf order (keys sorted:
    dec, func, rnn_b, rnn_out, rnn_w)."""
    return (mlp_leaves(p.dec) + mlp_leaves(p.func) + [p.rnn_b]
            + mlp_leaves(p.rnn_out) + [p.rnn_w])


def _latent_eps(key, n, latent):
    """The reparameterisation noise `elbo_loss` draws (latent_ode.py:100-101
    and :111): one normal draw of each trajectory's split key."""
    keys = jax.random.split(key, n)
    return jax.vmap(lambda k: jax.random.normal(k, (latent,)))(keys)


def test_latent_ode_matches_jax():
    (jx, jargs, key, trajs, ts, params, model, p_trajs,
     p_ts) = _latent_setup()
    opt = optax.adam(jargs.lr)
    opt_state = opt.init(params)
    popt = Adam(model.parameters(), jargs.lr)
    for step in range(3):
        key, skey = jax.random.split(key)
        eps = _latent_eps(skey, jargs.nspiral, jargs.latent_dim)
        loss, grads = jax.value_and_grad(jx.elbo_loss)(
            params, trajs, ts, skey, jargs.noise_std)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        ploss = latent_ode.train_step(model, popt, p_trajs, p_ts,
                                      torch.from_numpy(np.asarray(eps)),
                                      jargs.noise_std)
        close(ploss, loss, VALUES, f"neg elbo, step {step}")
        if step == 0:
            grads_close([p.grad for p in _latent_leaves(model)],
                        jax.tree.leaves(grads))
    all_close(_latent_leaves(model), jax.tree.leaves(params), PARAMS,
              "parameters after 3 steps")


def test_latent_ode_per_trajectory_stats_and_extrapolation_match_jax():
    """Each trajectory's own solve (its controller's counters against JAX's
    vmap of one solve a trajectory), and the extrapolation's reversed- and
    forward-time solves from 0 (latent_ode.py:145-160)."""
    (jx, jargs, key, trajs, ts, params, model, p_trajs,
     p_ts) = _latent_setup()
    eps = _latent_eps(key, jargs.nspiral, jargs.latent_dim)
    mean, logvar = jax.vmap(lambda tr: jx.encode(params, tr))(trajs)
    z0 = mean + eps * jnp.exp(0.5 * logvar)
    ys_j, st_j = j_per_sample(jx.latent_field, z0, ts,
                              args=(params['func'],), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        p_mean, p_logvar = latent_ode.encode(model, p_trajs)
        close(p_mean, mean, VALUES, "encoder mean")
        close(p_logvar, logvar, VALUES, "encoder logvar")
        p_z0 = p_mean + torch.from_numpy(np.asarray(eps)) * torch.exp(
            0.5 * p_logvar)
        ys_p, st_p = latent_ode.latent_solve(model, p_z0, p_ts,
                                             with_stats=True)
    close(ys_p, ys_j, VALUES, "latent paths")
    stats_equal(st_p, st_j)
    assert int(np.asarray(st_j.n_steps).min()) > 1

    ts_ext = jnp.linspace(-1.0, 2.0, 30, dtype=jnp.float32)
    m0, _ = jx.encode(params, trajs[0])
    want = [j_odeint_adjoint(jx.latent_field, m0, jnp.concatenate(
                [jnp.zeros(1, jnp.float32), part]), args=(params['func'],))
            for part in (ts_ext[ts_ext < 0][::-1], ts_ext[ts_ext >= 0])]
    with torch.no_grad():
        got = latent_ode.extrapolate(model, p_trajs[0], torch.from_numpy(
            np.asarray(ts_ext)).double())
    for g, w in zip(got, want):
        close(g, w, VALUES, "extrapolation")


