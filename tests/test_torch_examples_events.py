"""The port's bouncing_ball, learn_physics and ensemble examples against the
JAX package's (``examples/*.py``), in float64, whole (3 events each):

* bouncing_ball: the three chained event times and the last one's
  gradient with respect to all five inputs, t0 among them;
* learn_physics: the trajectory loss through 3 events, its gradient and 3
  Adam steps;
* ensemble (B=16): the per-lane kernel route (the plain version on the CPU)
  against JAX's Pallas kernel in interpret mode, forward and event solves,
  every counter exactly and values to 1e-12; the batched driver against
  JAX's vmap route likewise, but for its event times, which its bisection
  to atol sets only to atol.  ``examples/ensemble.py`` runs at import, so
  its field is written out here, its lines cited.

Bounds as in test_torch_examples.py: values to 1e-10 relative, gradients
to 1e-8, parameters after 3 steps to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from test_torch_examples import (GRADS, PARAMS, VALUES, all_close, close,
                                 jax_example, stats_equal, one_thread)
from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
from torchdiffeq_tpu_torch.examples import (bouncing_ball, ensemble,
                                            learn_physics)
from torchdiffeq_tpu_torch.examples._common import default_dtype
from torchdiffeq_tpu_torch.examples._optim import Adam

INPUTS = (10.0, -2.0, float(np.log(0.3)), 9.8, 0.0)


def test_bouncing_ball_times_and_gradients_match_jax():
    jx = jax_example("bouncing_ball")
    j_in = tuple(jnp.asarray(v) for v in INPUTS)
    want_t = jx.get_collision_times(*j_in)
    want_g = jax.grad(lambda *a: jx.get_collision_times(*a)[-1],
                      argnums=tuple(range(5)))(*j_in)
    with default_dtype(torch.float64):
        p_in = [torch.tensor(v, requires_grad=True) for v in INPUTS]
        got_t = bouncing_ball.get_collision_times(*p_in)
        got_g = torch.autograd.grad(got_t[-1], p_in)
    for g, w in zip(got_t, want_t):
        close(g, w, VALUES, "event time")
    all_close(list(got_g), list(want_g), GRADS, "d(last event)/d(input)")
    # the t0 gradient is one: a later start delays every bounce by as much
    assert abs(float(got_g[4]) - 1.0) < 1e-9


def test_learn_physics_loss_gradients_and_adam_match_jax():
    jx = jax_example("learn_physics")
    t_np = np.linspace(0.0, 3.0, 100)
    y_np = jx.simulate_true(t_np)
    np.testing.assert_array_equal(learn_physics.simulate_true(t_np), y_np)
    t_obs, y_obs = jnp.asarray(t_np), jnp.asarray(y_np)
    params = dict(log_gravity=jnp.asarray(np.log(5.0)),
                  logit_restitution=jnp.asarray(0.0))
    loss_grad = jax.value_and_grad(
        lambda p: jx.trajectory_loss(p, t_obs, y_obs, 3.0, 3))
    opt = optax.adam(0.05)
    opt_state = opt.init(params)
    with default_dtype(torch.float64):
        p_params = learn_physics.params_from_jax(params)
        popt = Adam(list(p_params.values()), 0.05)
        pt, py = torch.from_numpy(t_np), torch.from_numpy(y_np)
        for step in range(3):
            loss, grads = loss_grad(params)
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            popt.zero_grad()
            ploss = learn_physics.trajectory_loss(p_params, pt, py, 3.0, 3)
            ploss.backward()
            close(ploss, loss, VALUES, f"loss, step {step}")
            all_close([p_params[k].grad for k in sorted(p_params)],
                      [grads[k] for k in sorted(grads)], GRADS, "gradient")
            popt.step()
    all_close([p_params[k] for k in sorted(p_params)],
              [params[k] for k in sorted(params)], PARAMS,
              "parameters after 3 steps")


def j_field(t, y, om):
    """examples/ensemble.py:46-48."""
    return jnp.stack([y[1], -om ** 2 * y[0] - 0.1 * y[1]])


def _ensemble(B=16):
    omega, y0, t = ensemble.make_problem(B, "cpu", torch.float64)
    return omega, y0, t, jnp.asarray(omega.numpy()), jnp.asarray(y0.numpy())


def test_ensemble_kernel_route_and_driver_match_jax():
    omega, y0, t, j_om, j_y0 = _ensemble()
    common = dict(args=(j_om,), args_axes=(-1,), rtol=1e-6, atol=1e-8,
                  method="dopri5")
    t_j = jnp.asarray(t.numpy())
    for pallas in (True, False):
        opts = dict(options=dict(pallas=True, interpret=True)) if pallas \
            else {}
        ys_j, st_j = j_per_sample(j_field, j_y0, t_j, **opts, **common)
        ys_p, st_p = ensemble.solve(omega, y0, t, 1e-6, "dopri5", pallas)
        close(ys_p, ys_j, 1e-12, f"ensemble values, pallas={pallas}")
        stats_equal(st_p, st_j)
    assert int(np.asarray(st_j.n_steps).max()) > 100


def test_ensemble_events_match_jax():
    omega, y0, _, j_om, j_y0 = _ensemble()
    t_ev = torch.tensor([0.0, 2.0], dtype=torch.float64)
    common = dict(args=(j_om,), args_axes=(-1,), rtol=1e-6, atol=1e-8,
                  method="dopri5", event_fn=lambda tt, yy: yy[0])
    for pallas in (True, False):
        opts = dict(options=dict(pallas=True, interpret=True)) if pallas \
            else {}
        (et_j, ys_j), st_j = j_per_sample(j_field, j_y0,
                                          jnp.asarray(t_ev.numpy()),
                                          **opts, **common)
        (et_p, ys_p), st_p = ensemble.solve(omega, y0, t_ev, 1e-6, "dopri5",
                                            pallas, event=True)
        stats_equal(st_p, st_j)
        if pallas:
            close(et_p, et_j, 1e-12, "kernel route event times")
            close(ys_p, ys_j, 1e-12, "kernel route event states")
        else:
            # the driver bisects each sample's last step until its bracket
            # is under atol (JAX's vmap route does the same), so a last-bit
            # difference of the interpolant at a midpoint moves the event
            # time within atol (5e-9 measured), and the state by that
            # times its rate, at most omega^2 = 3600 here
            atol, w2 = 1e-8, float(omega.max()) ** 2
            close(et_p, et_j, 1.0, "driver event times", atol)
            close(ys_p, ys_j, 1.0, "driver event states", atol * w2)
