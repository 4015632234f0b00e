"""``options=dict(replay_grad=True)``: the port's record-and-replay against
JAX's (tests/test_replay.py), on the same numpy inputs in float64.

The replay runs the same steps with the same arithmetic, so values agree
to 1e-12 and gradients (reverse, forward and second order) to 1e-10 of
their largest entry; the Stats are the recording's and equal JAX's
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import construct_problem, counters

REPLAY = dict(replay_grad=True, max_segments=256)
VAL, GRAD = 1e-12, 1e-10


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.nanmax(np.abs(want))), 1e-300)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert float(np.nanmax(np.abs(got - want))) <= rel * scale, \
        (float(np.nanmax(np.abs(got - want))), scale)


def _pair(f_j, f_t, y0, t, **kw):
    """odeint_with_stats through both packages: (ys, counters) each (JAX's
    under jit, whose replay capacity is then `max_segments`, or 512)."""
    ys_j, st_j = jax.jit(lambda y, s: tde.odeint_with_stats(
        f_j, y, s, **kw))(jnp.asarray(y0), jnp.asarray(t))
    ys_t, st_t = tt.odeint_with_stats(f_t, _t(y0), _t(t), **kw)
    return (np.asarray(ys_j), counters(st_j)), (ys_t.detach().numpy(),
                                                counters(st_t))


@pytest.mark.parametrize('method', ['dopri5'])
def test_replay_matches_jax_and_forward(method):
    """test_replay_matches_forward: the replayed values equal the plain
    solve's, JAX's (which its own test holds equal to JAX's replay to
    1e-12) and the port's; the Stats are the plain solve's (the recording
    counts the same steps and evaluations)."""
    f_j, f_t, y0, t = construct_problem(ode='sine')
    tol = dict(rtol=1e-5, atol=1e-7) if method == 'adaptive_heun' else {}
    (ys_j, st_j), (ys_p, st_p) = _pair(f_j, f_t, y0, t, method=method, **tol)
    ys_t, st_t = tt.odeint_with_stats(f_t, _t(y0), _t(t), method=method,
                                      options=dict(replay_grad=True,
                                                   max_segments=4096), **tol)
    assert counters(st_t) == st_j == st_p and st_j[4] == 0
    _close(ys_t.detach().numpy(), ys_j, VAL)
    _close(ys_t.detach().numpy(), ys_p, VAL)


@pytest.mark.parametrize('method', ['bosh3'])
def test_replay_exact_discrete_gradients(method):
    """test_replay_exact_discrete_gradients: through the replay with the
    recorded boundaries frozen, autograd equals central differences to
    near machine precision (the tests below hold the replay's gradients to
    JAX's)."""
    from torchdiffeq_tpu_torch.misc import check_inputs
    from torchdiffeq_tpu_torch.odeint import _adaptive_config
    from torchdiffeq_tpu_torch.solvers import SOLVERS, replay

    _, f_t, y0, t = construct_problem(ode='linear', npts=3)
    w = np.arange(1.0, 1.0 + y0.shape[0])
    prob = check_inputs(f_t, _t(y0), _t(t), 1e-6, 1e-8, method, None, None,
                        SOLVERS)
    cfg = _adaptive_config(prob, SOLVERS[method]['tableau'])
    times, stats = replay.record_segments(prob.func, prob.y0, prob.t, cfg,
                                          512)
    assert stats.error_code == 0
    ts_d = torch.from_numpy(prob.t)

    def loss(y):
        ys = replay.replay_integrate(prob.func, y, prob.t, ts_d, cfg, times)
        return (ys[-1] * _t(w)).sum()

    y = _t(y0, grad=True)
    loss(y).backward()
    g = y.grad.numpy()
    eps = 1e-7
    g_fd = np.array([(float(loss(_t(y0 + eps * e))) -
                      float(loss(_t(y0 - eps * e)))) / (2 * eps)
                     for e in np.eye(y0.size)])
    np.testing.assert_allclose(g, g_fd, rtol=5e-6, atol=1e-8)


def test_replay_forward_mode_and_second_order():
    """test_replay_forward_mode and test_replay_second_order on y' = -y**2,
    y(1) = y0 / (1 + y0): torch.func.jvp through the replayed solve, and
    autograd over autograd, against JAX's jvp and grad of grad (one
    compile) and the closed forms 1/(1+y0)^2 and -2/(1+y0)^3."""
    f = lambda s, y: -y ** 2
    t = np.array([0., 1.])

    def last_j(y):
        return tde.odeint(f, y[None], jnp.asarray(t), options=REPLAY)[-1, 0]

    tj, hj = jax.jit(lambda y: (jax.jvp(last_j, (y,), (jnp.ones(()),))[1],
                                jax.grad(jax.grad(last_j))(y)))(
        jnp.asarray(0.5))
    last_t = lambda y: tt.odeint(f, y[None], _t(t), options=REPLAY)[-1, 0]
    _, tg = torch.func.jvp(last_t, (_t(0.5),), (_t(1.0),))
    y = _t(0.5, grad=True)
    (g,) = torch.autograd.grad(last_t(y), y, create_graph=True)
    (h,) = torch.autograd.grad(g, y)
    _close(tg.numpy(), tj, GRAD)
    _close(h.numpy(), hj, GRAD)
    np.testing.assert_allclose(float(tg), 1 / 1.5 ** 2, rtol=1e-6)
    np.testing.assert_allclose(float(h), -2 / 1.5 ** 3, rtol=1e-5)


def test_replay_param_and_time_gradients():
    """test_replay_param_gradients, with the gradients to y0 and every
    output time beside the parameter's."""
    t = np.linspace(0., 2., 3)

    def loss_j(A, y0, ts):
        return jnp.sum(tde.odeint(lambda s, y: y @ A, y0, ts,
                                  options=REPLAY) ** 2)

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(jnp.array([[-0.4]]),
                                            jnp.ones(1), jnp.asarray(t))
    A, y0, ts = _t([[-0.4]], True), _t([1.0], True), _t(t, True)
    (tt.odeint(lambda s, y: y @ A, y0, ts, options=REPLAY) ** 2).sum() \
        .backward()
    for got, want in zip((A.grad, y0.grad, ts.grad), gj):
        _close(got.numpy(), want, GRAD)


def test_replay_overflow_flags_error():
    """test_replay_overflow_flags_error: max_segments=2 overflows; the
    error code and the NaN outputs are JAX's."""
    f = lambda s, y: -y
    kw = dict(options=dict(replay_grad=True, max_segments=2))
    (ys_j, st_j), (ys_t, st_t) = _pair(f, f, np.ones(1),
                                       np.linspace(0., 50., 3), **kw)
    assert st_t == st_j and st_t[4] == 5
    assert np.isnan(ys_t[-1, 0])
    np.testing.assert_array_equal(np.isnan(ys_t), np.isnan(ys_j))


def test_replay_auto_segments():
    """test_replay_auto_segments_probe: with max_segments omitted the
    record grows past JAX's first probe capacity of 512 steps (586 here);
    values and Stats to JAX's plain solve, which JAX's own probe test holds
    its auto-sized replay to."""
    g = lambda s, y: -60.0 * y
    y0, t = np.array([1.0, 2.0]), np.linspace(0., 4., 3)
    kw = dict(rtol=1e-7, atol=1e-9, method='bosh3')
    (ys_j, st_j), _ = _pair(g, g, y0, t, **kw)
    ys_t, st_t = tt.odeint_with_stats(g, _t(y0), _t(t),
                                      options=dict(replay_grad=True), **kw)
    assert counters(st_t) == st_j and st_j[2] > 512
    _close(ys_t.numpy(), ys_j, VAL)


@pytest.mark.parametrize("method", ["radau5a"])
def test_replay_implicit_tableaus(method):
    """The implicit adaptive tableaus replay their Newton stage solves, each
    converged stage carrying the implicit-function gradient (JAX's
    custom_root): the port's replay equals its plain solve to 1e-15 and
    JAX's replay to 1e-7 of max|y|, the gradient JAX's to 1e-6 of its
    largest entry, the Stats exactly.  The bounds are the stage solves',
    not rounding's: a Newton solve stops within 1e-8 of its root, and a
    last-bit difference in its residual can move the stop by one
    iteration (JAX's replay of kvaerno5 on this problem departs from its
    own plain solve by 1.1e-8; radau5a's agrees with the port's to 9e-12
    and its gradient to 1.2e-10)."""
    t = np.linspace(0., 1., 3)
    kw = dict(method=method, rtol=1e-6, atol=1e-8,
              options=dict(replay_grad=True, max_segments=64))

    def loss_j(a, y0):
        ys, st = tde.odeint_with_stats(lambda s, y: -a * y + jnp.sin(s), y0,
                                       jnp.asarray(t), **kw)
        return jnp.sum(ys ** 2), (ys, st)

    (_, (ys_j, st_j)), gj = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(0.7, jnp.array([1.0, 2.0]))
    a, y0 = _t(0.7, True), _t([1.0, 2.0], True)
    ys_t, st_t = tt.odeint_with_stats(lambda s, y: -a * y + torch.sin(s), y0,
                                      _t(t), **kw)
    (ys_t ** 2).sum().backward()
    assert counters(st_t) == counters(st_j)
    _close(ys_t.detach().numpy(), ys_j, 1e-7)
    _close(a.grad.numpy(), gj[0], 1e-6)
    _close(y0.grad.numpy(), gj[1], 1e-6)
    with torch.no_grad():
        ys_p = tt.odeint(lambda s, y: -0.7 * y + torch.sin(s), _t([1.0, 2.0]),
                         _t(t), method=method, rtol=1e-6, atol=1e-8)
    _close(ys_t.detach().numpy(), ys_p.numpy(), 1e-15)


def _h_j(a):
    return lambda s, y: jnp.where(s < 0.77, -a * y, -2.0 * a * y)


def _h_t(a):
    return lambda s, y: torch.where(s < 0.77, -a * y, -2.0 * a * y)


def test_replay_step_t_jump_t_matches_jax():
    """test_replay_step_t_jump_t_forward_parity and
    test_replay_jump_t_gradients: step_t and jump_t replayed (the jump's
    far-side re-evaluation included): values to the plain solve's and
    JAX's, Stats JAX's, and the gradient through the jump_t discontinuity
    to JAX's (one compile) and to central differences."""
    y0, t = np.array([1.0, 2.0]), np.linspace(0., 2., 5)
    opts = dict(step_t=np.array([0.33]), jump_t=np.array([0.77]))
    kw = dict(rtol=1e-8, atol=1e-10, options=dict(replay_grad=True, **opts))

    def solve_j(a):
        ys, st = tde.odeint_with_stats(_h_j(a), jnp.asarray(y0),
                                       jnp.asarray(t), **kw)
        return jnp.sum(ys[-1]), (ys, st)

    (_, (ys_j, st_j)), gj = jax.jit(jax.value_and_grad(solve_j,
                                                       has_aux=True))(0.5)

    def solve_t(a):
        return tt.odeint_with_stats(_h_t(a), _t(y0), _t(t), **kw)

    a = _t(0.5, grad=True)
    ys_t, st_t = solve_t(a)
    assert counters(st_t) == counters(st_j)
    _close(ys_t.detach().numpy(), ys_j, VAL)
    with torch.no_grad():
        ys_p = tt.odeint(_h_t(0.5), _t(y0), _t(t), rtol=1e-8, atol=1e-10,
                         options=opts)
    _close(ys_t.detach().numpy(), ys_p.numpy(), VAL)
    ys_t[-1].sum().backward()
    _close(a.grad.numpy(), gj, GRAD)
    eps = 1e-6
    g_fd = (float(solve_t(_t(0.5 + eps))[0][-1].sum())
            - float(solve_t(_t(0.5 - eps))[0][-1].sum())) / (2 * eps)
    np.testing.assert_allclose(float(a.grad), g_fd, rtol=1e-5)


def test_replay_event_solve():
    """test_replay_event_solve and test_replay_event_state_gradient: the
    event time ln(2)/a and the state at the event, with the gradients of
    the discrete solution (no IFT regulariser), and the recording's Stats,
    against JAX's; the event time's gradient against -ln(2)/a**2; and
    `odeint_event`, which takes the replay's event time and gradient with
    no reroute."""
    kw = dict(rtol=1e-10, atol=1e-12, options=dict(replay_grad=True),
              event_fn=lambda s, y: y[0] - 0.5)

    def solve_j(a):
        (et, ys), st = tde.odeint_with_stats(
            lambda s, y: jnp.stack([-a * y[0], -0.3 * y[1]]),
            jnp.array([1.0, 1.0]), jnp.array([0.0, 1.0]), **kw)
        return jnp.stack([et, ys[-1, 1]]), st

    (out_j, st_j), jac_j = jax.jit(lambda a: (solve_j(a), jax.jacrev(
        lambda b: solve_j(b)[0])(a)))(0.7)
    a = _t(0.7, grad=True)
    field = lambda s, y: torch.stack([-a * y[0], -0.3 * y[1]])
    (et, ys), st_t = tt.odeint_with_stats(field, _t([1.0, 1.0]),
                                          _t([0.0, 1.0]), **kw)
    assert counters(st_t) == counters(st_j)
    out = torch.stack([et, ys[-1, 1]])
    _close(out.detach().numpy(), out_j, VAL)
    g = torch.stack([torch.autograd.grad(o, a, retain_graph=True)[0]
                     for o in out])
    _close(g.numpy(), jac_j, GRAD)
    np.testing.assert_allclose(float(et), np.log(2) / 0.7, rtol=1e-8)
    np.testing.assert_allclose(float(g[0]), -np.log(2) / 0.7 ** 2, rtol=1e-6)
    et2, _ = tt.odeint_event(field, _t([1.0, 1.0]), 0.0, **kw)
    (g2,) = torch.autograd.grad(et2, a)
    assert float(et2) == float(et) and float(g2) == float(g[0])


def test_replay_tuple_state_and_custom_norm():
    """The compat matrix's test_replay_pytree_state_works on a tuple state
    (its dict state in the next test): the same gradients as the same
    problem on one flat state; test_replay_custom_norm_works: a user norm,
    against the closed form (JAX's test holds it to the adjoint's)."""
    t = np.linspace(0., 1., 5)
    a, b = _t([1.0, 2.0], True), _t(0.5, True)
    ys = tt.odeint(lambda s, y: (-y[0], 0.1 * y[1]), (a, b), _t(t),
                   options=dict(replay_grad=True))
    ys[0][-1].sum().backward()
    flat = _t([1.0, 2.0, 0.5], True)
    yf = tt.odeint(lambda s, y: y * _t([-1.0, -1.0, 0.1]), flat, _t(t),
                   options=dict(replay_grad=True, norm=lambda x: torch.max(
                       x[:2].pow(2).mean().sqrt(), x[2:].abs().max())))
    yf[-1, :2].sum().backward()
    _close(a.grad.numpy(), flat.grad[:2].numpy(), VAL)
    assert float(b.grad) == float(flat.grad[2]) == 0.0

    y = _t([1.0, 2.0], True)
    tt.odeint(lambda s, yy: -0.5 * yy, y, _t(t), options=dict(
        replay_grad=True, norm=lambda x: x.abs().max()))[-1].sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), np.exp(-0.5), rtol=1e-6)


def test_replay_dict_state_matches_jax():
    """The compat matrix's test_replay_pytree_state_works on its dict
    state: values, Stats and the gradients in both leaves against JAX's
    replay."""
    t = np.linspace(0., 1., 5)
    f = lambda s, y: {'x': -y['x'], 'v': 0.1 * y['v'] * y['x'][:1]}  # noqa
    opts = dict(replay_grad=True)

    def j_loss(x0, v0):
        ys = tde.odeint(f, {'x': x0, 'v': v0}, jnp.asarray(t), options=opts)
        return jnp.sum(ys['x'][-1]) + jnp.sum(ys['v'][-1] ** 2)

    x0, v0 = np.array([1.0, 2.0]), np.array([0.5])
    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(x0),
                                                      jnp.asarray(v0))
    ys_j, st_j = tde.odeint_with_stats(f, {'x': jnp.asarray(x0),
                                           'v': jnp.asarray(v0)},
                                       jnp.asarray(t), options=opts)
    x, v = _t(x0, True), _t(v0, True)
    ys, st = tt.odeint_with_stats(f, {'x': x, 'v': v}, _t(t), options=opts)
    assert counters(st) == counters(st_j)
    _close(ys['x'].detach().numpy(), ys_j['x'], VAL)
    _close(ys['v'].detach().numpy(), ys_j['v'], VAL)
    (ys['x'][-1].sum() + (ys['v'][-1] ** 2).sum()).backward()
    _close(x.grad.numpy(), g_j[0], GRAD)
    _close(v.grad.numpy(), g_j[1], GRAD)
