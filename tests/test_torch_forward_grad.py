"""``options=dict(forward_grad=True)`` on the adaptive methods: the port's
`torch.func.jvp` through the host loop against JAX's `jax.jvp` through its
``while_loop`` (tests/test_gradients.py:292-360 and the forward_grad rows
of tests/test_compat_matrix.py), on the same numpy inputs in float64.

Both take the tangent of every step size the controller picks, so the
tangents agree to 1e-9 of their largest entry, and the values and Stats
are the plain solve's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt
from torch_problems import counters

FG = dict(forward_grad=True)
REL = 1e-9


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rel * scale, \
        (float(np.abs(got - want).max()), scale)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _jvp_pair(f_j, f_t, y0, t, v, **kw):
    """(primal, tangent) of odeint(f, y0, t) in the direction v of y0,
    through both packages."""
    pj, tj = jax.jit(lambda y, w: jax.jvp(
        lambda x: tde.odeint(f_j, x, jnp.asarray(t), **kw), (y,), (w,)))(
        jnp.asarray(y0), jnp.asarray(v))
    pt, tt_ = torch.func.jvp(lambda y: tt.odeint(f_t, y, _t(t), **kw),
                             (_t(y0),), (_t(v),))
    return (np.asarray(pj), np.asarray(tj)), (pt.numpy(), tt_.numpy())


def test_jvp_wrt_y0_matches_jax_and_closed_form():
    """test_forward_grad_jvp_matches_closed_form (and the compat matrix's
    test_forward_grad_jvp_works): y' = -y, d y(t)/d y0 = exp(-t)."""
    t = np.linspace(0., 2., 5)
    (pj, tj), (pt, tt_) = _jvp_pair(lambda s, y: -y, lambda s, y: -y,
                                    np.array([1.0]), t, np.ones(1),
                                    options=FG)
    _close(pt, pj, 1e-12)
    _close(tt_, tj)
    np.testing.assert_allclose(tt_[:, 0], np.exp(-t), rtol=1e-6)


def test_jvp_through_the_controller_matches_jax():
    """y' = tanh(y A) - y**3 / 10 at a loose tolerance, where the step
    sizes' tangents are far above 1e-9, with the PID controller, step_t,
    jump_t and a first step: the tangent in a random direction of y0 to
    JAX's, the Stats the plain solve's; the controller's share of the
    tangent, which the replay's (the step boundaries held fixed) leaves
    out, is far above REL."""
    rng = np.random.RandomState(0)
    A = rng.randn(2, 2) * 0.5
    y0, v = rng.randn(4, 2), rng.randn(4, 2)
    t = np.linspace(0., 1., 4)
    opts = dict(controller='pid', dcoeff=0.2, step_t=[0.3], jump_t=[0.45],
                first_step=0.01)
    kw = dict(rtol=1e-4, atol=1e-6, options=dict(FG, **opts))
    f_j = lambda s, y: jnp.tanh(y @ jnp.asarray(A)) - 0.1 * y ** 3
    f_t = lambda s, y: torch.tanh(y @ _t(A)) - 0.1 * y ** 3
    (pj, tj), (pt, tt_) = _jvp_pair(f_j, f_t, y0, t, v, **kw)
    _close(pt, pj, 1e-12)
    _close(tt_, tj)
    # the Stats are the plain solve's (which equal JAX's,
    # tests/test_torch_solver_options.py)
    _, st_fg = tt.odeint_with_stats(f_t, _t(y0), _t(t), **kw)
    _, st_t = tt.odeint_with_stats(f_t, _t(y0), _t(t),
                                   **dict(kw, options=opts))
    assert counters(st_fg) == counters(st_t)
    rp = torch.func.jvp(lambda y: tt.odeint(
        f_t, y, _t(t), **dict(kw, options=dict(opts, replay_grad=True))),
        (_t(y0),), (_t(v),))[1]
    assert float(np.abs(rp.numpy() - tt_).max()) > 1e3 * REL * float(
        np.abs(tj).max())


@pytest.mark.parametrize("method", ["kvaerno5"])
def test_jvp_implicit_tiers_match_jax(method):
    """y' = -0.7 y**3 + sin(t) on the stiff tableaus: each stage solve's
    implicit-function tangent (JAX's custom_root), not the Newton
    iterations', and the initial step's tangent (its norms' maximum
    included)."""
    t = np.linspace(0., 1., 3)
    kw = dict(method=method, rtol=1e-6, atol=1e-8, options=FG)
    (pj, tj), (pt, tt_) = _jvp_pair(
        lambda s, y: -0.7 * y ** 3 + jnp.sin(s),
        lambda s, y: -0.7 * y ** 3 + torch.sin(s),
        np.array([1.0, 2.0]), t, np.array([1.0, -0.5]), **kw)
    _close(pt, pj, 1e-12)
    _close(tt_, tj)


@pytest.mark.parametrize("step_to_end", [False, True])
def test_jvp_wrt_t_matches_jax(step_to_end):
    """test_forward_grad_jvp_wrt_t: d y(t1)/d t1 = -exp(-t1), and the
    tangent of an interior output time; with step_to_end the forced step
    boundaries carry the output times' tangents."""
    f = lambda s, y: -y

    def ends_j(t):
        return tde.odeint(f, jnp.array([1.0]), t, options=dict(
            FG, step_to_end=step_to_end))[:, 0]

    def ends_t(t):
        return tt.odeint(f, _t([1.0]), t, options=dict(
            FG, step_to_end=step_to_end))[:, 0]

    t, v = np.array([0., 0.7, 1.5]), np.array([0., 0.5, 1.0])
    _, tj = jax.jit(lambda a, b: jax.jvp(ends_j, (a,), (b,)))(
        jnp.asarray(t), jnp.asarray(v))
    _, tt_ = torch.func.jvp(ends_t, (_t(t),), (_t(v),))
    _close(tt_.numpy(), np.asarray(tj))
    np.testing.assert_allclose(tt_.numpy()[-1], -np.exp(-1.5), rtol=1e-6)


def test_jacfwd_matches_jax():
    """test_forward_grad_jacfwd_matches_adjoint_jacrev: the Jacobian of
    y(t_end) in y0 of y' = A y, column by column (``torch.func.jacfwd``
    vmaps, and the loop reads to the host), against JAX's jacfwd and the
    closed form expm(A t_end)."""
    import scipy.linalg
    A = np.random.RandomState(0).randn(3, 3) * 0.5
    y0, t = np.ones(3), np.array([0., 0.5, 1.0])
    kw = dict(rtol=1e-7, atol=1e-9, options=FG)
    J_j = jax.jit(jax.jacfwd(lambda y: tde.odeint(
        lambda s, yy: jnp.asarray(A) @ yy, y, jnp.asarray(t), **kw)[-1]))(
        jnp.asarray(y0))
    cols = [torch.func.jvp(lambda y: tt.odeint(
        lambda s, yy: _t(A) @ yy, y, _t(t), **kw)[-1], (_t(y0),), (e,))[1]
        for e in torch.eye(3, dtype=torch.float64)]
    J_t = torch.stack(cols, dim=1).numpy()
    _close(J_t, np.asarray(J_j))
    np.testing.assert_allclose(J_t, scipy.linalg.expm(A), rtol=1e-5)


def test_second_order_matches_jax():
    """test_forward_grad_second_order: y' = -y**2, y(1) = y0 / (1 + y0),
    d2 y(1) / d y0^2 = -2 / (1 + y0)^3, forward over forward (jvp of jvp
    on both sides: jacfwd of jacfwd for a scalar)."""
    f = lambda s, y: -y ** 2
    t = np.array([0., 1.])
    kw = dict(rtol=1e-8, atol=1e-10, options=FG)

    def last_j(y):
        return tde.odeint(f, y[None], jnp.asarray(t), **kw)[-1, 0]

    def last_t(y):
        return tt.odeint(f, y[None], _t(t), **kw)[-1, 0]

    one_j = jnp.ones(())
    d2_j = jax.jit(lambda y: jax.jvp(lambda x: jax.jvp(
        last_j, (x,), (one_j,))[1], (y,), (one_j,))[1])(jnp.asarray(0.5))
    one = _t(1.0)
    d2_t = torch.func.jvp(
        lambda y: torch.func.jvp(last_t, (y,), (one,))[1], (_t(0.5),),
        (one,))[1]
    _close(d2_t.numpy(), np.asarray(d2_j))
    np.testing.assert_allclose(float(d2_t), -2 / 1.5 ** 3, rtol=1e-5)


def test_event_raises():
    """test_forward_grad_event_raises and the compat matrix's
    test_forward_grad_rejects_events: JAX's message."""
    f = lambda s, y: -y
    with pytest.raises(ValueError, match="replay_grad"):
        tt.odeint(f, _t([1.0]), _t([0., 1.]),
                  event_fn=lambda s, y: y[0] - 0.5, options=FG)
    with pytest.raises(ValueError, match="forward_grad does not support"):
        tt.odeint_event(f, _t([1.0, 2.0]), 0.0,
                        event_fn=lambda s, y: y[0] - 0.5, options=FG)


def test_has_no_reverse_mode():
    """test_forward_grad_has_no_reverse_mode: the loop runs under
    torch.no_grad(), so backward finds no graph and raises, as JAX finds
    no transpose of its while_loop."""
    y0 = _t([1.0, 2.0]).requires_grad_()
    ys = tt.odeint(lambda s, y: -0.5 * y, y0, _t([0., 1.]), options=FG)
    assert not ys.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        ys[-1].sum().backward()


def test_noop_on_fixed_methods():
    """test_forward_grad_noop_on_fixed_methods: the fixed grid takes the
    option and drops it (the same tangent as without it, exp(-t)); both
    modes of differentiation work, as in JAX."""
    f = lambda s, y: -y
    t = _t(np.linspace(0., 2., 5))

    def solve(y, **opts):
        return tt.odeint(f, y, t, method='rk4',
                         options=dict(num_steps=40, **opts))

    _, tg = torch.func.jvp(lambda y: solve(y, **FG), (_t([1.0]),),
                           (_t([1.0]),))
    _, tp = torch.func.jvp(solve, (_t([1.0]),), (_t([1.0]),))
    assert torch.equal(tg, tp)
    np.testing.assert_allclose(tg[:, 0].numpy(), np.exp(-t.numpy()),
                               rtol=1e-5)
    y0 = _t([1.0]).requires_grad_()
    solve(y0, **FG).sum().backward()
    assert torch.isfinite(y0.grad).all()
