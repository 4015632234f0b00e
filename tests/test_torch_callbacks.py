"""The callbacks of the PyTorch port (mirrors tests/test_callbacks.py): a
field's ``callback_step`` / ``callback_accept_step`` /
``callback_reject_step`` attributes fire on the host per executed step with
the user's time frame and state structure, their ``_adjoint`` twins fire in
the backward solve, and a callback the solver kind does not fire is warned
about and dropped.  Where JAX is run beside the port, the sequence of
``(t0, dt)`` the callbacks see is held to JAX's (float64): on a fixed grid
at 1e-12; on the adaptive loop at 1e-5 relative, since the proposed step
inherits the relative rounding of the error estimate, a cancellation of
stage values whose last bits differ between the two (measured 1.1e-6 at
most in these tests), while every accept decision and counter agrees."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt


ADAPTIVE_RTOL = 1e-5


class Recorder:
    """A field that records its callbacks: ``(kind, t0, dt, the shapes of
    the state's leaves)``."""

    def __init__(self, f):
        self.f = f
        self.seen = []

    def __call__(self, t, y, *args):
        return self.f(t, y, *args)

    def _rec(self, kind, t0, y0, dt):
        shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(y0)]
        self.seen.append((kind, float(t0), float(dt), shapes))

    def callback_step(self, t0, y0, dt):
        self._rec('step', t0, y0, dt)

    def callback_accept_step(self, t0, y0, dt):
        self._rec('accept', t0, y0, dt)

    def callback_reject_step(self, t0, y0, dt):
        self._rec('reject', t0, y0, dt)

    def callback_step_adjoint(self, t0, y0, dt):
        self._rec('step_adjoint', t0, y0, dt)

    def callback_accept_step_adjoint(self, t0, y0, dt):
        self._rec('accept_adjoint', t0, y0, dt)

    def callback_reject_step_adjoint(self, t0, y0, dt):
        self._rec('reject_adjoint', t0, y0, dt)

    def count(self, kind):
        return sum(1 for s in self.seen if s[0] == kind)

    def times(self, *kinds):
        return np.array([(s[1], s[2]) for s in self.seen if s[0] in kinds])


def _kink_j(t, y):
    return jnp.where(t < 0.5, -y, 2.0 * y) + jnp.sin(3.0 * t)


def _kink_t(t, y):
    return torch.where(t < 0.5, -y, 2.0 * y) + torch.sin(3.0 * t)


Y0 = np.array([1.0, -0.5, 0.25])


@pytest.mark.parametrize("t", [(0.0, 0.3, 1.0), (1.0, 0.6, 0.0)],
                         ids=['fwd', 'rev'])
def test_adaptive_callbacks_accounting_matches_jax(t):
    """steps == n_steps, accepts == n_accepted, rejects == n_rejected, and
    the (t0, dt) of every callback equal to JAX's in the user's frame, on a
    solve that rejects steps."""
    rec_j, rec_t = Recorder(_kink_j), Recorder(_kink_t)
    _, st_j = tde.odeint_with_stats(rec_j, jnp.asarray(Y0), jnp.asarray(t),
                                    rtol=1e-8, atol=1e-10)
    jax.effects_barrier()
    _, st = tt.odeint_with_stats(rec_t, torch.from_numpy(Y0),
                                 torch.tensor(t, dtype=torch.float64),
                                 rtol=1e-8, atol=1e-10)
    assert st.n_rejected > 0
    assert rec_t.count('step') == st.n_steps
    assert rec_t.count('accept') == st.n_accepted
    assert rec_t.count('reject') == st.n_rejected
    assert rec_t.count('accept') + rec_t.count('reject') == st.n_steps
    for kinds in (('step',), ('accept',), ('reject',)):
        np.testing.assert_allclose(rec_t.times(*kinds), rec_j.times(*kinds),
                                   rtol=ADAPTIVE_RTOL, atol=1e-15)
    assert [int(x) for x in st_j[:5]] == list(st[:5])


def test_callback_args_user_frame():
    """User-frame time and user-structured state, also for reversed time
    and a tuple state (reference misc.py:326-333)."""
    rec = Recorder(lambda t, y: (-y[0], -2.0 * y[1]))
    y0 = (torch.ones(2, 2, dtype=torch.float64),
          torch.ones(3, dtype=torch.float64))
    tt.odeint(rec, y0, torch.linspace(2.0, 0.0, 3, dtype=torch.float64))
    steps = [s for s in rec.seen if s[0] == 'step']
    assert steps and all(s[3] == [(2, 2), (3,)] for s in steps)
    ts = [s[1] for s in steps]
    assert all(0.0 <= x <= 2.0 for x in ts) and ts[0] == 2.0
    assert all(s[2] > 0 for s in steps)     # dt in the internal frame


@pytest.mark.parametrize("method", ['euler', 'rk4'])
def test_fixed_grid_step_callback(method):
    """One step callback per grid step (15 grid points over [1, 8] at
    h=0.5: 14 steps), the same (t0, dt) as JAX's, and no accept/reject
    callbacks, which the fixed kind does not fire."""
    t = np.linspace(1.0, 8.0, 4)
    rec_j, rec_t = Recorder(lambda s, y: -0.1 * y), Recorder(
        lambda s, y: -0.1 * y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tde.odeint(rec_j, jnp.ones(2), jnp.asarray(t), method=method,
                   options=dict(step_size=0.5))
        jax.effects_barrier()
        tt.odeint(rec_t, torch.ones(2, dtype=torch.float64),
                  torch.from_numpy(t), method=method,
                  options=dict(step_size=0.5))
    assert rec_t.count('step') == 14
    assert rec_t.count('accept') == rec_t.count('reject') == 0
    np.testing.assert_allclose(rec_t.times('step'), rec_j.times('step'),
                               rtol=0, atol=1e-12)


def test_invalid_callback_warns():
    rec = Recorder(lambda s, y: -y)
    with pytest.warns(UserWarning, match="does not support callbacks"):
        tt.odeint(rec, torch.ones(1, dtype=torch.float64),
                  torch.tensor([0.0, 1.0], dtype=torch.float64),
                  method='euler', options=dict(step_size=0.25))
    assert rec.count('step') == 4


@pytest.mark.parametrize("method,options", [
    ('dopri5', None), ('rk4', dict(num_steps=5)),
], ids=['adaptive', 'fixed'])
def test_adjoint_callbacks_match_jax(method, options):
    """The `_adjoint` callbacks fire in the backward solve and only there,
    with the backward's own time (the forward's internal frame) and step
    sizes, equal to JAX's; the state they get is the augmented tuple
    ``(vjp_t, y, adj_y, theta_bar)``."""
    t = np.array([0.0, 0.4, 1.0])
    args = {}
    for lib in ('jax', 'torch'):
        if lib == 'jax':
            rec = Recorder(lambda s, y, w: -w * y)
            y0, ts, w = jnp.asarray(Y0), jnp.asarray(t), jnp.asarray(0.7)
            g = jax.grad(lambda y, w_: jnp.sum(tde.odeint_adjoint(
                rec, y, ts, method=method, options=options,
                args=(w_,))[-1] ** 2), argnums=(0, 1))(y0, w)
            jax.effects_barrier()
        else:
            rec = Recorder(lambda s, y, w: -w * y)
            y0 = torch.from_numpy(Y0).requires_grad_()
            w = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
            (tt.odeint_adjoint(rec, y0, torch.from_numpy(t), method=method,
                               options=options, args=(w,))[-1] ** 2
             ).sum().backward()
            g = (y0.grad, w.grad)
        args[lib] = rec, g
    (rec_j, g_j), (rec_t, g_t) = args['jax'], args['torch']
    assert rec_t.count('step_adjoint') > 0
    rtol = ADAPTIVE_RTOL if method == 'dopri5' else 0.0
    for kinds in (('step',), ('step_adjoint',), ('accept_adjoint',),
                  ('reject_adjoint',)):
        np.testing.assert_allclose(rec_t.times(*kinds).reshape(-1, 2),
                                   rec_j.times(*kinds).reshape(-1, 2),
                                   rtol=rtol, atol=1e-12)
    aug = [s[3] for s in rec_t.seen if s[0] == 'step_adjoint'][0]
    assert aug == [(), (3,), (3,), ()]
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)


def test_adjoint_noise_floor_preset():
    """adjoint_options=dict(noise_floor=True) floors the backward rtol at
    the state dtype's rounding unit: for a bfloat16 state it cuts the
    backward steps, counted by the adjoint step callback, with the
    gradient at the bfloat16 noise level (analytic e^-1); for float32 at
    ordinary tolerances it changes nothing (JAX
    test_callbacks.py::test_adjoint_noise_floor_preset)."""
    def run(noise_floor, dtype):
        rec = Recorder(lambda s, y: -0.5 * y)
        y0 = torch.ones(4, dtype=dtype, requires_grad=True)
        opts = dict(noise_floor=True) if noise_floor else None
        ys = tt.odeint_adjoint(rec, y0, torch.tensor([0.0, 1.0, 2.0]),
                               rtol=1e-4, atol=1e-6, adjoint_options=opts)
        ys[-1].float().sum().backward()
        return rec.count('step_adjoint'), y0.grad.double().numpy()

    steps_plain, g_plain = run(False, torch.bfloat16)
    steps_floor, g_floor = run(True, torch.bfloat16)
    assert steps_floor < steps_plain, (steps_floor, steps_plain)
    assert np.allclose(g_floor, np.exp(-1.0), rtol=0.05)
    assert np.allclose(g_plain, g_floor, rtol=0.05)
    assert run(False, torch.float32)[0] == run(True, torch.float32)[0]
