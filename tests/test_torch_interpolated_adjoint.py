"""``adjoint_options=dict(interpolated=True)``: the port's interpolated
adjoint against JAX's (tests/test_interpolated_adjoint.py and the
interpolated rows of tests/test_compat_matrix.py), on the same numpy inputs
in float64.

The forward is one dense recording and the backward one reduced sweep with
y read from its interpolant, in both packages with the same steps: the
forward values agree to 1e-12, the gradients to 1e-9 of their largest
entry, and the forward and backward Stats exactly; a complex state's
gradients are torch's conjugate of JAX's (`test_complex_state_matches_
jax`).  JAX's vmap row is ROADMAP A6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu.adjoint as jadj
import torchdiffeq_tpu_torch as tt
import torchdiffeq_tpu_torch.adjoint as tadj
from torch_problems import counters

INTERP = dict(interpolated=True)
VAL, GRAD = 1e-12, 1e-9
T5 = np.linspace(0.0, 2.0, 5)
Y0 = np.array([1.0, 2.0])


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rel * scale, \
        (float(np.abs(got - want).max()), scale)


# JAX's backward counters, appended by a debug callback compiled into the
# cached JAX functions below (so the list outlives each test's fixture)
_JAX_BWD = []


@pytest.fixture
def bwd_stats(monkeypatch):
    """The backward solves' counters of both packages: (jax, port); JAX's
    read by a debug callback, since its backward runs under jit."""
    _JAX_BWD.clear()
    got = (_JAX_BWD, [])
    raw_j, raw_t = jadj._raw_odeint, tadj._raw_odeint

    def wrapped_j(*a, **k):
        ys, st = raw_j(*a, **k)
        jax.debug.callback(lambda *c: _JAX_BWD.append([int(x) for x in c]),
                           *st[:5])
        return ys, st

    def wrapped_t(*a, **k):
        ys, st = raw_t(*a, **k)
        got[1].append(counters(st))
        return ys, st

    monkeypatch.setattr(jadj, '_raw_odeint', wrapped_j)
    monkeypatch.setattr(tadj, '_raw_odeint', wrapped_t)
    return got


_JAX = {}


def _jax_grads(f_j, loss_j, adjoint_options, adjoint_method=None):
    """JAX's value, Stats and gradients of ``loss(odeint_adjoint(...))``
    (dopri5 forward) under jit, one compile per field, loss, options and
    adjoint method (the times and states are arguments, so tests of the
    same shapes share it)."""
    key = (f_j, loss_j, repr(adjoint_options), adjoint_method)
    if key not in _JAX:
        def fj(y, s, a):
            ys, st = jadj.adjoint_solve(
                f_j, y, s, rtol=1e-7, atol=1e-9, method=None, options=None,
                event_fn=None, args=a, adjoint_rtol=1e-7, adjoint_atol=1e-9,
                adjoint_method=adjoint_method,
                adjoint_options=adjoint_options)
            return loss_j(ys), (ys, st)
        _JAX[key] = jax.jit(jax.value_and_grad(fj, argnums=(0, 1, 2),
                                               has_aux=True))
    return _JAX[key]


def _sum_last_j(ys):
    return jnp.sum(ys[-1])


def _both(f_j, f_t, y0, t, args=(), loss_j=None, loss_t=None, **kw):
    """Values, forward Stats and gradients (to y0, t and each arg) of
    ``loss(odeint_adjoint(...))`` through both packages (rtol 1e-7, atol
    1e-9, dopri5)."""
    loss_j = loss_j or _sum_last_j
    loss_t = loss_t or (lambda ys: ys[-1].sum())
    (_, (ys_j, st_j)), gj = _jax_grads(f_j, loss_j, kw['adjoint_options'])(
        jax.tree_util.tree_map(jnp.asarray, y0), jnp.asarray(t),
        tuple(jnp.asarray(a) for a in args))
    y = jax.tree_util.tree_map(lambda x: _t(x, True), y0)
    s, a = _t(t, True), tuple(_t(x, True) for x in args)
    ys_t, st_t = tadj.adjoint_solve(
        f_t, y, s, rtol=1e-7, atol=1e-9, method=None, options=None,
        event_fn=None, args=a, adjoint_rtol=1e-7, adjoint_atol=1e-9,
        adjoint_method=None, adjoint_options=kw['adjoint_options'])
    loss_t(ys_t).backward()
    leaves = list(y) if isinstance(y, tuple) else [y]
    g_t = [x.grad.numpy() for x in leaves + [s, *a]]
    g_j = [np.asarray(x) for x in jax.tree_util.tree_leaves(gj[0])] \
        + [np.asarray(gj[1])] + [np.asarray(x) for x in gj[2]]
    return (jax.tree_util.tree_map(np.asarray, ys_j), counters(st_j), g_j), \
        (jax.tree_util.tree_map(lambda x: x.detach().numpy(), ys_t),
         counters(st_t), g_t)


F_J = lambda t, y: -y + jnp.sin(t)
F_T = lambda t, y: -y + torch.sin(t)


@pytest.mark.parametrize("t", [T5, np.linspace(2.0, 0.0, 5),
                               np.array([0.0, 1.0])],
                         ids=["forward", "reversed", "endpoint"])
def test_matches_jax_y0_and_t(t, bwd_stats):
    """test_matches_standard_adjoint_y0_and_t and
    test_reverse_time_and_endpoint_only: values, gradients to y0 and every
    output time, forward and backward Stats against JAX's; the gradients
    against the standard adjoint's to 1e-5, as JAX holds them."""
    (ys_j, st_j, g_j), (ys_t, st_t, g_t) = _both(
        F_J, F_T, Y0, t, adjoint_options=INTERP)
    _close(ys_t, ys_j, VAL)
    assert st_t == st_j
    assert bwd_stats[1] == bwd_stats[0] and len(bwd_stats[1]) == 1
    for a, b in zip(g_t, g_j):
        _close(a, b, GRAD)
    y, s = _t(Y0, True), _t(t, True)
    tt.odeint_adjoint(F_T, y, s)[-1].sum().backward()
    np.testing.assert_allclose(g_t[0], y.grad.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(g_t[1], s.grad.numpy(), rtol=1e-5, atol=1e-9)


def test_matches_jax_params(bwd_stats):
    """test_matches_standard_adjoint_params: the gradient of a parameter
    in `args`, and the default adjoint norm's parameter term."""
    (_, st_j, g_j), (_, st_t, g_t) = _both(
        lambda t, y, w: -w * y, lambda t, y, w: -w * y, Y0, T5,
        args=(np.array([0.7]),), adjoint_options=INTERP)
    assert st_t == st_j and bwd_stats[1] == bwd_stats[0]
    for a, b in zip(g_t, g_j):
        _close(a, b, GRAD)


def test_tuple_state_and_seminorm(bwd_stats):
    """test_container_state_and_seminorm (a tuple state here) and the
    compat matrix's test_interpolated_norm_seminorm_string_works and
    test_interpolated_pytree_state_works."""
    f_j = lambda t, y: (-y[0], -0.5 * y[1])
    f_t = lambda t, y: (-y[0], -0.5 * y[1])
    (_, st_j, g_j), (_, st_t, g_t) = _both(
        f_j, f_t, (np.array([1.0]), np.array([2.0, 0.5])), T5,
        loss_j=lambda ys: jnp.sum(ys[0][-1]) + jnp.sum(ys[1][-1] ** 2),
        loss_t=lambda ys: ys[0][-1].sum() + (ys[1][-1] ** 2).sum(),
        adjoint_options=dict(INTERP, norm='seminorm'))
    assert st_t == st_j and bwd_stats[1] == bwd_stats[0]
    for a, b in zip(g_t, g_j):
        _close(a, b, GRAD)


def test_implicit_method_matches_jax(bwd_stats):
    """A radau5a backward (dopri5 forward): its stage solves take the
    Jacobian of the reduced augmented field, whose y the interpolant gives
    at a time torch.func made (looked up on the device, never read)."""
    f_j = lambda t, y, a: -a * y ** 3 + jnp.sin(t)
    f_t = lambda t, y, a: -a * y ** 3 + torch.sin(t)
    opts = dict(INTERP)
    loss = _jax_grads(f_j, _sum_last_j, opts, adjoint_method='radau5a')
    (_, (ys_j, st_j)), gj = loss(jnp.asarray(Y0), jnp.asarray(T5[:4]),
                                 (jnp.asarray(0.7),))
    y, a = _t(Y0, True), _t(0.7, True)
    ys_t, st_t = tadj.adjoint_solve(
        f_t, y, _t(T5[:4]), rtol=1e-7, atol=1e-9, method=None,
        options=None, event_fn=None, args=(a,), adjoint_rtol=1e-7,
        adjoint_atol=1e-9, adjoint_method='radau5a', adjoint_options=opts)
    ys_t[-1].sum().backward()
    _close(ys_t.detach().numpy(), ys_j, VAL)
    assert counters(st_t) == counters(st_j)
    assert bwd_stats[1] == bwd_stats[0]
    _close(y.grad.numpy(), gj[0], GRAD)
    _close(a.grad.numpy(), gj[2][0], GRAD)


def test_forward_step_t_jump_t_and_closed_form():
    """test_forward_jump_t_is_honored and the compat matrix's
    test_interpolated_forward_step_jump_t_work: the recording honours the
    forward's jump_t (and step_t) against the closed form; test_under_jit's
    exp(-2) gradient."""
    f = lambda t, y: torch.where(t < 0.5, -y, -3.0 * y)
    t = np.linspace(0.0, 1.0, 3)
    exact = np.where(t < 0.5, np.exp(-t), np.exp(-0.5) * np.exp(-3 * (t - 0.5)))
    ys = tt.odeint_adjoint(f, _t([1.0]), _t(t), rtol=1e-9, atol=1e-11,
                           options=dict(jump_t=[0.5], step_t=[0.25]),
                           adjoint_options=INTERP)
    assert float(np.abs(ys[:, 0].numpy() - exact).max()) < 1e-8
    y = _t(Y0, True)
    tt.odeint_adjoint(F_T, y, _t(T5), adjoint_options=INTERP)[-1].sum() \
        .backward()
    np.testing.assert_allclose(y.grad.numpy(), np.exp(-2.0), rtol=1e-5)


def test_separatrix_robustness():
    """test_separatrix_robustness: the logistic y' = y(1-y) from 0.2 to
    T=25, where the standard adjoint's reverse y re-solve is repelled from
    the separatrix y=1: the interpolated gradient is within 5e-2 of the
    analytic one, the standard one more than 100% off."""
    f = lambda t, y: y * (1.0 - y)
    T, y0v = 25.0, 0.2
    g_true = (np.exp(-T) / y0v ** 2) / (
        1.0 + (1.0 / y0v - 1.0) * np.exp(-T)) ** 2

    def grad_of(opts):
        y = _t([y0v], True)
        tt.odeint_adjoint(f, y, _t([0.0, T]), rtol=1e-9, atol=1e-11,
                          adjoint_options=opts)[-1, 0].backward()
        return float(y.grad)

    assert abs(grad_of(INTERP) - g_true) / g_true < 5e-2
    assert abs(grad_of(None) - g_true) / g_true > 1.0


def test_recording_failure_poisons_outputs():
    """test_recording_failure_poisons_outputs: a recording that trips its
    step budget NaN-poisons the outputs past the span it covered."""
    ys, st = tadj.adjoint_solve(
        F_T, _t(Y0), _t(T5), rtol=1e-7, atol=1e-9, method=None,
        options=dict(max_num_steps=1), event_fn=None, args=(),
        adjoint_rtol=1e-7, adjoint_atol=1e-9, adjoint_method=None,
        adjoint_options=INTERP)
    assert st.error_code == 3
    assert bool(torch.isnan(ys[-1]).all()) and bool(torch.isfinite(ys[0]).all())


def test_reduced_state_callbacks():
    """The `_adjoint` callbacks fire on the backward's steps with the
    reduced augmented state (vjp_t, adj_y, theta_bar), as in JAX."""
    seen = []

    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(_t([0.7]))

        def forward(self, t, y):
            return -self.w * y

        def callback_step_adjoint(self, t0, aug, dt):
            seen.append(tuple(x.shape if torch.is_tensor(x) else len(x)
                              for x in aug))

    tt.odeint_adjoint(Field(), _t(Y0, True), _t(T5),
                      adjoint_options=INTERP)[-1].sum().backward()
    assert seen and all(s == (torch.Size([]), torch.Size([2]), 1)
                        for s in seen)


@pytest.mark.parametrize("call,err,match", [
    (dict(method='dopri5x'), ValueError, "Invalid method"),
    (dict(method='rk4', options=dict(step_size=0.1)), ValueError,
     "adaptive"),
    (dict(adjoint_method='rk4', adjoint_options=dict(INTERP, step_size=0.1)),
     ValueError, "adaptive"),
    (dict(adjoint_options=dict(INTERP, norm=lambda aug: aug[0].abs())),
     ValueError, "custom adjoint norm"),
    (dict(adjoint_options=dict(INTERP, step_t=[0.5])), ValueError, "step_t"),
    (dict(adjoint_options=dict(INTERP, jump_t=[0.5])), ValueError, "jump_t"),
    (dict(event_fn=lambda t, y: y[0] - 0.5), ValueError, "event mode"),
])
def test_refusals(call, err, match):
    """test_invalid_configs_raise and the compat matrix's "raises" cells
    (events, a fixed-grid forward or adjoint method, a callable norm, an
    adjoint step_t or jump_t), JAX's messages."""
    kw = dict(adjoint_options=INTERP)
    kw.update(call)
    y0 = kw.pop('y0', _t(Y0, True))
    t = _t([0.0, 10.0]) if 'event_fn' in kw else _t(T5)
    with pytest.raises(err, match=match):
        tt.odeint_adjoint(lambda s, y: -y, y0, t, **kw)


def test_complex_state_matches_jax():
    """The compat matrix's complex cell (tests/test_compat_matrix.py:138),
    once a refusal here: the interpolated adjoint of a complex state with a
    real parameter, the gradients in y0 (conjugated: torch's convention is
    the conjugate of jax.grad's), the parameter and the output times
    against JAX's interpolated adjoint."""
    y0 = np.array([1.0 + 0.5j, 0.5 - 0.25j])
    w = np.array([1.0, 0.3])

    def loss(ys, lib):
        return lib.sum(abs(ys[-1]) ** 2) + lib.sum((ys[1] * ys[2]).real)

    g_j = jax.grad(lambda y, w_, t_: loss(tde.odeint_adjoint(
        lambda s, y_, ww: 1j * ww * y_ - 0.1 * y_ * s, y, t_, args=(w_,),
        adjoint_options=dict(interpolated=True)), jnp), argnums=(0, 1, 2))(
        jnp.asarray(y0), jnp.asarray(w), jnp.asarray(T5))
    yt = torch.tensor(y0, requires_grad=True)
    wt, tt_ = _t(w, True), _t(T5, True)
    loss(tt.odeint_adjoint(lambda s, y_, ww: 1j * ww * y_ - 0.1 * y_ * s, yt,
                           tt_, args=(wt,), adjoint_options=INTERP),
         torch).backward()
    for got, want in ((np.conj(yt.grad.numpy()), g_j[0]),
                      (wt.grad.numpy(), g_j[1]), (tt_.grad.numpy(), g_j[2])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-9 * max(1.0, float(np.abs(
                                       np.asarray(want)).max())))


def test_event_interface_refused():
    """test_interpolated_rejects_events: through odeint_event."""
    with pytest.raises(ValueError, match="does not support.*event"):
        tt.odeint_event(lambda s, y: -0.5 * y, _t(Y0), 0.0,
                        event_fn=lambda s, y: y[0] - 0.5,
                        odeint_interface=tt.odeint_adjoint,
                        adjoint_options=INTERP)
