"""Complex states in the PyTorch port against the JAX package, on the same
numpy inputs (CPU, complex128 unless stated): every tier (explicit adaptive,
fixed grid, Adams, FIRK/DIRK, the stiff tier), dense output, events, the
continuous adjoint (default, seminorm, noise_floor, interpolated), the
replay, forward-mode tangents, the SciPy bridge and the per-sample driver.
Mirrors tests/test_dtypes.py:17-53 and :77-99, tests/test_tree_fixed.py:109
and tests/test_compat_matrix.py:138, and goes beyond them.

Time, the step sizes, the tolerances and the controller stay real (the
state's real dtype), as in JAX and the reference.

Tolerances: complex128 values within 1e-12 of max|y| on the explicit tiers
and 1e-10 on the implicit ones; `Stats` counters exactly (per sample on the
driver); gradients: torch's gradient of a real loss with respect to a
complex tensor is the conjugate of `jax.grad`'s (torch gives dL/dx +
i dL/dy, JAX dL/dx - i dL/dy), so ``conj(port)`` is held to JAX's, within
1e-9 of max(1, max|g|).  The two frameworks' complex128 arithmetic is not
bit for bit the same (ROADMAP C16: XLA's |z|, products and quotients round
otherwise in the last place), so values differ by a few units in the last
place and an event time, found by bisection to the solve's atol, within
that atol.

Four findings are shown here (ROADMAP C14-C17): JAX's implicit-function
reroute of `odeint_event` forms its inner products of complex cotangents
without the conjugate, so its event gradient departs from finite
differences where the port's matches them (C14); JAX's adjoint hands a
closure-converted event function a complex time, so an event function that
does arithmetic with t raises in JAX and is answered by the port (C15);
the last-place differences of C16; and forward mode through a FIRK/DIRK
stage solve, which JAX refuses for any state and the port answers (C17).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu.adjoint as jadj
import torchdiffeq_tpu_torch as tt
import torchdiffeq_tpu_torch.adjoint as tadj
from torchdiffeq_tpu.parallel import odeint_per_sample as j_ps
from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
from torch_problems import counters

W = 2.0
T5 = np.linspace(0.0, 1.0, 5)
Y0 = np.array([1.0 + 0.5j, 0.3 - 0.2j])
OM = np.array([2.0, 0.7])
GRAD_TOL = 1e-9


def rot(t, y):
    """tests/test_dtypes.py's rotation y' = i W y (JAX and torch alike)."""
    return 1j * W * y


def j_field(t, y, w):
    """A nonlinear, non-holomorphic, time-dependent field."""
    return 1j * w * y - 0.1 * y * y[0] + 0.05 * jnp.conj(y) * t


def t_field(t, y, w):
    return 1j * w * y - 0.1 * y * y[0] + 0.05 * torch.conj(y) * t


def _c(x, dtype=torch.complex128):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _r(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _grad_close(port_grad, jax_grad, conj=True):
    """conj(port) against JAX within GRAD_TOL of max(1, max|g|)."""
    got = _np(port_grad)
    got = np.conj(got) if conj else got
    want = _np(jax_grad)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_TOL * max(1.0, float(np.abs(want).max())), err


def _pair(method=None, *, y0=Y0, t=T5, f_j=rot, f_t=rot, args=(), rel=1e-12,
          **kw):
    """`odeint_with_stats` through both packages: values within `rel` of
    max|y|, counters exactly."""
    ys_j, st_j = tde.odeint_with_stats(
        f_j, jnp.asarray(y0), jnp.asarray(t), method=method,
        args=tuple(jnp.asarray(a) for a in args), **kw)
    ys_t, st_t = tt.odeint_with_stats(
        f_t, _c(y0), _r(t), method=method, args=tuple(_r(a) for a in args),
        **kw)
    assert ys_t.dtype == torch.complex128
    _close(ys_t, ys_j, rel)
    assert counters(st_t) == counters(st_j)
    return ys_t, ys_j


# ---- tests/test_dtypes.py:17-53 -------------------------------------------

def test_complex_adaptive():
    ys_t, _ = _pair(rtol=1e-9, atol=1e-11, y0=np.array([1.0 + 0j]))
    np.testing.assert_allclose(ys_t[:, 0].numpy(), np.exp(1j * W * T5),
                               rtol=1e-7)


def test_complex_fixed():
    ys_t, _ = _pair('rk4', y0=np.array([1.0 + 0j]),
                    options=dict(step_size=0.01))
    np.testing.assert_allclose(ys_t[:, 0].numpy(), np.exp(1j * W * T5),
                               rtol=1e-6)


def test_complex_gradient():
    """|y(1)|^2 of a rotation is |y0|^2: the gradient is 2 y0 in torch's
    convention, its conjugate in JAX's (the same, y0 being real here)."""
    t = np.linspace(0.0, 1.0, 3)
    y0 = np.array([1.0 + 0.0j])

    def loss_j(y):
        ys = tde.odeint(rot, y, jnp.asarray(t), rtol=1e-10, atol=1e-12)
        return jnp.sum(jnp.abs(ys[-1]) ** 2)

    g_j = jax.grad(loss_j)(jnp.asarray(y0))
    y = _c(y0).requires_grad_()
    ys = tt.odeint(rot, y, _r(t), rtol=1e-10, atol=1e-12)
    (ys[-1].abs() ** 2).sum().backward()
    _grad_close(y.grad, g_j)
    np.testing.assert_allclose(y.grad.numpy(), [2.0 + 0j], atol=1e-6)


def test_complex_event():
    """The first zero of Re y: pi/4 for the rotation at W=2; the event time
    is real."""
    kw = dict(rtol=1e-10, atol=1e-10)
    et_j, ys_j = tde.odeint_event(rot, jnp.asarray([1.0 + 0j]),
                                  jnp.array(0.0),
                                  event_fn=lambda t, y: jnp.real(y[0]), **kw)
    et_t, ys_t = tt.odeint_event(rot, _c([1.0 + 0j]), 0.0,
                                 event_fn=lambda t, y: y[0].real, **kw)
    assert et_t.dtype == torch.float64
    assert abs(float(et_t) - float(et_j)) <= kw['atol']
    assert abs(float(et_t) - np.pi / 4) < 1e-7
    _close(ys_t, ys_j, 1e-9)


# ---- tests/test_dtypes.py:77-99: the implicit tiers --------------------------

@pytest.mark.parametrize('method', ['implicit_euler', 'trapezoid', 'sdirk2',
                                    'gl4', 'kvaerno3'])
def test_complex_state_implicit_methods(method):
    """y' = i y on the stacked real view of each stage system: values,
    counters and the gradient of |y(1)|^2 (2 Re y0 to the method's order;
    backward Euler dissipates)."""
    f = lambda t, y: 1j * y
    t = np.linspace(0.0, 1.0, 3)
    kw = ({} if method == 'kvaerno3' else dict(options=dict(num_steps=64)))
    y0 = np.array([1.0 + 0.0j])
    ys_t, _ = _pair(method, y0=y0, t=t, f_j=f, f_t=f, rel=1e-10, **kw)
    assert abs(complex(ys_t[-1, 0]) - np.exp(1j)) < 1e-2

    g_j = jax.grad(lambda y: jnp.sum(jnp.abs(tde.odeint(
        f, y, jnp.asarray(t), method=method, **kw)[-1]) ** 2))(
        jnp.asarray(y0))
    y = _c(y0).requires_grad_()
    (tt.odeint(f, y, _r(t), method=method, **kw)[-1].abs() ** 2).sum() \
        .backward()
    _grad_close(y.grad, g_j)
    tol = 5e-2 if method == 'implicit_euler' else 1e-2
    assert abs(complex(y.grad[0]) - 2.0) < tol


# ---- tests/test_tree_fixed.py:109 and tests/test_compat_matrix.py:138 -----

def test_complex_state_fixed_grid():
    t = np.linspace(0.0, 2.0, 5)
    f = lambda t, y: 1j * y
    ys_t, _ = _pair('rk4', y0=np.array([1.0 + 0j]), t=t, f_j=f, f_t=f,
                    options=dict(step_size=0.01))
    assert abs(complex(ys_t[-1, 0]) - np.exp(2j)) < 1e-8


def test_interpolated_complex_state_works():
    """The interpolated adjoint's gradient of sum |y(1)|^2 against JAX's
    interpolated adjoint, and against the port's default adjoint to the
    compat matrix's 1e-4."""
    y0 = np.array([1.0 + 0.5j, 0.5 - 0.25j])
    f = lambda t, y: 1j * y
    interp = dict(adjoint_options=dict(interpolated=True))
    g_j = jax.grad(lambda y: jnp.sum(jnp.abs(tde.odeint_adjoint(
        f, y, jnp.asarray(T5), **interp)[-1]) ** 2))(jnp.asarray(y0))

    def port(**kw):
        y = _c(y0).requires_grad_()
        (tt.odeint_adjoint(f, y, _r(T5), **kw)[-1].abs() ** 2).sum() \
            .backward()
        return y.grad

    g_t = port(**interp)
    _grad_close(g_t, g_j)
    np.testing.assert_allclose(g_t.numpy(), port().numpy(), rtol=1e-4)


# ---- every tier: values and counters ----------------------------------------

@pytest.mark.parametrize('method', ['dopri5', 'dopri8', 'tsit5', 'bosh3',
                                    'fehlberg2', 'adaptive_heun'])
def test_explicit_adaptive_methods(method):
    kw = dict(rtol=1e-6, atol=1e-8) if method in ('fehlberg2',
                                                 'adaptive_heun') else {}
    _pair(method, f_j=j_field, f_t=t_field, args=(OM,), **kw)


@pytest.mark.parametrize('method,options', [
    ('euler', dict(step_size=0.1)), ('midpoint', dict(num_steps=12)),
    ('heun3', dict(num_steps=12, interp='cubic')),
    ('rk4', dict(num_steps=12, perturb=True)),
    ('explicit_adams', dict(step_size=0.05)),
    ('implicit_adams', dict(step_size=0.05)),
])
def test_fixed_grid_and_adams(method, options):
    _pair(method, f_j=j_field, f_t=t_field, args=(OM,), options=options)


@pytest.mark.parametrize('method,options', [
    ('kvaerno5', None), ('radau5a', None),
    ('trbdf2', dict(num_steps=10, root_solver='newton')),
    ('radauIIA5', dict(num_steps=10)),
])
def test_stiff_and_implicit_tiers(method, options):
    _pair(method, f_j=j_field, f_t=t_field, args=(OM,), rel=1e-10,
          options=options)


def test_reversed_time():
    _pair(t=T5[::-1].copy(), f_j=j_field, f_t=t_field, args=(OM,))


def test_tuple_state_one_complex_one_real_leaf():
    """A complex leaf beside a real one: the flat state is complex, the real
    leaf comes back real, as JAX's unravel casts it."""
    def f(t, y):
        a, b = y
        return 1j * a * b[0], -0.5 * b

    y0 = (Y0, np.array([1.0]))
    ys_j, st_j = tde.odeint_with_stats(f, tuple(jnp.asarray(v) for v in y0),
                                       jnp.asarray(T5))
    ys_t, st_t = tt.odeint_with_stats(f, (_c(y0[0]), _r(y0[1])), _r(T5))
    assert [x.dtype for x in ys_t] == [torch.complex128, torch.float64]
    for a, b in zip(ys_t, ys_j):
        _close(a, b, 1e-12)
    assert counters(st_t) == counters(st_j)


@pytest.mark.parametrize('method,options,rel', [
    ('dopri5', None, 4e-7), ('kvaerno5', None, 4e-5),
    ('gl4', dict(num_steps=10), 4e-7), ('rk4', dict(num_steps=10), 4e-7)])
def test_complex64(method, options, rel):
    """complex64 state, float32 time dtype in the steps: counters exactly,
    values within a few complex64 units of the last place (C16; Newton's
    float32 linear solves add a few more on the stiff tier)."""
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method=method, rtol=1e-5, atol=1e-7, options=options)
    ys_j, st_j = tde.odeint_with_stats(rot, jnp.asarray(Y0, jnp.complex64),
                                       jnp.asarray(t), **kw)
    ys_t, st_t = tt.odeint_with_stats(rot, _c(Y0, torch.complex64), _r(t),
                                      **kw)
    assert ys_t.dtype == torch.complex64
    _close(ys_t, ys_j, rel)
    assert counters(st_t) == counters(st_j)


def test_dense_output():
    """odeint_dense: values and derivatives at real query times."""
    sol_j = tde.odeint_dense(j_field, jnp.asarray(Y0), 0.0, 2.0,
                             args=(jnp.asarray(OM),))
    sol_t = tt.odeint_dense(t_field, _c(Y0), 0.0, 2.0, args=(_r(OM),))
    q = np.array([0.3, 1.1, 1.9])
    _close(sol_t(_r(q)), sol_j(jnp.asarray(q)), 1e-12)
    _close(sol_t.derivative(0.7), sol_j.derivative(0.7), 1e-12)


# ---- events ------------------------------------------------------------------

@pytest.mark.parametrize('method,options', [
    ('dopri5', None), ('kvaerno5', None), ('rk4', dict(step_size=0.01)),
    ('gl4', dict(step_size=0.05)), ('implicit_adams', dict(step_size=0.05))])
def test_event_solves(method, options):
    """A real event function on the complex state, the event time real:
    within the bisection's tolerance (atol) of JAX's, the state at it
    within the field's speed times that."""
    f = lambda t, y: 1j * 2.0 * y - 0.1 * y
    kw = dict(method=method, options=options, rtol=1e-10, atol=1e-10)
    et_j, ys_j = tde.odeint_event(f, jnp.asarray(Y0), jnp.array(0.0),
                                  event_fn=lambda t, y: jnp.real(y[0]) - 0.1,
                                  **kw)
    et_t, ys_t = tt.odeint_event(f, _c(Y0), 0.0,
                                 event_fn=lambda t, y: y[0].real - 0.1, **kw)
    assert et_t.dtype == torch.float64
    assert abs(float(et_t) - float(et_j)) <= 1e-10
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=3e-10)


def test_chained_event_solve():
    """A second event solve from the first's event time (reference
    `odeint_event` chaining): both times as JAX's, and the gradient of the
    second time with respect to y0 against central differences of the
    port's own solves."""
    f = lambda t, y: 1j * 2.0 * y - 0.1 * y
    kw = dict(rtol=1e-10, atol=1e-12)

    def chain_j(y0):
        e1, s1 = tde.odeint_event(f, y0, jnp.array(0.0),
                                  event_fn=lambda t, y: jnp.real(y[0]), **kw)
        return tde.odeint_event(f, s1[-1], e1,
                                event_fn=lambda t, y: jnp.imag(y[0]), **kw)[0]

    def chain_t(y0):
        e1, s1 = tt.odeint_event(f, y0, 0.0,
                                 event_fn=lambda t, y: y[0].real, **kw)
        return tt.odeint_event(f, s1[-1], e1,
                               event_fn=lambda t, y: y[0].imag, **kw)[0]

    y = _c(Y0).requires_grad_()
    e2 = chain_t(y)
    assert abs(float(e2) - float(chain_j(jnp.asarray(Y0)))) <= 1e-11
    e2.backward()
    eps, fd = 1e-6, []
    for d in (1.0, 1.0j):
        step = np.array([d * eps, 0.0])
        with torch.no_grad():
            fd.append((float(chain_t(_c(Y0 + step)))
                       - float(chain_t(_c(Y0 - step)))) / (2 * eps))
    # torch's gradient: dL/dx + i dL/dy
    assert abs(complex(y.grad[0]) - (fd[0] + 1j * fd[1])) < 1e-5


def test_event_gradient_matches_finite_differences():
    """ROADMAP C14: the implicit-function reroute of `odeint_event` needs
    the real inner products Re sum(conj(g) f) of the complex cotangents.
    JAX's forms sum(g f) and divides in complex arithmetic
    (torchdiffeq_tpu/events.py:66-132), so its gradient of t* + |y(t*)|^2
    in the first component departs from central differences; the port's
    matches them (to 1e-6, the differences' own error)."""
    f = lambda t, y: 1j * 2.0 * y - 0.1 * y
    kw = dict(rtol=1e-10, atol=1e-12)

    def loss_j(y0):
        et, ys = tde.odeint_event(f, y0, jnp.array(0.0),
                                  event_fn=lambda t, y: jnp.real(y[0]) - 0.1,
                                  **kw)
        return et + jnp.sum(jnp.abs(ys[-1]) ** 2)

    def loss_t(y0):
        et, ys = tt.odeint_event(f, y0, 0.0,
                                 event_fn=lambda t, y: y[0].real - 0.1, **kw)
        return et + (ys[-1].abs() ** 2).sum()

    eps, fd = 1e-6, np.zeros(2, complex)
    for k in range(2):
        for d in (1.0, 1.0j):
            step = np.zeros(2, complex)
            step[k] = d * eps
            with torch.no_grad():
                diff = (float(loss_t(_c(Y0 + step)))
                        - float(loss_t(_c(Y0 - step)))) / (2 * eps)
            fd[k] += diff * (1.0 if d == 1.0 else 1j)
    y = _c(Y0).requires_grad_()
    loss_t(y).backward()
    np.testing.assert_allclose(y.grad.numpy(), fd, atol=1e-6)
    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(Y0)))
    # JAX's departs in the first component (its event's own), by far more
    # than the differences' error; the second, which the event does not
    # read, agrees
    assert abs(g_j[0] - np.conj(fd[0])) > 0.1
    assert abs(g_j[1] - np.conj(fd[1])) < 1e-6


def test_event_function_of_time():
    """ROADMAP C15: JAX's adjoint casts the time it hands a closure-
    converted event function to the state dtype (torchdiffeq_tpu/
    adjoint.py:258-260), so an event of Re y - 0.1 t on a complex state
    raises TypeError there; the port hands it the real time and finds the
    root of the closed form y(t) = y0 exp((2i - 0.1) t)."""
    f = lambda t, y: (2j - 0.1) * y
    with pytest.raises(TypeError):
        tde.odeint_event(f, jnp.asarray(Y0), jnp.array(0.0),
                         event_fn=lambda t, y: jnp.real(y[0]) - 0.1 * t)
    et, _ = tt.odeint_event(f, _c(Y0), 0.0,
                            event_fn=lambda t, y: y[0].real - 0.1 * t,
                            rtol=1e-10, atol=1e-12)
    exact = scipy.optimize.brentq(
        lambda s: (Y0[0] * np.exp((2j - 0.1) * s)).real - 0.1 * s, 0.0, 1.0,
        xtol=1e-14)
    assert abs(float(et) - exact) < 1e-9


# ---- the continuous adjoint ----------------------------------------------------

def _loss_j(ys):
    return jnp.sum(jnp.abs(ys[-1]) ** 2) + jnp.sum(jnp.real(ys[1] * ys[2]))


def _loss_t(ys):
    return (ys[-1].abs() ** 2).sum() + (ys[1] * ys[2]).real.sum()


@pytest.fixture
def bwd_stats(monkeypatch):
    """The backward solves' Stats of both packages: (jax list, port
    list)."""
    got = ([], [])
    for i, mod in enumerate((jadj, tadj)):
        raw = mod._raw_odeint

        def wrapped(*a, _raw=raw, _out=got[i], **k):
            ys, st = _raw(*a, **k)
            _out.append(counters(st))
            return ys, st
        monkeypatch.setattr(mod, '_raw_odeint', wrapped)
    return got


def _adjoint_grads(solver_j, solver_t, t=np.linspace(0.0, 1.0, 4), **kw):
    """Gradients of the loss in y0, the parameters and the output times."""
    g_j = jax.grad(lambda y, w, tt_: _loss_j(solver_j(
        j_field, y, tt_, args=(w,), **kw)), argnums=(0, 1, 2))(
        jnp.asarray(Y0), jnp.asarray(OM), jnp.asarray(t))
    y, w, tt_ = _c(Y0).requires_grad_(), _r(OM).requires_grad_(), \
        _r(t).requires_grad_()
    _loss_t(solver_t(t_field, y, tt_, args=(w,), **kw)).backward()
    _grad_close(y.grad, g_j[0])
    _grad_close(w.grad, g_j[1], conj=False)
    _grad_close(tt_.grad, g_j[2], conj=False)


@pytest.mark.parametrize('adjoint_options', [
    None, dict(norm='seminorm'), dict(noise_floor=True),
    dict(interpolated=True)])
def test_adjoint_modes(adjoint_options, bwd_stats):
    """Gradients in y0, the field's real parameters and the output times
    (the time gradient the real part of sum(conj(g) f), misc.time_effect)
    and every backward solve's counters."""
    _adjoint_grads(tde.odeint_adjoint, tt.odeint_adjoint, rtol=1e-9,
                   atol=1e-11, adjoint_options=adjoint_options)
    assert bwd_stats[1] == bwd_stats[0] and bwd_stats[0]


def test_adjoint_interval_fallback_and_stiff_backward():
    """The interval-by-interval sweep (an adjoint `first_step`, which turns
    the fused sweep's warm starts off) with kvaerno5 forward and backward
    (JAX runs that sweep inside a scan, whose Stats the fixture cannot
    read: the gradients alone)."""
    _adjoint_grads(tde.odeint_adjoint, tt.odeint_adjoint, method='kvaerno5',
                   adjoint_options=dict(first_step=0.05))


@pytest.mark.parametrize('method,options', [
    ('dopri5', None), ('rk4', dict(num_steps=20)),
    ('sdirk2', dict(num_steps=16)), ('implicit_adams', dict(num_steps=20))])
def test_backprop_through_the_loop(method, options):
    """plain `odeint` under autograd: the continuous adjoint for dopri5,
    backprop through the fixed-grid, FIRK/DIRK (implicit-function) and
    Adams loops for the others."""
    _adjoint_grads(tde.odeint, tt.odeint, method=method, options=options)


# ---- the other gradient modes and the SciPy bridge ---------------------------

@pytest.mark.parametrize('event', [False, True])
def test_replay_grad(event):
    """`replay_grad`: autograd through the replayed steps (with an event,
    the replay's event-time derivative, which needs no reroute)."""
    if not event:
        _adjoint_grads(tde.odeint, tt.odeint,
                       options=dict(replay_grad=True))
        return
    kw = dict(options=dict(replay_grad=True))

    def loss_j(y, w):
        et, ys = tde.odeint_event(j_field, y, jnp.array(0.0), args=(w,),
                                  event_fn=lambda t, y: jnp.real(y[0]) - 0.2,
                                  **kw)
        return et + jnp.sum(jnp.abs(ys[-1]) ** 2)

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(Y0), jnp.asarray(OM))
    y, w = _c(Y0).requires_grad_(), _r(OM).requires_grad_()
    et, ys = tt.odeint_event(t_field, y, 0.0, args=(w,),
                             event_fn=lambda t, y: y[0].real - 0.2, **kw)
    (et + (ys[-1].abs() ** 2).sum()).backward()
    _grad_close(y.grad, g_j[0])
    _grad_close(w.grad, g_j[1], conj=False)


@pytest.mark.parametrize('method,options', [
    ('dopri5', None), ('kvaerno5', None),
    ('implicit_adams', dict(num_steps=8))])
def test_forward_grad(method, options):
    """`forward_grad`: `torch.func.jvp` against `jax.jvp`, a complex tangent
    of y0 (a holomorphic-free field: jvp is the real derivative in both)."""
    t = np.linspace(0.0, 1.0, 3)
    v = np.array([0.3 + 0.1j, -0.2j])
    opts = dict(forward_grad=True, **(options or {}))
    _, tan_j = jax.jvp(lambda y: tde.odeint(
        j_field, y, jnp.asarray(t), args=(jnp.asarray(OM),), method=method,
        options=opts), (jnp.asarray(Y0),), (jnp.asarray(v),))
    _, tan_t = torch.func.jvp(lambda y: tt.odeint(
        t_field, y, _r(t), args=(_r(OM),), method=method, options=opts),
        (_c(Y0),), (_c(v),))
    _close(tan_t, tan_j, GRAD_TOL)


def test_forward_grad_firk_where_jax_raises():
    """ROADMAP C17, not complex-specific: JAX's FIRK/DIRK stage solve is a
    custom_vjp, so forward mode through it raises TypeError for any state
    (torchdiffeq_tpu/solvers/fixed_grid_implicit.py:130); the port has
    given the implicit-function tangent for real states since PR 9 and
    gives it for complex ones too: it equals central differences of its
    own solves."""
    t = np.linspace(0.0, 1.0, 3)
    opts = dict(forward_grad=True, num_steps=8)
    with pytest.raises(TypeError):
        jax.jvp(lambda y: tde.odeint(j_field, y, jnp.asarray(t),
                                     args=(jnp.asarray(OM),), method='gl4',
                                     options=opts),
                (jnp.asarray(Y0),), (jnp.ones(2, jnp.complex128),))
    solve = lambda y: tt.odeint(t_field, y, _r(t), args=(_r(OM),),
                                method='gl4', options=opts)
    v = _c([0.3 + 0.1j, -0.2j])
    _, tan = torch.func.jvp(solve, (_c(Y0),), (v,))
    eps = 1e-6
    fd = (solve(_c(Y0) + eps * v) - solve(_c(Y0) - eps * v)) / (2 * eps)
    _close(tan, fd, 1e-7)


def test_scipy_solver_discards_the_imaginary_part_as_jax_does():
    """The SciPy bridge integrates a float64 copy of the state in both
    packages, which drops the imaginary part with a warning (JAX
    solvers/scipy_wrapper.py); the port does the same, so the values
    agree."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        ys_j = tde.odeint(rot, jnp.asarray(Y0), jnp.asarray(T5),
                          method='scipy_solver', options=dict(solver='RK45'))
        n_jax = len(caught)
        ys_t = tt.odeint(rot, _c(Y0), _r(T5), method='scipy_solver',
                         options=dict(solver='RK45'))
    assert n_jax > 0 and len(caught) > n_jax
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_j))


# ---- the per-sample driver -----------------------------------------------------

B = 5
YB = (np.random.RandomState(0).randn(B, 2)
      + 1j * np.random.RandomState(1).randn(B, 2)) * 0.6
WB = np.linspace(1.0, 3.0, B)


def j_sample(t, y, w):
    return 1j * w * y - 0.1 * y * y[0] - 0.05 * t * y


def t_sample(t, y, w):
    return 1j * w * y - 0.1 * y * y[0] - 0.05 * t * y


def _per_sample(t, **kw):
    out_j, st_j = jax.jit(lambda y, w: j_per_sample(
        j_sample, y, t, args=(w,), args_axes=(0,), **kw))(
        jnp.asarray(YB), jnp.asarray(WB))
    with torch.no_grad():
        out_t, st_t = tt.odeint_per_sample_with_stats(
            t_sample, _c(YB), _r(t), args=(_r(WB),), args_axes=(0,), **kw)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return out_j, out_t


@pytest.mark.parametrize('method,options,rel', [
    ('dopri5', None, 1e-12), ('dopri5', dict(pallas=True), 1e-12),
    ('kvaerno5', None, 1e-10), ('gl4', dict(num_steps=10), 1e-10),
    ('implicit_adams', dict(num_steps=10), 1e-12)])
def test_per_sample_driver(method, options, rel):
    """`odeint_per_sample` on the batched driver: every sample's values and
    counters; ``pallas=True`` takes the driver for a complex state, as JAX's
    vmap route does (its `_pallas_qualifies`, batched.py:70)."""
    out_j, out_t = _per_sample(np.linspace(0.0, 1.0, 4), method=method,
                               options=options)
    assert out_t.dtype == torch.complex128
    _close(out_t, out_j, rel)


@pytest.mark.parametrize('method', ['dopri5', 'kvaerno3'])
def test_per_sample_event(method):
    """Each sample's first zero of Re y[0] (every sample oscillates through
    it): counters exactly, the event times within the bisection's atol."""
    out_j, out_t = _per_sample(
        np.array([0.0, 3.0]), method=method, rtol=1e-9, atol=1e-11,
        event_fn=lambda t, y: (y[0].real if isinstance(y, torch.Tensor)
                               else jnp.real(y[0])))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize('method,options,event', [
    ('dopri5', None, False), ('kvaerno5', None, False),
    ('rk4', dict(num_steps=10), False), ('dopri5', dict(replay_grad=True),
                                         False),
    ('dopri5', None, True)])
def test_per_sample_gradients(method, options, event):
    """Each sample's own adjoint (or the loop's backprop, or the replay):
    gradients in y0, the per-sample parameter and the output times."""
    t = np.array([0.0, 3.0]) if event else np.linspace(0.0, 1.0, 3)
    kw = dict(method=method, options=options, rtol=1e-9, atol=1e-11)
    if event:
        kw['event_fn'] = lambda tt_, y: (
            y[0].real if isinstance(y, torch.Tensor) else jnp.real(y[0]))

    def loss(out, lib):
        if event:
            return lib.sum(out[0]) + lib.sum(abs(out[1][:, -1]) ** 2)
        return lib.sum(abs(out[:, -1]) ** 2) + lib.sum(
            (out[:, 1] * out[:, 2]).real)

    g_j = jax.grad(lambda y, w, tt_: loss(j_ps(
        j_sample, y, tt_, args=(w,), args_axes=(0,), **kw), jnp),
        argnums=(0, 1, 2))(jnp.asarray(YB), jnp.asarray(WB), jnp.asarray(t))
    y, w, tt_ = _c(YB).requires_grad_(), _r(WB).requires_grad_(), \
        _r(t).requires_grad_()
    loss(tt.odeint_per_sample(t_sample, y, tt_, args=(w,), args_axes=(0,),
                              **kw), torch).backward()
    _grad_close(y.grad, g_j[0])
    _grad_close(w.grad, g_j[1], conj=False)
    _grad_close(tt_.grad, g_j[2], conj=False)


# ---- ROADMAP C16 ---------------------------------------------------------------

def test_complex_arithmetic_rounds_otherwise_in_xla():
    """ROADMAP C16: XLA's complex128 |z| and product round otherwise than
    torch's in the last place on a share of inputs (so the two packages'
    values differ by a few units and an event time within the bisection's
    tolerance); never by more than a few units."""
    rng = np.random.RandomState(0)
    z = rng.randn(4096) + 1j * rng.randn(4096)
    w = rng.randn(4096) + 1j * rng.randn(4096)
    for j_val, t_val in ((jnp.abs(jnp.asarray(z)), _c(z).abs()),
                         (jnp.asarray(z) * jnp.asarray(w), _c(z) * _c(w))):
        j_val, t_val = np.asarray(j_val), t_val.numpy()
        assert np.mean(j_val != t_val) > 0.05
        np.testing.assert_allclose(t_val, j_val, rtol=4e-16, atol=0)
