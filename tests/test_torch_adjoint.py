"""The port's continuous adjoint against the JAX package's, on the same
numpy inputs (CPU, float64), mirroring the quick tier of
tests/test_gradients.py and the event gradients of tests/test_events.py.

Gradients in y0, t and the parameters agree to rtol=1e-9, atol=1e-11 (the
worst measured here: 8.5e-7 absolute, 2.9e-14 of the value, on a time
gradient of order 3e7; among differences above atol, 1.7e-11 of the
value, on a bias), and the forward and backward `Stats` counters exactly: both packages take the same
steps, in the forward solve and in every backward solve.  The backward
`Stats` of the JAX package are not returned by it; they are recorded by
wrapping its `_raw_odeint` (and the port's, the same way) for the length of
a test.

The JAX fields close over no arrays: parameters go through `args`, so both
packages' theta_bar holds the same tensors, and the default adjoint norm,
which takes the max over every one of them, is the same function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu.adjoint as jadj
import torchdiffeq_tpu_torch as tt
import torchdiffeq_tpu_torch.adjoint as tadj
from torchdiffeq_tpu_torch.models import mlp_params_from_jax

RTOL, ATOL = 1e-9, 1e-11


def _counters(st):
    return [int(st.nfe), int(st.n_steps), int(st.n_accepted),
            int(st.n_rejected), int(st.error_code)]


@pytest.fixture
def bwd_stats(monkeypatch):
    """The backward solves' Stats of both packages: (jax list, port list)."""
    got = ([], [])
    for i, mod in enumerate((jadj, tadj)):
        raw = mod._raw_odeint

        def wrapped(*a, _raw=raw, _out=got[i], **k):
            ys, st = _raw(*a, **k)
            _out.append(_counters(st))
            return ys, st
        monkeypatch.setattr(mod, '_raw_odeint', wrapped)
    return got


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


# ---- the four ODEs of tests/test_gradients.py::test_adjoint_vs_direct -------

_A = (lambda U: 2 * U - (U + U.T))(np.random.RandomState(0).randn(10, 10) * 0.1)


def _odes():
    """name -> (jax field, port field, args (numpy), y0 at t=1)."""
    t1 = 1.0
    return {
        'constant': (
            lambda t, y, a, b: a + (y - (a * t + b)) ** 5,
            lambda t, y, a, b: a + (y - (a * t + b)) ** 5,
            (np.array(0.2), np.array(3.0)), np.array([0.2 * t1 + 3.0])),
        'linear': (
            lambda t, y, A: A @ y, lambda t, y, A: A @ y, (_A,),
            scipy.linalg.expm(_A * t1) @ np.ones(10)),
        'sine': (
            lambda t, y: 2 * y / t + t ** 4 * jnp.sin(2 * t) - t ** 2
            + 4 * t ** 3,
            lambda t, y: 2 * y / t + t ** 4 * torch.sin(2 * t) - t ** 2
            + 4 * t ** 3,
            (), np.array([np.pi - 0.25 - 0.5 * np.cos(2.) + 0.5 * np.sin(2.)
                          + 0.25 * np.cos(2.) - 1 + 2])),
        'exp': (
            lambda t, y: -0.1 * jnp.exp(-0.1 * t) * jnp.ones_like(y),
            lambda t, y: -0.1 * torch.exp(-0.1 * t) * torch.ones_like(y),
            (), np.array([np.exp(-0.1)])),
    }


def _grads_jax(field, y0, t, args, loss, **kw):
    def f(y0_, t_, args_):
        return loss(tde.odeint_adjoint(field, y0_, t_, args=args_, **kw))
    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(y0), jnp.asarray(t),
                                       tuple(jnp.asarray(a) for a in args))
    return [np.asarray(g[0]), np.asarray(g[1])] + [np.asarray(x)
                                                  for x in g[2]]


def _grads_port(field, y0, t, args, loss, solver=None, **kw):
    y0_t = torch.tensor(y0, dtype=torch.float64, requires_grad=True)
    t_t = torch.tensor(t, dtype=torch.float64, requires_grad=True)
    args_t = tuple(torch.tensor(a, dtype=torch.float64, requires_grad=True)
                   for a in args)
    solver = solver or tt.odeint_adjoint
    loss(solver(field, y0_t, t_t, args=args_t, **kw)).backward()
    return [x.grad.numpy() for x in (y0_t, t_t, *args_t)]


@pytest.mark.parametrize('ode', ['constant', 'linear', 'sine', 'exp'])
@pytest.mark.parametrize('reverse', [False, True])
def test_adjoint_vs_direct(ode, reverse, bwd_stats):
    """tests/test_gradients.py's four ODEs on [1, 8], forward and reversed,
    loss sum(ys**2) at rtol=1e-9, atol=1e-12: the port's adjoint gradients
    in y0, t and the args against the JAX adjoint's, and the backward
    solves' counters."""
    f_j, f_t, args, y0 = _odes()[ode]
    t = np.linspace(1.0, 8.0, 10)
    if reverse:
        t = t[::-1].copy()
        with torch.no_grad():
            y0 = tt.odeint(f_t, torch.from_numpy(y0), torch.from_numpy(
                t[::-1].copy()), args=tuple(map(torch.tensor, args)),
                rtol=1e-9, atol=1e-12)[-1].numpy()
    kw = dict(rtol=1e-9, atol=1e-12)
    g_j = _grads_jax(f_j, y0, t, args, lambda ys: jnp.sum(ys ** 2), **kw)
    g_t = _grads_port(f_t, y0, t, args, lambda ys: torch.sum(ys ** 2), **kw)
    for name, a, b in zip(('y0', 't', 'args'), g_t, g_j):
        _close(a, b, name)
    assert bwd_stats[1] == bwd_stats[0] and len(bwd_stats[1]) == 1


def test_unused_params_zero_grad(bwd_stats):
    """A parameter the field does not use gets exactly zero gradient
    (tests/test_gradients.py:231)."""
    def f(t, y, used, unused):
        return y @ used
    args = (np.array([[-0.5]]), np.array([7.0, 8.0]))
    t = np.linspace(0.0, 1.0, 3)
    g_j = _grads_jax(f, np.ones(1), t, args, lambda ys: jnp.sum(ys[-1]))
    g_t = _grads_port(f, np.ones(1), t, args, lambda ys: torch.sum(ys[-1]))
    assert np.abs(g_t[2]).max() > 0
    np.testing.assert_array_equal(g_t[3], np.zeros(2))
    for a, b in zip(g_t, g_j):
        _close(a, b)
    assert bwd_stats[1] == bwd_stats[0]


class _Linear(torch.nn.Module):
    def __init__(self, A):
        super().__init__()
        self.A = torch.nn.Parameter(torch.tensor(A))

    def forward(self, t, y):
        return y @ self.A


def test_adjoint_params_and_args(bwd_stats):
    """The parameters: an nn.Module's, explicit `adjoint_params` for a
    closure, and `args` (nested in a dict) give the same gradients, equal
    to JAX's with the matrix in args; a closure tensor passed in none of
    those ways gets no gradient."""
    A = np.array([[-0.7, 0.2], [0.1, -0.3]])
    t = np.linspace(0.0, 2.0, 4)
    y0 = np.array([1.0, 0.5])
    kw = dict(rtol=1e-7, atol=1e-9)
    g_j = _grads_jax(lambda t_, y, A_: y @ A_, y0, t, (A,),
                     lambda ys: jnp.sum(ys[-1] ** 2), **kw)

    def run(**how):
        y0_t = torch.tensor(y0, requires_grad=True)
        ys = tt.odeint_adjoint(how.pop('func'), y0_t, torch.tensor(t), **how,
                               **kw)
        (ys[-1] ** 2).sum().backward()
        return y0_t.grad.numpy()

    module = _Linear(A)
    gy_m = run(func=module)
    A_t = torch.tensor(A, requires_grad=True)
    gy_c = run(func=lambda t_, y: y @ A_t, adjoint_params=(A_t,))
    A_a = torch.tensor(A, requires_grad=True)
    gy_a = run(func=lambda t_, y, p: y @ p['A'], args=({'A': A_a},))
    for gy, gA in ((gy_m, module.A.grad), (gy_c, A_t.grad),
                   (gy_a, A_a.grad)):
        _close(gy, g_j[0])
        _close(gA.numpy(), g_j[2])
    assert bwd_stats[1] == bwd_stats[0] * 3
    # captured, not passed: no gradient
    A_x = torch.tensor(A, requires_grad=True)
    y0_x = torch.tensor(y0, requires_grad=True)
    tt.odeint_adjoint(lambda t_, y: y @ A_x, y0_x, torch.tensor(t),
                      **kw)[-1].sum().backward()
    assert A_x.grad is None and y0_x.grad is not None


def test_adjoint_different_method(bwd_stats):
    """adjoint_method other than the forward method (tests/test_gradients
    .py:266), and the rule that it then needs adjoint_options when options
    are given."""
    f_j, f_t, args, y0 = _odes()['constant']
    t = np.linspace(1.0, 8.0, 3)
    kw = dict(rtol=1e-9, atol=1e-11, adjoint_method='bosh3',
              adjoint_rtol=1e-9, adjoint_atol=1e-11)
    g_j = _grads_jax(f_j, y0, t, args, lambda ys: jnp.sum(ys[-1]), **kw)
    g_t = _grads_port(f_t, y0, t, args, lambda ys: torch.sum(ys[-1]), **kw)
    for a, b in zip(g_t, g_j):
        _close(a, b)
    assert bwd_stats[1] == bwd_stats[0]
    with pytest.raises(ValueError, match="adjoint_options"):
        tt.odeint_adjoint(f_t, torch.tensor(y0), torch.tensor(t),
                          args=tuple(map(torch.tensor, args)),
                          adjoint_method='bosh3', options=dict(safety=0.8))


def test_second_forward_after_grad():
    """The solve is reusable after a backward pass, and plain odeint's
    gradient is the adjoint's (ROADMAP C4)."""
    f_j, f_t, args, y0 = _odes()['constant']
    t = torch.linspace(1.0, 8.0, 3, dtype=torch.float64)
    a_t = tuple(torch.tensor(a, requires_grad=True) for a in args)
    y0_t = torch.tensor(y0, requires_grad=True)
    tt.odeint(f_t, y0_t, t, args=a_t)[-1].sum().backward()
    g_plain = y0_t.grad.clone()
    y0_t.grad = None
    tt.odeint_adjoint(f_t, y0_t, t, args=a_t)[-1].sum().backward()
    torch.testing.assert_close(y0_t.grad, g_plain, rtol=0, atol=0)
    out1 = tt.odeint(f_t, y0_t, t, args=a_t)
    out2 = tt.odeint(f_t, y0_t, t, args=a_t)
    assert torch.equal(out1, out2)


def test_adjoint_max_num_steps_is_per_interval(bwd_stats):
    """A backward max_num_steps is a per-interval budget: the fused sweep
    scales it by T-1 (tests/test_gradients.py:372)."""
    t = np.linspace(0.0, 2.0, 10)
    f = lambda t_, y: -y
    kw = dict(adjoint_options=dict(max_num_steps=50))
    g_j = _grads_jax(f, np.ones(1), t, (), lambda ys: jnp.sum(ys[-1]), **kw)
    g_t = _grads_port(f, np.ones(1), t, (), lambda ys: torch.sum(ys[-1]),
                      **kw)
    np.testing.assert_allclose(g_t[0], np.exp(-2.0), rtol=1e-5)
    for a, b in zip(g_t, g_j):
        _close(a, b)
    assert bwd_stats[1] == bwd_stats[0]
    assert bwd_stats[1][0][4] == 0


# ---- the spiral MLP of bench.py at rtol 1e-7 / atol 1e-9 ------------------

SPIRAL_B, SPIRAL_H = 16, 32


def _spiral_params(seed=0):
    rng = np.random.RandomState(seed)
    params = [dict(w=rng.randn(2, SPIRAL_H) * 0.3, b=rng.randn(SPIRAL_H) * 0.1),
              dict(w=rng.randn(SPIRAL_H, 2) * 0.3, b=rng.randn(2) * 0.1)]
    return params, rng.randn(SPIRAL_B, 2), rng.randn(SPIRAL_B, 2)


def _spiral_field_jax(t, y, p):
    h = jnp.tanh((y ** 3) @ p[0]['w'] + p[0]['b'])
    return h @ p[1]['w'] + p[1]['b']


def _spiral_both(T, adjoint_options=None, solver='adjoint', t1=1.0):
    """The training step's gradients in both packages: (jax, port) lists of
    [y0, t, w1, b1, w2, b2] and the forward Stats of each."""
    params, y0, target = _spiral_params()
    t = np.linspace(0.0, t1, T)
    kw = dict(rtol=1e-7, atol=1e-9, method='dopri5')
    if adjoint_options is not None:
        kw['adjoint_options'] = adjoint_options[0]

    def loss_j(p, y0_, t_):
        ys = tde.odeint_adjoint(_spiral_field_jax, y0_, t_, args=(p,), **kw)
        return jnp.mean((ys - target[None]) ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    g = jax.grad(loss_j, argnums=(0, 1, 2))(jp, jnp.asarray(y0),
                                            jnp.asarray(t))
    g_j = [np.asarray(x) for x in (g[1], g[2], g[0][0]['w'], g[0][0]['b'],
                                    g[0][1]['w'], g[0][1]['b'])]
    _, st_j = tde.odeint_with_stats(_spiral_field_jax, jnp.asarray(y0),
                                    jnp.asarray(t), args=(jp,), rtol=1e-7,
                                    atol=1e-9)

    model = mlp_params_from_jax(params, power=3, device='cpu')
    y0_t = torch.tensor(y0, requires_grad=True)
    t_t = torch.tensor(t, requires_grad=True)
    if adjoint_options is not None:
        kw['adjoint_options'] = adjoint_options[1]
    if solver == 'adjoint':
        ys = tt.odeint_adjoint(model, y0_t, t_t, **kw)
        st_t = None
    else:
        ys, st_t = tt.odeint_with_stats(model, y0_t, t_t, rtol=1e-7,
                                        atol=1e-9)
    ((ys - torch.from_numpy(target)[None]) ** 2).mean().backward()
    g_t = [x.grad.numpy() for x in (y0_t, t_t, model.weights[0],
                                    model.biases[0], model.weights[1],
                                    model.biases[1])]
    if st_t is None:
        with torch.no_grad():
            _, st_t = tt.odeint_with_stats(model, y0_t, t_t, rtol=1e-7,
                                           atol=1e-9)
    return g_j, g_t, st_j, st_t


@pytest.mark.parametrize('T', [2, 10], ids=['fallback', 'fused'])
def test_spiral_gradients(T, bwd_stats):
    """The training step's gradients in y0, t and the four parameters; T=2
    runs the interval fallback, T=10 the fused sweep (one backward solve
    either way).  Forward and backward counters equal."""
    g_j, g_t, st_j, st_t = _spiral_both(T)
    for name, a, b in zip(('y0', 't', 'w1', 'b1', 'w2', 'b2'), g_t, g_j):
        _close(a, b, name)
    assert _counters(st_t) == _counters(st_j)
    assert bwd_stats[1] == bwd_stats[0] and len(bwd_stats[1]) == 1
    assert bwd_stats[1][0][1] > 0


def test_spiral_plain_odeint_takes_the_adjoint(bwd_stats):
    """Plain odeint under autograd: the adjoint with no backward options,
    as JAX's odeint (odeint.py:319-329)."""
    g_j, g_t, st_j, st_t = _spiral_both(10, solver='odeint')
    for a, b in zip(g_t, g_j):
        _close(a, b)
    assert _counters(st_t) == _counters(st_j)
    assert bwd_stats[1] == bwd_stats[0]


def _rms_j(x):
    return jnp.sqrt(jnp.mean(x ** 2))


@pytest.mark.parametrize('norm', ['default', 'seminorm', 'callable',
                                  'noise_floor'])
def test_spiral_adjoint_norms(norm, bwd_stats):
    """Every adjoint norm (JAX adjoint.py:64-118) and the noise_floor
    preset (:160-186; at float64 a floor of 1e-6 rather than the dtype's
    unit, so that it moves the backward rtol of 1e-7)."""
    opts = {
        'default': ({}, {}),
        'seminorm': (dict(norm='seminorm'), dict(norm='seminorm')),
        'callable': (
            dict(norm=lambda xs: jnp.max(jnp.stack([_rms_j(x) for x in xs]))),
            dict(norm=lambda xs: torch.stack(
                [x.pow(2).mean().sqrt() for x in xs]).max())),
        'noise_floor': (dict(noise_floor=1e-6), dict(noise_floor=1e-6)),
    }[norm]
    g_j, g_t, _, _ = _spiral_both(10, adjoint_options=opts)
    for a, b in zip(g_t, g_j):
        _close(a, b)
    assert bwd_stats[1] == bwd_stats[0]


def test_noise_floor_and_interpolated_options():
    """noise_floor=True floors at the state dtype's unit (a no-op for a
    float64 state at rtol 1e-7); interpolated=True, which this test once
    held to raising, solves (tests/test_torch_interpolated_adjoint.py holds
    it against JAX): exp(-1) for y' = -y."""
    assert tadj._noise_floor(True, (torch.ones(1),), 1e-7, 1e-9) == \
        (max(1e-7, 2 ** -24), 1e-9 * max(1e-7, 2 ** -24) / 1e-7)
    assert tadj._noise_floor(True, (torch.ones(1, dtype=torch.float64),),
                             1e-7, 1e-9) == (1e-7, 1e-9)
    y0 = torch.ones(1, dtype=torch.float64, requires_grad=True)
    tt.odeint_adjoint(lambda t, y: -y, y0,
                      torch.tensor([0.0, 1.0], dtype=torch.float64),
                      adjoint_options=dict(interpolated=True,
                                           noise_floor=True))[-1].sum() \
        .backward()
    np.testing.assert_allclose(float(y0.grad), np.exp(-1.0), rtol=1e-6)


# ---- tuple state --------------------------------------------------------------

def test_tuple_state_gradients(bwd_stats):
    """A tuple state (x, v) of a damped oscillator with a parameter in
    args, fused sweep: gradients of both leaves and the parameter, the
    default adjoint norm taking the mixed norm over the leaves."""
    def f_j(t, y, k):
        x, v = y
        return (v, -k * x - 0.1 * v)

    def f_t(t, y, k):
        x, v = y
        return (v, -k * x - 0.1 * v)

    x0, v0 = np.array([1.0, 0.3]), np.array([0.0, 0.5])
    k = np.array(2.0)
    t = np.linspace(0.0, 2.0, 5)

    def loss_j(x, v, k_):
        xs, vs = tde.odeint_adjoint(f_j, (x, v), jnp.asarray(t), args=(k_,))
        return jnp.sum(xs ** 2) + jnp.sum(vs[-1])

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(x0),
                                              jnp.asarray(v0), jnp.asarray(k))
    xt, vt_, kt = (torch.tensor(a, requires_grad=True) for a in (x0, v0, k))
    xs, vs = tt.odeint_adjoint(f_t, (xt, vt_), torch.tensor(t), args=(kt,))
    (torch.sum(xs ** 2) + torch.sum(vs[-1])).backward()
    for a, b in zip((xt.grad, vt_.grad, kt.grad), g_j):
        _close(a.numpy(), b)
    assert bwd_stats[1] == bwd_stats[0]


# ---- odeint_event (tests/test_events.py:75-133) --------------------------------

@pytest.mark.parametrize('interface', ['odeint', 'odeint_adjoint'])
def test_event_time_gradient_ift(interface):
    """d(event_t)/dy0 through the IFT reroute: for dy/dt = -y and y == 0.5,
    t* = ln(y0 / 0.5), dt*/dy0 = 1/y0; with odeint_adjoint as the
    interface, the state's gradient adds in (tests/test_events.py:75-133)."""
    f = lambda t, y: -y
    ev = lambda t, y: y[0] - 0.5
    kw = dict(event_fn=ev, rtol=1e-10, atol=1e-12)
    y0 = torch.tensor([1.3], dtype=torch.float64, requires_grad=True)
    if interface == 'odeint':
        et, sol = tt.odeint_event(f, y0, 0.0, **kw)
        et.backward()
        np.testing.assert_allclose(float(y0.grad), 1 / 1.3, rtol=1e-6)
        y0.grad = None
        et, sol = tt.odeint_event(f, y0, 0.0, **kw)
        sol.sum().backward()
        np.testing.assert_allclose(float(y0.grad), 1.0, atol=1e-5)
    else:
        et, sol = tt.odeint_event(f, y0, 0.0,
                                  odeint_interface=tt.odeint_adjoint, **kw)
        (et + sol[-1].sum()).backward()
        np.testing.assert_allclose(float(y0.grad), 1 / 1.3, rtol=1e-5)


@pytest.mark.parametrize('reverse_time', [False, True])
def test_event_gradients_match_jax(reverse_time, bwd_stats):
    """odeint_event on the spiral field, a loss on the event time and the
    event state: gradients in y0 and the parameters equal JAX's, and the
    forward event solve's and the backward solve's counters."""
    params, y0, _ = _spiral_params(1)
    y0 = y0[:1].reshape(2) * 0.5
    thr = float(y0[0]) + (-0.05 if reverse_time else 0.05)
    kw = dict(rtol=1e-9, atol=1e-11, reverse_time=reverse_time)

    def field_j(t, y, p):
        return _spiral_field_jax(t, y[None], p)[0] + jnp.array([0.3, 0.0])

    def loss_j(p, y0_):
        et, sol = tde.odeint_event(field_j, y0_, jnp.asarray(0.0),
                                   event_fn=lambda t, y: y[0] - thr,
                                   args=(p,), **kw)
        return et + jnp.sum(sol[-1] ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    g = jax.grad(loss_j, argnums=(0, 1))(jp, jnp.asarray(y0))
    g_j = [np.asarray(x) for x in (g[1], g[0][0]['w'], g[0][0]['b'],
                                    g[0][1]['w'], g[0][1]['b'])]
    model = mlp_params_from_jax(params, power=3, device='cpu')
    push = torch.tensor([0.3, 0.0], dtype=torch.float64)
    y0_t = torch.tensor(y0, requires_grad=True)
    et, sol = tt.odeint_event(lambda t, y: model(t, y[None])[0] + push, y0_t,
                              0.0, event_fn=lambda t, y: y[0] - thr,
                              adjoint_params=tuple(model.parameters()),
                              odeint_interface=tt.odeint_adjoint, **kw)
    (et + (sol[-1] ** 2).sum()).backward()
    g_t = [x.grad.numpy() for x in (y0_t, model.weights[0], model.biases[0],
                                    model.weights[1], model.biases[1])]
    for name, a, b in zip(('y0', 'w1', 'b1', 'w2', 'b2'), g_t, g_j):
        _close(a, b, name)
    assert bwd_stats[1] == bwd_stats[0] and len(bwd_stats[1]) == 1
