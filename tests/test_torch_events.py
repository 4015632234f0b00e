"""The port's event solves and dense output against the JAX package: the
same problems, with numbers from a numpy seed, through `odeint_event`,
`odeint(event_fn=...)`, `find_event`, the IFT reroute, `odeint_dense` and
the per-sample event route.  JAX runs on the CPU with x64, as conftest.py
pins it.

float64 unless stated: both packages take the same steps, so the `Stats`
counters are exactly equal, and event times agree to 1e-12.  The step
sizes differ in their last bits (the embedded error estimate is a
near-cancelling sum, which XLA and PyTorch round differently: one dopri5
step of exp(-t) at rtol=1e-7 already moves the next step by 2e-12
relative), so the step boundaries drift apart slowly over a solve; the bisection,
which halves the bracketing step down to its tolerance (`atol`), then
lands on different dyadic points of the two brackets.  So the event solves
here run at atol <= 1e-12 and over spans of tens, not thousands, of steps,
where both land within 1e-12 of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
from torchdiffeq_tpu import events as jev
from torchdiffeq_tpu.models import spiral_field
from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch import events as tev
from torchdiffeq_tpu_torch.models import LinearEvent, mlp_params_from_jax
from torchdiffeq_tpu_torch.ops import kernels
from torchdiffeq_tpu_torch.solvers.solution import ERR_MAX_NUM_STEPS

ADAPTIVE = ['dopri5', 'dopri8', 'tsit5', 'tsit5_le', 'bosh3', 'fehlberg2',
            'adaptive_heun']


def j_circle(t, y):
    return jnp.stack([y[1], -y[0]])


def t_circle(t, y):
    return torch.stack([y[1], -y[0]])


def _counters(st):
    return [int(x) for x in st[:5]]


def _spiral(seed, B=4, H=8, scale=0.5):
    rng = np.random.RandomState(seed)
    params = [dict(w=rng.randn(2, H) * scale, b=rng.randn(H) * 0.1),
              dict(w=rng.randn(H, 2) * scale, b=rng.randn(2) * 0.1)]
    return params, rng.randn(B, 2)


# ---- odeint_event / odeint(event_fn=...) ----------------------------------

@pytest.mark.parametrize("method", ADAPTIVE)
def test_event_solve_matches_jax(method):
    """y = (sin t, cos t) from t0 = 2.6; the event sin t = 0 fires at pi.
    `odeint_with_stats(event_fn=...)` gives JAX's counters exactly and its
    event time to 1e-12; `odeint_event` the same time and solution."""
    y0 = np.array([np.sin(2.6), np.cos(2.6)])
    t = np.array([2.6, 3.6])
    kw = dict(method=method, rtol=1e-8, atol=1e-13)
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        j_circle, jnp.asarray(y0), jnp.asarray(t),
        event_fn=lambda t_, y: y[0], **kw)
    with torch.no_grad():
        (et_t, ys_t), st_t = tt.odeint_with_stats(
            t_circle, torch.from_numpy(y0), torch.from_numpy(t),
            event_fn=lambda t_, y: y[0], **kw)
    assert _counters(st_t) == _counters(st_j)
    assert st_t.n_steps > 1
    assert et_t.dtype == torch.float64 and et_t.shape == ()
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    assert abs(float(et_t) - np.pi) < 2e-4
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)

    ev_j, sol_j = tde.odeint_event(j_circle, jnp.asarray(y0),
                                   jnp.asarray(2.6), event_fn=lambda t_, y: y[0],
                                   **kw)
    ev_t, sol_t = tt.odeint_event(t_circle, torch.from_numpy(y0), 2.6,
                                  event_fn=lambda t_, y: y[0], **kw)
    assert abs(float(ev_t) - float(ev_j)) <= 1e-12
    np.testing.assert_allclose(sol_t.numpy(), np.asarray(sol_j), rtol=0,
                               atol=1e-12)


def test_event_solve_mlp_field_matches_jax():
    """The spiral field on a (B, 2) state with a threshold event on a batch
    statistic and a time cut-off (the shape of chip_smoke.py's phase 7)."""
    params, y0 = _spiral(0)
    thr = float(np.mean(y0[:, 0])) - 0.05
    kw = dict(method='dopri5', rtol=1e-7, atol=1e-13)
    j_ev = lambda t, y: jnp.stack([jnp.mean(y[:, 0]) - thr, t - 0.8])
    t_ev = lambda t, y: torch.stack([y[:, 0].mean() - thr, t - 0.8])
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        lambda t, y, p: spiral_field(p, t, y), jnp.asarray(y0),
        jnp.asarray([0.0, 1.0]), args=(params,), event_fn=j_ev, **kw)
    model = mlp_params_from_jax(params, power=3,
                                device='cpu').requires_grad_(False)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        model, torch.from_numpy(y0), torch.tensor([0.0, 1.0]),
        event_fn=t_ev, **kw)
    assert _counters(st_t) == _counters(st_j)
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    assert 0.0 < float(et_t) < 0.8    # the state threshold fires first
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)


def test_event_reverse_time_matches_jax():
    """dy/dt = -y backwards from t0 = 0 reaches y = 2 at t = -ln 2."""
    f_j, f_t = (lambda t, y: -y), (lambda t, y: -y)
    kw = dict(reverse_time=True, rtol=1e-10, atol=1e-12)
    ev_j, sol_j = tde.odeint_event(f_j, jnp.array([1.0]), jnp.array(0.0),
                                   event_fn=lambda t, y: y[0] - 2.0, **kw)
    ev_t, sol_t = tt.odeint_event(f_t, torch.tensor([1.0], dtype=torch.float64),
                                  0.0, event_fn=lambda t, y: y[0] - 2.0, **kw)
    assert abs(float(ev_t) - float(ev_j)) <= 1e-12
    assert abs(float(ev_t) + np.log(2.0)) < 1e-6
    np.testing.assert_allclose(sol_t.numpy(), np.asarray(sol_j), rtol=0,
                               atol=1e-12)


def test_event_time_dependent_reverse_time_matches_jax():
    """A time-dependent event in reversed time sees the user's (negated)
    time, and its counters match JAX's."""
    kw = dict(rtol=1e-9, atol=1e-13)
    y0 = np.array([np.sin(2.0), np.cos(2.0)])
    (et_j, _), st_j = tde.odeint_with_stats(
        j_circle, jnp.asarray(y0), jnp.asarray([2.0, 1.0]),
        event_fn=lambda t, y: y[1] + t - 1.5, **kw)
    (et_t, _), st_t = tt.odeint_with_stats(
        t_circle, torch.from_numpy(y0), torch.tensor([2.0, 1.0]),
        event_fn=lambda t, y: y[1] + t - 1.5, **kw)
    assert _counters(st_t) == _counters(st_j)
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    assert float(et_t) < 2.0


def test_multi_output_event_matches_jax():
    """Outputs are sign-normalised and min-combined: y == 1 fires first."""
    ev_j = lambda t, y: jnp.stack([y[0] - 1.0, y[0] - 3.0])
    ev_t = lambda t, y: torch.stack([y[0] - 1.0, y[0] - 3.0])
    kw = dict(rtol=1e-10, atol=1e-12)
    et_j, _ = tde.odeint_event(lambda t, y: jnp.ones_like(y), jnp.array([0.0]),
                               jnp.array(0.0), event_fn=ev_j, **kw)
    et_t, _ = tt.odeint_event(lambda t, y: torch.ones_like(y),
                              torch.zeros(1, dtype=torch.float64), 0.0,
                              event_fn=ev_t, **kw)
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    assert abs(float(et_t) - 1.0) < 1e-6


def test_event_at_start_matches_jax():
    """An event already zero at t0 returns (t0, y0) without a step."""
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        lambda t, y: jnp.ones_like(y), jnp.array([0.0]),
        jnp.array([2.0, 3.0]), event_fn=lambda t, y: y[0])
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        lambda t, y: torch.ones_like(y), torch.zeros(1, dtype=torch.float64),
        torch.tensor([2.0, 3.0]), event_fn=lambda t, y: y[0])
    assert float(et_t) == float(et_j) == 2.0
    assert _counters(st_t) == _counters(st_j)
    assert st_t.n_steps == 0
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_j))


def test_event_max_num_steps_matches_jax():
    """An event that never fires within max_num_steps: error code 3 and
    JAX's counters; the bisection runs on the last accepted step."""
    kw = dict(rtol=1e-8, atol=1e-13, options=dict(max_num_steps=7))
    y0 = np.array([np.sin(0.5), np.cos(0.5)])
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        j_circle, jnp.asarray(y0), jnp.asarray([0.5, 1.5]),
        event_fn=lambda t, y: y[0] + 2.0, **kw)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        t_circle, torch.from_numpy(y0), torch.tensor([0.5, 1.5]),
        event_fn=lambda t, y: y[0] + 2.0, **kw)
    assert _counters(st_t) == _counters(st_j)
    assert st_t.error_code == ERR_MAX_NUM_STEPS
    # the bisection never sees a sign change, so the result is the end of
    # the last step: a step boundary, which carries the drift of the step
    # sizes' last bits (module docstring), ~1e-11 after these 7 long steps
    assert abs(float(et_t) - float(et_j)) <= 1e-10
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-10)


def test_replay_event_route_matches_jax():
    """The replay event solve, which this file once held to raising
    (tests/test_torch_replay.py holds its gradients): event time and state
    to 1e-12 and Stats exactly equal to JAX's."""
    kw = dict(event_fn=lambda t, y: y[0] - 0.5, rtol=1e-8, atol=1e-10,
              options=dict(replay_grad=True))
    et_j, ys_j = tde.odeint_event(lambda t, y: -y, jnp.ones(1),
                                  jnp.asarray(0.0), **kw)
    et_t, ys_t = tt.odeint_event(lambda t, y: -y,
                                 torch.ones(1, dtype=torch.float64), 0.0,
                                 **kw)
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("method", ['rk4', 'euler', 'implicit_adams'])
def test_fixed_grid_event_routes_match_jax(method):
    """The fixed-grid event solves that test above held to raising, now
    against JAX: event time and state to 1e-12, Stats exactly equal
    (tests/test_torch_fixed_grid.py, test_torch_adams.py and
    test_torch_implicit.py hold every method)."""
    kw = dict(method=method, options=dict(step_size=0.01))
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        lambda t, y: -y, jnp.ones(1), jnp.asarray([0.0, 1.0]),
        event_fn=lambda t, y: y[0] - 0.5, **kw)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        lambda t, y: -y, torch.ones(1, dtype=torch.float64),
        torch.tensor([0.0, 1.0], dtype=torch.float64),
        event_fn=lambda t, y: y[0] - 0.5, **kw)
    assert _counters(st_t) == _counters(st_j)
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    assert abs(float(et_t) - np.log(2.0)) < 2e-2
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)


def test_event_requires_two_times():
    with pytest.raises(ValueError, match="len\\(t\\) == 2"):
        tt.odeint(lambda t, y: -y, torch.ones(1, dtype=torch.float64),
                  torch.linspace(0.0, 1.0, 3), event_fn=lambda t, y: y[0])


def test_event_refuses_autograd():
    """A differentiable event solve takes its gradients from the adjoint
    and the IFT reroute: for dy/dt = -y and the event y == 0.5, t* =
    ln(y0 / 0.5) and dt*/dy0 = 1/y0 (JAX tests/test_events.py:75-90; held
    against JAX in tests/test_torch_adjoint.py).  What still refuses is the
    forward-only per-sample kernel route and odeint_dense."""
    y0 = torch.full((1,), 1.3, dtype=torch.float64, requires_grad=True)
    et, _ = tt.odeint_event(lambda t, y: -y, y0, 0.0,
                            event_fn=lambda t, y: y[0] - 0.5, rtol=1e-10,
                            atol=1e-12)
    et.backward()
    np.testing.assert_allclose(float(y0.grad), 1 / 1.3, rtol=1e-6)
    from torchdiffeq_tpu_torch.models import LinearEvent
    with pytest.raises(RuntimeError, match="forward-only.*ROADMAP A6"):
        tt.odeint_per_sample_with_stats(
            lambda t, y: -y, y0.expand(4, 1), torch.tensor([0.0, 5.0]),
            options=dict(pallas=True),
            event_fn=LinearEvent([[1.0]], bias=[-0.5], dtype=torch.float64,
                                 device='cpu'))
    with pytest.raises(NotImplementedError, match="no gradients"):
        tt.odeint_dense(lambda t, y: -y, y0, 0.0, 1.0)


# ---- find_event, combine_event_functions, the IFT reroute -----------------

def _quartic_coeffs(seed):
    rng = np.random.RandomState(seed)
    c = rng.randn(5, 3) * 0.3
    c[0] = [1.0, -0.5, 0.2]
    return c


def test_find_event_matches_jax():
    """The same quartic, bracket and event: the same bisection, to the
    last bit of float64."""
    c = _quartic_coeffs(0)
    j_interp = lambda t: jnp.asarray(c)[0] + sum(
        ((t - 0.2) / 0.7) ** i * jnp.asarray(c)[i] for i in range(1, 5))
    t_interp = lambda t: torch.from_numpy(c)[0] + sum(
        ((t - 0.2) / 0.7) ** i * torch.from_numpy(c)[i] for i in range(1, 5))
    level = float(j_interp(0.55)[0]) + 0.1 * 0.55     # a root at t = 0.55
    e_j = lambda t, y: y[0] - level + 0.1 * t
    e_t = lambda t, y: y[0] - level + 0.1 * t
    s0_j = jnp.sign(e_j(0.2, j_interp(0.2)))
    s0_t = torch.sign(e_t(torch.tensor(0.2, dtype=torch.float64),
                          t_interp(torch.tensor(0.2, dtype=torch.float64))))
    for tol in (1e-6, 1e-10):
        et_j, ye_j = jev.find_event(j_interp, s0_j, 0.2, 0.9, e_j, tol)
        et_t, ye_t = tev.find_event(t_interp, s0_t, 0.2, 0.9, e_t, tol)
        assert float(et_t) == float(et_j)
        np.testing.assert_array_equal(ye_t.numpy(), np.asarray(ye_j))
        assert abs(float(e_t(et_t, ye_t))) < 10 * tol


def test_combine_event_functions_matches_jax():
    c = _quartic_coeffs(1)
    e_j = lambda t, y: jnp.stack([y[0] - 0.5, -y[1] + t, y[2] * 2.0])
    e_t = lambda t, y: torch.stack([y[0] - 0.5, -y[1] + t, y[2] * 2.0])
    y0 = c[0]
    comb_j = jev.combine_event_functions(e_j, 0.0, jnp.asarray(y0))
    comb_t = tev.combine_event_functions(e_t, 0.0, torch.from_numpy(y0))
    for row in c[1:]:
        t = float(row[0])
        want = float(comb_j(t, jnp.asarray(row)))
        got = float(comb_t(torch.tensor(t, dtype=torch.float64),
                           torch.from_numpy(row)))
        assert got == want
    assert float(comb_t(torch.tensor(0.0, dtype=torch.float64),
                        torch.from_numpy(y0))) > 0


def test_reroute_backward_matches_jax():
    """The IFT backward on the same (event_t, state_t, grads), with a field
    and an event that capture parameters: the same state gradient, a zero
    event-time gradient, and no gradient to the captured parameters."""
    rng = np.random.RandomState(2)
    a, w = rng.randn(3), rng.randn(3)
    et, st = 0.7, rng.randn(3)
    g_t, g_s = 0.3, rng.randn(3)

    a_j, w_j = jnp.asarray(a), jnp.asarray(w)
    f_j = lambda t, y: -a_j * y + jnp.sin(t)
    e_j = lambda t, y: jnp.dot(w_j, y) - 0.1 * t * t
    apply = jev._implicit_fn_gradient_rerouting(f_j, e_j, jnp.asarray(et),
                                                jnp.asarray(st))
    out, vjp = jax.vjp(apply, jnp.asarray(et), jnp.asarray(st))
    gt_j, gs_j = vjp((jnp.asarray(g_t), jnp.asarray(g_s)))

    a_t = torch.tensor(a, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    f_t = lambda t, y: -a_t * y + torch.sin(t)
    e_t = lambda t, y: torch.dot(w_t, y) - 0.1 * t * t
    et_t = torch.tensor(et, dtype=torch.float64, requires_grad=True)
    st_t = torch.tensor(st, requires_grad=True)
    o_t, o_s = tev._implicit_fn_gradient_rerouting(f_t, e_t, et_t, st_t)
    assert float(o_t.detach()) == et and torch.equal(o_s, st_t.detach())
    gt_t, gs_t = torch.autograd.grad((o_t, o_s), (et_t, st_t),
                                     (torch.tensor(g_t, dtype=torch.float64),
                                      torch.from_numpy(g_s)))
    assert float(gt_t) == float(gt_j) == 0.0
    np.testing.assert_allclose(gs_t.numpy(), np.asarray(gs_j), rtol=1e-14,
                               atol=1e-14)
    assert not np.allclose(gs_t.numpy(), g_s)      # the reroute did act
    assert a_t.grad is None and w_t.grad is None


# ---- odeint_dense ----------------------------------------------------------

def _dense_both(t0, t1, method='dopri5', **kw):
    f_j = lambda t, y: -y
    f_t = lambda t, y: -y
    sol_j, st_j = tde.odeint_dense(f_j, jnp.array([1.0]), t0, t1,
                                   method=method, _return_stats=True, **kw)
    sol_t, st_t = tt.odeint_dense(f_t, torch.tensor([1.0], dtype=torch.float64),
                                  t0, t1, method=method, _return_stats=True,
                                  **kw)
    return sol_j, st_j, sol_t, st_t


@pytest.mark.parametrize("method", ['dopri5', 'tsit5', 'dopri8', 'bosh3',
                                    'kvaerno3'])
def test_dense_matches_jax(method):
    """Values and derivatives at scalar and batched times, and the stats
    (NFE from JAX's start at 2), for exp(-t) on [0, 2]."""
    sol_j, st_j, sol_t, st_t = _dense_both(0.0, 2.0, method)
    assert _counters(st_t) == _counters(st_j)
    assert sol_t.count == int(sol_j.count)
    tq = np.array([0.0, 0.3, 1.1, 1.9, 2.0])
    np.testing.assert_allclose(sol_t(torch.from_numpy(tq)).numpy(),
                               np.asarray(sol_j(jnp.asarray(tq))), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(sol_t.derivative(tq).numpy(),
                               np.asarray(sol_j.derivative(jnp.asarray(tq))),
                               rtol=0, atol=1e-12)
    assert sol_t(1.1).shape == (1,)                       # scalar time
    assert abs(float(sol_t(1.1)[0]) - float(sol_j(jnp.asarray(1.1))[0])) \
        <= 1e-12
    assert abs(float(sol_t.derivative(0.3)[0])
               - float(sol_j.derivative(jnp.asarray(0.3))[0])) <= 1e-12
    np.testing.assert_allclose(sol_t(torch.from_numpy(tq)).numpy()[:, 0],
                               np.exp(-tq), atol=1e-4)


def test_dense_find_event_matches_jax():
    sol_j, _, sol_t, _ = _dense_both(0.0, 2.0)
    cases = [
        (lambda t, y: y[0] - 0.5, lambda t, y: y[0] - 0.5),
        (lambda t, y: jnp.stack([y[0] - 0.5, y[0] - 10.0]),
         lambda t, y: torch.stack([y[0] - 0.5, y[0] - 10.0])),
        (lambda t, y: jnp.sin(t) - y[0], lambda t, y: torch.sin(t) - y[0]),
    ]
    for e_j, e_t in cases:
        et_j, ye_j = sol_j.find_event(e_j, tol=1e-13)
        et_t, ye_t = sol_t.find_event(e_t, tol=1e-13)
        assert abs(float(et_t) - float(et_j)) <= 1e-12
        np.testing.assert_allclose(ye_t.numpy(), np.asarray(ye_j), rtol=0,
                                   atol=1e-12)
    assert abs(float(sol_t.find_event(cases[0][1])[0]) - np.log(2.0)) < 1e-5
    et_t, _ = sol_t.find_event(lambda t, y: y[0] + 1.0)   # no crossing
    assert np.isnan(float(et_t))


def test_dense_reverse_time_matches_jax():
    sol_j, st_j, sol_t, st_t = _dense_both(2.0, 0.0)
    assert _counters(st_t) == _counters(st_j)
    tq = np.array([1.5, 0.5])
    np.testing.assert_allclose(sol_t(tq).numpy(),
                               np.asarray(sol_j(jnp.asarray(tq))), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(sol_t.derivative(tq).numpy(),
                               np.asarray(sol_j.derivative(jnp.asarray(tq))),
                               rtol=0, atol=1e-12)
    et_j, _ = sol_j.find_event(lambda t, y: y[0] - 3.0, tol=1e-13)
    et_t, _ = sol_t.find_event(lambda t, y: y[0] - 3.0, tol=1e-13)
    assert abs(float(et_t) - float(et_j)) <= 1e-12
    assert abs(float(et_t) - (2.0 - np.log(3.0))) < 1e-5


def test_dense_max_segments_matches_jax():
    """More accepted steps than `max_segments`: ERR_MAX_NUM_STEPS, JAX's
    counters, and the solution covers the integrated prefix."""
    sol_j, st_j, sol_t, st_t = _dense_both(0.0, 2.0, rtol=1e-7, atol=1e-9,
                                           max_segments=5)
    assert _counters(st_t) == _counters(st_j)
    assert st_t.error_code == sol_t.error_code == ERR_MAX_NUM_STEPS
    assert sol_t.count == 5 and sol_t.t_hi < 2.0
    # a step boundary: it carries the drift of the step sizes' last bits
    # (module docstring), measured 2.3e-12 after these five steps
    assert abs(sol_t.t_hi - float(sol_j.t_hi)) <= 1e-10
    tq = np.array([0.01, sol_t.t_hi / 2])
    np.testing.assert_allclose(sol_t(tq).numpy(),
                               np.asarray(sol_j(jnp.asarray(tq))), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("y0", [1e30, np.inf])
def test_dense_failed_solve_matches_jax(y0):
    """A blow-up y' = y*y from a huge state ends in an error after JAX's
    steps; from inf the first step already fails and the solution has no
    segment.  Either way find_event is NaN."""
    f_j, f_t = (lambda t, y: y * y), (lambda t, y: y * y)
    sol_j, st_j = tde.odeint_dense(f_j, jnp.array([y0]), 0.0, 1.0,
                                   _return_stats=True)
    sol_t, st_t = tt.odeint_dense(f_t, torch.tensor([y0], dtype=torch.float64),
                                  0.0, 1.0, _return_stats=True)
    assert _counters(st_t) == _counters(st_j)
    assert sol_t.count == int(sol_j.count)
    assert sol_t.error_code == int(sol_j.error_code) != 0
    if y0 == np.inf:
        assert sol_t.count == 0
    assert np.isnan(float(sol_t.find_event(lambda t, y: y[0] - 0.5)[0]))
    assert np.isnan(float(sol_j.find_event(lambda t, y: y[0] - 0.5)[0]))


def test_dense_non_adaptive_methods_raise():
    with pytest.raises(ValueError, match="adaptive"):
        tt.odeint_dense(lambda t, y: -y, torch.ones(1), 0.0, 2.0,
                        method='rk4')


def test_dense_float32_spiral_against_odeint():
    """float32 state on the spiral field: the dense solution at the output
    times of an `odeint` solve agrees with it (both interpolate the same
    accepted steps, so to float32 rounding)."""
    params, y0 = _spiral(3, B=8)
    model = mlp_params_from_jax(
        [{k: v.astype(np.float32) for k, v in p.items()} for p in params],
        power=3, device='cpu').requires_grad_(False)
    y = torch.from_numpy(y0.astype(np.float32))
    t = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    ys = tt.odeint(model, y, t, rtol=1e-5, atol=1e-7)
    sol = tt.odeint_dense(model, y, 0.0, 1.0, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sol(t).numpy(), ys.numpy(), rtol=0, atol=1e-6)


# ---- per-sample event route ------------------------------------------------

def test_per_sample_event_route_matches_jax():
    """Free fall from heights in [1, 2] to the ground, float64
    (tests/test_pallas.py::test_per_sample_event_parity_with_vmap): event
    times, states and per-sample Stats equal JAX's kernel route."""
    B = 32
    rng = np.random.RandomState(1)
    pos0 = 1.0 + rng.rand(B)
    y0 = np.stack([pos0, np.zeros(B)], axis=1)
    t = np.array([0.0, 1.0])
    (et_j, ys_j), st_j = j_per_sample(
        lambda t_, y: jnp.stack([y[1], jnp.full_like(y[1], -9.8)]),
        jnp.asarray(y0), jnp.asarray(t), event_fn=lambda t_, y: y[0],
        rtol=1e-6, atol=1e-8, options=dict(pallas=True, interpret=True))
    kernels.reset_launch_counts()
    (et_t, ys_t), st_t = tt.odeint_per_sample_with_stats(
        lambda t_, y: torch.stack([y[1], torch.full_like(y[1], -9.8)]),
        torch.from_numpy(y0), torch.from_numpy(t),
        event_fn=lambda t_, y: y[0], rtol=1e-6, atol=1e-8,
        options=dict(pallas=True))
    assert kernels.launch_counts['dopri5_events_batched'] == 0  # CPU: plain
    assert ys_t.shape == (B, 2, 2) and et_t.shape == (B,)
    np.testing.assert_allclose(et_t.numpy(), np.asarray(et_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(et_t.numpy(), np.sqrt(2 * pos0 / 9.8),
                               atol=1e-5)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("as_linear", [False, True])
def test_per_sample_event_multi_output_and_not_found_matches_jax(as_linear):
    """Sign-combined two-output events; lanes that never fire report NaN
    and ERR_MAX_NUM_STEPS (tests/test_pallas.py::test_per_sample_event_
    multi_output_and_not_found), through a callable and as a LinearEvent.
    Their last state sits wherever `max_num_steps` left it, so it is
    compared on the lanes that fired."""
    B = 32
    y0 = np.stack([np.linspace(0.5, 2.0, B), np.zeros(B)], axis=1)
    t = np.array([0.0, 1.0])
    kw = dict(rtol=1e-6, atol=1e-8)
    (et_j, ys_j), st_j = j_per_sample(
        lambda t_, y: jnp.stack([-y[0], jnp.zeros_like(y[1])]),
        jnp.asarray(y0), jnp.asarray(t),
        event_fn=lambda t_, y: jnp.stack([y[0] - 0.45, y[1] + 1.0]),
        options=dict(pallas=True, interpret=True, max_num_steps=200), **kw)
    if as_linear:
        event = LinearEvent([[1.0, 0.0], [0.0, 1.0]], bias=[-0.45, 1.0],
                            dtype=torch.float64,
                            device='cpu').requires_grad_(False)
    else:
        event = lambda t_, y: torch.stack([y[0] - 0.45, y[1] + 1.0])
    (et_t, ys_t), st_t = tt.odeint_per_sample_with_stats(
        lambda t_, y: torch.stack([-y[0], torch.zeros_like(y[1])]),
        torch.from_numpy(y0), torch.from_numpy(t), event_fn=event,
        options=dict(pallas=True, max_num_steps=200), **kw)
    fired = y0[:, 0] > 0.45
    et_np = et_t.numpy()
    assert np.isnan(et_np[~fired]).all() and not np.isnan(et_np[fired]).any()
    np.testing.assert_allclose(et_np[fired], np.asarray(et_j)[fired], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(et_np[fired], np.log(y0[fired, 0] / 0.45),
                               atol=1e-4)
    np.testing.assert_allclose(ys_t.numpy()[fired], np.asarray(ys_j)[fired],
                               rtol=0, atol=1e-12)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    codes = st_t.error_code.numpy()
    assert (codes[~fired] == ERR_MAX_NUM_STEPS).all()
    assert (codes[fired] == 0).all()


def test_per_sample_event_requires_two_times():
    with pytest.raises(ValueError, match="shape \\(2,\\)"):
        tt.odeint_per_sample(lambda t, y: -y, torch.ones(4, 2),
                             torch.linspace(0.0, 1.0, 3),
                             event_fn=lambda t, y: y[0] - 0.5,
                             options=dict(pallas=True))


# ---- the entry points, float32 --------------------------------------------

def test_event_solve_float32_matches_jax():
    """float32 state (time float64), the threshold event of
    test_event_solve_mlp_field_matches_jax: the counters are equal and the
    event time agrees to the solver's tolerance -- a one-ULP difference in
    a slope moves the embedded error estimate (see test_torch_odeint.py),
    and with it the step sizes and the bracketing quartic."""
    params, y0 = _spiral(0)
    p32 = [{k: v.astype(np.float32) for k, v in p.items()} for p in params]
    thr = float(np.mean(y0[:, 0])) - 0.05
    kw = dict(method='dopri5', rtol=1e-5, atol=1e-7,
              options=dict(max_num_steps=1000))
    (et_j, _), st_j = tde.odeint_with_stats(
        lambda t, y, p: spiral_field(p, t, y), jnp.asarray(y0, jnp.float32),
        jnp.asarray([0.0, 1.0]), args=(p32,),
        event_fn=lambda t, y: jnp.mean(y[:, 0]) - thr, **kw)
    model = mlp_params_from_jax(p32, power=3,
                                device='cpu').requires_grad_(False)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        model, torch.from_numpy(y0.astype(np.float32)),
        torch.tensor([0.0, 1.0]), event_fn=lambda t, y: y[:, 0].mean() - thr,
        **kw)
    assert ys_t.dtype == torch.float32
    assert _counters(st_t) == _counters(st_j)
    assert st_t.error_code == 0
    assert abs(float(et_t) - float(et_j)) <= 1e-5
