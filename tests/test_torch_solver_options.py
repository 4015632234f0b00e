"""The adaptive solver's step_t, jump_t, jump_state_fn and step_to_end, the
tuple state, per-leaf tolerances and user norms of the PyTorch port, each
against the JAX package on the same numpy inputs (CPU, float64).

Values agree to 1e-12 and the `Stats` counters (NFE, steps, accepted,
rejected, error code) exactly: the port's host loop follows the JAX
`_adaptive_step` (torchdiffeq_tpu/solvers/adaptive_rk.py:212-258) decision
by decision.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt

TOL = 1e-12


def _counters(st):
    return [int(st.nfe), int(st.n_steps), int(st.n_accepted),
            int(st.n_rejected), int(st.error_code)]


def _kink_j(t, y):
    # a field with a jump in its slope at t = 0.5
    return jnp.where(t < 0.5, -y, 2.0 * y) + jnp.sin(3.0 * t)


def _kink_t(t, y):
    return torch.where(t < 0.5, -y, 2.0 * y) + torch.sin(3.0 * t)


# Without a jump_t time at its kink the controller crawls through it with
# dozens of rejections, where last-bit differences of sin grow to 1e-9: the
# kink is solved with jump_t at 0.5, everything else on a smooth field.
SMOOTH = (lambda t, y: -y + jnp.sin(3.0 * t),
          lambda t, y: -y + torch.sin(3.0 * t))


Y0 = np.array([1.0, -0.5, 0.25])


def _both(options_j, options_t=None, t=(0.0, 0.3, 1.0), rtol=1e-8,
          atol=1e-10, func=(_kink_j, _kink_t), y0=Y0):
    """The same solve in both packages: (ys_j, st_j), (ys_t, st_t)."""
    ys_j, st_j = tde.odeint_with_stats(func[0], jnp.asarray(y0),
                                       jnp.asarray(t), rtol=rtol, atol=atol,
                                       options=options_j)
    ys_t, st_t = tt.odeint_with_stats(
        func[1], torch.from_numpy(np.array(y0)),
        torch.tensor(t, dtype=torch.float64), rtol=rtol, atol=atol,
        options=options_j if options_t is None else options_t)
    return (np.asarray(ys_j), st_j), (ys_t.numpy(), st_t)


@pytest.mark.parametrize("options", [
    dict(jump_t=[0.5]),
    dict(step_t=[0.2, 0.45, 0.8]),
    dict(step_t=[-1.0, 0.45, 0.9, 2.0], jump_t=[0.5, 0.7]),   # outside [t0, t1]
    dict(step_t=[0.9, 0.1], jump_t=[0.7, 0.5]),                 # unsorted
], ids=["jump", "step", "both_outside", "unsorted"])
def test_step_t_and_jump_t_match_jax(options):
    (ys_j, st_j), (ys_t, st_t) = _both(
        options, func=(_kink_j, _kink_t) if 'jump_t' in options else SMOOTH)
    assert _counters(st_t) == _counters(st_j)
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("t", [(0.0, 0.3, 1.0), (1.0, 0.6, 0.0)],
                         ids=["forward", "reverse"])
def test_step_to_end_matches_jax(t):
    """Steps land on every output time and the state is copied there
    (JAX adaptive_rk.py:446-497), alone and with step_t and jump_t times,
    one of them equal to an output time."""
    for options, func in ((dict(step_to_end=True), SMOOTH),
                          (dict(step_to_end=True, step_t=[0.45, 0.6],
                                jump_t=[0.3, 0.5]), (_kink_j, _kink_t))):
        (ys_j, st_j), (ys_t, st_t) = _both(options, t=t, func=func)
        assert _counters(st_t) == _counters(st_j), options
        np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=TOL)


def _hook_j(k, t, y):
    return y * 0.5 + (k + 1.0)


def _hook_t(k, t, y):
    return y * 0.5 + (k + 1.0)


def test_jump_state_fn_matches_jax():
    """The hook runs on an accepted step that ends on a jump time, before
    the far-side slope, which counts in the NFE; the interpolant of that
    step is fit to the pre-jump state, so an output inside it sees no
    jump."""
    t = (0.0, 0.45, 0.6, 1.0)
    (ys_j, st_j), (ys_t, st_t) = _both(
        dict(jump_t=[0.5, 0.8], jump_state_fn=_hook_j),
        dict(jump_t=[0.5, 0.8], jump_state_fn=_hook_t), t=t)
    assert _counters(st_t) == _counters(st_j)
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=TOL)
    # the jumps happened: y(1) is far from the solution without them
    (ys_n, _), _ = _both(dict(jump_t=[0.5, 0.8]), t=t)
    assert np.abs(ys_n[-1] - ys_j[-1]).max() > 0.5


def test_jump_on_the_end_of_a_step_still_fires():
    """A step whose end lands bitwise on the jump time: with a hook the
    jump still fires (JAX adaptive_rk.py:231-246), else its injection
    would be skipped."""
    calls = []

    def hook_t(k, t, y):
        calls.append((int(k), float(t)))
        return y + 1.0

    options = dict(first_step=0.25, jump_t=[0.25])
    (ys_j, st_j), (ys_t, st_t) = _both(
        dict(options, jump_state_fn=lambda k, t, y: y + 1.0),
        dict(options, jump_state_fn=hook_t), t=(0.0, 1.0),
        func=(lambda t, y: -y, lambda t, y: -y))
    assert calls == [(0, 0.25)]
    assert _counters(st_t) == _counters(st_j)
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=TOL)


def test_step_t_and_jump_t_must_not_share_times():
    for odeint in (tde.odeint, tt.odeint):
        with pytest.raises(ValueError, match="repeated elements"):
            odeint(lambda t, y: -y, np.ones(1) if odeint is tde.odeint
                   else torch.ones(1, dtype=torch.float64),
                   np.array([0.0, 1.0]) if odeint is tde.odeint
                   else torch.tensor([0.0, 1.0], dtype=torch.float64),
                   options=dict(step_t=[0.5], jump_t=[0.5]))


def test_jump_t_in_an_event_solve_matches_jax():
    """The bisection runs to atol; at 1e-13 its last steps' signs, where
    last-bit differences could decide them, move the event by 1e-13."""
    kw = dict(rtol=1e-8, atol=1e-13, options=dict(jump_t=[0.5]))
    (et_j, ys_j), st_j = tde.odeint_with_stats(
        _kink_j, jnp.asarray(Y0), jnp.asarray([0.0, 2.0]),
        event_fn=lambda t, y: y[0] - 1.2, **kw)
    (et_t, ys_t), st_t = tt.odeint_with_stats(
        _kink_t, torch.from_numpy(Y0.copy()), torch.tensor([0.0, 2.0]),
        event_fn=lambda t, y: y[0] - 1.2, **kw)
    assert _counters(st_t) == _counters(st_j)
    assert abs(float(et_t) - float(et_j)) <= TOL
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=TOL)


# ---- tuple state, per-leaf tolerances, norms --------------------------------

def _pair_j(t, y):
    a, b = y
    return (b * jnp.cos(t), -a[:, :1] * b - 0.1 * b)


def _pair_t(t, y):
    a, b = y
    return (b * torch.cos(t), -a[:, :1] * b - 0.1 * b)


PAIR = (np.array([[1.0, 0.5], [0.2, -0.3]]), np.array([[0.3, 0.1],
                                                       [-0.7, 0.4]]))


@pytest.mark.parametrize("tols", [dict(rtol=1e-8, atol=1e-10),
                                  dict(rtol=[1e-8, 1e-6], atol=[1e-10, 1e-9])],
                         ids=["scalar", "per_leaf"])
@pytest.mark.parametrize("t", [(0.0, 0.5, 2.0), (2.0, 1.0, 0.0)],
                         ids=["forward", "reverse"])
def test_tuple_state_matches_jax(tols, t):
    """A tuple state: flattened inside the port, the max of per-leaf RMS
    norms (`mixed_norm`), per-leaf tolerances expanded per element."""
    ys_j, st_j = tde.odeint_with_stats(
        _pair_j, tuple(jnp.asarray(x) for x in PAIR), jnp.asarray(t), **tols)
    ys_t, st_t = tt.odeint_with_stats(
        _pair_t, tuple(torch.from_numpy(x.copy()) for x in PAIR),
        torch.tensor(t, dtype=torch.float64), **tols)
    assert isinstance(ys_t, tuple) and len(ys_t) == 2
    assert _counters(st_t) == _counters(st_j)
    for a, b in zip(ys_t, ys_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("which", ["single", "tuple"])
def test_user_norm_matches_jax(which):
    """A user norm sees the state in its own structure (JAX
    misc.py:295-304)."""
    if which == "single":
        (ys_j, st_j), (ys_t, st_t) = _both(
            dict(norm=lambda x: jnp.max(jnp.abs(x))),
            dict(norm=lambda x: x.abs().max()), func=SMOOTH)
        assert _counters(st_t) == _counters(st_j)
        np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=TOL)
        return
    ys_j, st_j = tde.odeint_with_stats(
        _pair_j, tuple(jnp.asarray(x) for x in PAIR), jnp.asarray([0., 2.]),
        options=dict(norm=lambda y: jnp.maximum(jnp.max(jnp.abs(y[0])),
                                                jnp.max(jnp.abs(y[1])))))
    ys_t, st_t = tt.odeint_with_stats(
        _pair_t, tuple(torch.from_numpy(x.copy()) for x in PAIR),
        torch.tensor([0., 2.], dtype=torch.float64),
        options=dict(norm=lambda y: torch.maximum(y[0].abs().max(),
                                                  y[1].abs().max())))
    assert _counters(st_t) == _counters(st_j)
    for a, b in zip(ys_t, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


def test_mixed_norm_and_time_sign():
    from torchdiffeq_tpu.misc import (mixed_norm as mixed_j,
                                      time_sign as sign_j)
    from torchdiffeq_tpu_torch.misc import mixed_norm, time_sign
    xs = (np.array([3.0, -4.0]), np.array([[1.0, 2.0], [2.0, 1.0]]))
    assert float(mixed_norm([torch.from_numpy(x) for x in xs])) == \
        float(mixed_j(tuple(jnp.asarray(x) for x in xs)))
    assert float(mixed_norm([])) == 0.0
    for t in ([0.0, 1.0], [1.0, 0.0], [2.0]):
        assert time_sign(torch.tensor(t)) == float(sign_j(jnp.asarray(t)))


def test_reverse_time_direction_forces_the_sign():
    """``time_direction='reverse'`` integrates backwards whatever the order
    of t (the adjoint's backward solves; JAX misc.py:323-330)."""
    from torchdiffeq_tpu.misc import check_inputs as check_j
    from torchdiffeq_tpu.solvers import SOLVERS as SOLVERS_J
    from torchdiffeq_tpu_torch.misc import check_inputs
    from torchdiffeq_tpu_torch.solvers import SOLVERS
    t = np.array([2.0, 1.0])
    prob = check_inputs(lambda t, y: -y, torch.ones(1), t, 1e-6, 1e-8, None,
                        dict(jump_t=[1.5]), None, SOLVERS,
                        time_direction='reverse')
    prob_j = check_j(lambda t, y: -y, jnp.ones(1), t, 1e-6, 1e-8, None,
                     dict(jump_t=[1.5]), None, SOLVERS_J,
                     time_direction='reverse')
    assert prob.t_sign == float(prob_j.t_sign) == -1.0
    np.testing.assert_array_equal(prob.t, np.asarray(prob_j.t))
    np.testing.assert_array_equal(prob.options['jump_t'],
                                  np.asarray(prob_j.options['jump_t']))


# ---- the PI and PID controllers, linf_norm and the larger norm ------------

@pytest.mark.parametrize("method", ['dopri5', 'bosh3', 'tsit5'])
@pytest.mark.parametrize("options", [
    dict(controller='pi'), dict(controller='pi', pcoeff=0.3, icoeff=0.6),
    dict(controller='pid', dcoeff=0.2),
    dict(controller='pid', pcoeff=0.2, icoeff=0.5, dcoeff=0.1),
    dict(controller='i'),
], ids=['pi', 'pi-coeffs', 'pid', 'pid-coeffs', 'i'])
def test_controllers_match_jax(options, method):
    """PI and PID (JAX ops/step_control.py:90-143, the last one and two
    accepted ratios in the carry) on the smooth field from a first step
    far too large, a solve that rejects steps: Stats exactly equal and
    values to 1e-12."""
    opts = dict(options, first_step=0.8)
    ys_j, st_j = tde.odeint_with_stats(SMOOTH[0], jnp.asarray(Y0),
                                       jnp.asarray([0.0, 0.3, 2.0]),
                                       rtol=1e-8, atol=1e-10, method=method,
                                       options=opts)
    ys_t, st_t = tt.odeint_with_stats(SMOOTH[1], torch.from_numpy(Y0),
                                      torch.tensor([0.0, 0.3, 2.0],
                                                   dtype=torch.float64),
                                      rtol=1e-8, atol=1e-10, method=method,
                                      options=opts)
    assert _counters(st_t) == _counters(st_j)
    assert st_t.n_rejected > 0
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=TOL)


def test_pid_with_zero_dcoeff_is_pi_and_controllers_differ():
    """dcoeff=0 reduces PID to PI exactly (JAX's docstring), and the PI
    controller takes another step sequence than the I controller."""
    runs = {}
    for name, opts in (('i', {}), ('pi', dict(controller='pi')),
                       ('pid0', dict(controller='pid', dcoeff=0.0))):
        runs[name] = tt.odeint_with_stats(
            SMOOTH[1], torch.from_numpy(Y0),
            torch.tensor([0.0, 2.0], dtype=torch.float64), rtol=1e-9,
            atol=1e-11, options=opts)
    assert list(runs['pi'][1]) == list(runs['pid0'][1])
    assert torch.equal(runs['pi'][0], runs['pid0'][0])
    assert list(runs['pi'][1][:4]) != list(runs['i'][1][:4])


def test_step_size_controllers_match_jax_on_edge_ratios():
    """The controller functions alone on float64 host scalars against JAX's:
    zero error (a full ifactor), ratios below the smallest normal (floored
    by finfo.tiny), and the clamps at dfactor and ifactor."""
    from torchdiffeq_tpu.ops import step_control as sc_j
    from torchdiffeq_tpu_torch.ops import step_control as sc_t
    cases = [(0.0, 1.0, 1.0), (1e-320, 1e-310, 0.5), (1e6, 1.0, 1.0),
             (1e-9, 1.0, 1.0), (0.7, 1.3, 0.2), (2.5, 0.4, 3.0)]
    for err, prev, prev2 in cases:
        for order in (2, 4, 5):
            pi_t = sc_t.optimal_step_size_pi(0.1, err, prev, 0.9, 10.0, 0.2,
                                             order, 0.4, 0.7)
            pi_j = sc_j.optimal_step_size_pi(jnp.float64(0.1), err, prev,
                                             0.9, 10.0, 0.2, order, 0.4, 0.7)
            pid_t = sc_t.optimal_step_size_pid(0.1, err, prev, prev2, 0.9,
                                               10.0, 0.2, order, 0.4, 0.7,
                                               0.2)
            pid_j = sc_j.optimal_step_size_pid(jnp.float64(0.1), err, prev,
                                               prev2, 0.9, 10.0, 0.2, order,
                                               0.4, 0.7, 0.2)
            assert float(pi_t) == float(pi_j), (err, prev, order)
            assert float(pid_t) == float(pid_j), (err, prev, prev2, order)


@pytest.mark.parametrize("which", ["linf", "zero", "larger"])
def test_more_norms_match_jax(which):
    """linf_norm and zero_norm (JAX misc.py:133-138) and a norm that reports
    ten times the RMS error (tests/test_norms.py:78-89: at least as many
    NFE as the default), as user norms: Stats exactly, values to 1e-12."""
    from torchdiffeq_tpu import misc as misc_j
    from torchdiffeq_tpu_torch import misc as misc_t
    norms = {
        'linf': (misc_j.linf_norm, misc_t.linf_norm),
        'zero': (misc_j.zero_norm, misc_t.zero_norm),
        'larger': (lambda x: 10.0 * jnp.sqrt(jnp.mean(jnp.abs(x) ** 2)),
                   lambda x: 10.0 * torch.sqrt(torch.mean(x.abs() ** 2))),
    }[which]
    kw = dict(t=(0.0, 0.5, 2.0), func=SMOOTH)
    (ys_j, st_j), (ys_t, st_t) = _both(dict(norm=norms[0]),
                                       dict(norm=norms[1]), **kw)
    assert _counters(st_t) == _counters(st_j)
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=TOL)
    _, st_plain = _both(None, **kw)[1]
    if which == 'larger':
        assert st_t.nfe >= st_plain.nfe
    if which == 'zero':
        assert st_t.n_rejected == 0
    x = torch.tensor([[3.0, -4.0], [0.5, 2.0]], dtype=torch.float64)
    assert float(misc_t.linf_norm(x)) == 4.0
    assert misc_t.zero_norm(x).dtype == torch.float64
