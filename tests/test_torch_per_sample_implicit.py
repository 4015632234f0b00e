"""The per-sample route's stiff, implicit and Adams tiers and its other
options (`parallel/batched.py`, `solvers/batched_rk.py`, the lane steppers
of `solvers/fixed_grid_implicit.py`, `adaptive_implicit.py` and
`adams.py`) against the JAX package's vmap route
(`torchdiffeq_tpu.parallel.odeint_per_sample_with_stats`, `jax.jit`-ed),
on the same numpy inputs, in float64.

Bounds: values to 1e-10 of max|y|; every per-sample `Stats` counter
exactly (`final_dt` to 1e-6, as tests/test_torch_per_sample.py explains);
gradients and tangents to 1e-9 of max|g|.  Most cases also hold samples of
the batch against the port's own single solve of that sample (values to
1e-10, counters exactly), which checks the masking without JAX: a batched
Broyden update or Adams sum rounds as a batched product, not as one
sample's, and the stage solves stop within their tolerance of each other.

The problem is a linear relaxation y' = -lam_i (y - cos t) with one
stiffness a sample (lam from 1 to 1000), so the samples take different
step sequences, Newton and Broyden iteration counts and Adams orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.solvers.solution import (
    IMPLICIT_COUNTS, reset_implicit_counts, ERR_IMPLICIT_NO_CONVERGENCE)

LAM = np.logspace(0.0, 3.0, 4)
Y0 = np.array([[1.0, 0.5], [0.2, -0.4], [1.5, 1.0], [-0.3, 0.8]])
T3 = np.linspace(0.0, 1.0, 3)


def j_relax(t, y, lam):
    return -lam * (y - jnp.cos(t))


def t_relax(t, y, lam):
    return -lam * (y - torch.cos(t))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _assert_values(got, want, tol=1e-10):
    # a complex state is compared whole, not through its real part
    kind = (np.complex128 if np.iscomplexobj(_np(got))
            or np.iscomplexobj(_np(want)) else np.float64)
    got, want = _np(got).astype(kind), _np(want).astype(kind)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = max(np.nanmax(np.abs(want)), 1e-300)
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=tol * scale)


def _assert_stats(st_t, st_j):
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_allclose(_np(st_t.final_dt), np.asarray(st_j.final_dt),
                               rtol=1e-6)


def _jax(t, j_func=j_relax, axes=(0,), **kw):
    return jax.jit(lambda y0, *args: j_per_sample(
        j_func, y0, t, args=args, args_axes=axes, **kw))


def _port(y0, t, t_func=t_relax, args=(LAM,), axes=(0,), **kw):
    return tt.odeint_per_sample_with_stats(
        t_func, torch.from_numpy(y0), torch.from_numpy(t),
        args=tuple(torch.from_numpy(a) for a in args), args_axes=axes, **kw)


def _own(ys, st, y0, t, t_func=t_relax, args=(LAM,), samples=(0, 3), **kw):
    """Samples of the batch against the port's solve of each alone."""
    for i in samples:
        ys_i, st_i = tt.odeint_with_stats(
            t_func, torch.from_numpy(y0[i]), torch.from_numpy(t),
            args=tuple(torch.as_tensor(a[i]) for a in args), **kw)
        if kw.get('event_fn') is not None:
            _assert_values(ys[0][i], ys_i[0])
            _assert_values(ys[1][i], ys_i[1])
        else:
            _assert_values(ys[i], ys_i)
        assert [int(x[i]) for x in st[:5]] == [int(x) for x in st_i[:5]]


def _both(y0=Y0, t=T3, own=True, **kw):
    ys_j, st_j = _jax(t, **kw)(jnp.asarray(y0), jnp.asarray(LAM))
    ys_t, st_t = _port(y0, t, **kw)
    if own:
        _own(ys_t, st_t, y0, t, **kw)
    return (ys_j, st_j), (ys_t, st_t)


# ---- every method of the Adams, implicit and stiff tiers ---------------------

METHODS = [
    ('kvaerno3', dict(rtol=1e-5, atol=1e-7)),
    ('kvaerno5', dict(rtol=1e-6, atol=1e-8)),
    ('radau5a', dict(rtol=1e-6, atol=1e-8)),
    ('explicit_adams', dict(options=dict(num_steps=60))),
    ('implicit_adams', dict(options=dict(num_steps=20))),
    ('fixed_adams', dict(options=dict(num_steps=20, max_order=6))),
    ('implicit_euler', dict(options=dict(num_steps=10))),
    ('implicit_midpoint', dict(options=dict(num_steps=10))),
    ('trapezoid', dict(options=dict(num_steps=10))),
    ('radauIIA3', dict(options=dict(num_steps=10))),
    ('gl4', dict(options=dict(num_steps=10))),
    ('radauIIA5', dict(options=dict(num_steps=8, root_solver='newton'))),
    ('gl6', dict(options=dict(num_steps=8, root_solver='newton'))),
    ('sdirk2', dict(options=dict(num_steps=10))),
    ('trbdf2', dict(options=dict(num_steps=10, root_solver='newton'))),
]


@pytest.mark.parametrize("method,kw", METHODS, ids=[m for m, _ in METHODS])
def test_method_matches_jax(method, kw):
    """Values, every per-sample counter (the stiff tier's steps a sample,
    the Adams corrector's NFE a sample) and the port's own single solves."""
    (ys_j, st_j), (ys_t, st_t) = _both(method=method, **kw)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    if SOLVERS_KIND[method] == 'adaptive':
        assert len(set(st_t.n_steps.tolist())) == 4


SOLVERS_KIND = {m: tt.solvers.SOLVERS[m]['kind'] for m, _ in METHODS}


@pytest.mark.parametrize("method,options", [
    ('gl4', dict(num_steps=5, max_iters=5)),
    ('trbdf2', dict(num_steps=4, max_iters=1)),
    ('implicit_adams', dict(num_steps=40, max_iters=3)),
])
def test_unconverged_samples_are_their_own(method, options):
    """Stage solves and Adams correctors cut short by `max_iters`: each
    sample's error code (4 where a FIRK/DIRK stage solve did not converge)
    and, for Adams, each sample's dropped history, so its own order and
    NFE, as JAX's vmap gives them."""
    (ys_j, st_j), (ys_t, st_t) = _both(method=method, options=options,
                                       own=False)
    _assert_stats(st_t, st_j)
    ok = (st_t.error_code == 0).numpy()
    if ok.any():
        _assert_values(ys_t[ok], np.asarray(ys_j)[ok])
    # an unconverged Broyden iterate carries the rounding of its batched
    # rank-1 updates (the port's single solve departs from JAX's there as
    # much): held to the stage tolerance's scale only
    if not ok.all():
        _assert_values(ys_t[~ok], np.asarray(ys_j)[~ok], tol=1e-6)
    if method == 'gl4':
        assert st_t.error_code.tolist() == [0, 0, 0,
                                            ERR_IMPLICIT_NO_CONVERGENCE]
    if method == 'implicit_adams':
        assert len(set(st_t.nfe.tolist())) == 3


def test_root_solves_read_the_host_once_an_iteration():
    """One host read an iteration of a batched stage solve (is any sample
    still iterating?), whatever the batch."""
    for B in (1, 4):
        reset_implicit_counts()
        _port(Y0[:B], T3, args=(LAM[:B],), method='trbdf2',
              options=dict(num_steps=4, root_solver='newton'))
        counts = dict(IMPLICIT_COUNTS)
        # per stage solve: the iterations, then the read that ends them
        assert counts['host_reads'] == counts['iterations'] + 2 * 4
        assert counts['linear_solves'] == counts['iterations']


def test_stiff_tier_events_match_jax():
    """kvaerno5 to each sample's own event (the adaptive event loop with
    the per-sample Newton step): event times and states within 2 * atol,
    the bisection's tolerance (tests/test_torch_stiff.py's bound for one
    solve: a sign decision at the root follows the stage solves' last
    bits), Stats exactly."""
    kw = dict(method='kvaerno5', rtol=1e-6, atol=1e-8,
              event_fn=lambda t, y: y[0] - 0.5)
    y0 = np.abs(Y0) * 0.2
    (ys_j, st_j), (ys_t, st_t) = _both(y0=y0, t=np.array([0.0, 3.0]), **kw)
    for a, b in zip(ys_t, ys_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=2e-8)
    _assert_stats(st_t, st_j)


@pytest.mark.parametrize("method,options", [
    ('implicit_adams', dict(step_size=0.05)),
    ('trbdf2', dict(step_size=0.05, root_solver='newton'))])
def test_fixed_grid_implicit_events_match_jax(method, options):
    y0 = np.abs(Y0) * 0.2
    ev = lambda t, y: y[0] - 0.5
    (et_j, ys_j), st_j = j_per_sample(
        j_relax, jnp.asarray(y0), np.array([0.0, 3.0]),
        args=(jnp.asarray(LAM),), args_axes=(0,), method=method,
        options=options, event_fn=ev)
    (et_t, ys_t), st_t = _port(y0, np.array([0.0, 3.0]), method=method,
                               options=options, event_fn=ev)
    _assert_values(et_t, et_j)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


# ---- gradients ---------------------------------------------------------------------

W3 = np.random.RandomState(3).randn(4, 3, 2)
# the gradients' stiffness: a continuous adjoint integrates y back in time,
# where each sample's decay is a growth its controller resolves step by
# step (lam = 1000 takes over 3000 backward steps, in JAX as here)
LAM_G = np.logspace(0.0, 1.0, 4)


@pytest.mark.parametrize("method,kw", [
    ('kvaerno5', dict(rtol=1e-6, atol=1e-8)),
    ('radau5a', dict(rtol=1e-6, atol=1e-8)),
    ('kvaerno3', dict(rtol=1e-4, atol=1e-6)),
    ('gl4', dict(options=dict(num_steps=10))),
    ('trbdf2', dict(options=dict(num_steps=10, root_solver='newton'))),
    ('implicit_adams', dict(options=dict(num_steps=20))),
])
def test_gradients_match_jax(method, kw):
    """The stiff tier through each sample's continuous adjoint (JAX's
    custom_vjp under vmap; the backward's Newton steps per sample too), the
    fixed-grid tiers through the loop and each sample's implicit-function
    gradient: to y0 and to the per-sample stiffness."""
    def j_loss(y0, lam):
        ys = j_per_sample(j_relax, y0, T3, args=(lam,), args_axes=(0,),
                          method=method, **kw)[0]
        return jnp.sum(ys * W3)

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(Y0),
                                                    jnp.asarray(LAM_G))
    ps = [torch.from_numpy(x).requires_grad_() for x in (Y0, LAM_G)]
    ys, _ = tt.odeint_per_sample_with_stats(
        t_relax, ps[0], torch.from_numpy(T3), args=(ps[1],), args_axes=(0,),
        method=method, **kw)
    (ys * torch.from_numpy(W3)).sum().backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9)


def test_stiff_event_gradient_matches_jax():
    """kvaerno5's event-mode adjoint per sample: each sample backpropagates
    from its own event time (at atol 1e-10, the bisection's tolerance, as
    tests/test_torch_per_sample.py holds the explicit tier's)."""
    y0 = np.abs(Y0) * 0.2
    ev = lambda t, y: y[0] - 0.5
    kw = dict(method='kvaerno5', rtol=1e-8, atol=1e-10, event_fn=ev)

    def j_loss(y0_, lam):
        (_, ys), _ = j_per_sample(j_relax, y0_, np.array([0.0, 3.0]),
                                  args=(lam,), args_axes=(0,), **kw)
        return jnp.sum(ys[:, 1] ** 2)

    g_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(LAM_G))
    ps = [torch.from_numpy(x).requires_grad_() for x in (y0, LAM_G)]
    (_, ys), _ = tt.odeint_per_sample_with_stats(
        t_relax, ps[0], torch.tensor([0.0, 3.0], dtype=torch.float64),
        args=(ps[1],), args_axes=(0,), **kw)
    (ys[:, 1] ** 2).sum().backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9)


# ---- the other gradient modes ------------------------------------------------------

@pytest.mark.parametrize("method", ['dopri5', 'radau5a'])
def test_replay_gradients_match_jax(method):
    """``replay_grad``: each sample records and replays its own steps; the
    gradients JAX's to 1e-9 for dopri5, and for radau5a to the 1e-6 of
    tests/test_torch_replay.py's single solve (the Newton stops' bound it
    explains); each sample's equal to the port's own replay of it."""
    kw = dict(method=method, rtol=1e-6, atol=1e-8,
              options=dict(replay_grad=True))

    def j_loss(y0, lam):
        ys = j_per_sample(j_relax, y0, T3, args=(lam,), args_axes=(0,),
                          **kw)[0]
        return jnp.sum(ys * W3)

    g_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(Y0),
                                           jnp.asarray(LAM_G))
    ps = [torch.from_numpy(x).requires_grad_() for x in (Y0, LAM_G)]
    ys, st = tt.odeint_per_sample_with_stats(
        t_relax, ps[0], torch.from_numpy(T3), args=(ps[1],), args_axes=(0,),
        **kw)
    (ys * torch.from_numpy(W3)).sum().backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9 if method == 'dopri5' else 1e-6)
    assert len(set(st.n_steps.tolist())) > 1
    i = 3
    p_i = [torch.from_numpy(Y0[i]).requires_grad_(),
           torch.tensor(LAM_G[i], requires_grad=True)]
    ys_i = tt.odeint(t_relax, p_i[0], torch.from_numpy(T3), args=(p_i[1],),
                     **kw)
    (ys_i * torch.from_numpy(W3[i])).sum().backward()
    assert torch.equal(p_i[0].grad, ps[0].grad[i])
    assert torch.equal(p_i[1].grad, ps[1].grad[i])


@pytest.mark.parametrize("method", ['dopri5', 'kvaerno5'])
def test_forward_grad_tangents_match_jax(method):
    """``forward_grad``: tangents through the batched driver with (B,)
    tensor times (the stiff tier's stage solves carry their
    implicit-function tangents), against JAX's jvp of its vmap route: to
    y0, to the per-sample stiffness and to the output times."""
    kw = dict(method=method, rtol=1e-6, atol=1e-8,
              options=dict(forward_grad=True))
    dy0 = np.random.RandomState(5).randn(*Y0.shape)
    dlam = np.linspace(0.1, 0.4, 4)
    dt_ = np.array([0.0, 0.3, 0.5])

    def j_fn(y0, lam, t):
        return j_per_sample(j_relax, y0, t, args=(lam,), args_axes=(0,),
                            **kw)[0]

    _, tan_j = jax.jvp(j_fn, (jnp.asarray(Y0), jnp.asarray(LAM_G),
                              jnp.asarray(T3)),
                       (jnp.asarray(dy0), jnp.asarray(dlam),
                        jnp.asarray(dt_)))

    def t_fn(y0, lam, t):
        return tt.odeint_per_sample(t_relax, y0, t, args=(lam,),
                                    args_axes=(0,), **kw)

    _, tan_t = torch.func.jvp(t_fn, tuple(torch.from_numpy(x) for x in
                                          (Y0, LAM_G, T3)),
                              tuple(torch.from_numpy(x) for x in
                                    (dy0, dlam, dt_)))
    _assert_values(tan_t, tan_j, tol=1e-9)


# ---- callbacks, grids and events -----------------------------------------------------

class _Recorder:
    """A field with the three callbacks, recording (kind, t0, y0, dt) and
    keying each record by the sample's stiffness, which the callbacks see
    through the state's identity only: so the field carries it."""

    def __init__(self, jnp_mode=False):
        self.calls = []
        self.jnp_mode = jnp_mode

    def __call__(self, t, y):
        lam, yy = y[0], y[1:]
        d = (j_relax if self.jnp_mode else t_relax)(t, yy, lam)
        zero = 0.0 * lam
        return (jnp if self.jnp_mode else torch).concatenate(
            [zero.reshape(1), d])

    def _rec(self, kind):
        def cb(t0, y, dt):
            self.calls.append((kind, round(float(t0), 12),
                               round(float(y[0]), 12),
                               tuple(np.round(np.asarray(y[1:], np.float64),
                                              10).tolist()),
                               round(float(dt), 12)))
        return cb

    def callback_step(self, t0, y, dt):
        self._rec('step')(t0, y, dt)

    def callback_accept_step(self, t0, y, dt):
        self._rec('accept')(t0, y, dt)

    def callback_reject_step(self, t0, y, dt):
        self._rec('reject')(t0, y, dt)


def _by_sample(calls):
    out = {}
    for c in calls:
        out.setdefault(c[2], []).append(c)
    return out


@pytest.mark.parametrize("method,kw", [
    ('dopri5', dict(rtol=1e-5, atol=1e-7)),
    ('kvaerno5', dict(rtol=1e-5, atol=1e-7)),
    ('implicit_adams', dict(options=dict(num_steps=8)))])
def test_callbacks_fire_each_samples_own_steps(method, kw):
    """Each sample's callbacks get that sample's own values on its own
    steps, as its own solve (JAX's single solve of it) fires them: the
    records of the batch, split by sample, equal each sample's alone."""
    y0 = np.concatenate([LAM_G[:, None], Y0], axis=1)
    rec = _Recorder()
    tt.odeint_per_sample(rec, torch.from_numpy(y0), torch.from_numpy(T3),
                         method=method, **kw)
    got = _by_sample(rec.calls)
    assert len(got) == 4
    for i in range(4):
        own = _Recorder()
        tt.odeint(own, torch.from_numpy(y0[i]), torch.from_numpy(T3),
                  method=method, **kw)
        assert got[round(float(LAM_G[i]), 12)] == own.calls
        assert any(c[0] == 'step' for c in own.calls)


def test_callbacks_under_jax_vmap_fire_more_c9():
    """ROADMAP C9: JAX's vmap route runs its batched while_loop's body for
    every lane until the last finishes, and its accept/reject `lax.cond`
    on a batched predicate runs both branches, so each sample's callbacks
    fire on steps it never took and both of accept and reject fire on
    each; the port fires each sample's own (the test above).  Here JAX's
    records of the sample with the fewest steps hold more calls than its
    own single solve's."""
    y0 = np.concatenate([LAM_G[:, None], Y0], axis=1)
    kw = dict(rtol=1e-5, atol=1e-7)
    rec = _Recorder(jnp_mode=True)
    _, st = j_per_sample(rec, jnp.asarray(y0), T3, **kw)
    jax.effects_barrier()
    got = _by_sample(rec.calls)
    easy = int(np.argmin(np.asarray(st.n_steps)))
    lam = round(float(LAM_G[easy]), 12)
    kinds = [c[0] for c in got[lam]]
    n_max = int(np.max(np.asarray(st.n_steps)))
    assert kinds.count('step') == n_max > int(st.n_steps[easy])
    assert kinds.count('accept') == kinds.count('reject') == n_max
    rec_t = _Recorder()
    tt.odeint_per_sample(rec_t, torch.from_numpy(y0), torch.from_numpy(T3),
                         **kw)
    own = [c[0] for c in _by_sample(rec_t.calls)[lam]]
    assert own.count('step') == int(st.n_steps[easy])
    assert own.count('accept') + own.count('reject') == own.count('step')


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("method", ['rk4', 'implicit_adams', 'gl4'])
def test_grid_constructor_matches_jax(method, per_sample):
    """A ``grid_constructor`` JAX evaluates under vmap: a grid that does not
    depend on the state is every sample's (the batched sweep); one that
    does is each sample's own (each sample sweeps its own grid)."""
    def grid(n_of):
        def make(f, y0, t):
            lib = jnp if isinstance(y0, jnp.ndarray) else torch
            frac = lib.linspace(0.0, 1.0, 13, dtype=y0.dtype) ** 1.5
            if per_sample:
                frac = frac ** (1.0 + 0.2 * lib.abs(y0[0]))
            return t[0] + (t[-1] - t[0]) * frac
        return make

    kw = dict(method=method, options=dict(grid_constructor=grid(13)))
    (ys_j, st_j), (ys_t, st_t) = _both(own=True, **kw)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


def test_fixed_grid_event_gradient_matches_jax():
    """Gradients through a per-sample rk4 event solve: each sample's
    event-mode adjoint on its own grid back from its own event time, as
    JAX's vmap of its adjoint gives them."""
    def f_j(t, y, lam):
        return jnp.stack([y[1], -lam * y[0]])

    def f_t(t, y, lam):
        return torch.stack([y[1], -lam * y[0]])

    y0 = np.array([[1.0, 0.0], [1.0, 0.5], [2.0, 0.0]])
    lam = np.array([1.0, 2.0, 3.0])
    kw = dict(method='rk4', options=dict(step_size=0.05),
              event_fn=lambda t, y: y[0] - 0.5)
    t = np.array([0.0, 5.0])

    def j_loss(y0_, lam_):
        (_, ys), _ = j_per_sample(f_j, y0_, t, args=(lam_,), args_axes=(0,),
                                  **kw)
        return jnp.sum(ys[:, 1] ** 2)

    g_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(lam))
    ps = [torch.from_numpy(x).requires_grad_() for x in (y0, lam)]
    (_, ys), _ = tt.odeint_per_sample_with_stats(
        f_t, ps[0], torch.from_numpy(t), args=(ps[1],), args_axes=(0,), **kw)
    (ys[:, 1] ** 2).sum().backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9)


def test_scipy_solver_refused_by_both():
    """JAX's vmap route refuses the SciPy bridge (a pure_callback that
    vmap cannot batch); so does the port's, saying so."""
    with pytest.raises(NotImplementedError):
        j_per_sample(lambda t, y: -y, jnp.ones((2, 2)), T3,
                     method='scipy_solver')
    with pytest.raises(NotImplementedError, match="vmap route refuses"):
        tt.odeint_per_sample(lambda t, y: -y,
                             torch.ones(2, 2, dtype=torch.float64),
                             torch.from_numpy(T3), method='scipy_solver')


def test_complex_state_refused_naming_a2():
    """Formerly the refusal of complex states on the per-sample route; the
    driver now takes them (the name is kept): the relaxation with a complex
    state and a rotation, y' = -lam (y - cos t) + i y, per sample through
    kvaerno5 against JAX's vmap route, values to 1e-10 and every counter
    exactly."""
    y0 = Y0 + 0.5j * Y0[::-1]

    def j_f(t, y, lam):
        return j_relax(t, y, lam) + 1j * y

    def t_f(t, y, lam):
        return t_relax(t, y, lam) + 1j * y

    kw = dict(method='kvaerno5', rtol=1e-7, atol=1e-9)
    ys_j, st_j = jax.jit(lambda y, lam: j_per_sample(
        j_f, y, T3, args=(lam,), args_axes=(0,), **kw))(
        jnp.asarray(y0), jnp.asarray(LAM))
    with torch.no_grad():
        ys_t, st_t = tt.odeint_per_sample_with_stats(
            t_f, torch.from_numpy(y0), torch.from_numpy(T3),
            args=(torch.from_numpy(LAM),), args_axes=(0,), **kw)
    assert ys_t.dtype == torch.complex128
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


def test_integer_per_sample_arg_under_gradients():
    """A per-sample integer arg (a power per sample) beside a shared float
    one under gradients: the backward's field gets each sample's row of it,
    so every sample's gradients equal those of its own solve (JAX's
    adjoint refuses an integer arg under vmap: no JAX side here)."""
    k = np.array([1, 2, 3, 1])

    def f(t, y, kk, lam):
        return -lam * y ** kk

    y0 = np.abs(Y0) + 0.2
    kw = dict(rtol=1e-7, atol=1e-9)
    ps = [torch.from_numpy(y0).requires_grad_(),
          torch.tensor(0.7, dtype=torch.float64, requires_grad=True)]
    ys = tt.odeint_per_sample(f, ps[0], torch.from_numpy(T3),
                              args=(torch.from_numpy(k), ps[1]),
                              args_axes=(0, None), **kw)
    (ys * torch.from_numpy(W3)).sum().backward()
    g_lam = 0.0
    for i in range(4):
        y_i = torch.from_numpy(y0[i]).requires_grad_()
        lam = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        ys_i = tt.odeint(f, y_i, torch.from_numpy(T3),
                         args=(torch.tensor(k[i]), lam), **kw)
        (ys_i * torch.from_numpy(W3[i])).sum().backward()
        _assert_values(ps[0].grad[i], y_i.grad, tol=1e-12)
        g_lam += float(lam.grad)
    np.testing.assert_allclose(float(ps[1].grad), g_lam, rtol=1e-12)


@pytest.mark.parametrize("method,kw", [
    ('kvaerno5', dict(rtol=1e-6, atol=1e-8)),
    ('gl4', dict(options=dict(num_steps=10)))])
def test_tuple_state_matches_jax(method, kw):
    """A tuple state: each sample's leaves flattened into its row of the
    stage systems, values per leaf and counters as JAX's."""
    def j_f(t, y, lam):
        a, b = y
        return (-lam * (a - jnp.cos(t)), -lam * b[::-1] * 0.5)

    def t_f(t, y, lam):
        a, b = y
        return (-lam * (a - torch.cos(t)), -lam * b.flip(0) * 0.5)

    a0, b0 = Y0[:, :1], Y0[:, ::-1].copy()
    ys_j, st_j = _jax(T3, j_func=j_f, method=method, **kw)(
        (jnp.asarray(a0), jnp.asarray(b0)), jnp.asarray(LAM_G))
    ys_t, st_t = tt.odeint_per_sample_with_stats(
        t_f, (torch.from_numpy(a0), torch.from_numpy(b0)),
        torch.from_numpy(T3), args=(torch.from_numpy(LAM_G),),
        args_axes=(0,), method=method, **kw)
    for a, b in zip(ys_t, ys_j):
        _assert_values(a, b)
    _assert_stats(st_t, st_j)
