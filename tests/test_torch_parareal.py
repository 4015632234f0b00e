"""The port's Parareal (`torchdiffeq_tpu_torch.parallel.odeint_parareal`)
and its fine sweep, the per-sample-span driver
(`parallel.batched.odeint_spans_with_stats`), against the JAX package's
`torchdiffeq_tpu.parallel.odeint_parareal(_with_info)` and
``jax.vmap(odeint_with_stats)`` on the same numpy inputs, in float64;
mirrors tests/test_parareal.py.

Bounds: values to 1e-10 of max|y| (finite termination: JAX's own bound
against the sequential chain); the correction norms JAX puts above 1e-12
to 1e-8 relative (below that they are rounding noise of a converged
iterate), with an absolute floor of 1e-13 of max|y|: a norm is a
difference of two iterates, each of which the two packages' adaptive
solves round to about 2e-14 of max|y| apart, which at a norm of 1e-10 is
1e-4 of it; gradients in y0, an args matrix, an ``nn.Module`` field's
parameters and `t` to 1e-9 of max|g|; the span driver's values to 1e-12 of max|y| for dopri5 and 1e-10 for kvaerno5 (its
Newton iterations round in another order, as in
tests/test_torch_per_sample_implicit.py), with every counter exact.

JAX's `test_mesh_execution_matches_vmap` (the slices sharded over a device
mesh) has no counterpart until the port's sharding slice (ROADMAP queue
A): here a mesh raises `NotImplementedError`.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
from torchdiffeq_tpu.models.neural_ode import spiral_field as j_spiral
from torchdiffeq_tpu.parallel import (odeint_parareal as j_parareal,
                                      odeint_parareal_with_info as j_info)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import mlp_params_from_jax
from torchdiffeq_tpu_torch.parallel import (odeint_parareal,
                                            odeint_parareal_with_info)
from torchdiffeq_tpu_torch.parallel.batched import odeint_spans_with_stats
from torchdiffeq_tpu_torch.solvers import batched_rk
from test_torch_examples import one_thread  # noqa: F401 (autouse)

A = np.array([[-0.5, 2.0], [-2.0, -0.5]])


def j_stiffish(tt_, yy):
    return jnp.stack([-0.5 * yy[0] + 2.0 * yy[1],
                      -2.0 * yy[0] - 0.5 * yy[1]])


def t_stiffish(tt_, yy):
    return torch.stack([-0.5 * yy[0] + 2.0 * yy[1],
                        -2.0 * yy[0] - 0.5 * yy[1]])


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=grad)


def test_finite_termination_matches_jax_and_the_chain():
    """n_iters = T-1 reproduces the slice-restarted sequential fine chain
    (JAX's oracle) and JAX's Parareal."""
    y0, t = np.array([1.0, 0.3]), np.linspace(0., 4., 9)
    kw = dict(rtol=1e-8, atol=1e-10, n_iters=8, coarse_num_steps=1)
    ys = odeint_parareal(t_stiffish, _t(y0), _t(t), **kw)
    ys_j = jax.jit(lambda y: j_parareal(j_stiffish, y, jnp.asarray(t),
                                        **kw))(jnp.asarray(y0))
    _close(ys, ys_j, 1e-10)
    u, chain = _t(y0), [_t(y0)]
    for s in range(8):
        u = tt.odeint(t_stiffish, u, _t(t[s:s + 2]), rtol=1e-8,
                      atol=1e-10)[-1]
        chain.append(u)
    _close(ys, torch.stack(chain), 1e-10)


def test_correction_decay_matches_jax():
    """The correction norms decay monotonically and equal JAX's; a few
    iterations reach tolerance-level accuracy."""
    y0, t = np.array([0.7]), np.linspace(0., 6., 13)
    kw = dict(rtol=1e-8, atol=1e-10, n_iters=5, coarse_num_steps=2)
    ys, deltas = odeint_parareal_with_info(
        lambda s, y: torch.sin(s) - 0.8 * y, _t(y0), _t(t), **kw)
    ys_j, d_j = jax.jit(lambda y: j_info(
        lambda s, yy: jnp.sin(s) - 0.8 * yy, y, jnp.asarray(t),
        **kw))(jnp.asarray(y0))
    d, d_j = _np(deltas), np.asarray(d_j)
    assert deltas.shape == (5,) and (np.diff(d) <= 1e-12).all(), d
    big = d_j > 1e-12
    np.testing.assert_allclose(d[big], d_j[big], rtol=1e-8,
                               atol=1e-13 * np.abs(np.asarray(ys_j)).max())
    _close(ys, ys_j, 1e-10)
    seq = tt.odeint(lambda s, y: torch.sin(s) - 0.8 * y, _t(y0), _t(t),
                    rtol=1e-8, atol=1e-10)
    _close(ys, seq, 1e-6)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["forward", "reversed"])
def test_gradients_match_jax(sign):
    """Gradients in y0, an args matrix and t through the whole scheme (each
    slice's adjoint and the coarse sweeps), forward and reversed time."""
    y0, t = np.array([1.0, 0.3]), sign * np.linspace(0., 2., 5)
    kw = dict(rtol=1e-9, atol=1e-11, n_iters=4)

    def j_loss(y, a, tt_):
        ys = j_parareal(lambda s, yy, a_: yy @ a_.T, y, tt_, args=(a,), **kw)
        return jnp.sum(ys[-1] ** 2), ys

    (_, ys_j), g_j = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(y0), jnp.asarray(A), jnp.asarray(t))
    ins = [_t(y0, True), _t(A, True), _t(t, True)]
    ys = odeint_parareal(lambda s, yy, a_: yy @ a_.T, ins[0], ins[2],
                         args=(ins[1],), **kw)
    (ys[-1] ** 2).sum().backward()
    _close(ys, ys_j, 1e-10)
    for x, g in zip(ins, g_j):
        _close(x.grad, g, 1e-9)


def test_module_field_parameter_gradients_match_jax():
    """An `MLPField` (the spiral's, B=8 trajectories as one state): the
    gradients reach its parameters."""
    rng = np.random.RandomState(3)
    params = [dict(w=rng.randn(2, 16) * 0.3, b=rng.randn(16) * 0.1),
              dict(w=rng.randn(16, 2) * 0.3, b=rng.randn(2) * 0.1)]
    y0, t = rng.randn(8, 2) * 0.8, np.linspace(0., 1., 3)
    kw = dict(rtol=1e-9, atol=1e-11, n_iters=1)

    def j_loss(p):
        ys = j_parareal(lambda s, yy, pp: j_spiral(pp, s, yy),
                        jnp.asarray(y0), jnp.asarray(t), args=(p,), **kw)
        return jnp.sum(ys[-1] ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    g_j = jax.jit(jax.grad(j_loss))(jp)
    model = mlp_params_from_jax(params, power=3, device='cpu')
    ys = odeint_parareal(model, _t(y0), _t(t), **kw)
    (ys[-1] ** 2).sum().backward()
    for p, g in zip([model.weights[0], model.biases[0], model.weights[1],
                     model.biases[1]],
                    [g_j[0]['w'], g_j[0]['b'], g_j[1]['w'], g_j[1]['b']]):
        _close(p.grad, g, 1e-9)


def test_tuple_state_matches_jax_dict():
    """A tuple state, the port's form of JAX's dict state, through the
    flattening."""
    t = np.linspace(0., 1., 5)
    kw = dict(rtol=1e-8, atol=1e-10, n_iters=4)
    ys = odeint_parareal(lambda s, y: (-y[0], -2.0 * y[1]),
                         (_t([1.0]), _t([2.0, 3.0])), _t(t), **kw)
    ys_j = j_parareal(lambda s, y: dict(a=-y['a'], b=-2.0 * y['b']),
                      dict(a=jnp.array([1.0]), b=jnp.array([2.0, 3.0])),
                      jnp.asarray(t), **kw)
    assert isinstance(ys, tuple) and ys[0].shape == (5, 1)
    _close(ys[0], ys_j['a'], 1e-10)
    _close(ys[1], ys_j['b'], 1e-10)
    np.testing.assert_allclose(_np(ys[0][-1, 0]), np.exp(-1.0), rtol=1e-6)


def test_dict_state_matches_jax_dict():
    """JAX's dict state itself (and a nested one), through the flattening:
    the structure back, each leaf to 1e-10 of JAX's."""
    t = np.linspace(0., 1., 5)
    kw = dict(rtol=1e-8, atol=1e-10, n_iters=4)
    f = lambda s, y: dict(a=-y['a'], b=dict(c=-2.0 * y['b']['c']))  # noqa
    y0 = dict(a=np.array([1.0]), b=dict(c=np.array([2.0, 3.0])))
    ys = odeint_parareal(f, jax.tree_util.tree_map(_t, y0), _t(t), **kw)
    ys_j = j_parareal(f, jax.tree_util.tree_map(jnp.asarray, y0),
                      jnp.asarray(t), **kw)
    assert isinstance(ys['b'], dict) and ys['b']['c'].shape == (5, 2)
    _close(ys['a'], ys_j['a'], 1e-10)
    _close(ys['b']['c'], ys_j['b']['c'], 1e-10)


def test_input_validation_and_mesh():
    f = lambda s, y: -y   # noqa: E731
    for fn in (odeint_parareal, j_parareal):
        with pytest.raises(ValueError):
            fn(f, np.ones(1), np.array([0.]), n_iters=2)
        with pytest.raises(ValueError):
            fn(f, np.ones(1), np.linspace(0., 1., 4), n_iters=0)
    # the mesh is a `parallel.Mesh` of ranks (tests/test_torch_sharding.py
    # runs it); a dict is not one
    with pytest.raises(TypeError, match="make_mesh"):
        odeint_parareal(f, _t([1.0]), _t(np.linspace(0., 1., 5)),
                        n_iters=1, mesh={'time': 4}, axis='time')


def _lane_field(s, y, a):
    return torch.tanh(y @ a.T) + torch.sin(s)


@pytest.mark.parametrize("method,tol", [("dopri5", 1e-12),
                                        ("kvaerno5", 1e-10)])
def test_span_driver_matches_jax_vmap(method, tol):
    """S lanes, each over its own (t0, t1), against JAX's vmap of
    `odeint_with_stats` over per-lane times: values, and every counter per
    lane exactly; one batched sweep (the driver's iterations are the
    longest lane's steps, not their sum)."""
    S = 5
    y0 = np.random.RandomState(0).randn(S, 2)
    grid = np.linspace(0., 4., S + 1)
    spans = np.stack([grid[:-1], grid[1:]], 1)
    kw = dict(rtol=1e-8, atol=1e-10, method=method)
    ys_j, st_j = jax.jit(jax.vmap(lambda y, s: tde.odeint_with_stats(
        lambda tt_, yy, a: jnp.tanh(yy @ a.T) + jnp.sin(tt_), y, s,
        args=(jnp.asarray(A),), **kw)))(jnp.asarray(y0), jnp.asarray(spans))
    batched_rk.reset_lane_counts()
    ys, st = odeint_spans_with_stats(_lane_field, _t(y0), _t(spans),
                                     args=(_t(A),), **kw)
    _close(ys, ys_j, tol)
    for a, b in zip(st[:5], st_j[:5]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert batched_rk.LANE_COUNTS['iterations'] == int(st.n_steps.max())
    assert int(st.n_steps.sum()) > int(st.n_steps.max())


def test_span_driver_gradients_equal_each_lanes_solve():
    """Each lane's adjoint over its own span: the gradients in y0, the
    shared args matrix and each lane's two times equal the port's own
    solves of the lanes one by one."""
    S = 4
    y0 = np.random.RandomState(1).randn(S, 2)
    grid = -np.linspace(0., 3., S + 1)          # reversed time
    spans = np.stack([grid[:-1], grid[1:]], 1)
    kw = dict(rtol=1e-8, atol=1e-10)
    ins = [_t(y0, True), _t(A, True), _t(spans, True)]
    ys, _ = odeint_spans_with_stats(_lane_field, ins[0], ins[2],
                                    args=(ins[1],), **kw)
    (ys[:, -1] ** 2).sum().backward()
    got = [x.grad.clone() for x in ins]
    for x in ins:
        x.grad = None
    total = sum((tt.odeint(_lane_field, ins[0][b], ins[2][b],
                           args=(ins[1],), **kw)[-1] ** 2).sum()
                for b in range(S))
    total.backward()
    for g, x in zip(got, ins):
        _close(g, x.grad, 1e-12)


def test_fine_sweep_is_one_batched_solve_and_coarse_runs_once_a_slice(
        monkeypatch):
    """Each iteration's fine sweep is one batched solve of the S slices
    (the driver's iteration count is the sum over iterations of the
    longest slice's steps), and the coarse propagator runs once a slice an
    iteration (JAX's reuse): S * (n_iters + 1) rk4 solves of
    coarse_num_steps steps, 4 evaluations each."""
    odeint_mod = sys.modules['torchdiffeq_tpu_torch.odeint']
    coarse = dict(calls=0, nfe=0)

    def counted(*a, **k):
        ys, st = odeint_mod.odeint_with_stats(*a, **k)
        coarse['calls'] += 1
        coarse['nfe'] += int(st.nfe)
        return ys

    monkeypatch.setattr(odeint_mod, 'odeint', counted)
    spans_calls = []
    import torchdiffeq_tpu_torch.parallel.parareal as par
    real_spans = par.odeint_spans_with_stats

    def spans(*a, **k):
        before = batched_rk.LANE_COUNTS['iterations']
        ys, st = real_spans(*a, **k)
        spans_calls.append((batched_rk.LANE_COUNTS['iterations'] - before,
                            int(st.n_steps.max()), int(st.n_steps.sum())))
        return ys, st

    monkeypatch.setattr(par, 'odeint_spans_with_stats', spans)
    S, n_iters, k = 6, 3, 2
    odeint_parareal(t_stiffish, _t([1.0, 0.3]),
                    _t(np.linspace(0., 3., S + 1)), rtol=1e-8, atol=1e-10,
                    n_iters=n_iters, coarse_num_steps=k)
    assert coarse['calls'] == S * (n_iters + 1)
    assert coarse['nfe'] == S * (n_iters + 1) * 4 * k
    assert len(spans_calls) == n_iters
    for iters, longest, total in spans_calls:
        assert iters == longest < total
