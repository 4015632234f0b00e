"""Pytree states (C19): dicts, nested tuples and lists and namedtuples,
through the port's own flattener (`misc.tree_flatten`, JAX's leaf order)
on every tier, both adjoints, events, dense output and the per-sample
route, against the JAX package (`ravel_pytree`) on the same numpy inputs
(CPU, float64).

Values agree to 1e-12 of their largest entry and the Stats counters
exactly; the result has the state's structure, each leaf in the shape and
dtype JAX's `unravel` gives it.  Gradients agree to 1e-9 of their largest
entry.  Mirrors tests/test_api.py::test_dict_state and
tests/test_tree_fixed.py::test_dict_state_fixed_grid."""
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
from torchdiffeq_tpu.parallel import (odeint_per_sample_with_stats as
                                      j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.misc import tree_flatten, tree_leaves
from torchdiffeq_tpu_torch.parallel import odeint_per_sample_with_stats

VAL, GRAD = 1e-12, 1e-9


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


def _j(tree):
    """A port tree (or numpy tree) as JAX arrays."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(
        x.detach() if isinstance(x, torch.Tensor) else x)), tree)


def tt_tree(tree, grad=False):
    """A numpy tree as float64 tensors."""
    return jax.tree_util.tree_map(lambda x: _t(x, grad), tree)


def tree_map_grad(tree):
    return jax.tree_util.tree_map(lambda x: x.grad, tree)


def _same_tree(got, want, rel):
    """Same structure, leaf shapes and dtypes as JAX's, values to `rel` of
    the largest leaf entry."""
    g_leaves, _ = tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    assert len(g_leaves) == len(w_leaves)
    assert str(jax.tree_util.tree_structure(_j(got))) == str(w_def)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split('.')[-1] == str(w.dtype)
        err = float(np.abs(g.detach().numpy().astype(np.float64)
                           - w.astype(np.float64)).max())
        assert err <= rel * scale, (err, scale)


def _counters(st):
    return [int(x) for x in st[:5]]


# tests/test_api.py::test_dict_state's problem
def _f_nested(t, y):
    return {'a': -y['a'], 'b': {'c': 2.0 * y['b']['c']}}


Y0_NESTED = {'a': np.array([1.0]), 'b': {'c': np.array([1.0, 1.0])}}

METHODS = [('dopri5', None), ('tsit5', None), ('kvaerno5', None),
           ('radau5a', None), ('rk4', dict(step_size=0.05)),
           ('euler', dict(step_size=0.05)),
           ('explicit_adams', dict(step_size=0.05)),
           ('implicit_adams', dict(step_size=0.05)),
           ('radauIIA5', dict(step_size=0.1)),
           ('trbdf2', dict(step_size=0.1))]


@pytest.mark.parametrize("method,options", METHODS)
def test_dict_state_matches_jax(method, options):
    """test_api.py:37's nested dict on every tier: values and Stats."""
    t = np.linspace(0.0, 1.0, 3)
    kw = dict(rtol=1e-10, atol=1e-12, method=method, options=options)
    ys_j, st_j = tde.odeint_with_stats(_f_nested, _j(Y0_NESTED),
                                       jnp.asarray(t), **kw)
    ys, st = tt.odeint_with_stats(_f_nested, tt_tree(Y0_NESTED), _t(t), **kw)
    assert isinstance(ys, dict) and isinstance(ys['b'], dict)
    _same_tree(ys, ys_j, VAL)
    assert _counters(st) == _counters(st_j)
    if method == 'dopri5':
        np.testing.assert_allclose(float(ys['a'][-1, 0]), np.exp(-1),
                                   rtol=1e-8)


def test_dict_state_fixed_grid():
    """tests/test_tree_fixed.py:66: rk4 on a dict with leaves of two
    shapes."""
    t = np.linspace(0.0, 2.0, 5)
    y0 = {'a': np.array([1.0]), 'b': np.array([[2.0, 4.0]])}
    kw = dict(method='rk4', options=dict(step_size=0.05))
    ys_j, st_j = tde.odeint_with_stats(
        lambda s, y: {'a': -y['a'], 'b': -2.0 * y['b']}, _j(y0),
        jnp.asarray(t), **kw)
    ys, st = tt.odeint_with_stats(
        lambda s, y: {'a': -y['a'], 'b': -2.0 * y['b']}, tt_tree(y0), _t(t),
        **kw)
    assert ys['a'].shape == (5, 1) and ys['b'].shape == (5, 1, 2)
    assert float(torch.abs(ys['a'][-1, 0] - np.exp(-2.0))) < 1e-6
    _same_tree(ys, ys_j, VAL)
    assert _counters(st) == _counters(st_j)


Pair = namedtuple('Pair', ['pos', 'vel'])


@pytest.mark.parametrize("kind", ['nested_tuple', 'list_in_dict',
                                  'namedtuple'])
def test_nested_containers_match_jax(kind):
    """Nested tuples, a list inside a dict and a namedtuple: the leaf order
    and the structure JAX's flattening gives them."""
    rng = np.random.RandomState(1)
    a, b, c = rng.randn(2), rng.randn(3), rng.randn(1, 2)
    if kind == 'nested_tuple':
        y0 = ((a, b), c)
        f = lambda s, y, m: ((-y[0][0], m * y[0][1]), -y[1] * s)  # noqa
    elif kind == 'list_in_dict':
        y0 = {'z': [a, b], 'x': c}
        f = lambda s, y, m: {'z': [-y['z'][0], m * y['z'][1]],  # noqa
                             'x': -y['x'] * s}
    else:
        y0 = Pair(a, b)
        f = lambda s, y, m: Pair(y.vel[:2] * m, -y.pos.sum() * y.vel)  # noqa
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(rtol=1e-9, atol=1e-11)
    ys_j, st_j = tde.odeint_with_stats(
        lambda s, y: f(s, y, jnp.cos(s)), _j(y0), jnp.asarray(t), **kw)
    ys, st = tt.odeint_with_stats(lambda s, y: f(s, y, torch.cos(s)),
                                  tt_tree(y0), _t(t), **kw)
    assert type(ys) is type(y0)
    _same_tree(ys, ys_j, VAL)
    assert _counters(st) == _counters(st_j)


@pytest.mark.parametrize("method,options", [
    ('dopri5', None), ('implicit_adams', dict(step_size=0.1))])
def test_mixed_dtype_leaves_come_back_in_their_dtypes(method, options):
    """A float32 leaf beside a float64 one: the flat state is float64, the
    field sees each leaf in its own dtype, and the result gives it back in
    it, as JAX's `unravel` does.  JAX's explicit tiers run such a state
    tree-native, the float32 leaf's arithmetic in float32, where the port's
    flat state rounds it in float64 (C21): values agree to the float32
    leaf's precision."""
    y0 = {'b': np.array([1.0], np.float32), 'a': np.array([2.0, 3.0])}
    seen = []

    def f(s, y):
        seen.append((y['a'].dtype, y['b'].dtype))
        return {'a': -y['a'], 'b': -2.0 * y['b']}

    t = np.linspace(0.0, 1.0, 3)
    kw = dict(method=method, options=options)
    ys_j, st_j = tde.odeint_with_stats(f, _j(y0), jnp.asarray(t), **kw)
    y0_t = {k: torch.from_numpy(v) for k, v in y0.items()}
    seen.clear()
    ys, st = tt.odeint_with_stats(f, y0_t, _t(t), **kw)
    assert set(seen) == {(torch.float64, torch.float32)}
    assert ys['b'].dtype == torch.float32 and ys['a'].dtype == torch.float64
    _same_tree(ys, ys_j, 2e-6)
    assert _counters(st) == _counters(st_j)


def test_per_leaf_tolerances_as_a_tree():
    """Per-leaf rtol/atol given as a tree of the state's structure follow
    its leaves: the same solve as JAX's per-leaf sequence in leaf order,
    and as the port's own sequence."""
    t = np.linspace(0.0, 2.0, 3)
    rtol = {'a': 1e-4, 'b': {'c': 1e-9}}
    atol = {'a': 1e-6, 'b': {'c': 1e-11}}
    ys_j, st_j = tde.odeint_with_stats(_f_nested, _j(Y0_NESTED),
                                       jnp.asarray(t), rtol=[1e-4, 1e-9],
                                       atol=[1e-6, 1e-11])
    ys, st = tt.odeint_with_stats(_f_nested, tt_tree(Y0_NESTED), _t(t),
                                  rtol=rtol, atol=atol)
    ys_l, st_l = tt.odeint_with_stats(_f_nested, tt_tree(Y0_NESTED), _t(t),
                                      rtol=[1e-4, 1e-9], atol=[1e-6, 1e-11])
    _same_tree(ys, ys_j, VAL)
    assert _counters(st) == _counters(st_j) == _counters(st_l)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(ys),
                                                 tree_leaves(ys_l)))
    with pytest.raises(ValueError, match="per-leaf rtol"):
        tt.odeint(_f_nested, tt_tree(Y0_NESTED), _t(t), rtol=[1e-4])
    with pytest.raises(ValueError, match="state's structure"):
        tt.odeint(_f_nested, tt_tree(Y0_NESTED), _t(t),
                  rtol={'a': 1e-4, 'c': 1e-9})


def _f_param(s, y, w):
    return {'a': -w * y['a'], 'b': {'c': w * y['b']['c'] * y['a'][:1]}}


@pytest.mark.parametrize("interpolated", [False, True])
def test_dict_state_adjoint_matches_jax(interpolated):
    """A nested dict through `odeint_adjoint` (the continuous and the
    interpolated adjoint): gradients in the parameter and in every leaf of
    y0."""
    t = np.linspace(0.0, 1.0, 4)
    y0 = {'a': np.array([1.0, 0.4]), 'b': {'c': np.array([1.0, 2.0])}}
    kw = dict(rtol=1e-9, atol=1e-11,
              adjoint_options=dict(interpolated=True) if interpolated
              else None)

    def j_loss(w, y0_):
        ys = tde.odeint_adjoint(_f_param, y0_, jnp.asarray(t), args=(w,),
                                **kw)
        return jnp.sum(ys['a'][-1] ** 2) + jnp.sum(ys['b']['c'][-2])

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(0.7, _j(y0))
    w, y0_t = _t(0.7, True), tt_tree(y0, True)
    ys = tt.odeint_adjoint(_f_param, y0_t, _t(t), args=(w,), **kw)
    assert isinstance(ys['b'], dict)
    ((ys['a'][-1] ** 2).sum() + ys['b']['c'][-2].sum()).backward()
    _same_tree(w.grad, g_j[0], GRAD)
    _same_tree(tree_map_grad(y0_t), g_j[1], GRAD)


def test_dict_state_event_matches_jax():
    """`odeint_event` on a nested dict: the event time, the state at it in
    the state's structure, and the event time's gradient in a y0 leaf."""
    y0 = {'a': np.array([1.0]), 'b': {'c': np.array([0.5, 2.0])}}
    ev = lambda s, y: y['a'][0] - 0.3 * y['b']['c'][0]  # noqa: E731
    kw = dict(rtol=1e-10, atol=1e-12)

    def j_et(a0):
        et, _ = tde.odeint_event(_f_nested, dict(a=a0, b=_j(y0['b'])), 0.0,
                                 event_fn=ev, **kw)
        return et

    et_j, sol_j = tde.odeint_event(_f_nested, _j(y0), 0.0, event_fn=ev, **kw)
    g_j = jax.grad(j_et)(jnp.asarray(y0['a']))
    y0_t = tt_tree(y0)
    y0_t['a'].requires_grad_(True)
    et, sol = tt.odeint_event(_f_nested, y0_t, 0.0, event_fn=ev, **kw)
    np.testing.assert_allclose(float(et), float(et_j), rtol=VAL)
    _same_tree(sol, sol_j, VAL)
    (g,) = torch.autograd.grad(et, y0_t['a'])
    _same_tree(g, g_j, GRAD)


def test_dict_state_dense_matches_jax():
    """`odeint_dense` on a nested dict: values, derivatives and
    `find_event` in the state's structure."""
    kw = dict(rtol=1e-9, atol=1e-11)
    sol_j = tde.odeint_dense(_f_nested, _j(Y0_NESTED), 0.0, 1.0, **kw)
    with torch.no_grad():
        sol = tt.odeint_dense(_f_nested, tt_tree(Y0_NESTED), 0.0, 1.0, **kw)
    q = np.array([0.1, 0.45, 0.9])
    _same_tree(sol(_t(q)), sol_j(jnp.asarray(q)), VAL)
    _same_tree(sol.derivative(0.3), sol_j.derivative(0.3), VAL)
    ev = lambda s, y: y['b']['c'][1] - 4.0  # noqa: E731
    et_j, y_j = sol_j.find_event(ev, tol=1e-13)
    et, y = sol.find_event(ev, tol=1e-13)
    np.testing.assert_allclose(float(et), float(et_j), rtol=VAL)
    _same_tree(y, y_j, VAL)


def test_dict_state_per_sample_matches_jax():
    """The per-sample route (the batched driver) on a dict state with a
    leading batch axis: values and every per-sample counter against JAX's
    vmap route."""
    rng = np.random.RandomState(2)
    y0 = {'a': rng.rand(4, 1) + 0.5, 'b': {'c': rng.randn(4, 2)}}
    k = np.array([0.5, 1.0, 4.0, 30.0])
    f = lambda s, y, kk: {'a': -kk * y['a'] ** 2,  # noqa: E731
                          'b': {'c': -y['b']['c'] * y['a']}}
    t = np.linspace(0.0, 1.0, 3)
    kw = dict(rtol=1e-9, atol=1e-11)
    ys_j, st_j = jax.jit(lambda y, kk: j_per_sample(
        f, y, jnp.asarray(t), args=(kk,), args_axes=(0,), **kw))(
        _j(y0), jnp.asarray(k))
    with torch.no_grad():
        ys, st = odeint_per_sample_with_stats(f, tt_tree(y0), _t(t),
                                              args=(_t(k),),
                                              args_axes=(0,), **kw)
    _same_tree(ys, ys_j, VAL)
    for name in ('nfe', 'n_steps', 'n_accepted', 'n_rejected',
                 'error_code'):
        assert getattr(st, name).tolist() == \
            np.asarray(getattr(st_j, name)).tolist(), name


def test_dict_state_per_sample_gradient_matches_jax():
    """Each sample's adjoint on a dict state: the gradients in a shared
    parameter and in y0's leaves."""
    rng = np.random.RandomState(5)
    y0 = {'a': rng.rand(3, 2) + 0.5, 'b': rng.randn(3, 1)}
    f = lambda s, y, w: {'a': -w * y['a'], 'b': y['a'][:1] * w}  # noqa
    t = np.linspace(0.0, 1.0, 3)
    kw = dict(rtol=1e-9, atol=1e-11)

    def j_loss(w, y0_):
        ys, _ = j_per_sample(f, y0_, jnp.asarray(t), args=(w,), **kw)
        return jnp.sum(ys['a'][:, -1] ** 2) + jnp.sum(ys['b'])

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(0.9, _j(y0))
    w, y0_t = _t(0.9, True), tt_tree(y0, True)
    ys, _ = odeint_per_sample_with_stats(f, y0_t, _t(t), args=(w,), **kw)
    ((ys['a'][:, -1] ** 2).sum() + ys['b'].sum()).backward()
    _same_tree(w.grad, g_j[0], GRAD)
    _same_tree(tree_map_grad(y0_t), g_j[1], GRAD)


def test_dict_state_callbacks_see_the_structure():
    """A field's callbacks get the state in its structure."""
    seen = []

    class F:
        def __call__(self, s, y):
            return _f_nested(s, y)

        def callback_step(self, t0, y, dt):
            seen.append(type(y['b']))

    tt.odeint(F(), tt_tree(Y0_NESTED), _t([0.0, 0.5]), method='rk4',
              options=dict(step_size=0.25))
    assert seen == [dict, dict]
