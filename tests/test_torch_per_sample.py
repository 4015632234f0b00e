"""The port's per-sample batched driver (`parallel/batched.py` off the
kernel route, `solvers/batched_rk.py`) against the JAX package's vmap route
(`torchdiffeq_tpu.parallel.odeint_per_sample_with_stats` without
``pallas``), on the same numpy inputs, in float64; mirrors the per-sample
cases of tests/test_pallas.py:92-390 and tests/test_sharding.py:167-200.

Bounds: values to 1e-12 of max|y|; every `Stats` counter exactly, per
sample; gradients to 1e-9 of max|g|.  `final_dt` is held to the port's own
solve of each sample to 1e-9 and to JAX's to 1e-6: the last step is cut
short at the end of the span, so its error estimate is rounding noise,
whose last bits the field's own arithmetic sets (a vmapped matrix product
rounds as a batched one, not as one sample's), and the port's single
solve already departs from JAX's there by up to 5e-7 (with the PI
controller), while every decision agrees.

Most cases also hold samples of the batch against the port's own
`odeint_with_stats` of that sample alone (values to 1e-12, counters
exactly, `final_dt` as above), which checks the masking without JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import mlp_params_from_jax
from torchdiffeq_tpu_torch.solvers import batched_rk
from torchdiffeq_tpu_torch.solvers.solution import ERR_MAX_NUM_STEPS

A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
T4 = np.linspace(0.0, 1.0, 4)


def _y0(B=12, seed=0):
    return np.random.RandomState(seed).randn(B, 2) * 0.8


def j_cubic(t, y, a):
    return (y ** 3) @ a


def t_cubic(t, y, a):
    return (y ** 3) @ a


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _assert_values(got, want, tol=1e-12):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = max(np.nanmax(np.abs(want)), 1e-300)
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=tol * scale)


def _assert_stats(st_t, st_j, final_dt_rtol=1e-6):
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_allclose(_np(st_t.final_dt), np.asarray(st_j.final_dt),
                               rtol=final_dt_rtol)


def _own(func, y0, t, args=(), axes=None, **kw):
    """The port's driver against the port's own solve of a sample alone:
    the first, the middle and the last of the batch."""
    ys, st = tt.odeint_per_sample_with_stats(func, y0, t, args=args,
                                             args_axes=axes, **kw)
    leaves = y0 if isinstance(y0, tuple) else (y0,)
    axes = axes or (None,) * len(args)
    B = leaves[0].shape[0]
    for i in sorted({0, B // 2, B - 1}):
        args_i = tuple(a if ax is None else a.select(ax, i)
                       for a, ax in zip(args, axes))
        y0_i = (tuple(x[i] for x in y0) if isinstance(y0, tuple) else y0[i])
        ys_i, st_i = tt.odeint_with_stats(func, y0_i, t, args=args_i, **kw)
        if isinstance(ys, tuple):
            for a, b in zip(ys, ys_i):
                _assert_values(a[i], b)
        elif kw.get('event_fn') is not None:
            _assert_values(ys[0][i], ys_i[0])
            _assert_values(ys[1][i], ys_i[1])
        else:
            _assert_values(ys[i], ys_i)
        assert [int(x[i]) for x in st[:5]] == [int(x) for x in st_i[:5]]
        np.testing.assert_allclose(float(st.final_dt[i]),
                                   float(st_i.final_dt), rtol=1e-9)
    return ys, st


def _jit(j_func, t, axes=None, **kw):
    """JAX's vmap route under `jax.jit` (one compile, a fraction of the
    eager route's per-operation ones), with the output times a concrete
    numpy array, as the fixed grid needs them."""
    return jax.jit(lambda y0, *args: j_per_sample(
        j_func, y0, t, args=args, args_axes=axes, **kw))


def _both(y0, t, *, args=(), axes=None, j_func=j_cubic, t_func=t_cubic,
          own=True, **kw):
    """JAX's vmap route and the port's driver on the same inputs; the
    port's rows also against its own solves."""
    ys_j, st_j = _jit(j_func, t, axes, **kw)(
        jnp.asarray(y0), *(jnp.asarray(a) for a in args))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    ty0, tt_ = torch.from_numpy(y0), torch.from_numpy(t)
    if own:
        ys_t, st_t = _own(t_func, ty0, tt_, targs, axes, **kw)
    else:
        ys_t, st_t = tt.odeint_per_sample_with_stats(
            t_func, ty0, tt_, args=targs, args_axes=axes, **kw)
    return (ys_j, st_j), (ys_t, st_t)


# ---- the adaptive tier ---------------------------------------------------------

@pytest.mark.parametrize("method,tol", [
    ('dopri5', 1e-7), ('tsit5', 1e-7), ('bosh3', 1e-5), ('fehlberg2', 1e-4),
    ('adaptive_heun', 1e-3)])
def test_adaptive_methods_match_jax(method, tol):
    """FSAL (dopri5, bosh3) and non-FSAL (tsit5, fehlberg2, adaptive_heun)
    tableaus, each sample with its own controller."""
    y0 = _y0()
    (ys_j, st_j), (ys_t, st_t) = _both(y0, T4, args=(A,), method=method,
                                       rtol=tol, atol=tol * 1e-2)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    # the samples really differ in their step sequences
    assert len(set(st_t.n_steps.tolist())) > 1


@pytest.mark.parametrize("options", [
    dict(controller='pi'), dict(controller='pid', dcoeff=0.2),
    dict(first_step=0.01, step_t=[0.3]), dict(jump_t=[0.55], max_step=0.2),
    dict(step_to_end=True, safety=0.8, ifactor=5.0, dfactor=0.3)],
    ids=['pi', 'pid', 'first_step-step_t', 'jump_t-max_step',
         'step_to_end'])
def test_controllers_and_options_match_jax(options):
    y0 = _y0()
    (ys_j, st_j), (ys_t, st_t) = _both(y0, T4, args=(A,), rtol=1e-7,
                                       atol=1e-9, options=options)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


def test_max_num_steps_reached_by_one_sample_only():
    """A fast sample exhausts `max_num_steps` in an output interval: its
    error code is set and its unwritten outputs are NaN; the other samples
    are unaffected (their rows equal a solve with no budget)."""
    y0 = _y0(6)
    y0[2] = [2.5, -2.0]                   # |y|^2 sets the speed
    opts = dict(max_num_steps=40)
    (ys_j, st_j), (ys_t, st_t) = _both(y0, T4, args=(A,), rtol=1e-7,
                                       atol=1e-9, options=opts)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    codes = st_t.error_code.numpy()
    assert codes[2] == ERR_MAX_NUM_STEPS and (np.delete(codes, 2) == 0).all()
    assert torch.isnan(ys_t[2, -1]).all() and not torch.isnan(ys_t[2, 0]).any()
    free, _ = tt.odeint_per_sample_with_stats(
        t_cubic, torch.from_numpy(y0), torch.from_numpy(T4),
        args=(torch.from_numpy(A),), rtol=1e-7, atol=1e-9)
    keep = [i for i in range(6) if i != 2]
    assert torch.equal(ys_t[keep], free[keep])


def test_args_axes_match_jax():
    """args_axes maps an arg over any axis (JAX `_norm_args_axes`): a
    per-sample matrix stacked on its last axis and on its first, beside a
    shared one."""
    y0 = _y0(8)
    rng = np.random.RandomState(3)
    per = A[None] + 0.3 * rng.randn(8, 2, 2)
    for arr, ax in ((np.moveaxis(per, 0, -1), -1), (per, 0)):
        (ys_j, st_j), (ys_t, st_t) = _both(
            y0, T4, args=(arr, 0.5 * A), axes=(ax, None),
            j_func=lambda t, y, a, b: (y ** 3) @ (a + b),
            t_func=lambda t, y, a, b: (y ** 3) @ (a + b),
            rtol=1e-7, atol=1e-9)
        _assert_values(ys_t, ys_j)
        _assert_stats(st_t, st_j)


def test_shared_arg_of_batch_length_reaches_the_field_whole():
    """test_pallas.py::test_per_sample_args_axes: an arg stays shared by
    default, even when its last axis has the batch's length."""
    lam = np.linspace(0.5, 2.0, 16)
    y0 = np.ones((16, 1))
    (ys_j, st_j), (ys_t, st_t) = _both(
        y0, np.linspace(0.0, 1.0, 3), args=(lam,),
        j_func=lambda t, y, w: -jnp.mean(w) * y,
        t_func=lambda t, y, w: -torch.mean(w) * y, own=False,
        rtol=1e-7, atol=1e-9)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    np.testing.assert_allclose(ys_t[:, -1, 0].numpy(), np.exp(-lam.mean()),
                               rtol=1e-6)


def test_tuple_state_matches_jax():
    """test_pallas.py::test_per_sample_pallas_fallback: a tuple state (with
    pallas=True, which it does not qualify for) takes the driver; each
    sample's norm is the mixed norm over its own leaves."""
    rng = np.random.RandomState(5)
    a0, b0 = rng.rand(8, 2) + 0.5, rng.rand(8, 1) * 3 + 0.5
    t = np.linspace(0.0, 1.0, 3)
    jf = lambda tt_, yy: (-yy[0] * yy[1][0], -2.0 * yy[1] ** 2)
    tf = lambda tt_, yy: (-yy[0] * yy[1][0], -2.0 * yy[1] ** 2)
    ys_j, st_j = _jit(jf, t, options=dict(pallas=True))(
        (jnp.asarray(a0), jnp.asarray(b0)))
    ys_t, st_t = _own(tf, (torch.from_numpy(a0), torch.from_numpy(b0)),
                      torch.from_numpy(t), options=dict(pallas=True))
    assert isinstance(ys_t, tuple) and ys_t[1].shape == (8, 3, 1)
    for a, b in zip(ys_t, ys_j):
        _assert_values(a, b)
    _assert_stats(st_t, st_j)


def test_reversed_time_and_a_user_norm_match_jax():
    """Decreasing output times (each sample integrates backwards), and a
    user norm, which gets one sample (JAX's vmap hands it one)."""
    y0 = _y0(8)
    (ys_j, st_j), (ys_t, st_t) = _both(y0, T4[::-1].copy(), args=(A,),
                                       rtol=1e-7, atol=1e-9)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    ys_j, st_j = _jit(j_cubic, T4, options=dict(
        norm=lambda x: jnp.max(jnp.abs(x))))(jnp.asarray(y0), jnp.asarray(A))
    ys_t, st_t = _own(t_cubic, torch.from_numpy(y0), torch.from_numpy(T4),
                      (torch.from_numpy(A),),
                      options=dict(norm=lambda x: x.abs().max()))
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
def test_low_precision_states_match_jax(dtype):
    """float32 and bfloat16 states (bfloat16 with float32 error control):
    the state dtype out, counters exactly JAX's, values as
    tests/test_torch_dtypes.py holds the single-solve route (one unit in
    the last place of bfloat16; float32 to three times the solve's
    tolerance)."""
    j_dt, t_dt = {'float32': (jnp.float32, torch.float32),
                  'bfloat16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    y0 = _y0(8)
    kw = dict(rtol=1e-5, atol=1e-7) if dtype == 'float32' else dict(
        rtol=1e-3, atol=1e-4)
    f = lambda t, y: -y + 0.5 * y * y
    opts_j = opts_t = None
    if dtype == 'bfloat16':
        opts_j, opts_t = (dict(error_dtype=jnp.float32),
                          dict(error_dtype=torch.float32))
    ys_j, st_j = _jit(f, T4, options=opts_j, **kw)(jnp.asarray(y0, j_dt))
    ys_t, st_t = tt.odeint_per_sample_with_stats(
        f, torch.from_numpy(y0).to(t_dt), torch.from_numpy(T4),
        options=opts_t, **kw)
    assert ys_t.dtype == t_dt
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(ys_j.astype(jnp.float32))
    if dtype == 'bfloat16':
        np.testing.assert_allclose(ys_t.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=2.0 ** -7 * 1e-3)
    else:
        # the solver's tolerance, not float32 rounding, as
        # test_torch_odeint.py::test_float32_matches_jax explains
        np.testing.assert_allclose(ys_t.numpy(), want, rtol=3 * kw['rtol'],
                                   atol=3 * kw['atol'])
    assert (st_t.n_steps > 2).all()


def test_stiff_sample_takes_more_steps():
    """test_sharding.py::test_per_sample_controller_stats: the stiff sample
    takes more steps than the easy one, each its own controller."""
    f = lambda t, y: -y * y[..., :1] ** 2
    y0 = np.stack([np.full((2,), 0.5), np.full((2,), 30.0)])
    (ys_j, st_j), (ys_t, st_t) = _both(y0, np.linspace(0.0, 1.0, 2),
                                       j_func=f, t_func=f, rtol=1e-6,
                                       atol=1e-8)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    assert int(st_t.n_steps[1]) > int(st_t.n_steps[0])


def test_driver_reads_the_host_once_an_iteration():
    y0 = torch.from_numpy(_y0(8))
    batched_rk.reset_lane_counts()
    _, st = tt.odeint_per_sample_with_stats(
        t_cubic, y0, torch.from_numpy(T4), args=(torch.from_numpy(A),))
    counts = dict(batched_rk.LANE_COUNTS)
    # the last read finds no sample running
    assert counts['iterations'] == int(st.n_steps.max())
    assert counts['host_reads'] == counts['iterations'] + 1


# ---- the fixed grid ----------------------------------------------------------------

@pytest.mark.parametrize("method,options", [
    ('rk4', dict(num_steps=21)), ('euler', dict(num_steps=30)),
    ('rk4', dict(num_steps=21, interp='cubic', perturb=True))])
def test_fixed_grid_matches_jax(method, options):
    """The grid comes from the shared `t`: every sample's Stats are the
    shared counters, broadcast, as JAX's vmap broadcasts them."""
    y0 = _y0(8)
    (ys_j, st_j), (ys_t, st_t) = _both(y0, T4, args=(A,), method=method,
                                       options=options)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


def test_fixed_grid_gradient_through_the_loop_matches_jax():
    y0, W = _y0(6), np.random.RandomState(2).randn(6, 4, 2)
    lam = np.linspace(0.2, 1.2, 6)
    kw = dict(method='rk4', options=dict(num_steps=12), args_axes=(None, 0))

    def j_loss(y0_, a, l):
        ys = j_per_sample(lambda t, y, a_, l_: (y ** 3) @ a_ - l_ * y, y0_,
                          T4, args=(a, l), **kw)[0]
        return jnp.sum(ys * W)

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (y0, A, lam)))
    ps = [torch.from_numpy(x).requires_grad_() for x in (y0, A, lam)]
    ys, _ = tt.odeint_per_sample_with_stats(
        lambda t, y, a_, l_: (y ** 3) @ a_ - l_ * y, ps[0],
        torch.from_numpy(T4), args=tuple(ps[1:]), **kw)
    (ys * torch.from_numpy(W)).sum().backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9)


# ---- events ----------------------------------------------------------------------

G = 9.8


def _ball(t, y):
    return (jnp if isinstance(y, jnp.ndarray) else torch).stack(
        [y[1], -G + 0.0 * y[1]])


def test_falling_ball_with_a_height_per_sample():
    h = 1.0 + np.random.RandomState(1).rand(12)
    y0 = np.stack([h, np.zeros(12)], axis=1)
    kw = dict(event_fn=lambda t, y: y[0], rtol=1e-8, atol=1e-10)
    ((et_j, ys_j), st_j), ((et_t, ys_t), st_t) = _both(
        y0, np.array([0.0, 5.0]), j_func=_ball, t_func=_ball, **kw)
    _assert_values(et_t, et_j)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    np.testing.assert_allclose(et_t.numpy(), np.sqrt(2 * h / G), rtol=1e-7)


def test_multi_output_event_and_one_that_never_fires():
    """Two outputs sign-combined per sample; samples whose first output
    never crosses stop at `max_num_steps` with ERR_MAX_NUM_STEPS, their
    event time the bisection of their last step, as JAX's vmap route gives
    it (the kernel route reports NaN there)."""
    y0 = np.stack([np.linspace(0.3, 2.0, 10), np.zeros(10)], axis=1)
    f = lambda t, y: (jnp if isinstance(y, jnp.ndarray) else torch).stack(
        [-y[0], 0.0 * y[1]])
    ev = lambda t, y: (jnp if isinstance(y, jnp.ndarray) else torch).stack(
        [y[0] - 0.45, y[1] + 1.0])
    ((et_j, ys_j), st_j), ((et_t, ys_t), st_t) = _both(
        y0, np.array([0.0, 1.0]), j_func=f, t_func=f, event_fn=ev,
        rtol=1e-6, atol=1e-8, options=dict(max_num_steps=30))
    _assert_values(et_t, et_j)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)
    fired = y0[:, 0] > 0.45
    assert (st_t.error_code.numpy()[~fired] == ERR_MAX_NUM_STEPS).all()
    assert (st_t.error_code.numpy()[fired] == 0).all()
    np.testing.assert_allclose(et_t.numpy()[fired],
                               np.log(y0[fired, 0] / 0.45), atol=1e-6)


@pytest.mark.parametrize("interp", ['linear', 'cubic'])
def test_fixed_grid_event_matches_jax(interp):
    h = 1.0 + np.random.RandomState(4).rand(8)
    y0 = np.stack([h, np.zeros(8)], axis=1)
    ((et_j, ys_j), st_j), ((et_t, ys_t), st_t) = _both(
        y0, np.array([0.0, 5.0]), j_func=_ball, t_func=_ball,
        event_fn=lambda t, y: y[0], method='rk4',
        options=dict(step_size=0.05, interp=interp))
    _assert_values(et_t, et_j)
    _assert_values(ys_t, ys_j)
    _assert_stats(st_t, st_j)


def test_event_t_must_hold_two_times():
    """The JAX vmap route raises on a `t` of three points in event mode."""
    with pytest.raises(ValueError, match="len\\(t\\) == 2"):
        tt.odeint_per_sample(lambda t, y: -y, torch.ones(4, 2),
                             torch.linspace(0.0, 1.0, 3),
                             event_fn=lambda t, y: y[0])


# ---- gradients: the continuous adjoint, vmapped --------------------------------

class _Field(torch.nn.Module):
    """An MLP field plus a shared linear term and a per-sample decay."""

    def __init__(self, mlp):
        super().__init__()
        self.mlp = mlp

    def forward(self, t, y, a, lam):
        return self.mlp(t, y) + y @ a - lam * y


def test_gradients_match_jax():
    """`.backward()` through the driver: to y0, to an `MLPField`'s
    parameters (carried across with `mlp_params_from_jax`), to a shared
    arg and to a per-sample arg; each sample solves its own backward, a
    shared parameter's gradient is the sum over the samples."""
    rng = np.random.RandomState(7)
    B, H = 6, 8
    params = [dict(w=rng.randn(2, H) * 0.5, b=rng.randn(H) * 0.1),
              dict(w=rng.randn(H, 2) * 0.5, b=rng.randn(2) * 0.1)]
    y0, lam = rng.randn(B, 2), rng.rand(B) + 0.2
    a, W = 0.3 * A, rng.randn(B, 4, 2)

    def j_field(t, y, p, a_, l_):
        h = jnp.tanh(y ** 3 @ p[0]['w'] + p[0]['b'])
        return h @ p[1]['w'] + p[1]['b'] + y @ a_ - l_ * y

    def j_loss(y0_, p, a_, l_):
        ys = j_per_sample(j_field, y0_, jnp.asarray(T4), args=(p, a_, l_),
                          args_axes=(None, None, 0), rtol=1e-8,
                          atol=1e-10)[0]
        return jnp.sum(ys ** 2 * W)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    g_y0, g_p, g_a, g_l = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(y0), jp, jnp.asarray(a), jnp.asarray(lam))

    field = _Field(mlp_params_from_jax(params, power=3, device='cpu'))
    ty0, ta, tl = (torch.from_numpy(x).requires_grad_() for x in (y0, a, lam))
    ys, st = tt.odeint_per_sample_with_stats(
        field, ty0, torch.from_numpy(T4), args=(ta, tl),
        args_axes=(None, 0), rtol=1e-8, atol=1e-10)
    (ys ** 2 * torch.from_numpy(W)).sum().backward()
    _assert_values(ty0.grad, g_y0, tol=1e-9)
    _assert_values(ta.grad, g_a, tol=1e-9)
    _assert_values(tl.grad, g_l, tol=1e-9)
    for layer, w, b in zip(g_p, field.mlp.weights, field.mlp.biases):
        _assert_values(w.grad, layer['w'], tol=1e-9)
        _assert_values(b.grad, layer['b'], tol=1e-9)
    assert len(set(st.n_steps.tolist())) > 1


def test_tuple_state_and_time_gradients_match_jax():
    """Gradients of a tuple state's leaves and of the shared output times
    (each sample's vjp_t, summed over the samples)."""
    rng = np.random.RandomState(5)
    a0, b0 = rng.rand(5, 2) + 0.5, rng.rand(5, 1) + 0.5
    t = np.linspace(0.0, 1.0, 3)
    jf = lambda tt_, yy: (-yy[0] * yy[1][0], -2.0 * yy[1] ** 2)

    def j_loss(a, b, t_):
        ys = j_per_sample(jf, (a, b), t_)[0]
        return jnp.sum(ys[0] ** 2) + jnp.sum(ys[1])

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (a0, b0, t)))
    ps = [torch.from_numpy(x).requires_grad_() for x in (a0, b0, t)]
    ys = tt.odeint_per_sample(jf, (ps[0], ps[1]), ps[2])
    (ys[0].pow(2).sum() + ys[1].sum()).backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9)


def test_gradient_with_a_user_norm_matches_jax():
    """The backward's default adjoint norm takes the user's state norm for
    y and adj_y, each sample's own."""
    y0 = _y0(5)

    def j_loss(y, a):
        return jnp.sum(j_per_sample(j_cubic, y, T4, args=(a,), options=dict(
            norm=lambda x: jnp.max(jnp.abs(x))))[0] ** 2)

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(y0),
                                                    jnp.asarray(A))
    ps = [torch.from_numpy(x).requires_grad_() for x in (y0, A)]
    ys = tt.odeint_per_sample(t_cubic, ps[0], torch.from_numpy(T4),
                              args=(ps[1],),
                              options=dict(norm=lambda x: x.abs().max()))
    (ys ** 2).sum().backward()
    for p, g in zip(ps, g_j):
        _assert_values(p.grad, g, tol=1e-9)


def test_gradients_of_two_output_times_equal_each_samples_own():
    """With two output times the backward is one interval per sample;
    each sample's gradients equal those of its own `odeint` (the port's
    continuous adjoint), and a shared arg's is their sum."""
    rng = np.random.RandomState(8)
    y0, lam = rng.randn(5, 2) * 0.8, rng.rand(5) + 0.2
    t = torch.tensor([0.0, 1.2], dtype=torch.float64)
    f = lambda t_, y, a_, l_: (y ** 3) @ a_ - l_ * y
    ty0, ta, tl = (torch.from_numpy(x).requires_grad_() for x in (y0, A, lam))
    ys = tt.odeint_per_sample(f, ty0, t, args=(ta, tl), args_axes=(None, 0))
    (ys[:, -1] ** 2).sum().backward()
    g_a = torch.zeros_like(ta)
    for i in range(5):
        yi = torch.from_numpy(y0[i]).requires_grad_()
        ai = torch.from_numpy(A).requires_grad_()
        li = torch.tensor(lam[i], dtype=torch.float64, requires_grad=True)
        (tt.odeint(f, yi, t, args=(ai, li))[-1] ** 2).sum().backward()
        _assert_values(ty0.grad[i], yi.grad, tol=1e-12)
        _assert_values(tl.grad[i], li.grad, tol=1e-12)
        g_a += ai.grad
    _assert_values(ta.grad, g_a, tol=1e-12)


def test_event_gradients_match_jax():
    """Gradients through a per-sample event solve, as JAX's vmap route
    gives them (its adjoint's event mode, adjoint.py:611-644, vmapped):
    each sample backpropagates as if it had integrated to its own event
    time, which gets no gradient itself.  A falling ball with a shared
    gravity and a drag per sample; each sample's gradients also equal
    those of the port's own `odeint(event_fn=...)` of it."""
    rng = np.random.RandomState(3)
    B = 6
    y0 = np.stack([1.0 + rng.rand(B), np.zeros(B)], axis=1)
    k, g, W = rng.rand(B) * 0.3, np.array(9.8), rng.randn(B, 2, 2)
    t = np.array([0.0, 5.0])
    kw = dict(event_fn=lambda t_, y: y[0], rtol=1e-8, atol=1e-10)

    def field(t_, y, g_, k_):
        return (jnp if isinstance(y, jnp.ndarray) else torch).stack(
            [y[1], -g_ - k_ * y[1]])

    def j_loss(y0_, g_, k_):
        ys2 = j_per_sample(field, y0_, t, args=(g_, k_), args_axes=(None, 0),
                           **kw)[0][1]
        return jnp.sum(ys2 ** 2 * W)

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (y0, g, k)))
    ps = [torch.from_numpy(x).requires_grad_() for x in (y0, g, k)]
    (et, ys2), _ = tt.odeint_per_sample_with_stats(
        field, ps[0], torch.from_numpy(t), args=tuple(ps[1:]),
        args_axes=(None, 0), **kw)
    assert not et.requires_grad
    (ys2 ** 2 * torch.from_numpy(W)).sum().backward()
    for p, g_ in zip(ps, g_j):
        _assert_values(p.grad, g_, tol=1e-9)
    for i in (0, B - 1):
        yi = torch.from_numpy(y0[i]).requires_grad_()
        ki = torch.tensor(k[i], dtype=torch.float64, requires_grad=True)
        _, ys_i = tt.odeint(field, yi, torch.from_numpy(t),
                            args=(torch.from_numpy(g), ki), **kw)
        (ys_i ** 2 * torch.from_numpy(W[i])).sum().backward()
        assert torch.equal(yi.grad, ps[0].grad[i])
        assert torch.equal(ki.grad, ps[2].grad[i])


# ---- the kernel route's plain version against the driver --------------------------

def test_kernel_route_plain_version_against_the_driver():
    """On the CPU the kernel route runs its plain version: for an
    `MLPField` its per-sample counters equal the driver's in float64 (the
    same controller; values to the plain version's own float64 order)."""
    rng = np.random.RandomState(9)
    params = [dict(w=rng.randn(2, 16) * 0.5, b=rng.randn(16) * 0.1),
              dict(w=rng.randn(16, 2) * 0.5, b=rng.randn(2) * 0.1)]
    model = mlp_params_from_jax(params, power=3, device='cpu')
    model.requires_grad_(False)
    y0 = torch.from_numpy(rng.randn(16, 2) * 1.5)
    t = torch.from_numpy(T4)
    runs = [tt.odeint_per_sample_with_stats(model, y0, t, options=opts)
            for opts in (dict(pallas=True), None)]
    (ys_k, st_k), (ys_d, st_d) = runs
    for a, b in zip(st_k[:5], st_d[:5]):
        assert torch.equal(a, b)
    _assert_values(ys_k, ys_d, tol=1e-10)


# ---- what the route took last (ROADMAP A6b), each as JAX answers it ----------------

class _WithCallback:
    def __init__(self):
        self.calls = 0

    def __call__(self, t, y):
        return -y

    def callback_step(self, t0, y, dt):
        self.calls += 1


@pytest.mark.parametrize("case", [
    dict(method='kvaerno3'), dict(method='kvaerno5'), dict(method='radau5a'),
    dict(method='implicit_adams', options=dict(step_size=0.1)),
    dict(method='explicit_adams', options=dict(step_size=0.1)),
    dict(method='gl4', options=dict(step_size=0.1)),
    dict(method='trbdf2', options=dict(step_size=0.1)),
    dict(method='scipy_solver'), dict(options=dict(replay_grad=True)),
    dict(options=dict(forward_grad=True)),
    dict(method='rk4', options=dict(
        grid_constructor=lambda f, y, t: t[0] + (t[-1] - t[0])
        * (jnp if isinstance(y, jnp.ndarray) else torch).linspace(
            0.0, 1.0, 5, dtype=y.dtype))),
    dict(func=_WithCallback()),
    dict(grad_event=True, method='rk4', options=dict(step_size=0.1))],
    ids=['kvaerno3', 'kvaerno5', 'radau5a', 'implicit_adams',
         'explicit_adams', 'gl4', 'trbdf2', 'scipy_solver', 'replay_grad',
         'forward_grad', 'grid_constructor', 'callback',
         'fixed_grid_event_gradient'])
def test_what_is_not_ported_raises_naming_a6b(case):
    """The calls this route refused while they were ROADMAP A6b, each now
    as JAX's vmap route answers it (tests/test_torch_per_sample_implicit.py
    holds each at length): values to 1e-10 and `Stats` exactly; the
    callback fired once a sample a step, as each sample's own solve fires
    it; the gradient through a fixed-grid event JAX's to 1e-9; and the
    SciPy bridge refused by both, as JAX's vmap of its host callback
    refuses it."""
    case = dict(case)
    func = case.pop('func', lambda t, y: -y)
    y0 = np.linspace(0.5, 1.2, 8).reshape(4, 2)
    t = np.linspace(0.0, 1.0, 3)
    grad_event = case.pop('grad_event', False)
    if grad_event:
        case['event_fn'] = lambda t_, y: y[0] - 0.5
        t = t[[0, -1]]
    if case.get('method') == 'scipy_solver':
        with pytest.raises(NotImplementedError):
            j_per_sample(func, jnp.asarray(y0), t, **case)
        with pytest.raises(NotImplementedError, match="refuses"):
            tt.odeint_per_sample(func, torch.from_numpy(y0),
                                 torch.from_numpy(t), **case)
        return
    if grad_event:
        def j_loss(y0_):
            (_, ys), _ = j_per_sample(func, y0_, t, **case)
            return jnp.sum(ys[:, 1] ** 2)

        g_j = jax.grad(j_loss)(jnp.asarray(y0))
        yt = torch.from_numpy(y0).requires_grad_()
        (_, ys), _ = tt.odeint_per_sample_with_stats(
            func, yt, torch.from_numpy(t), **case)
        (ys[:, 1] ** 2).sum().backward()
        _assert_values(yt.grad, g_j, tol=1e-9)
        return
    ys_j, st_j = j_per_sample(func, jnp.asarray(y0), t, **case)
    n_calls = getattr(func, 'calls', None)
    ys_t, st_t = tt.odeint_per_sample_with_stats(
        func, torch.from_numpy(y0), torch.from_numpy(t), **case)
    _assert_values(ys_t, ys_j, tol=1e-10)
    _assert_stats(st_t, st_j)
    if n_calls is not None:
        assert func.calls - n_calls == int(st_t.n_steps.sum())
