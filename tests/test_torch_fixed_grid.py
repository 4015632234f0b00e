"""The fixed-grid explicit tier of the PyTorch port (euler, midpoint, heun2,
heun3, rk4) against the JAX package on the same numpy inputs (CPU, x64):
values, `Stats`, gradients through the loop, the fixed-grid adjoint and
the fixed-grid event solve.  Mirrors tests/test_tree_fixed.py, the explicit
rows of tests/test_convergence.py and the fixed-grid cases of
test_odeint.py, test_api.py, test_gradients.py and test_events.py.

Tolerances: float64 values to 1e-12 (XLA may fuse a multiply-add into an
FMA inside its scan, torch does not, so a value can differ in its last
bit) and gradients to 1e-10 of the largest entry; float32 values to
2e-6 (the first stage's field runs in float32, where the matmul's
summation order and tanh's last bit differ; later stages run in float64
on both sides, see solvers/fixed_grid.py).  `Stats` are exactly equal.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
from torchdiffeq_tpu.models import spiral_field
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import mlp_params_from_jax
from torchdiffeq_tpu_torch.solvers import fixed_grid

FIXED = ['euler', 'midpoint', 'heun2', 'heun3', 'rk4']
VALUE_TOL = 1e-12
GRAD_TOL = 1e-10


def _counters(st):
    return [int(x) for x in st[:5]]


def _frac_grid(t, frac):
    return t[0] + (t[-1] - t[0]) * frac


_FRAC = np.linspace(0.0, 1.0, 11) ** 1.5     # a non-uniform grid


def _options(grid, lib):
    if grid == 'step_size':
        return dict(step_size=0.07)
    if grid == 'num_steps':
        return dict(num_steps=9)
    frac = jnp.asarray(_FRAC) if lib == 'jax' else torch.from_numpy(_FRAC)
    return dict(grid_constructor=lambda f, y0, t: _frac_grid(t, frac))


def _field_j(t, y):
    return -0.7 * y + 0.3 * jnp.sin(t) * y * y


def _field_t(t, y):
    return -0.7 * y + 0.3 * torch.sin(t) * y * y


def _pair_j(t, y):
    return (_field_j(t, y[0]), -1.3 * y[1] + jnp.cos(t))


def _pair_t(t, y):
    return (_field_t(t, y[0]), -1.3 * y[1] + torch.cos(t))


Y0 = np.array([0.5, -0.25, 1.0])
Y0_PAIR = (np.array([0.5, -0.25, 1.0]), np.array([[2.0, -1.0], [0.5, 0.0]]))


@pytest.mark.parametrize("state", ['tensor', 'tuple'])
@pytest.mark.parametrize("reverse", [False, True], ids=['fwd', 'rev'])
@pytest.mark.parametrize("grid", ['step_size', 'num_steps',
                                  'grid_constructor'])
@pytest.mark.parametrize("interp", ['linear', 'cubic'])
@pytest.mark.parametrize("method", FIXED)
def test_values_and_stats_match_jax(method, interp, grid, reverse, state):
    """Every method x interpolation x grid option x direction x state
    structure: float64 values to 1e-12, Stats exactly."""
    t = np.linspace(0.0, 1.0, 5)
    if reverse:
        t = t[::-1].copy()
    kw = dict(method=method)
    if state == 'tensor':
        fj, ft = _field_j, _field_t
        y0_j, y0_t = jnp.asarray(Y0), torch.from_numpy(Y0)
    else:
        fj, ft = _pair_j, _pair_t
        y0_j = tuple(jnp.asarray(x) for x in Y0_PAIR)
        y0_t = tuple(torch.from_numpy(x) for x in Y0_PAIR)
    ys_j, st_j = tde.odeint_with_stats(
        fj, y0_j, jnp.asarray(t), options=dict(_options(grid, 'jax'),
                                               interp=interp), **kw)
    ys_t, st_t = tt.odeint_with_stats(
        ft, y0_t, torch.from_numpy(t), options=dict(_options(grid, 'torch'),
                                                    interp=interp), **kw)
    assert _counters(st_t) == _counters(st_j)
    assert st_t.n_steps > 5
    for a, b in zip(jax.tree_util.tree_leaves(ys_j),
                    ys_t if state == 'tuple' else [ys_t]):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=VALUE_TOL)


def _spiral(seed, dtype, B=5, H=8):
    rng = np.random.RandomState(seed)
    params = [dict(w=(rng.randn(2, H) * 0.5).astype(dtype),
                   b=(rng.randn(H) * 0.1).astype(dtype)),
              dict(w=(rng.randn(H, 2) * 0.5).astype(dtype),
                   b=(rng.randn(2) * 0.1).astype(dtype))]
    return params, rng.randn(B, 2).astype(dtype)


def _jax_spiral(a, b, p):
    return spiral_field(p, a, b)


@pytest.mark.parametrize("method", FIXED)
def test_float32_spiral_within_bound(method):
    """A float32 state on the float64 grid: the stages after the first
    promote to float64 on both sides, the increment is cast back; values
    within 2e-6 of JAX's (module docstring), Stats exactly, and float32
    out."""
    params, y0 = _spiral(3, np.float32)
    t = np.linspace(0.0, 1.0, 4)
    for opts in (dict(num_steps=12), dict(step_size=0.1, interp='cubic')):
        ys_j, st_j = tde.odeint_with_stats(
            _jax_spiral, jnp.asarray(y0), jnp.asarray(t), args=(params,),
            method=method, options=opts)
        model = mlp_params_from_jax(params, power=3, device='cpu')
        with torch.no_grad():
            ys_t, st_t = tt.odeint_with_stats(model, torch.from_numpy(y0),
                                              torch.from_numpy(t),
                                              method=method, options=opts)
        assert ys_t.dtype == torch.float32
        assert _counters(st_t) == _counters(st_j)
        np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                                   atol=2e-6)


def _grads(model, y_t, t_t):
    return ([y_t.grad] + ([t_t.grad] if t_t.grad is not None else [])
            + [p.grad for p in model.weights] + [p.grad for p in model.biases])


def _jax_grads(gj, with_t):
    g_params, g_y = gj[0], gj[1]
    out = [g_y] + ([gj[2]] if with_t else [])
    return (out + [g_params[i]['w'] for i in range(2)]
            + [g_params[i]['b'] for i in range(2)])


def _assert_grads(got, want):
    assert len(got) == len(want)
    for g_t, g_j in zip(got, want):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=GRAD_TOL * np.abs(g_j).max())


_W = np.arange(1.0, 5.0)[:, None, None]


@pytest.mark.parametrize("options", [
    dict(num_steps=7), dict(num_steps=6, interp='cubic'),
    dict(step_size=0.13), dict(step_size=0.11, interp='cubic'), {},
], ids=['num_steps', 'num_steps-cubic', 'step_size', 'step_size-cubic',
        'on-t'])
@pytest.mark.parametrize("method", FIXED)
def test_gradients_through_the_loop_match_jax(method, options):
    """d/d(params, y0, t) of a weighted sum of squares through the loop
    against `jax.grad` through the scan and its searchsorted emission, at
    1e-10 relative.  JAX's step_size grid needs concrete times, so there
    the time gradient is left out on both sides."""
    params, y0 = _spiral(0, np.float64)
    with_t = 'step_size' not in options
    for t in (np.linspace(0.0, 1.0, 4), np.linspace(1.0, 0.0, 4)):
        def loss_j(p, y, tt_=t):
            ys = tde.odeint(_jax_spiral, y, tt_, args=(p,), method=method,
                            options=options)
            return jnp.sum(ys ** 2 * _W)

        args = (params, jnp.asarray(y0)) + ((jnp.asarray(t),) if with_t
                                            else ())
        gj = jax.grad(loss_j, argnums=tuple(range(len(args))))(*args)
        model = mlp_params_from_jax(params, power=3, device='cpu')
        y_t = torch.from_numpy(y0).requires_grad_()
        t_t = torch.from_numpy(t).requires_grad_(with_t)
        ys = tt.odeint(model, y_t, t_t, method=method, options=options)
        assert ys.requires_grad
        (ys ** 2 * torch.from_numpy(_W)).sum().backward()
        _assert_grads(_grads(model, y_t, t_t), _jax_grads(gj, with_t))


@pytest.mark.parametrize("interp", ['linear', 'cubic'])
@pytest.mark.parametrize("method", ['euler', 'rk4'])
def test_remat_equals_the_plain_loop(method, interp):
    """remat=True recomputes each step in the backward pass: the values and
    every gradient are bit for bit those of the loop without it."""
    params, y0 = _spiral(1, np.float64)
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    out = []
    for remat in (False, True):
        model = mlp_params_from_jax(params, power=3, device='cpu')
        y_t = torch.from_numpy(y0).requires_grad_()
        t_t = t.clone().requires_grad_()
        ys = tt.odeint(model, y_t, t_t, method=method,
                       options=dict(num_steps=8, interp=interp, remat=remat))
        (ys ** 2).sum().backward()
        out.append([ys.detach()] + _grads(model, y_t, t_t))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_frees_the_stages():
    """With remat a step keeps only its input state for the backward
    pass: fewer saved tensors than the plain loop's stages."""
    params, y0 = _spiral(1, np.float64, B=64, H=32)
    t = torch.linspace(0.0, 1.0, 2, dtype=torch.float64)
    counts = []
    for remat in (False, True):
        model = mlp_params_from_jax(params, power=3, device='cpu')
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x.numel()) or x, lambda x: x):
            tt.odeint(model, torch.from_numpy(y0), t, method='rk4',
                      options=dict(num_steps=10, remat=remat))
        counts.append(sum(saved))
    assert counts[1] < counts[0] / 4, counts


@pytest.mark.parametrize("method", FIXED)
def test_perturb_matches_jax(method):
    """perturb=True: the first stage one ULP after the step's start and the
    last (where the method has one at the end) one ULP before its end;
    values to 1e-12 of JAX's."""
    t = np.array([1.0, 1.5, 2.0])
    opts = dict(step_size=0.25, perturb=True)
    ys_j = tde.odeint(_field_j, jnp.asarray(Y0), jnp.asarray(t),
                      method=method, options=opts)
    ys_t = tt.odeint(_field_t, torch.from_numpy(Y0), torch.from_numpy(t),
                     method=method, options=opts)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=VALUE_TOL)


@pytest.mark.parametrize("perturb", [False, True])
def test_perturb_moves_the_evaluation_times(perturb):
    """The field sees times off the grid points with perturb (JAX
    test_odeint.py::test_perturb)."""
    times = []

    def f(t, y):
        times.append(float(t))
        return -y

    tt.odeint(f, torch.ones(1, dtype=torch.float64),
              torch.tensor([1.0, 2.0], dtype=torch.float64), method='euler',
              options=dict(step_size=0.5, perturb=perturb))
    on_grid = [x for x in times if x in (1.0, 1.5)]
    assert (len(on_grid) == 0) if perturb else (len(on_grid) == 2), times


def test_perturb_time_gradient_stitches():
    """The perturbed evaluation time keeps a gradient of 1 (JAX
    `_nextafter`'s custom JVP): the time gradient with perturb equals the
    one without to 1e-10 relative."""
    grads = []
    for perturb in (False, True):
        t = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
        ys = tt.odeint(lambda s, y: -y * s, torch.ones(2, dtype=torch.float64),
                       t, method='rk4',
                       options=dict(num_steps=4, perturb=perturb))
        ys[-1].sum().backward()
        grads.append(t.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-10, atol=0)


@pytest.mark.parametrize("method", FIXED)
def test_tuple_state_bit_identical_to_component_solves(method):
    """A tuple state solves as its components alone, bit for bit (JAX
    test_tree_fixed.py)."""
    t = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    opts = dict(step_size=0.01)
    a, b = (torch.tensor([1.0], dtype=torch.float64),
            torch.tensor([2.0], dtype=torch.float64))
    ys, st = tt.odeint_with_stats(lambda s, y: (-y[0], -2.0 * y[1]), (a, b),
                                  t, method=method, options=opts)
    assert st.error_code == 0
    ys_a = tt.odeint(lambda s, y: -y, a, t, method=method, options=opts)
    ys_b = tt.odeint(lambda s, y: -2.0 * y, b, t, method=method,
                     options=opts)
    assert torch.equal(ys[0], ys_a) and torch.equal(ys[1], ys_b)


def test_grid_constructor_sees_the_user_frame_and_structure():
    seen = {}

    def gc(func, y0, t):
        seen['y0'], seen['t'] = y0, t.clone()
        return torch.linspace(float(t[0]), float(t[-1]), 41,
                              dtype=torch.float64)

    t = torch.linspace(2.0, 0.0, 5, dtype=torch.float64)
    y0 = (torch.tensor([np.exp(-2.0)], dtype=torch.float64),
          torch.tensor([2 * np.exp(-4.0)], dtype=torch.float64))
    ys = tt.odeint(lambda s, y: (-y[0], -2.0 * y[1]), y0, t, method='rk4',
                   options=dict(grid_constructor=gc))
    assert isinstance(seen['y0'], tuple) and len(seen['y0']) == 2
    torch.testing.assert_close(seen['t'], t, rtol=0, atol=0)
    assert abs(float(ys[0][-1, 0]) - 1.0) < 1e-6


def test_grid_options_are_mutually_exclusive_and_interp_checked():
    y0 = torch.ones(1, dtype=torch.float64)
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt.odeint(lambda s, y: -y, y0, t, method='euler',
                  options=dict(step_size=0.1, num_steps=4))
    with pytest.raises(ValueError, match="Unknown interpolation"):
        tt.odeint(lambda s, y: -y, y0, t, method='euler',
                  options=dict(interp='quadratic'))
    with pytest.warns(UserWarning, match="fixed-grid solver: Unexpected"):
        tt.odeint(lambda s, y: -y, y0, t, method='euler',
                  options=dict(rtol_typo=1.0))


def test_forward_grad_is_dropped_on_fixed_methods():
    """JAX odeint.py:261-267: the loop is differentiable as it is, so the
    option is accepted and changes nothing."""
    y0 = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a = tt.odeint(lambda s, y: -y, y0, t, method='rk4',
                      options=dict(num_steps=4, forward_grad=True))
    b = tt.odeint(lambda s, y: -y, y0, t, method='rk4',
                  options=dict(num_steps=4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_single_output_time():
    y0 = torch.tensor([1.0, 2.0], dtype=torch.float64)
    ys = tt.odeint(lambda s, y: -y, y0, torch.tensor([0.5]), method='rk4',
                   options=dict(step_size=0.1))
    assert ys.shape == (1, 2)
    torch.testing.assert_close(ys[0], y0, rtol=0, atol=0)


@pytest.mark.parametrize("t", [[0.0, 0.4, 1.3], [0.0, 1.0, 3.0]],
                         ids=['non-uniform', 'uneven-stride'])
def test_kernel_route_falls_to_the_loop_by_qualification(t):
    """rk4 with pallas=True whose output times are not on the num_steps
    grid does not qualify (JAX `_try_pallas_rk4`): the port runs the loop
    and returns JAX's scan result, launching no kernel."""
    from torchdiffeq_tpu_torch.ops import kernels
    y0 = np.array([[1.0, 0.5], [2.0, -1.0]])
    opts = dict(pallas=True, num_steps=6)
    ys_j, st_j = tde.odeint_with_stats(_field_j, jnp.asarray(y0),
                                       jnp.asarray(t), method='rk4',
                                       options=opts)
    before = kernels.launch_counts["rk4_integrate"]
    with torch.no_grad():
        ys_t, st_t = tt.odeint_with_stats(_field_t, torch.from_numpy(y0),
                                          torch.tensor(t, dtype=torch.float64),
                                          method="rk4",
                                          options=opts)
    assert kernels.launch_counts["rk4_integrate"] == before
    assert _counters(st_t) == _counters(st_j)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=VALUE_TOL)


@pytest.mark.parametrize("adjoint_method", ['rk4', 'midpoint', 'dopri5'])
@pytest.mark.parametrize("method", ['rk4', 'euler', 'heun3'])
def test_fixed_grid_adjoint_matches_jax(method, adjoint_method):
    """odeint_adjoint with a fixed forward and a fixed (num_steps per
    interval, no warm start) or adaptive backward: gradients to y0, t and
    the parameters to 1e-10 relative of JAX's."""
    params, y0 = _spiral(2, np.float64)
    fo = dict(num_steps=9)
    ao = dict(num_steps=4) if adjoint_method != 'dopri5' else {}
    for t in (np.linspace(0.0, 1.0, 4), np.linspace(1.0, 0.0, 4)):
        def loss_j(p, y, tt_):
            ys = tde.odeint_adjoint(_jax_spiral, y, tt_, args=(p,),
                                    method=method, options=fo,
                                    adjoint_method=adjoint_method,
                                    adjoint_options=ao)
            return jnp.sum(ys ** 2 * _W)

        gj = jax.grad(loss_j, argnums=(0, 1, 2))(params, jnp.asarray(y0),
                                                 jnp.asarray(t))
        model = mlp_params_from_jax(params, power=3, device='cpu')
        y_t = torch.from_numpy(y0).requires_grad_()
        t_t = torch.from_numpy(t).requires_grad_()
        ys = tt.odeint_adjoint(model, y_t, t_t, method=method, options=fo,
                               adjoint_method=adjoint_method,
                               adjoint_options=ao)
        (ys ** 2 * torch.from_numpy(_W)).sum().backward()
        _assert_grads(_grads(model, y_t, t_t), _jax_grads(gj, True))


def test_fixed_grid_adjoint_step_size_backward():
    """adjoint_options=dict(step_size=h) on a two-point solve (JAX's
    interval loop traces its times past two points, where step_size needs
    concrete ones): the gradient to y0 to 1e-10 of JAX's."""
    params, y0 = _spiral(4, np.float64)
    t = np.array([0.0, 1.0])
    kw = dict(method='rk4', options=dict(num_steps=36),
              adjoint_options=dict(step_size=1 / 36))
    gj = jax.grad(lambda y: jnp.sum(tde.odeint_adjoint(
        _jax_spiral, y, t, args=(params,), **kw)[-1] ** 2))(jnp.asarray(y0))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    y_t = torch.from_numpy(y0).requires_grad_()
    (tt.odeint_adjoint(model, y_t, torch.from_numpy(t), **kw)[-1] ** 2
     ).sum().backward()
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=GRAD_TOL * np.abs(np.asarray(gj)).max())


def _event_j(t, y):
    return t - 0.37 + 0.1 * y[0]


def _event_t(t, y):
    return t - 0.37 + 0.1 * y[0]


@pytest.mark.parametrize("interp", ['linear', 'cubic'])
@pytest.mark.parametrize("method", FIXED)
def test_fixed_grid_event_and_its_gradient_match_jax(method, interp):
    """odeint_event on the fixed grid: event time and state to 1e-12, Stats
    exactly, and the gradient of ``event_t + |y(event_t)|^2`` to y0 and
    the parameters (the adjoint over [t0, event_t] plus the IFT reroute) to
    1e-10 relative of JAX's."""
    params, _ = _spiral(0, np.float64)
    y0 = np.array([0.3, 0.8])
    opts = dict(step_size=0.01, interp=interp)

    def loss_j(p, y):
        et, sol = tde.odeint_event(_jax_spiral, y, jnp.asarray(0.0),
                                   event_fn=_event_j, args=(p,),
                                   method=method, options=opts)
        return et + jnp.sum(sol[-1] ** 2), (et, sol)

    (_, (et_j, sol_j)), gj = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(params, jnp.asarray(y0))
    model = mlp_params_from_jax(params, power=3, device='cpu')
    y_t = torch.from_numpy(y0).requires_grad_()
    et, sol = tt.odeint_event(model, y_t, 0.0, event_fn=_event_t,
                              method=method, options=opts)
    assert abs(et.item() - float(et_j)) <= VALUE_TOL
    np.testing.assert_allclose(sol.detach().numpy(), np.asarray(sol_j),
                               rtol=0, atol=VALUE_TOL)
    (et + (sol[-1] ** 2).sum()).backward()
    _assert_grads(_grads(model, y_t, torch.zeros(())),
                  [gj[1]] + [gj[0][i]['w'] for i in range(2)]
                  + [gj[0][i]['b'] for i in range(2)])
    (_, _), st_j = tde.odeint_with_stats(
        _jax_spiral, jnp.asarray(y0), jnp.asarray([0.0, 1.0]),
        args=(params,), event_fn=_event_j, method=method, options=opts)
    with torch.no_grad():
        (_, _), st_t = tt.odeint_with_stats(
            model, torch.from_numpy(y0), torch.tensor([0.0, 1.0]),
            event_fn=_event_t, method=method, options=opts)
    assert _counters(st_t) == _counters(st_j)


def test_fixed_grid_event_float32_time_and_limits():
    """The event solve keeps time in the state dtype (JAX: float32 for a
    float32 state): event time to the float32 bisection's width of JAX's;
    no step_size raises; a sign that never changes stops at max_itrs with
    ERR_MAX_NUM_STEPS, as JAX's loop does."""
    y0 = np.array([1.0], np.float32)
    kw = dict(event_fn=lambda t, y: y[0] - 0.5, method='rk4',
              options=dict(step_size=0.01))
    et_j, _ = tde.odeint_event(lambda t, y: -y, jnp.asarray(y0),
                               jnp.asarray(0.0), **kw)
    et_t, ys_t = tt.odeint_event(lambda t, y: -y, torch.from_numpy(y0), 0.0,
                                 **kw)
    assert ys_t.dtype == torch.float32
    assert abs(float(et_t) - float(et_j)) <= 1e-6
    with pytest.raises(ValueError, match="requires `step_size`"):
        tt.odeint_event(lambda t, y: -y, torch.from_numpy(y0), 0.0,
                        event_fn=lambda t, y: y[0] - 0.5, method='rk4')
    (_, _), st = tt.odeint_with_stats(
        lambda t, y: -y * 0.0, torch.ones(1, dtype=torch.float64),
        torch.tensor([0.0, 1.0]), event_fn=lambda t, y: y[0] - 0.5,
        method='euler', options=dict(step_size=0.5))
    (_, _), st_j = tde.odeint_with_stats(
        lambda t, y: -y * 0.0, jnp.ones(1), jnp.asarray([0.0, 1.0]),
        event_fn=lambda t, y: y[0] - 0.5, method='euler',
        options=dict(step_size=0.5))
    assert _counters(st) == _counters(st_j) == [20000, 20000, 20000, 0, 3]


# (method, order, h): h per order so both errors sit in clean asymptotics
# (JAX tests/test_convergence.py:62-66)
@pytest.mark.parametrize("method,order,h", [
    ('euler', 1, 1 / 64), ('midpoint', 2, 1 / 32), ('heun2', 2, 1 / 32),
    ('heun3', 3, 1 / 16), ('rk4', 4, 1 / 8),
])
def test_convergence_order(method, order, h):
    """log2(e(h) / e(h/2)) at t=1 on y' = y cos t (y = exp(sin t)) is above
    the method's order less 0.4, JAX's criterion (superconvergence is
    fine; rk4 measures 3.64 at h=1/8 in both packages)."""
    errs = []
    for hh in (h, h / 2):
        ys = tt.odeint(lambda s, y: y * torch.cos(s),
                       torch.ones(1, dtype=torch.float64),
                       torch.tensor([0.0, 1.0], dtype=torch.float64),
                       method=method, options=dict(step_size=hh))
        errs.append(abs(float(ys[-1, 0]) - np.exp(np.sin(1.0))))
    assert errs[1] > 1e-14
    assert np.log2(errs[0] / errs[1]) > order - 0.4, errs


def test_construct_grid_step_size_matches_the_reference_rule():
    """arange * step + start with the last point set to the end."""
    grid = fixed_grid.construct_grid(None, None, np.array([0.0, 1.0]), 0.3,
                                     None)
    np.testing.assert_array_equal(grid, [0.0, 0.3, 0.6, 0.8999999999999999,
                                         1.0])
