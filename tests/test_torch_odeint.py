"""The port's main path, `odeint_with_stats` with an adaptive method, against
the JAX package on the spiral neural-ODE field (same numbers from a numpy
seed on both sides; JAX on CPU with x64, as conftest.py pins it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
from torchdiffeq_tpu.models import spiral_field
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import mlp_params_from_jax

ADAPTIVE = ['dopri5', 'dopri8', 'tsit5', 'tsit5_le', 'bosh3', 'fehlberg2',
            'adaptive_heun']


def _problem(seed, dtype, B=8, H=8, scale=0.5):
    rng = np.random.RandomState(seed)
    params = [dict(w=(rng.randn(2, H) * scale).astype(dtype),
                   b=(rng.randn(H) * 0.1).astype(dtype)),
              dict(w=(rng.randn(H, 2) * scale).astype(dtype),
                   b=(rng.randn(2) * 0.1).astype(dtype))]
    y0 = rng.randn(B, 2).astype(dtype)
    return params, y0


def _jax(params, y0, t, **kw):
    ys, st = tde.odeint_with_stats(
        lambda tt_, yy, p: spiral_field(p, tt_, yy), jnp.asarray(y0),
        jnp.asarray(t), args=(params,), **kw)
    return np.asarray(ys), [int(x) for x in st[:5]]


def _port(params, y0, t, **kw):
    model = mlp_params_from_jax(params, power=3, device='cpu')
    with torch.no_grad():
        ys, st = tt.odeint_with_stats(model, torch.from_numpy(y0),
                                      torch.from_numpy(np.asarray(t)), **kw)
    return ys.numpy(), list(st[:5])


@pytest.mark.parametrize("method", ADAPTIVE)
def test_float64_matches_jax_exactly(method):
    """float64 state: the same step sequence, so the five counters are
    exactly equal and the values agree to 1e-12 (the two differ only in
    the matmul's summation order and tanh's last ULP)."""
    params, y0 = _problem(0, np.float64)
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method=method, rtol=1e-6, atol=1e-8)
    ys_j, st_j = _jax(params, y0, t, **kw)
    ys_t, st_t = _port(params, y0, t, **kw)
    assert st_t == st_j
    assert st_t[1] > 5          # a real adaptive solve, with rejections
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-12)


def test_float64_main_path_tolerances():
    """The flagship settings (rtol=1e-7, atol=1e-9, dopri5, H=64) at a
    small batch: counters equal, values to 1e-12."""
    params, y0 = _problem(1, np.float64, B=16, H=64, scale=0.1)
    t = np.linspace(0.0, 1.0, 10)
    kw = dict(method='dopri5', rtol=1e-7, atol=1e-9)
    ys_j, st_j = _jax(params, y0, t, **kw)
    ys_t, st_t = _port(params, y0, t, **kw)
    assert st_t == st_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_float32_matches_jax(seed):
    """float32 state, float64 time.  The counters are equal.  The values
    agree to the solver's tolerance, not to float32 rounding: the embedded
    error estimate is a near-cancelling sum of stage slopes, so a one-ULP
    difference in a slope (XLA and PyTorch sum the matrix product in
    different orders, and their tanh differs in the last ULP) moves the
    error ratio by far more than one ULP, the next step size with it, and
    the solution by up to the local tolerance -- measured up to 5e-4 at
    rtol=1e-4 on |y| ~ 4, the same spread as JAX float32 against JAX
    float64.  Hence atol=1e-3."""
    params, y0 = _problem(seed, np.float32, B=16)
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method='dopri5', rtol=1e-4, atol=1e-6)
    ys_j, st_j = _jax(params, y0, t, **kw)
    ys_t, st_t = _port(params, y0, t, **kw)
    assert ys_t.dtype == np.float32
    assert st_t == st_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-3)


def test_reversed_time_matches_jax():
    """Decreasing output times integrate backwards (negated time)."""
    params, y0 = _problem(2, np.float64)
    t = np.linspace(1.0, 0.0, 4)
    kw = dict(method='dopri5', rtol=1e-6, atol=1e-8)
    ys_j, st_j = _jax(params, y0, t, **kw)
    ys_t, st_t = _port(params, y0, t, **kw)
    assert st_t == st_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-12)


def test_options_match_jax():
    """first_step, safety, ifactor, dfactor, min_step and max_step."""
    params, y0 = _problem(3, np.float64)
    t = np.linspace(0.0, 1.0, 3)
    kw = dict(method='bosh3', rtol=1e-6, atol=1e-8,
              options=dict(first_step=1e-3, safety=0.8, ifactor=5.0,
                           dfactor=0.3, min_step=1e-6, max_step=0.05))
    ys_j, st_j = _jax(params, y0, t, **kw)
    ys_t, st_t = _port(params, y0, t, **kw)
    assert st_t == st_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-12)


def test_max_num_steps_exhaustion_matches_jax():
    """The per-interval step budget runs out: error code 3, the counters
    of the JAX solve, and NaN in every row never written."""
    params, y0 = _problem(0, np.float64)
    t = np.linspace(0.0, 1.0, 4)
    kw = dict(method='dopri5', rtol=1e-10, atol=1e-12,
              options=dict(max_num_steps=6))
    ys_j, st_j = _jax(params, y0, t, **kw)
    ys_t, st_t = _port(params, y0, t, **kw)
    assert st_t == st_j
    assert st_t[4] == 3
    nan_rows = np.isnan(ys_t).all(axis=(1, 2))
    np.testing.assert_array_equal(nan_rows, np.isnan(ys_j).all(axis=(1, 2)))
    assert nan_rows[-1] and not nan_rows[0]
    np.testing.assert_allclose(ys_t[~nan_rows], ys_j[~nan_rows], rtol=0,
                               atol=1e-12)


def test_closed_form_linear_decay():
    """y' = -y against exp(-t), with dopri5's 6 evaluations per step + 2."""
    y0 = torch.tensor([[1.0], [2.0]], dtype=torch.float64)
    t = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    ys, st = tt.odeint_with_stats(lambda tt_, y: -y, y0, t)
    np.testing.assert_allclose(ys[:, :, 0].numpy(),
                               np.exp(-t.numpy())[:, None] * [1.0, 2.0],
                               rtol=1e-7)
    assert st.nfe == 6 * st.n_steps + 2 and st.error_code == 0


@pytest.mark.parametrize("call", [
    dict(options=dict(dtype=torch.float32)),
])
def test_not_yet_ported_raises(call):
    y0 = torch.ones(2, 2, dtype=torch.float64)
    t = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.odeint(lambda tt_, y: -y, y0, t, **call)


# calls this test file once held to raising, now ported: each against JAX
@pytest.mark.parametrize("call", [
    dict(method='euler', options=dict(step_size=0.1)),
    dict(method='rk4', options=dict(num_steps=6)),
    # 7 % 3 != 0: not the kernel route, so the fixed-grid loop, as JAX's
    # fallback to its scan
    dict(method='rk4', options=dict(pallas=True, num_steps=7)),
    dict(options=dict(controller='pi')), dict(options=dict(pcoeff=0.3)),
    dict(options=dict(error_dtype='float32')),
    dict(method='rk4', options=dict(step_size=0.05),
         event_fn=lambda t, y: y[0, 0] - 0.5),
    dict(method='implicit_adams'), dict(method='kvaerno5'),
    dict(method='scipy_solver'),
    dict(options=dict(replay_grad=True)), dict(options=dict(forward_grad=True)),
])
def test_formerly_refused_calls_match_jax(call):
    """float64 values to 1e-12 and Stats exactly equal; with a float32
    error_dtype, values to 1e-8: torch and XLA round a float32 RMS norm
    differently in its last bit now and then (13 of 2000 random
    4-vectors), which moves later step sizes at the 1e-9 level without
    changing a decision."""
    y0 = np.array([[1.0, 0.5], [2.0, -1.0]])
    t = np.linspace(0.0, 1.0, 4 if call.get('event_fn') is None else 2)
    opts = dict(call.get('options', {}))
    opts_j, opts_t = dict(opts), dict(opts)
    if opts.get('error_dtype'):
        opts_j['error_dtype'], opts_t['error_dtype'] = (jnp.float32,
                                                        torch.float32)
    kw = {k: v for k, v in call.items() if k != 'options'}
    out_j, st_j = tde.odeint_with_stats(
        lambda tt_, y: -y + 0.3 * jnp.sin(tt_), jnp.asarray(y0),
        jnp.asarray(t), options=opts_j, **kw)
    with torch.no_grad():
        out_t, st_t = tt.odeint_with_stats(
            lambda tt_, y: -y + 0.3 * torch.sin(tt_), torch.from_numpy(y0),
            torch.from_numpy(t), options=opts_t, **kw)
    assert list(st_t[:5]) == [int(x) for x in st_j[:5]]
    if call.get('event_fn') is not None:
        assert abs(float(out_t[0]) - float(out_j[0])) <= 1e-12
        out_t, out_j = out_t[1], out_j[1]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-8 if 'error_dtype' in opts else 1e-12)


def test_tuple_state_raises():
    """A tuple state solves (tests/test_torch_adjoint.py holds it against
    JAX); what raises is a leaf that is not floating point, and per-leaf
    tolerances of the wrong length."""
    t = torch.linspace(0.0, 1.0, 3)
    with pytest.raises(TypeError, match="floating point"):
        tt.odeint(lambda tt_, y: y, (torch.ones(2), torch.ones(3).int()), t)
    with pytest.raises(ValueError, match="per-leaf rtol"):
        tt.odeint(lambda tt_, y: y, (torch.ones(2), torch.ones(3)), t,
                  rtol=[1e-6, 1e-6, 1e-6])
    ys = tt.odeint(lambda tt_, y: (-y[0], y[1]), (torch.ones(2),
                                                   torch.ones(3)), t)
    assert [tuple(y.shape) for y in ys] == [(3, 2), (3, 3)]


def test_refuses_when_autograd_would_need_a_graph():
    """With grad mode on and something requiring grad, plain odeint takes
    its gradients from the continuous adjoint (ROADMAP C4; the values are
    held to JAX in tests/test_torch_adjoint.py); the forward-only kernel
    route, whose message points at the differentiable fixed-grid loop, and
    the gradient modes still to come raise, never returning a silently
    detached result; under no_grad it solves."""
    params, y0 = _problem(0, np.float64)
    model = mlp_params_from_jax(params, power=3, device='cpu')
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    y = torch.from_numpy(y0)
    ys = tt.odeint(model, y, t)                      # parameters need grad
    assert ys.requires_grad
    ys.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    y_g = y.clone().requires_grad_()
    tt.odeint(lambda tt_, yy: -yy, y_g, t)[-1].sum().backward()
    torch.testing.assert_close(y_g.grad, torch.full_like(y, np.exp(-1.0)),
                               rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError, match="drop pallas=True"):
        tt.odeint(model, y, t, method='rk4',
                  options=dict(pallas=True, num_steps=4))
    # replay_grad records a graph through the replayed steps; forward_grad
    # none (its tangents are forward-mode), as JAX's has no reverse mode
    ys = tt.odeint(model, y, t, options=dict(replay_grad=True))
    assert ys.requires_grad
    assert not tt.odeint(model, y, t,
                         options=dict(forward_grad=True)).requires_grad
    with torch.no_grad():
        ys = tt.odeint(model, y, t)
    assert ys.shape == (3, 8, 2) and not ys.requires_grad
    model.requires_grad_(False)
    assert torch.isfinite(tt.odeint(model, y, t)).all()
