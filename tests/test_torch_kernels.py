"""The plain PyTorch versions of the port's three kernels against the JAX
Pallas kernels they replace (run as the JAX package's own tests run them:
`interpret=True`, or the scan fallback, on the CPU), directly and through
the public entry points.  The CUDA kernels themselves are compared with
these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu as tde
from torchdiffeq_tpu.ops.pallas_kernels import (
    rk4_integrate as j_rk4, dopri5_integrate_batched as j_lanes,
    dopri5_events_batched as j_events)
from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import LinearEvent, mlp_params_from_jax
from torchdiffeq_tpu_torch.ops import _build, kernels, tableaus
from torchdiffeq_tpu_torch.ops.kernels import (
    rk4_integrate, rk4_integrate_ref, dopri5_integrate_batched,
    dopri5_integrate_batched_ref, dopri5_events_batched,
    dopri5_events_batched_ref)


def _weights(seed, dtype, H=16, D=2, scale=0.5):
    """MLP weights at scale 0.5, so solves take more than a few steps."""
    rng = np.random.RandomState(seed)
    w1 = (rng.randn(D, H) * scale).astype(dtype)
    b1 = (rng.randn(H) * 0.1).astype(dtype)
    w2 = (rng.randn(H, D) * scale).astype(dtype)
    b2 = (rng.randn(D) * 0.1).astype(dtype)
    return (w1, b1, w2, b2), rng


def _model(ws):
    w1, b1, w2, b2 = ws
    return mlp_params_from_jax([dict(w=w1, b=b1), dict(w=w2, b=b2)], power=3,
                               device='cpu')


def j_field(t, y, w1, b1, w2, b2):          # (B, D) rows
    return jnp.tanh((y ** 3) @ w1 + b1) @ w2 + b2


def j_lane_field(tv, yv, w1, b1, w2, b2):   # (D, B) lanes
    return j_field(tv, yv.T, w1, b1, w2, b2).T


def _tol(dtype):
    # float64: the operation order is the same, so only the matmul's
    # summation order and tanh's last ULP differ: 1e-12 over a solve.
    # float32: the same at float32's epsilon, amplified over the steps.
    return 1e-12 if dtype == np.float64 else 2e-5


# ---- K-rk4 ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("interpret", [False, True])
def test_rk4_ref_matches_jax(dtype, interpret):
    """`rk4_integrate_ref` against JAX `rk4_integrate`: its scan fallback
    and the interpreted Pallas kernel, with and without `out_every`."""
    ws, rng = _weights(0, dtype)
    y0 = rng.randn(32, 2).astype(dtype)
    model = _model(ws)
    jw = tuple(jnp.asarray(w) for w in ws)
    for out_every in (None, 10):
        want = np.asarray(j_rk4(j_field, jnp.asarray(y0), 0.0, 0.02, 40, jw,
                                out_every=out_every, interpret=interpret))
        with torch.no_grad():
            got = rk4_integrate_ref(model, torch.from_numpy(y0), 0.0, 0.02,
                                    40, out_every=out_every).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=_tol(dtype),
                                   atol=_tol(dtype))


def test_rk4_ref_any_callable_with_params():
    """The plain version takes any ``field(t, y, *params)``."""
    ws, rng = _weights(1, np.float64)
    y0 = rng.randn(8, 2)
    want = np.asarray(j_rk4(j_field, jnp.asarray(y0), 0.5, 0.01, 20,
                            tuple(jnp.asarray(w) for w in ws)))
    t_field = lambda t, y, w1, b1, w2, b2: torch.tanh(y ** 3 @ w1 + b1) @ w2 + b2
    got = rk4_integrate(t_field, torch.from_numpy(y0), 0.5, 0.01, 20,
                        tuple(torch.from_numpy(w) for w in ws)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_odeint_rk4_kernel_route_matches_jax(dtype):
    """``odeint(method='rk4', options=dict(pallas=True, num_steps=N))``
    against JAX's route (interpreted kernel), with nfe = 4 * num_steps."""
    ws, rng = _weights(2, dtype)
    y0 = rng.randn(16, 2).astype(dtype)
    t = np.linspace(0.0, 1.0, 5)
    ys_j, st_j = tde.odeint_with_stats(
        j_field, jnp.asarray(y0), jnp.asarray(t), method='rk4',
        args=tuple(jnp.asarray(w) for w in ws),
        options=dict(pallas=True, num_steps=100, interpret=True))
    model = _model(ws)
    kernels.reset_launch_counts()
    with torch.no_grad():
        ys_t, st_t = tt.odeint_with_stats(
            model, torch.from_numpy(y0), torch.from_numpy(t), method='rk4',
            options=dict(pallas=True, num_steps=100))
    assert kernels.launch_counts['rk4_integrate'] == 0   # CPU: plain version
    assert ys_t.shape == (5, 16, 2)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j),
                               rtol=_tol(dtype), atol=_tol(dtype))
    assert list(st_t[:5]) == [int(x) for x in st_j[:5]] == [400, 100, 100, 0, 0]


def test_odeint_rk4_route_takes_the_pallas_options():
    """The Pallas kernel's own options `interpret` and `block_b` (a TPU lane
    tile) are accepted and dropped on the rk4 route, as JAX's route takes
    them (odeint.py:207): the same call in both packages, values to 1e-12
    and equal counters (ROADMAP C8)."""
    ws, rng = _weights(4, np.float64)
    y0 = rng.randn(16, 2)
    t = np.linspace(0.0, 1.0, 5)
    options = dict(pallas=True, num_steps=40, interpret=True, block_b=8)
    ys_j, st_j = tde.odeint_with_stats(
        j_field, jnp.asarray(y0), jnp.asarray(t), method='rk4',
        args=tuple(jnp.asarray(w) for w in ws), options=options)
    with torch.no_grad():
        ys_t, st_t = tt.odeint_with_stats(
            _model(ws), torch.from_numpy(y0), torch.from_numpy(t),
            method='rk4', options=options)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)
    assert list(st_t[:5]) == [int(x) for x in st_j[:5]] == [160, 40, 40, 0, 0]


# ---- K-dopri5 (per lane) --------------------------------------------------

def _lanes_both(method, dtype, seed=3, B=32, ts=(0.0, 0.3, 0.6, 1.0),
                y_scale=0.8, **kw):
    ws, rng = _weights(seed, dtype)
    y0 = (rng.randn(2, B) * y_scale).astype(dtype)
    ts = np.asarray(ts, dtype)
    ys_j, acc_j, stp_j = j_lanes(
        j_lane_field, jnp.asarray(y0), ts[0], ts[-1], ts=ts,
        params=tuple(jnp.asarray(w) for w in ws),
        per_lane_params=(False,) * 4, method=method, interpret=True, **kw)
    with torch.no_grad():
        ys_t, acc_t, stp_t = dopri5_integrate_batched_ref(
            _model(ws), torch.from_numpy(y0), ts[0], ts[-1], ts=ts,
            method=method, **kw)
    return ((np.asarray(ys_j), np.asarray(acc_j), np.asarray(stp_j)),
            (ys_t.numpy(), acc_t.numpy(), stp_t.numpy()))


@pytest.mark.parametrize("method", ['dopri5', 'bosh3'])
def test_lanes_ref_matches_jax_float64(method):
    """float64: every lane's n_steps and n_accepted exactly equal to the
    interpreted JAX kernel's, values to 1e-12."""
    (ys_j, acc_j, stp_j), (ys_t, acc_t, stp_t) = _lanes_both(
        method, np.float64, rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(stp_t, stp_j)
    np.testing.assert_array_equal(acc_t, acc_j)
    assert np.median(stp_t) > 8 and (stp_t != acc_t).any()   # adaptive
    assert len(np.unique(stp_t)) > 3                    # per-lane control
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ['dopri5', 'bosh3'])
def test_lanes_ref_matches_jax_float32(method):
    """float32: as for the whole-batch solver, a one-ULP difference in a
    stage slope (matmul summation order, tanh) moves a lane's embedded
    error estimate, a near-cancelling sum, by far more than one ULP, and
    with it the lane's step sizes.  Most lanes keep their counts; a few
    differ by up to two steps (measured), and values by up to the solver's
    tolerance -- the spread between JAX's own float32 and float64 runs of
    this kernel is larger still."""
    (ys_j, acc_j, stp_j), (ys_t, acc_t, stp_t) = _lanes_both(
        method, np.float32, rtol=1e-5, atol=1e-7)
    assert np.abs(stp_t - stp_j).max() <= 2
    assert (stp_t == stp_j).mean() >= 0.75
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-3)


def test_lanes_first_step_and_controller_options():
    (ys_j, acc_j, stp_j), (ys_t, acc_t, stp_t) = _lanes_both(
        'dopri5', np.float64, rtol=1e-6, atol=1e-8, first_step=1e-3,
        safety=0.8, ifactor=4.0, dfactor=0.3)
    np.testing.assert_array_equal(stp_t, stp_j)
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=1e-12)


def test_lanes_nan_poisons_unreached_outputs():
    """Lanes that run out of max_steps return NaN rows; the easy lanes
    finish (mirrors tests/test_pallas.py::test_kernel_nan_poisons_
    unreached_outputs).  Every lane that runs out does so on the same
    step, so the JAX kernel's tile-wide loop stops them exactly where the
    port's per-lane loop does: counts equal the JAX ones."""
    B = 32
    lam = np.concatenate([np.full(B // 2, 1.0), np.full(B // 2, 1000.0)])
    y0 = np.ones((1, B))
    ys_j, acc_j, stp_j = j_lanes(
        lambda tv, yv, l: -l[None, :] * yv, jnp.asarray(y0), 0.0, 1.0,
        rtol=1e-6, atol=1e-8, params=(jnp.asarray(lam),), max_steps=8,
        interpret=True)
    lam_t = torch.from_numpy(lam)
    ys_t, acc_t, stp_t = dopri5_integrate_batched(
        lambda tv, yv: -lam_t[None, :] * yv, torch.from_numpy(y0), 0.0, 1.0,
        rtol=1e-6, atol=1e-8, max_steps=8)
    vals = ys_t.numpy()[0]
    assert np.isfinite(vals[:B // 2]).all()
    assert np.isnan(vals[B // 2:]).all()
    np.testing.assert_array_equal(stp_t.numpy(), np.asarray(stp_j))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_allclose(vals, np.asarray(ys_j)[0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ['dopri5', 'bosh3'])
def test_odeint_per_sample_kernel_route_matches_jax(method):
    """``odeint_per_sample_with_stats(options=dict(pallas=True))`` against
    JAX's kernel route: (B, T, D) values and per-sample Stats, float64;
    for an `MLPField` and for a plain per-sample callable with args."""
    ws, rng = _weights(4, np.float64)
    y0 = rng.randn(24, 2) * 1.5
    t = np.linspace(0.0, 1.0, 4)
    ys_j, st_j = j_per_sample(
        lambda tt_, yy, *w: j_field(tt_, yy, *w), jnp.asarray(y0),
        jnp.asarray(t), args=tuple(jnp.asarray(w) for w in ws),
        rtol=1e-7, atol=1e-9, method=method,
        options=dict(pallas=True, interpret=True))
    t_field = lambda tt_, y, w1, b1, w2, b2: torch.tanh(y ** 3 @ w1 + b1) @ w2 + b2
    kernels.reset_launch_counts()
    with torch.no_grad():
        runs = [tt.odeint_per_sample_with_stats(
                    _model(ws), torch.from_numpy(y0), torch.from_numpy(t),
                    rtol=1e-7, atol=1e-9, method=method,
                    options=dict(pallas=True)),
                tt.odeint_per_sample_with_stats(
                    t_field, torch.from_numpy(y0), torch.from_numpy(t),
                    args=tuple(torch.from_numpy(w) for w in ws),
                    rtol=1e-7, atol=1e-9, method=method,
                    options=dict(pallas=True))]
    assert kernels.launch_counts == {'rk4_integrate': 0,
                                     'dopri5_integrate_batched': 0,
                                     'dopri5_events_batched': 0,
                                     'fused_stage_step': 0}
    for ys_t, st_t in runs:
        assert ys_t.shape == (24, 4, 2)
        np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                                   atol=1e-12)
        for a, b in zip(st_t[:5], st_j[:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("call", [
    dict(options=None), dict(options=dict(pallas=True, rtol_per_leaf=1)),
    dict(options=dict(pallas=True), method='kvaerno3'),
    dict(options=None, event_fn=lambda t, y: y[0]),
    dict(options=dict(pallas=True), args=(np.linspace(0.5, 2.0, 4),),
         args_axes=(-1,)),
])
def test_per_sample_vmap_route_raises(call):
    """The calls that JAX's `_pallas_qualifies` sends to its vmap route, or
    to the kernel with per-sample args, each as JAX answers it: a problem
    off the kernel route (no ``pallas``, or an option the kernel does not
    take) is the batched driver's, values to 1e-12 and `Stats` equal to
    JAX's vmap route; per-sample args on the kernel route run its plain
    version, equal to JAX's kernel in interpret mode; a stiff method (which
    JAX's rules send to its vmap route) the batched driver's, its
    per-sample Newton steps included; an event solve with three output times raises
    the ValueError JAX's vmap route raises."""
    call = dict(call)
    y0 = np.linspace(0.5, 1.5, 8).reshape(4, 2)
    t = np.linspace(0.0, 1.0, 3)
    args = call.pop('args', ())
    if args:
        j_func, t_func = (lambda tt_, y, a: -a * y), (lambda tt_, y, a: -a * y)
    else:
        j_func, t_func = (lambda tt_, y: -y), (lambda tt_, y: -y)
    t_call = lambda: tt.odeint_per_sample_with_stats(
        t_func, torch.from_numpy(y0), torch.from_numpy(t),
        args=tuple(torch.from_numpy(a) for a in args), **call)
    j_opts = call.pop('options', None)
    if j_opts and j_opts.get('pallas'):
        j_opts = dict(j_opts, interpret=True)
    j_call = lambda: j_per_sample(j_func, jnp.asarray(y0), jnp.asarray(t),
                                  args=tuple(jnp.asarray(a) for a in args),
                                  options=j_opts, **call)
    if 'event_fn' in call:
        for run in (j_call, t_call):
            with pytest.raises(ValueError, match="len\\(t\\) == 2"):
                run()
        return
    ys_j, st_j = j_call()
    with torch.no_grad():
        ys_t, st_t = t_call()
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cuda_route_refuses_a_field_it_cannot_run():
    """A non-MLPField field has no CUDA kernel: the wrapper raises (naming
    the supported family) rather than quietly running the plain version.
    Checked on the CPU through the same check the CUDA route runs."""
    with pytest.raises(TypeError, match="MLPField"):
        kernels._kernel_mlp(lambda t, y: -y, (), torch.float32,
                            torch.device('cpu'), 2, 'rk4_integrate')
    ws, _ = _weights(0, np.float32, D=3)
    with pytest.raises(ValueError, match="state dimension"):
        kernels._kernel_mlp(_model(ws), (), torch.float32,
                            torch.device('cpu'), 2, 'rk4_integrate')


def test_wrappers_refuse_gradients():
    """Both kernels are forward-only, as the JAX kernels are."""
    ws, rng = _weights(0, np.float64)
    model = _model(ws)                      # parameters require grad
    y0 = torch.from_numpy(rng.randn(4, 2))
    with pytest.raises(RuntimeError, match="forward-only"):
        rk4_integrate(model, y0, 0.0, 0.1, 2)
    with pytest.raises(RuntimeError, match="forward-only"):
        dopri5_integrate_batched(model, y0.T.contiguous(), 0.0, 1.0)
    with pytest.raises(RuntimeError, match="forward-only"):
        tt.odeint_per_sample(lambda t, y, a: -a * y, y0,
                             torch.linspace(0.0, 1.0, 3),
                             args=(torch.ones(2, dtype=torch.float64,
                                              requires_grad=True),),
                             options=dict(pallas=True))


# ---- K-events (per-lane event solves) --------------------------------------

def _event_out(outs):
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("max_steps", [10_000, 4])
def test_events_ref_matches_jax_decay(max_steps):
    """The lambda-decay field of tests/test_pallas.py::test_events_kernel_
    accuracy in float64: each lane stops where y = 0.5, at ln 2 / lambda.
    Per lane, `found`, step and accept counts equal the interpreted JAX
    kernel's and the event time agrees to 1e-12; with max_steps=4 some
    lanes do not fire (NaN, their last accepted state)."""
    B = 64
    rng = np.random.RandomState(0)
    lam = 0.5 + rng.rand(B)
    y0 = np.ones((2, B))
    want = _event_out(j_events(
        lambda tv, yv, l: -l[None, :] * yv, jnp.asarray(y0), 0.0,
        lambda tv, yv: yv[:1] - 0.5, rtol=1e-6, atol=1e-8,
        params=(jnp.asarray(lam),), max_steps=max_steps, interpret=True))
    lam_t = torch.from_numpy(lam)
    got = [o.numpy() for o in dopri5_events_batched(
        lambda tv, yv: -lam_t[None, :] * yv, torch.from_numpy(y0), 0.0,
        lambda tv, yv: yv[:1] - 0.5, rtol=1e-6, atol=1e-8,
        max_steps=max_steps)]
    for g, w, name in zip(got[2:], want[2:], ('found', 'acc', 'steps')):
        np.testing.assert_array_equal(g, w, err_msg=name)
    found = got[2][0] == 1
    np.testing.assert_array_equal(np.isnan(got[0][0]), ~found)
    np.testing.assert_allclose(got[0][0, found], want[0][0, found], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got[1][:, found], want[1][:, found], rtol=0,
                               atol=1e-12)
    if max_steps == 4:
        assert 0 < found.sum() < B
        # a lane that did not fire returns its state at the end of its last
        # step, a time that carries the last-bit drift of its step sizes
        # (the error ratio's near-cancelling sum rounds differently in XLA;
        # see tests/test_torch_events.py): 2.3e-12 measured
        np.testing.assert_allclose(got[1][:, ~found], want[1][:, ~found],
                                   rtol=0, atol=1e-10)
    else:
        assert found.all()
        np.testing.assert_allclose(got[0][0], np.log(2.0) / lam, atol=1e-5)


def _linear_event_problem(seed, dtype, B=32, H=16):
    ws, rng = _weights(seed, dtype, H=H, scale=0.3)
    y0 = (rng.randn(2, B) * 0.8).astype(dtype)
    thr = float(np.median(y0[0]))
    W = np.array([[1.0, 0.0], [0.0, 0.0]], dtype)
    c = np.array([0.0, 1.0], dtype)
    b = np.array([-thr, -0.7], dtype)
    # the K outputs' signs at t0, per lane: (K, B)
    sign0 = np.sign(W @ y0 + b[:, None])
    return ws, y0, (W, c, b), sign0


def j_linear_event(tv, yv, W, c, b, s0):
    """The sign-combined LinearEvent in JAX's lane layout; a Pallas kernel
    takes its arrays as `ev_params`."""
    return jnp.min((W @ yv + c[:, None] * tv + b[:, None]) * s0, axis=0,
                   keepdims=True)


def _j_ev_params(W, c, b, sign0):
    return dict(ev_params=tuple(jnp.asarray(v) for v in (W, c, b, sign0)),
                per_lane_ev_params=(False, False, False, True))


@pytest.mark.parametrize("method", ['dopri5', 'bosh3'])
def test_events_ref_mlp_linear_event_matches_jax(method):
    """An MLPField with a two-output LinearEvent -- a threshold on y[0] at
    its median, so about half the lanes cross it, and a time cut-off at 0.7
    that ends every other lane -- sign-combined with ``ev_params=(sign0,)``
    as the per-sample route does: float64 counts and `found` exactly equal,
    event times and states to 1e-12."""
    ws, y0, (W, c, b), sign0 = _linear_event_problem(5, np.float64)
    want = _event_out(j_events(
        j_lane_field, jnp.asarray(y0), 0.0, j_linear_event, rtol=1e-7,
        atol=1e-9, method=method, params=tuple(jnp.asarray(w) for w in ws),
        per_lane_params=(False,) * 4, interpret=True,
        **_j_ev_params(W, c, b, sign0)))
    event = LinearEvent(W, time_coef=c, bias=b,
                        device='cpu').requires_grad_(False)
    got = [o.numpy() for o in dopri5_events_batched(
        _model(ws).requires_grad_(False), torch.from_numpy(y0), 0.0, event,
        ev_params=(torch.from_numpy(sign0),), rtol=1e-7, atol=1e-9,
        method=method)]
    for g, w, name in zip(got[2:], want[2:], ('found', 'acc', 'steps')):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].all()
    cut = np.abs(got[0][0] - 0.7) < 1e-9           # lanes ended by the time
    assert 0 < cut.sum() < y0.shape[1]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1][0, ~cut],
                               np.median(y0[0]) * np.ones((~cut).sum()),
                               atol=1e-6)


def test_events_ref_matches_jax_float32():
    """float32 (time in float32 too, as in the TPU kernel): a one-ULP
    difference in a stage slope moves a lane's embedded error estimate and
    its step sizes, as for K-dopri5 (test_lanes_ref_matches_jax_float32),
    so most lanes keep their counts, a few differ by up to two steps, and
    event times agree to the solver's tolerance."""
    ws, y0, (W, c, b), sign0 = _linear_event_problem(6, np.float32, B=64)
    want = _event_out(j_events(
        j_lane_field, jnp.asarray(y0), 0.0, j_linear_event, rtol=1e-5,
        atol=1e-7, params=tuple(jnp.asarray(w) for w in ws),
        per_lane_params=(False,) * 4, interpret=True,
        **_j_ev_params(W, c, b, sign0)))
    event = LinearEvent(W, time_coef=c, bias=b,
                        device='cpu').requires_grad_(False)
    got = [o.numpy() for o in dopri5_events_batched_ref(
        _model(ws).requires_grad_(False), torch.from_numpy(y0), 0.0, event,
        ev_params=(torch.from_numpy(sign0),), rtol=1e-5, atol=1e-7)]
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[2], want[2])
    dsteps = np.abs(got[4] - want[4])
    assert dsteps.max() <= 2 and (dsteps == 0).mean() >= 0.75
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


def test_events_nan_sign_semantics():
    """jnp.sign is NaN at NaN, torch.sign 0: a lane whose event turns NaN
    on an accepted step counts as a hit in both packages, and a lane
    whose event is 0 at t0 fires on its first accepted step."""
    B = 4
    y0 = np.array([[1.0, 1.0, 0.5, 1.0]])
    ev_j = lambda tv, yv: jnp.where(tv > 0.3, jnp.nan, yv - 0.5)
    ev_t = lambda tv, yv: torch.where(tv > 0.3, float('nan'), yv - 0.5)
    want = _event_out(j_events(
        lambda tv, yv: -yv, jnp.asarray(y0), 0.0, ev_j, rtol=1e-6,
        atol=1e-8, first_step=0.1, interpret=True))
    got = [o.numpy() for o in dopri5_events_batched_ref(
        lambda tv, yv: -yv, torch.from_numpy(y0), 0.0, ev_t, rtol=1e-6,
        atol=1e-8, first_step=0.1)]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    assert got[2].all() and got[4][0, 2] == 1
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)


def test_events_kernel_refuses_what_it_cannot_run():
    """On CUDA the event kernel takes a LinearEvent with a (K, B) sign0;
    the checks it runs there, run on the CPU."""
    with pytest.raises(TypeError, match="LinearEvent"):
        kernels._kernel_event(lambda tv, yv: yv[:1], (), torch.float64,
                              torch.device('cpu'), 2, 8)
    event = LinearEvent(np.ones((2, 2)), dtype=torch.float64, device='cpu')
    with pytest.raises(ValueError, match="sign0"):
        kernels._kernel_event(event, (torch.ones(2, 7, dtype=torch.float64),),
                              torch.float64, torch.device('cpu'), 2, 8)
    with pytest.raises(ValueError, match="state dimension"):
        kernels._kernel_event(event, (), torch.float64, torch.device('cpu'),
                              3, 8)
    with pytest.raises(ValueError, match="K <= 4"):
        LinearEvent(np.ones((5, 2)), device='cpu')


def test_linear_event_rows_and_lanes_agree():
    rng = np.random.RandomState(7)
    event = LinearEvent(rng.randn(3, 4), time_coef=rng.randn(3),
                        bias=rng.randn(3), dtype=torch.float64, device='cpu')
    y = torch.from_numpy(rng.randn(5, 4))
    t = torch.from_numpy(rng.rand(5))
    with torch.no_grad():
        rows = torch.stack([event(t[i], y[i]) for i in range(5)])
        lanes = event.lanes(t[None], y.T)
    torch.testing.assert_close(lanes, rows.T, rtol=0, atol=1e-15)


def test_packed_tableau_is_made_once_per_key():
    """The tableau and the output times are packed and copied once per key,
    so a timed repeat launch copies nothing host to device."""
    cpu = torch.device('cpu')
    a = kernels.packed_tableau('dopri5', torch.float32, cpu)
    assert kernels.packed_tableau('dopri5', torch.float32, cpu) is a
    assert kernels.packed_tableau('dopri5', torch.float64, cpu) is not a
    tab, n_alpha, order, fsal = kernels.packed_tableau('bosh3',
                                                       torch.float64, cpu)
    assert (n_alpha, order, fsal) == (3, 3, True)
    assert tab[0:3].tolist() == [0.5, 0.75, 1.0]
    ts = (0.0, 0.5, 1.0)
    assert kernels._device_times(ts, torch.float32, cpu) is \
        kernels._device_times(ts, torch.float32, cpu)
    # dopri8's 14 stages fill the packed layout (csrc/lane_ops.cuh)
    tab, n_alpha, order, fsal = kernels.packed_tableau('dopri8',
                                                       torch.float64, cpu)
    d8 = tableaus.DOPRI8
    assert (n_alpha, order, fsal) == (13, 8, True)
    assert tab.numel() == 13 + 13 * 13 + 3 * 14
    assert tab[:13].tolist() == list(d8.alpha)
    assert tab[13:182].reshape(13, 13).numpy().tolist() == \
        np.asarray(d8.beta).tolist()
    assert tab[182:196].tolist() == list(d8.c_sol)
    assert tab[196:210].tolist() == list(d8.c_error)
    assert tab[210:224].tolist() == list(d8.c_mid)


def test_build_reads_the_log_of_a_cached_library(tmp_path, monkeypatch):
    """A library already built is loaded with the ptxas log its build
    wrote beside it, so the register and spill summary is there on every
    run.  (The load itself is faked: there is no CUDA library here.)"""
    class FakeLib:
        def __getattr__(self, name):
            fn = lambda *a: 0
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_build", lambda cu, so: pytest.fail(
        "a cached library must not be rebuilt"))
    _build.library.cache_clear()
    try:
        digest = _build.hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        cu, cuh = _build._sources()
        for path in cu + cuh:
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        so = tmp_path / f"libtdt_kernels_{digest.hexdigest()[:16]}.so"
        so.write_bytes(b"")
        so.with_suffix(".log").write_text("ptxas info : Used 40 registers")
        _build.library()
        assert _build.build_info["log"] == "ptxas info : Used 40 registers"
        assert _build.build_info["path"] == str(so)
    finally:
        _build.library.cache_clear()
        _build.build_info.update(seconds=None, log="", path=None)


@pytest.mark.parametrize("B,H,want", [
    (1, 64, 32), (1024, 64, 32), (2048, 64, 32), (4096, 64, 16),
    (8192, 64, 8), (16384, 64, 4), (32767, 64, 4), (32768, 64, 1),
    (65536, 64, 1), (1 << 20, 64, 1),
    (1024, 8, 8), (1024, 1, 1), (1024, 3, 1), (1024, 4, 4),
])
def test_rk4_group_width(B, H, want):
    """K-rk4's lanes a trajectory: 1, or a power of two from 4 to 32 and at
    most H, the least that gives B * L >= _RK4_THREADS threads (or the
    cap); 1 where 2 would do."""
    L = kernels._rk4_group_width(B, H)
    assert L == want
    assert L in (1, 4, 8, 16, 32) and L <= max(H, 1)
    if L > 1:
        assert B * L >= kernels._RK4_THREADS or L == 32 or 2 * L > H
        assert B * (L // 2) < kernels._RK4_THREADS
    else:
        assert B * 2 >= kernels._RK4_THREADS or H < 4


# ---- the lane groups of K-dopri5 and K-events --------------------------------

@pytest.mark.parametrize("B,H,want", [
    (1, 64, 32), (33, 64, 32), (1024, 64, 32), (16384, 64, 4),
    (32768, 64, 1), (65536, 64, 1),
    (1, 8, 8), (1024, 4, 4), (1024, 2, 1), (33, 1, 1), (16384, 3, 1),
])
def test_lane_group_width(B, H, want):
    """K-dopri5's and K-events' lanes a trajectory: 1, or a power of two
    from 4 to 32 and at most H, the least that gives B * L >= _RK4_THREADS
    threads (or the cap); 1 where 2 would do (K-rk4's rule)."""
    L = kernels._lane_group_width(B, H)
    assert L == want
    assert L in (1, 4, 8, 16, 32) and L <= max(H, 1)
    if L > 1:
        assert B * (L // 2) < kernels._RK4_THREADS
        assert B * L >= kernels._RK4_THREADS or L == 32 or 2 * L > H
    else:
        assert B * 2 >= kernels._RK4_THREADS or H < 4


def _lanes_inputs():
    ws, rng = _weights(11, np.float64)
    y0 = torch.from_numpy(rng.randn(2, 8))
    event = LinearEvent([[1.0, 0.0]], bias=[-0.5], dtype=torch.float64,
                        device='cpu').requires_grad_(False)
    sign0 = torch.sign(event.lanes(torch.zeros(1, 8, dtype=torch.float64),
                                   y0))
    return _model(ws).requires_grad_(False), y0, event, sign0


@pytest.mark.parametrize("group", [0, 3, 64, -2, 2.0, "4"])
@pytest.mark.parametrize("wrapper", ["lanes", "events"])
def test_wrappers_refuse_a_bad_group_width(monkeypatch, wrapper, group):
    """A group width the kernels cannot take (not a power of two from 1 to
    32) raises before either the kernel or the plain version runs."""
    model, y0, event, sign0 = _lanes_inputs()
    for name in ("dopri5_integrate_batched_ref", "dopri5_events_batched_ref",
                 "_lanes_launch", "_events_launch"):
        monkeypatch.setattr(kernels, name, lambda *a, **k: pytest.fail(
            "ran before the group width was checked"))
    with pytest.raises(ValueError, match="power of two from 1 to 32"):
        if wrapper == "lanes":
            dopri5_integrate_batched(model, y0, 0.0, 1.0, group=group)
        else:
            dopri5_events_batched(model, y0, 0.0, event, ev_params=(sign0,),
                                  group=group)


@pytest.mark.parametrize("group", [None, 1, 32])
def test_group_width_leaves_the_plain_version_alone(group):
    """On the CPU a valid width is accepted and the plain version runs: the
    width shapes only the kernel's summation order."""
    model, y0, event, sign0 = _lanes_inputs()
    with torch.no_grad():
        got = dopri5_integrate_batched(model, y0, 0.0, 1.0, group=group)
        want = dopri5_integrate_batched_ref(model, y0, 0.0, 1.0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        got = dopri5_events_batched(model, y0, 0.0, event,
                                    ev_params=(sign0,), group=group)
        want = dopri5_events_batched_ref(model, y0, 0.0, event,
                                         ev_params=(sign0,))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_group_wider_than_the_hidden_layer_is_refused():
    """On CUDA a group splits the field's H hidden units, so it may not be
    wider than H; the check the launch runs, run on the CPU."""
    with pytest.raises(ValueError, match="at most H"):
        kernels._group_for(1024, 16, 32, 'dopri5_integrate_batched')
    assert kernels._group_for(1024, 16, 16, 'x') == 16
    assert kernels._group_for(1024, 64, None, 'x') == \
        kernels._lane_group_width(1024, 64)


@pytest.mark.parametrize("weight", [
    [[1.0, 0.0]], np.array([[1.0, 0.0]]), ((1.0, 0.0),)],
    ids=["list", "ndarray", "tuple"])
def test_linear_event_defaults_to_the_card(weight):
    """With `device` left at None and a weight that is not a tensor, a
    LinearEvent goes on the CUDA device, as MLPField does; with no CUDA
    device (as here) that raises, naming device='cpu'."""
    if torch.cuda.is_available():
        assert LinearEvent(weight).weight.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LinearEvent(weight, bias=[-0.5])
    event = LinearEvent(weight, bias=[-0.5], device='cpu')
    assert all(p.device.type == 'cpu' for p in event.parameters())


def test_linear_event_keeps_a_tensor_weights_device():
    event = LinearEvent(torch.ones(2, 3, dtype=torch.float64),
                        time_coef=[1.0, 0.0], bias=np.zeros(2))
    assert all(p.device.type == 'cpu' and p.dtype == torch.float64
               for p in event.parameters())


# ---- dopri8 and D > 8 (the CUDA kernels' shared-memory instances) ----------

# dopri8's embedded error estimate is a near-cancelling sum of 14 slopes.
# On a lane where the field is nearly linear over a step it is rounding
# noise, and the controller's next step (min(ifactor, 0.9 ratio^-1/8), not
# yet at its cap for ratios above 4e-9) follows that noise: two summation
# orders then take steps of slightly different sizes, agree to the solver's
# tolerance rather than to 1e-12, and can flip an accept.  A first step of
# 0.2, where the estimate is truncation, and a field with no flat lanes
# (no y**3 near 0) keep the counts equal.  Values against JAX's
# interpreted kernel, measured: 2.1e-11 (dopri8, D=2), 2.0e-14 (dopri5,
# D=12), 2.2e-11 (dopri8, D=12); held to 1e-9, 1e-12 and 1e-9.
WIDE = [(2, 1, 0.5, 'dopri8', 1e-9), (12, 1, 0.3, 'dopri5', 1e-12),
        (12, 1, 0.3, 'dopri8', 1e-9)]


def _wide_problem(D, power, scale, seed=7, B=48):
    rng = np.random.RandomState(seed)
    ws = ((rng.randn(D, 32) * scale), rng.randn(32) * 0.1,
          (rng.randn(32, D) * scale), rng.randn(D) * 0.1)
    y0 = rng.randn(D, B) * 0.8

    def j_field(tv, yv, w1, b1, w2, b2):
        x = yv.T if power == 1 else yv.T ** power
        return (jnp.tanh(x @ w1 + b1) @ w2 + b2).T

    model = mlp_params_from_jax([dict(w=ws[0], b=ws[1]),
                                 dict(w=ws[2], b=ws[3])], power=power,
                                device='cpu').requires_grad_(False)
    return ws, y0, j_field, model


@pytest.mark.parametrize("D,power,scale,method,tol", WIDE)
def test_lanes_ref_dopri8_and_wide_state_match_jax(D, power, scale, method,
                                                   tol):
    """The plain K-dopri5 on dopri8 (14 stages) and a 12-row state against
    the interpreted JAX kernel, which pads D to its sublane tile: float64
    per-lane steps and accepts exactly equal."""
    ws, y0, j_field, model = _wide_problem(D, power, scale)
    kw = dict(rtol=1e-7, atol=1e-9, method=method, first_step=0.2)
    ts = np.linspace(0.0, 1.0, 4)
    ys_j, acc_j, stp_j = (np.asarray(o) for o in j_lanes(
        j_field, jnp.asarray(y0), 0.0, 1.0, ts=ts,
        params=tuple(jnp.asarray(w) for w in ws),
        per_lane_params=(False,) * 4, interpret=True, **kw))
    ys_t, acc_t, stp_t = (o.numpy() for o in dopri5_integrate_batched(
        model, torch.from_numpy(y0), 0.0, 1.0, ts=ts, **kw))
    np.testing.assert_array_equal(stp_t, stp_j)
    np.testing.assert_array_equal(acc_t, acc_j)
    assert ys_t.shape == (4, D, 48)
    np.testing.assert_allclose(ys_t, ys_j, rtol=0, atol=tol)


@pytest.mark.parametrize("D,power,scale,method,tol", WIDE)
def test_events_ref_dopri8_and_wide_state_match_jax(D, power, scale, method,
                                                    tol):
    """The plain K-events likewise, with a LinearEvent threshold on y[0]
    and a time cut-off: found, steps and accepts exactly equal."""
    ws, y0, j_field, model = _wide_problem(D, power, scale)
    W = np.zeros((2, D))
    W[0, 0] = 1.0
    c = np.array([0.0, 1.0])
    b = np.array([-float(np.median(y0[0])), -0.7])
    sign0 = np.sign(W @ y0 + b[:, None])
    kw = dict(rtol=1e-7, atol=1e-9, method=method, first_step=0.2)
    want = _event_out(j_events(
        j_field, jnp.asarray(y0), 0.0, j_linear_event,
        params=tuple(jnp.asarray(w) for w in ws),
        per_lane_params=(False,) * 4, interpret=True,
        **_j_ev_params(W, c, b, sign0), **kw))
    event = LinearEvent(W, time_coef=c, bias=b,
                        device='cpu').requires_grad_(False)
    got = [o.numpy() for o in dopri5_events_batched(
        model, torch.from_numpy(y0), 0.0, event,
        ev_params=(torch.from_numpy(sign0),), **kw)]
    for g, w, name in zip(got[2:], want[2:], ('found', 'acc', 'steps')):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol)
