"""K-dopri5 and K-events in bfloat16 and float16: the plain versions
(`ops/kernels.dopri5_integrate_batched_ref`, `dopri5_events_batched_ref`),
which the per-sample kernel route runs on the CPU, against the JAX
package's Pallas kernels in interpret mode
(`odeint_per_sample_with_stats(..., options=dict(pallas=True,
interpret=True))`), on the same numpy inputs.

Both round every operation to the state dtype, as the TPU kernel's
arithmetic in that dtype does: times, tableau, tolerances and
intermediates; the sums of a matrix product and of a norm accumulate in
float32 and round once.  XLA's CPU compiler departs from per-operation
rounding in three ways (ROADMAP C11): it may keep an intermediate of a
16-bit chain in float32 (`xla_allow_excess_precision`, on by default), a
float16 fusion evaluates its chain in float32, and the algebraic
simplifier rewrites `a / x**p` as `a * x**-p`.  JAX's side is therefore
compiled with the first off and the `fusion` and `algsimp` passes
disabled, and then both dtypes agree bit for bit: counts exactly, values
within one 16-bit unit in the last place (all equal here).

The step counters are exact ints in the port; JAX counts in the state
dtype, where bfloat16 stops at 256 (ROADMAP C10): held where JAX's are
exact, and shown where they are not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import LinearEvent, mlp_params_from_jax
from torchdiffeq_tpu_torch.ops import kernels as K

A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
T4 = np.linspace(0.0, 1.0, 4)
Y0 = np.random.RandomState(0).randn(8, 2) * 0.8


def j_cubic(t, y, a):
    return (y * y * y) @ a - 0.5 * y


def t_cubic(t, y, a):
    return (y * y * y) @ a - 0.5 * y


def _jax_exact(fn, *args):
    """`fn` jitted so that every 16-bit operation rounds, as the port's do:
    XLA's excess precision off, its fusion and algebraic simplifier
    passes disabled (ROADMAP C11)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        'xla_allow_excess_precision': False,
        'xla_disable_hlo_passes': 'fusion,algsimp'})(*args)


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _assert_ulps(got, want, ulps=1):
    """Values within `ulps` units in the last place of the port's 16-bit
    dtype (NaNs at the same places)."""
    bits = 7 if got.dtype == torch.bfloat16 else 10
    got, want = _f32(got), _f32(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                   - bits)
    far = np.abs(got - want) > ulps * unit
    assert not far[~np.isnan(want)].any()


JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
# float16 lanes: 32 of them, atol 1e-2 where bfloat16's is 1e-3 (a float16
# lane at atol 1e-3 overflows the Hairer step's squares and stalls at
# dt = 0, in JAX's kernel as in the port's, so most would only stall)
Y0_16 = np.random.RandomState(1).randn(32, 2) * 0.8


def _same_counts(st_t, st_j):
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _kernel_route(dtype, y0, method, rtol, atol):
    """K-dopri5's plain version on the cubic field against JAX's kernel."""
    kw = dict(rtol=rtol, atol=atol, method=method,
              options=dict(pallas=True, interpret=True, max_num_steps=200))
    ys_j, st_j = _jax_exact(
        lambda y0_, a: j_per_sample(j_cubic, y0_, T4, args=(a,), **kw),
        jnp.asarray(y0, JDT[dtype]), jnp.asarray(A, JDT[dtype]))
    ys_t, st_t = tt.odeint_per_sample_with_stats(
        t_cubic, torch.tensor(y0).to(dtype), torch.from_numpy(T4),
        args=(torch.tensor(A).to(dtype),), **kw)
    assert ys_t.dtype == dtype
    _same_counts(st_t, st_j)
    _assert_ulps(ys_t, ys_j)
    assert len(set(st_t.n_steps.tolist())) > 1


def _event_route(dtype, y0, rtol, atol):
    """K-events' plain version: the event times, states and counts."""
    kw = dict(rtol=rtol, atol=atol, event_fn=lambda t, y: y[0] - 0.3,
              options=dict(pallas=True, interpret=True, max_num_steps=200))
    (et_j, ys_j), st_j = _jax_exact(
        lambda y0_: j_per_sample(lambda t, y: -y, y0_, np.array([0.0, 5.0]),
                                 **kw), jnp.asarray(y0, JDT[dtype]))
    (et_t, ys_t), st_t = tt.odeint_per_sample_with_stats(
        lambda t, y: -y, torch.tensor(y0).to(dtype),
        torch.tensor([0.0, 5.0]), **kw)
    _same_counts(st_t, st_j)
    _assert_ulps(et_t, et_j)
    _assert_ulps(ys_t, ys_j)


def _mlp_route(dtype, y0, rtol, atol):
    """The field and event families the CUDA kernels evaluate, in a 16-bit
    dtype (the route the card runs): an `MLPField` carried across from
    JAX's weights, integrated to `ts` and to a `LinearEvent`."""
    rng = np.random.RandomState(4)
    params = [dict(w=rng.randn(2, 16) * 0.5, b=rng.randn(16) * 0.1),
              dict(w=rng.randn(16, 2) * 0.5, b=rng.randn(2) * 0.1)]
    rnd = lambda x: np.asarray(jnp.asarray(x, JDT[dtype]).astype(
        jnp.float32), np.float64)
    params = [{k: rnd(v) for k, v in p.items()} for p in params]
    model = mlp_params_from_jax(params, power=1, device='cpu').to(
        dtype).requires_grad_(False)
    flat = [jnp.asarray(p[k], JDT[dtype]) for p in params for k in 'wb']

    def j_mlp(t, y, w1, b1, w2, b2):
        return jnp.tanh(y @ w1 + b1) @ w2 + b2

    kw = dict(rtol=rtol, atol=atol,
              options=dict(pallas=True, interpret=True, max_num_steps=200))
    ys_j, st_j = _jax_exact(
        lambda y0_, *w: j_per_sample(j_mlp, y0_, T4, args=w, **kw),
        jnp.asarray(y0, JDT[dtype]), *flat)
    with torch.no_grad():
        ys_t, st_t = tt.odeint_per_sample_with_stats(
            model, torch.tensor(y0).to(dtype), torch.from_numpy(T4), **kw)
    _same_counts(st_t, st_j)
    _assert_ulps(ys_t, ys_j)
    ev = LinearEvent([[1.0, 0.0]], bias=[-0.35], dtype=dtype, device='cpu')
    kw_e = dict(kw, event_fn=lambda t, y: y[0] - 0.35)
    (et_j, ye_j), st_j = _jax_exact(
        lambda y0_, *w: j_per_sample(j_mlp, y0_, np.array([0.0, 4.0]),
                                     args=w, **kw_e),
        jnp.asarray(y0, JDT[dtype]), *flat)
    with torch.no_grad():
        (et_t, ye_t), st_t = tt.odeint_per_sample_with_stats(
            model, torch.tensor(y0).to(dtype), torch.tensor([0.0, 4.0]),
            **dict(kw_e, event_fn=ev))
    _same_counts(st_t, st_j)
    _assert_ulps(et_t, et_j)
    _assert_ulps(ye_t, ye_j)


@pytest.mark.parametrize("method", ['dopri5', 'bosh3', 'tsit5'])
@pytest.mark.parametrize("tol", [(1e-2, 1e-3), (1e-3, 1e-4)])
def test_bfloat16_kernel_route_matches_jax(method, tol):
    _kernel_route(torch.bfloat16, Y0, method, *tol)


def test_bfloat16_event_route_matches_jax():
    _event_route(torch.bfloat16, np.abs(Y0) + 0.5, 1e-2, 1e-3)


def test_bfloat16_mlp_field_and_linear_event_match_jax():
    _mlp_route(torch.bfloat16, np.abs(Y0) + 0.3, 1e-2, 1e-3)


@pytest.mark.parametrize("method", ['dopri5', 'bosh3', 'tsit5'])
@pytest.mark.parametrize("tol", [(1e-2, 1e-2), (3e-3, 1e-3)])
def test_float16_kernel_route_matches_jax(method, tol):
    _kernel_route(torch.float16, Y0_16, method, *tol)


def test_float16_event_route_matches_jax():
    _event_route(torch.float16, np.abs(Y0_16) + 0.5, 1e-2, 1e-2)


def test_float16_mlp_field_and_linear_event_match_jax():
    _mlp_route(torch.float16, np.abs(Y0_16) + 0.3, 1e-2, 1e-2)


def _np16_step(f, y, rtol, atol, method='dopri5'):
    """One lane's first step of K-dopri5 in numpy float16, each operation
    rounded (numpy's float16 arithmetic): the initial step, the stage
    sweep, the error ratio and the next step size."""
    h = np.float16
    alpha, beta, c_sol, c_err, _, order, fsal = (
        K._tableau_consts(method, torch.float16))
    rtol, atol, D = h(rtol), h(atol), h(y.shape[0])

    def rms(v):
        sq = [h(x * x) for x in v]
        return h(np.sqrt(h(np.float32(np.sum(np.float32(sq))) / D)))

    tiny = h(np.finfo(np.float16).tiny)
    fc = f(y)
    scale = np.array([h(atol + h(rtol * abs(x))) for x in y], np.float16)
    d0 = rms([h(a / b) for a, b in zip(y, scale)])
    d1 = rms([h(a / b) for a, b in zip(fc, scale)])
    if d0 < h(1e-5) or d1 < h(1e-5):
        h0 = h(1e-6)
    else:
        h0 = h(h(h(0.01) * d0) / max(d1, tiny))
    fp = f(np.array([h(a + h(h0 * b)) for a, b in zip(y, fc)], np.float16))
    d2 = h(rms([h(h(a - b) / s) for a, b, s in zip(fp, fc, scale)])
           / max(h0, tiny))
    inv = h(1.0 / order)
    if d1 <= h(1e-15) and d2 <= h(1e-15):
        h1 = max(h(1e-6), h(h0 * h(1e-3)))
    else:
        h1 = h(np.float32(h(h(0.01) / max(max(d1, d2), tiny))) ** inv)
    dt = min(h(h(100) * h0), h1)

    def comb(cs, ks):
        acc = None
        for c, k in zip(cs, ks):
            if c == 0.0:
                continue
            term = np.array([h(h(c) * x) for x in k], np.float16)
            acc = term if acc is None else np.array(
                [h(a + b) for a, b in zip(acc, term)], np.float16)
        return acc

    ks = [fc]
    yi = y
    for i in range(len(alpha)):
        yi = np.array([h(a + h(dt * b)) for a, b in
                       zip(y, comb(beta[i, :i + 1], ks))], np.float16)
        ks.append(f(yi))
    y1 = yi if fsal else np.array([h(a + h(dt * b)) for a, b in
                                   zip(y, comb(c_sol, ks))], np.float16)
    err = np.array([h(dt * b) for b in comb(c_err, ks)], np.float16)
    tol = [h(atol + h(rtol * max(abs(a), abs(b)))) for a, b in zip(y, y1)]
    ratio = rms([h(e / s) for e, s in zip(err, tol)])
    dfac = h(1.0) if ratio < h(1.0) else h(0.2)
    factor = min(h(10.0), max(h(h(0.9) / h(np.float32(max(ratio, tiny))
                                           ** inv)), dfac))
    return dt, y1, err, ratio, h(dt * factor)


@pytest.mark.parametrize("method", ['dopri5', 'bosh3'])
def test_float16_lane_step_rounds_each_operation(method):
    """float16: the plain version's first step of every lane equals numpy's
    float16 evaluation of it bit for bit, a reference independent of
    XLA's compiler passes (ROADMAP C11)."""
    y0 = (np.abs(Y0) + 0.3).astype(np.float16)
    rtol, atol = 1e-2, 1e-3

    def f_np(y):
        return np.array([np.float16(-x) for x in y], np.float16)

    yt = torch.from_numpy(y0.T.copy())
    f = lambda tv, yv: -yv
    (consts, r, a, tiny, inv, t, fc, dt) = K._lane_setup(
        f, yt, 0.0, method, rtol, atol, None)
    alpha, beta, c_sol, c_err, c_mid, order, fsal = consts
    y1, f1, err, _ = K._stage_sweep(f, t, dt, yt, fc, alpha, beta, c_sol,
                                    c_err, fsal)
    ratio = K._error_ratio(yt, y1, err, r, a)
    nxt = K._next_dt(dt, ratio, 0.9, 10.0, 0.2, tiny, inv)
    for b in range(y0.shape[0]):
        want = _np16_step(f_np, y0[b], rtol, atol, method)
        got = (dt[0, b], y1[:, b], err[:, b], ratio[0, b], nxt[0, b])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_float16_kernel_route_runs_the_plain_version():
    """The float16 route end to end: the lanes step, write every output
    time and agree with the float32 solve to the tolerance's scale."""
    y0 = np.abs(Y0) + 0.3
    kw = dict(rtol=1e-2, atol=1e-3, options=dict(pallas=True,
                                                 max_num_steps=200))
    ys16, st16 = tt.odeint_per_sample_with_stats(
        lambda t, y: -y, torch.tensor(y0).half(), torch.from_numpy(T4), **kw)
    ys32, _ = tt.odeint_per_sample_with_stats(
        lambda t, y: -y, torch.tensor(y0).float(), torch.from_numpy(T4), **kw)
    assert ys16.dtype == torch.float16
    assert (st16.error_code == 0).all() and (st16.n_steps > 1).all()
    np.testing.assert_allclose(ys16.float().numpy(), ys32.numpy(),
                               rtol=3e-2, atol=3e-3)


def test_bfloat16_counters_above_256_c10():
    """ROADMAP C10: JAX's kernel counts in bfloat16, where a count stops at
    256; a fast oscillator takes about 300 steps a lane, whose values the
    port's plain version and JAX's kernel agree on, while JAX reports 256
    steps and the port the count it took (at most `max_num_steps`, which
    JAX's bfloat16 test can never reach past 256)."""
    w = 2000.0
    y0 = np.array([[1.0, 0.0], [0.5, 0.0]])
    t = np.array([0.0, 0.25])
    kw = dict(rtol=1e-2, atol=1e-3,
              options=dict(pallas=True, interpret=True, max_num_steps=1000))
    ys_j, st_j = _jax_exact(
        lambda y0_: j_per_sample(
            lambda t_, y: jnp.stack([w * y[1], -w * y[0]]), y0_, t, **kw),
        jnp.asarray(y0, jnp.bfloat16))
    ys_t, st_t = tt.odeint_per_sample_with_stats(
        lambda t_, y: torch.stack([w * y[1], -w * y[0]]),
        torch.tensor(y0).bfloat16(), torch.from_numpy(t), **kw)
    _assert_ulps(ys_t, ys_j)
    assert np.asarray(st_j.n_steps).tolist() == [256, 256]
    assert (st_t.n_steps > 256).all() and (st_t.n_steps < 1000).all()
    assert (st_t.n_accepted > 256).all()
