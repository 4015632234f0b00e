"""The bfloat16 and float16 traced instances of K-dopri5 and K-events on the
CPU: their plain versions (`ops/traced.PerSampleField` and
`PerSampleEvent` on a 16-bit state, which run the traced graph op by op in
the state dtype, `ops/traced._InStateDtype`) against the JAX package's
Pallas kernels in interpret mode, through ``odeint_per_sample_with_stats(
..., options=dict(pallas=True))``, on the same numpy inputs; and the C++
the tracer emits for a 16-bit state.

JAX's side runs as tests/test_torch_lanes_16bit.py runs it: compiled with
XLA's excess precision off and its `fusion` and `algsimp` passes disabled,
so that every 16-bit operation rounds (ROADMAP C11).  Then the two agree
bit for bit: every counter exactly, every value (NaNs at the same places).

The fields: `examples/ensemble.py`'s oscillators with a per-lane omega and
its first-zero event, and a field whose scalar operands are not exact in
the state dtype (0.3 and 0.1) and which cubes the state.  There PyTorch
alone would keep ``0.3 * y`` a float32 product rounded once, and compute a
float16 ``y ** 3`` in float rounded once; JAX rounds the weakly typed
scalar to the state dtype first, and its integer power rounds each product,
and so do the plain version and the emitted functor (the float16 case
departs from JAX when the plain version does what PyTorch alone does,
`test_scalar_rounding_is_what_float16_parity_needs`).

The card's instances against these plain versions: tests/test_torch_cuda.py
(``test_traced_16bit_instances_match_plain``, marked gpu).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.ops import traced
from torchdiffeq_tpu_torch.ops.traced import PerSampleEvent, PerSampleField
from test_torch_lanes_16bit import JDT, _jax_exact, _f32

B = 32
# per-lane omega: up to 20 in bfloat16; float16's range ends at 65504, and
# the Hairer step's square of |f| / scale overflows it past omega ~ 1.5 at
# these tolerances (each such lane stalls at dt = 0 in both packages), so
# its lanes take omega in [0.3, 1.2]
OMEGA = {torch.bfloat16: np.exp(np.random.RandomState(0).uniform(
    0.0, np.log(20.0), B)), torch.float16: np.exp(
        np.random.RandomState(0).uniform(np.log(0.3), np.log(1.2), B))}
Y0 = np.stack([np.ones(B), np.zeros(B)], axis=1)
T5 = np.linspace(0.0, 2.0, 5)


def t_osc(t, y, om):
    """examples/ensemble.py:46-48 (the port's examples/ensemble.field)."""
    return torch.stack([y[1], -om ** 2 * y[0] - 0.1 * y[1]])


def j_osc(t, y, om):
    return jnp.stack([y[1], -om ** 2 * y[0] - 0.1 * y[1]])


def t_scalars(t, y, om):
    return torch.stack([y[1], -om ** 2 * y[0] - 0.3 * y[1]
                        - 0.1 * y[0] ** 3])


def j_scalars(t, y, om):
    return jnp.stack([y[1], -om ** 2 * y[0] - 0.3 * y[1]
                      - 0.1 * y[0] ** 3])


FIELDS = {'ensemble': (t_osc, j_osc, 1.0), 'scalars': (t_scalars, j_scalars,
                                                       1.3)}
DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16}
# phase 15 (f)'s tolerances
KW = dict(args_axes=(-1,), rtol=1e-2, atol=1e-2)


def _same(a, b):
    """Bit for bit: the float32 views equal, NaNs at the same places."""
    a, b = _f32(a), _f32(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


def _same_counts(st_t, st_j):
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _solve_both(name, dtype, t, **kw):
    t_f, j_f, amp = FIELDS[name]
    y0 = Y0 * amp
    opts = dict(pallas=True, interpret=True, max_num_steps=2000)
    out_j, st_j = _jax_exact(
        lambda y, w: j_per_sample(j_f, y, t, args=(w,), options=opts,
                                  **dict(KW, **kw)),
        jnp.asarray(y0, JDT[dtype]), jnp.asarray(OMEGA[dtype], JDT[dtype]))
    with torch.no_grad():
        out_t, st_t = tt.odeint_per_sample_with_stats(
            t_f, torch.tensor(y0).to(dtype), torch.from_numpy(t),
            args=(torch.tensor(OMEGA[dtype]).to(dtype),), options=opts,
            **dict(KW, **kw))
    return (out_j, st_j), (out_t, st_t)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_integrate_matches_jax_bit_for_bit(name, dtype):
    """K-dopri5's traced plain version to the output times."""
    dt = DTYPES[dtype]
    (ys_j, st_j), (ys_t, st_t) = _solve_both(name, dt, T5)
    assert ys_t.dtype == dt
    _same_counts(st_t, st_j)
    _same(ys_t, ys_j)
    assert len(set(st_t.n_steps.tolist())) > 1
    assert np.isfinite(_f32(ys_t)).all()


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_first_zero_event_matches_jax_bit_for_bit(name, dtype):
    """K-events' traced plain version: each lane's first zero of x."""
    dt = DTYPES[dtype]
    ((et_j, ye_j), st_j), ((et_t, ye_t), st_t) = _solve_both(
        name, dt, np.array([0.0, 2.0]), event_fn=lambda t, y: y[0])
    _same_counts(st_t, st_j)
    _same(et_t, et_j)
    _same(ye_t, ye_j)
    assert np.isfinite(_f32(et_t)).all()


def test_scalar_rounding_is_what_float16_parity_needs(monkeypatch):
    """The float16 scalar field run by PyTorch alone (``torch.func.vmap``
    of the field, which keeps 0.3 and 0.1 in float32 and rounds
    ``y ** 3`` once) departs from JAX's kernel: the rule the plain
    version and the emitter follow is what makes them agree."""
    monkeypatch.setattr(PerSampleField, '__call__',
                        lambda self, tv, yv: self._lanes(tv[0], yv,
                                                         *self.args))
    (ys_j, st_j), (ys_t, _) = _solve_both('scalars', torch.float16, T5)
    assert not np.array_equal(np.nan_to_num(_f32(ys_t)),
                              np.nan_to_num(_f32(ys_j)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_field_and_event_round_as_jax(dtype):
    """One evaluation on random lanes: the plain field (with a shared
    matrix, a sum, sin and a power) and the sign-combined event equal JAX's
    evaluation of the same functions in the state dtype, bit for bit."""
    dt = DTYPES[dtype]
    rng = np.random.RandomState(5)
    Wm = rng.randn(2, 2)
    y = rng.randn(2, B)
    tv = np.full((1, B), 0.37)
    k = rng.uniform(0.5, 2.0, B)

    def t_f(t, y, Wt, kk):
        return (torch.sin(y @ Wt) * kk - 0.3 * y * torch.sum(y * y)
                + 0.7 * y ** 3 - 0.2 * t)

    def j_f(t, y, Wj, kk):
        return (jnp.sin(y @ Wj) * kk - 0.3 * y * jnp.sum(y * y)
                + 0.7 * y ** 3 - 0.2 * t)

    cast = lambda x: torch.tensor(x).to(dt)
    field = PerSampleField(t_f, (cast(Wm), cast(k)), (None, -1))
    got = field(cast(tv), cast(y))
    want = _jax_exact(
        lambda t_, y_, W_, k_: jnp.stack([j_f(t_[0, b], y_[:, b], W_, k_[b])
                                          for b in range(B)], axis=1),
        *(jnp.asarray(x, JDT[dt]) for x in (tv, y, Wm, k)))
    _same(got, want)

    ev = PerSampleEvent(lambda t, y: torch.stack([y[0] - 0.3, 0.1 * t - y[1]]))
    sign0 = cast(np.sign(rng.randn(2, B)))
    got = ev(cast(tv), cast(y), sign0)
    want = _jax_exact(
        lambda t_, y_, s_: jnp.min(jnp.stack([y_[0] - 0.3, 0.1 * t_[0]
                                              - y_[1]]) * s_, axis=0)[None],
        *(jnp.asarray(x, JDT[dt]) for x in (tv, y, _f32(sign0))))
    _same(got, want)


@pytest.mark.parametrize("dtype,ctype", [(torch.bfloat16, "tdt::bf16"),
                                         (torch.float16, "tdt::f16")])
def test_16bit_source(dtype, ctype):
    """The emitted instance: the state type, each scalar operand as its
    value in the state dtype, the integer power as JAX's products, and a
    matrix product's and a sum's terms accumulated in float and rounded
    once; the event beside it."""
    y0 = torch.ones(2, 4, dtype=dtype)
    Wm = torch.tensor([[0.3, -1.2], [1.1, 0.2]]).to(dtype)

    def f(t, y, Wt, om):
        return torch.tanh(y @ Wt) * om - 0.3 * y * torch.sum(y) \
            + 0.1 * y ** 3

    src = traced.events_source(
        PerSampleField(f, (Wm, torch.ones(4, dtype=dtype)), (None, -1)),
        PerSampleEvent(lambda t, y: y[0] - 0.3), y0, 'dopri5')
    c03 = repr(float(torch.tensor(0.3).to(dtype)))
    c01 = repr(float(torch.tensor(0.1).to(dtype)))
    assert f"using T = {ctype};" in src.source
    assert f"T({c03})" in src.source and f"T({c01})" in src.source
    assert "T(0.3)" not in src.source
    assert "(y[0] * (y[0] * y[0]))" in src.source
    # y @ W: two outputs of two terms; sum(y): one of two
    assert src.source.count("T(((tdt::acc(") == 2
    assert src.source.count("T((tdt::acc(") == 1
    assert "tdt_traced_events" in src.source
