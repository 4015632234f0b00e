"""The conv ODE-Net field (`models/conv_ode.py`) against the JAX package's
(tests/test_models.py:58, 121, 132, 168, 195, without the comparison with
the reference's torch ODEfunc, fault C1), on the same seed-made weights
carried across by `conv_params_from_jax`, float64 unless stated, at B <= 4,
6x6 and dim <= 8.

The field differs from JAX's only in the convolutions' and the GroupNorm
reductions' summation order: 1e-12 of max|y|.  A dopri5 solve at
rtol=atol=1e-3 takes the same steps (Stats equal) to 1e-10, and
`odeint_adjoint`'s gradients agree to 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdiffeq_tpu.adjoint as jadj
from torchdiffeq_tpu.models import conv_ode as jconv
import torchdiffeq_tpu_torch.adjoint as tadj
from torchdiffeq_tpu_torch.models import (ConvField, conv_field,
                                          conv_field_flops, conv_field_foldt,
                                          conv_params_from_jax, group_norm)
from torchdiffeq_tpu_torch.models import conv_ode as tconv
from torch_problems import counters

FIELD, SOLVE, GRAD = 1e-12, 1e-10, 1e-9


def _params(dim, seed=0):
    """bench.py's `make_shared_conv` weights at width `dim` (HWIO, time
    channel last, He scale), with nonzero biases so that they count."""
    rng = np.random.RandomState(seed)

    def conv():
        return dict(w=rng.randn(3, 3, dim + 1, dim) * np.sqrt(2.0 / (9 * (dim + 1))),
                    b=rng.randn(dim) * 0.1)
    return dict(conv1=conv(), conv2=conv())


def _jparams(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _x(b, h, w, dim, seed=1):
    return 0.3 * np.random.RandomState(seed).randn(b, h, w, dim)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dim,hw", [(8, 5)])
def test_conv_field_matches_jax(dim, hw):
    """test_conv_field_matches_reference_odefunc's shapes against JAX's
    `conv_field` (and its foldt variant, test_conv_field_foldt_matches_
    conv_field), at a time where the time channel counts."""
    p = _params(dim)
    x = _x(3, hw, hw, dim)
    model = conv_params_from_jax(p, device='cpu')
    want, want_f = jax.jit(lambda q, y: (jconv.conv_field(q, 0.37, y),
                                         jconv.conv_field_foldt(q, 0.37, y)))(
        _jparams(p), jnp.asarray(x))
    got = model(torch.tensor(0.37, dtype=torch.float64), torch.from_numpy(x))
    assert got.shape == x.shape
    assert _rel(got.detach(), want) <= FIELD
    foldt = conv_field_foldt(model, 0.37, torch.from_numpy(x))
    assert _rel(foldt.detach(), want_f) <= FIELD
    assert _rel(foldt.detach(), want) <= FIELD


@pytest.mark.parametrize("c", [16, 12, 48, 7])
def test_group_norm_matches_jax(c):
    """The group count (the largest divisor of C at most min(32, C)), the
    population variance and eps, float64, to 1e-12."""
    x = 1.0 + np.random.RandomState(c).randn(2, 4, 4, c)
    got = group_norm(torch.from_numpy(x))
    assert _rel(got, jconv.group_norm(jnp.asarray(x))) <= FIELD


def test_group_norm_bf16_statistics_in_f32():
    """test_group_norm_f32_stats_for_bf16: a bfloat16 state's statistics
    are taken in float32 and the output cast back.  Against JAX's: the
    float32 results differ in the reductions' last bits, so each element is
    JAX's or one bfloat16 step (2^-8 relative) from it; the groups are
    normalised in float32."""
    x32 = (1.0 + np.random.RandomState(0).randn(2, 4, 4, 16)).astype(np.float32)
    xb = torch.from_numpy(x32).bfloat16()
    out = group_norm(xb)
    assert out.dtype == torch.bfloat16
    want = jconv.group_norm(jnp.asarray(x32).astype(jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    got = out.float().numpy()
    step = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -8
    assert np.all(np.abs(got - want) <= step * 1.0001)
    assert abs(float(out.float().mean())) < 0.05
    assert abs(float(out.float().var()) - 1.0) < 0.1
    # float32 statistics: a bfloat16 mean of the squares would be off by
    # far more than this on a mean of 1
    ref = group_norm(xb.double()).float()
    assert float((out.float() - ref).abs().max()) <= 2.0 ** -6


def test_conv_field_flops_counts_both_convs():
    """test_conv_field_flops_counts_both_convs: equal to JAX's."""
    for args in ((4, 6, 6, 64), (128, 6, 6, 64), (2, 5, 7, 8)):
        assert conv_field_flops(*args) == jconv.conv_field_flops(*args)
    assert conv_field_flops(4, 6, 6, 64) == 2 * (2 * 4 * 6 * 6 * 9 * 65 * 64)


@pytest.mark.parametrize("hw,dim", [((5, 7), 4)])
def test_conv_apply_foldt_gradients(hw, dim):
    """test_conv_apply_foldt_matches_concat_conv: folding the time channel
    out re-associates the same products; values and the gradients in the
    weights, t and x match the concat convolution's to rounding, border
    positions included, and JAX's foldt gradients."""
    h, w = hw
    p = _params(dim)['conv1']
    x = np.random.RandomState(2).randn(2, h, w, dim)
    jg = jax.jit(jax.grad(lambda w_, t_, x_: jnp.sum(jconv.conv_apply_foldt(
        dict(w=w_, b=jnp.asarray(p['b'])), t_, x_) ** 2), argnums=(0, 1, 2)))(
        jnp.asarray(p['w']), jnp.asarray(0.37), jnp.asarray(x))
    outs = []
    for fold in (True, False):
        wt = torch.from_numpy(p['w'].transpose(3, 2, 0, 1).copy()) \
            .requires_grad_()
        t = torch.tensor(0.37, dtype=torch.float64, requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_()
        q = dict(w=wt, b=torch.from_numpy(p['b']))
        y = (tconv.conv_apply_foldt(q, t, xt) if fold else
             tconv.conv_apply(q, tconv.concat_time(t, xt)))
        (y ** 2).sum().backward()
        outs.append((y.detach(), wt.grad.permute(2, 3, 1, 0), t.grad,
                     xt.grad))
    for a, b in zip(*outs):
        assert _rel(a, b) <= FIELD
    for a, b in zip(outs[0][1:], jg):
        assert _rel(a, b) <= FIELD


def test_solve_and_adjoint_gradients_match_jax(monkeypatch):
    """bench.py's conv training loss at its settings, mean((y(1) -
    target)**2) through `odeint_adjoint` (dopri5, rtol=atol=1e-3), here
    with an interior output time: the forward solve's values to 1e-10 of
    max|y| with its Stats, the gradients in the four weights, y0 and t to
    1e-9 of their largest entry, and the backward's Stats, all JAX's."""
    p = _params(8)
    x = _x(2, 6, 6, 8)
    target = np.random.RandomState(3).randn(6, 6, 8)
    t = np.array([0.0, 0.5, 1.0])
    kw = dict(rtol=1e-3, atol=1e-3)
    bwd = ([], [])

    def wrapped_j(*a, _raw=jadj._raw_odeint, **k):
        ys, st = _raw(*a, **k)
        jax.debug.callback(lambda *c: bwd[0].append([int(v) for v in c]),
                           *st[:5])
        return ys, st

    def wrapped_t(*a, _raw=tadj._raw_odeint, **k):
        ys, st = _raw(*a, **k)
        bwd[1].append(counters(st))
        return ys, st

    monkeypatch.setattr(jadj, '_raw_odeint', wrapped_j)
    monkeypatch.setattr(tadj, '_raw_odeint', wrapped_t)

    def loss_j(q, y, s):
        ys, st = jadj.adjoint_solve(
            lambda tt_, yy, qq: jconv.conv_field(qq, tt_, yy), y, s,
            method=None, options=None, event_fn=None, args=(q,),
            adjoint_rtol=1e-3, adjoint_atol=1e-3, adjoint_method=None,
            adjoint_options=None, **kw)
        return jnp.mean((ys[-1] - jnp.asarray(target)[None]) ** 2), (ys, st)

    (_, (ys_j, st_j)), gj = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
        _jparams(p), jnp.asarray(x), jnp.asarray(t))
    model = conv_params_from_jax(p, device='cpu')
    y = torch.from_numpy(x).requires_grad_()
    s = torch.from_numpy(t).requires_grad_()
    ys, st_t = tadj.adjoint_solve(
        model, y, s, method=None, options=None, event_fn=None, args=(),
        adjoint_rtol=1e-3, adjoint_atol=1e-3, adjoint_method=None,
        adjoint_options=None, **kw)
    assert counters(st_t) == counters(st_j) and st_t.n_steps > 1
    assert _rel(ys.detach(), ys_j) <= SOLVE
    ((ys[-1] - torch.from_numpy(target)[None]) ** 2).mean().backward()
    # each weight's gradient to 1e-9 of the largest weight gradient: conv2's
    # bias is one channel a group (dim 8, 8 groups), which the last
    # GroupNorm removes, so its gradient is rounding noise about 0
    grads = [(model[n]['w'].grad.permute(2, 3, 1, 0), gj[0][n]['w'])
             for n in ('conv1', 'conv2')] + [
        (model[n]['b'].grad, gj[0][n]['b']) for n in ('conv1', 'conv2')]
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in grads)
    for got, want in grads:
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
            <= GRAD * scale
    assert _rel(y.grad, gj[1]) <= GRAD
    assert _rel(s.grad, gj[2]) <= GRAD
    assert bwd[1] == bwd[0] and len(bwd[1]) == 1


def test_params_from_jax_layout_and_default_device():
    """HWIO goes to OIHW with the time channel last on the input axis; the
    model's parameters are conv1.w/b and conv2.w/b; with no CUDA device
    the default device raises instead of building on the CPU."""
    p = _params(4)
    model = conv_params_from_jax(p, device='cpu')
    assert model.conv1['w'].shape == (4, 5, 3, 3)
    np.testing.assert_array_equal(model.conv2['w'].detach().numpy(),
                                  p['conv2']['w'].transpose(3, 2, 0, 1))
    assert sorted(n for n, _ in model.named_parameters()) == [
        'conv1.b', 'conv1.w', 'conv2.b', 'conv2.w']
    assert ConvField(4, device='cpu').conv1['w'].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ConvField(4)
    x = torch.from_numpy(_x(1, 6, 6, 4))
    assert torch.equal(conv_field(model, 0.5, x), model(0.5, x))
