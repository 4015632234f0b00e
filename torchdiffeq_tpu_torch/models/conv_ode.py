"""The convolutional ODE field: the reference's ODE-Net workload
(counterpart of ``torchdiffeq_tpu/models/conv_ode.py``; reference
examples/odenet_mnist.py:76-113).

``conv_field`` runs

    norm1 -> relu -> concat(t)+conv1 -> norm2 -> relu -> concat(t)+conv2
          -> norm3

with GroupNorm(min(32, dim)) for every norm and two time-concat 3x3 SAME
convolutions (dim + 1 -> dim).  The MNIST pipeline downsamples 28x28
inputs to a (B, 6, 6, 64) state before the ODE block.

Layout, kept from the JAX package so that solves, norms and the parity
tests compare like with like:

* the state is JAX's NHWC ``(B, H, W, C)``.  Inside a convolution,
  ``x.permute(0, 3, 1, 2)`` is a channels-last NCHW view, which
  ``F.conv2d`` (cuDNN on the card) takes with no copy; its result is
  permuted back.
* the weights are PyTorch's OIHW with the time channel LAST on the input
  axis, as JAX's HWIO has it (JAX conv_ode.py:59-64; the reference's
  ``ConcatConv2d`` puts it first): `conv_params_from_jax` is a plain
  transpose.
* `group_norm` keeps JAX's rules: the group count is the largest divisor
  of C that is at most ``min(32, C)``; the statistics are taken in
  ``promote(dtype, float32)`` (float32 for a bfloat16 state); the variance
  is the population variance; the result is ``(x - mean) * rsqrt(var +
  1e-5)`` with no affine weights, cast back to the input dtype.

The convolutions are cuDNN's, as JAX's are XLA's outside any Pallas
kernel; GroupNorm, relu and the time concat are plain torch operations.
JAX's width-packed variant (``conv_apply_packed``) works around the TPU
MXU's lanes and is not ported (ROADMAP "Not to port").
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .neural_ode import default_device


def init_conv(c_in, c_out, k=3, dtype=torch.float32, device=None,
              generator=None):
    """He-initialised k x k convolution (OIHW) and a zero bias, as a dict
    ``{'w', 'b'}`` (JAX `init_conv`); on the card unless `device` says
    otherwise."""
    device = default_device(device)
    w = torch.randn((c_out, c_in, k, k), generator=generator, dtype=dtype) \
        * math.sqrt(2.0 / (k * k * c_in))
    return dict(w=w.to(device), b=torch.zeros(c_out, dtype=dtype,
                                               device=device))


def _same_padding(size, k, stride):
    """XLA's 'SAME' padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(w, x, stride=1):
    """The 'SAME' convolution of an NHWC `x` with OIHW `w`, NHWC out: the
    input's channels-last view goes to ``F.conv2d`` with no copy."""
    kh, kw = w.shape[2:]
    (top, bottom), (left, right) = (_same_padding(x.shape[1], kh, stride),
                                    _same_padding(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)
    if top == bottom and left == right:
        y = F.conv2d(xc, w, None, stride, (top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, None, stride)
    return y.permute(0, 2, 3, 1)


def conv_apply(p, x, stride=1):
    """A k x k 'SAME' convolution of an NHWC `x` and its bias (JAX
    `conv_apply`): ``conv(x) + b``."""
    y = _conv(p['w'].to(x.dtype), x, stride)
    return y + p['b'].to(y.dtype)


def group_norm(x, groups=32, eps=1e-5):
    """GroupNorm over NHWC with the largest divisor of C that is at most
    ``min(groups, C)`` groups (reference odenet_mnist.py:18-19), statistics
    in ``promote(dtype, float32)``, output in `x`'s dtype (JAX
    `group_norm`, conv_ode.py:44-56)."""
    n, h, w, c = x.shape
    g = max(d for d in range(1, min(groups, c) + 1) if c % d == 0)
    stat_dtype = torch.promote_types(x.dtype, torch.float32)
    xg = x.to(stat_dtype).reshape(n, h, w, g, c // g)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    out = (xg - mean) * torch.rsqrt(var + eps)
    return out.reshape(n, h, w, c).to(x.dtype)


def _time_like(t, x):
    """The time `t` (a number or a 0-d tensor, which may carry a gradient)
    as a 0-d tensor of `x`'s dtype and device."""
    if isinstance(t, torch.Tensor):
        return t.to(device=x.device, dtype=x.dtype)
    return torch.full((), float(t), dtype=x.dtype, device=x.device)


def concat_time(t, x):
    """``ConcatConv2d``'s input transform (reference odenet_mnist.py:76-89):
    a channel filled with `t` appended to NHWC `x`."""
    tt = _time_like(t, x)
    return torch.cat([x, tt.reshape((1,) * x.dim()).expand(
        x.shape[:-1] + (1,))], dim=-1)


def init_conv_field(dim, dtype=torch.float32, device=None, generator=None):
    """The reference ODEfunc's parameters: two time-concat 3x3 convolutions
    (dim + 1 -> dim), ``{'conv1', 'conv2'}`` (JAX `init_conv_field`); the
    three GroupNorms have no parameters (the reference's affine weights
    start at the identity)."""
    return dict(conv1=init_conv(dim + 1, dim, dtype=dtype, device=device,
                                generator=generator),
                conv2=init_conv(dim + 1, dim, dtype=dtype, device=device,
                                generator=generator))


def conv_field(params, t, x):
    """The reference ODEfunc's forward (odenet_mnist.py:105-113; JAX
    `conv_field`): norm1 -> relu -> conv1(t, .) -> norm2 -> relu ->
    conv2(t, .) -> norm3.  `params` is `init_conv_field`'s dict or a
    `ConvField`."""
    h = torch.relu(group_norm(x))
    h = conv_apply(params['conv1'], concat_time(t, h))
    h = torch.relu(group_norm(h))
    h = conv_apply(params['conv2'], concat_time(t, h))
    return group_norm(h)


def conv_apply_foldt(p, t, x):
    """The time-concat 3x3 'SAME' convolution without the concat (JAX
    `conv_apply_foldt`): the time channel is constant over the image, so
    its share is ``t * tmap``, `tmap` the convolution of a ones image with
    the time channel's kernel slice (the taps that land inside the image).
    The same products re-associated, so it matches
    ``conv_apply(p, concat_time(t, x))`` to rounding."""
    w = p['w'].to(x.dtype)
    ts = _time_like(t, x)
    y = _conv(w[:, :-1], x)
    ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype,
                      device=x.device)
    tmap = _conv(w[:, -1:], ones)
    return y + ts * tmap + p['b'].to(y.dtype)


def conv_field_foldt(params, t, x):
    """`conv_field` with the time channel folded out of both convolutions
    (the same parameters and function; JAX `conv_field_foldt`)."""
    h = torch.relu(group_norm(x))
    h = conv_apply_foldt(params['conv1'], t, h)
    h = torch.relu(group_norm(h))
    h = conv_apply_foldt(params['conv2'], t, h)
    return group_norm(h)


def conv_field_flops(batch, height, width, dim):
    """FLOPs of ONE `conv_field` evaluation's two 3x3 convolutions,
    ``2 * B*H*W * 9*(dim+1) * dim`` each (GroupNorm and relu move bytes;
    JAX `conv_field_flops`)."""
    return 2 * (2 * batch * height * width * 9 * (dim + 1) * dim)


class ConvField(nn.Module):
    """``f(t, x) = conv_field(self, t, x)`` for an NHWC state ``(B, H, W,
    dim)``, holding ``conv1`` and ``conv2`` (each an ``nn.ParameterDict``
    ``{'w', 'b'}``, OIHW with the time channel last), built on the card
    unless the caller passes ``device='cpu'``.

    Args:
        dim: the channel count (64 in the reference's MNIST model).
        dtype: of the parameters.
        device: of the parameters; default the CUDA device (with no CUDA
            device that raises: pass ``device='cpu'``).
        generator: ``torch.Generator`` for the weights (CPU).
    """

    def __init__(self, dim, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        params = init_conv_field(dim, dtype=dtype, device=device,
                                 generator=generator)
        self.dim = dim
        self.conv1 = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params['conv1'].items()})
        self.conv2 = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params['conv2'].items()})

    def __getitem__(self, name):
        return getattr(self, name)

    def forward(self, t, x):
        return conv_field(self, t, x)


def conv_params_from_jax(params, *, device=None):
    """A `ConvField` holding the JAX package's ``{'conv1': {'w', 'b'},
    'conv2': ...}`` parameters (numpy or JAX arrays, HWIO), each weight
    transposed to OIHW, so both packages compute the same function from the
    same numbers; on the card unless `device` says otherwise."""
    w1 = np.asarray(params['conv1']['w'])
    dim = w1.shape[-1]
    model = ConvField(dim, dtype=torch.from_numpy(w1).dtype, device=device,
                      generator=torch.Generator())   # overwritten below
    with torch.no_grad():
        for name in ('conv1', 'conv2'):
            p = params[name]
            w = torch.from_numpy(np.asarray(p['w']).transpose(3, 2, 0, 1)
                                 .copy())
            model[name]['w'].copy_(w)
            model[name]['b'].copy_(torch.from_numpy(np.asarray(p['b']).copy()))
    return model
