"""Neural-ODE MLP vector fields (counterpart of
``torchdiffeq_tpu/models/neural_ode.py``).

`MLPField` is an ``nn.Module`` holding the JAX layout: each weight is
``(in, out)`` and a layer computes ``x @ w + b``, with an activation
between layers (tanh unless the module is built with another, as JAX's
``mlp_apply(..., activation=...)``).  The field is ``f(t, y) = mlp(y **
power)``: power 1 for a plain MLP field, 3 for the spiral demo's field
(reference examples/ode_demo.py:111-121).  With tanh and one hidden layer
it is the family the CUDA kernels evaluate by hand (``ops/kernels.py``);
the per-lane kernels take any other field through the tracer
(``ops/traced.py``).

`LinearEvent` is the event family the CUDA event kernel takes: K <= 4
affine outputs ``y @ W.T + c * t + b``.  It covers threshold events on a
state component or a linear combination of components, and time cut-offs.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class MLPField(nn.Module):
    """``f(t, y) = mlp(y ** power)`` with `activation` between layers.

    Args:
        sizes: layer sizes ``[in, h1, ..., out]``.
        power: 1, 2 or 3 (the kernels evaluate ``y*y`` and ``y*y*y``).
        activation: the hidden layers' activation, ``torch.tanh`` by default
            (the one the hand-written CUDA kernels evaluate).
        scale: weight scale; default ``1/sqrt(fan_in)``.  Biases start at 0.
        device: of the parameters; default the CUDA device (the port runs
            on the card unless the caller asks for the CPU with
            ``device='cpu'``).  With no CUDA device the default raises.
        generator: ``torch.Generator`` for the weights (CPU).
    """

    def __init__(self, sizes, *, power=1, scale=None, dtype=torch.float32,
                 device=None, generator=None, activation=torch.tanh):
        super().__init__()
        if power not in (1, 2, 3):
            raise ValueError(f"power must be 1, 2 or 3, got {power}")
        device = default_device(device)
        self.power = power
        self.activation = activation
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            w = torch.randn((fan_in, fan_out), generator=generator,
                            dtype=dtype) * s
            self.weights.append(nn.Parameter(w.to(device)))
            self.biases.append(nn.Parameter(
                torch.zeros(fan_out, dtype=dtype, device=device)))

    @property
    def sizes(self):
        return [self.weights[0].shape[0]] + [w.shape[1] for w in self.weights]

    def forward(self, t, y):
        return mlp_apply(self, y ** self.power if self.power != 1 else y,
                         self.activation)


class LinearEvent(nn.Module):
    """``e(t, y) = y @ weight.T + time_coef * t + bias``: K <= 4 affine event
    outputs, each a zero crossing to detect (``y[0] - 0.5`` is
    ``weight=[[1, 0]], bias=[-0.5]``; ``t - 2`` is ``time_coef=[1],
    bias=[-2]``).  Applied to one sample ``y`` of shape (D,) it returns the
    (K,) outputs.

    Args:
        weight: (K, D).
        time_coef, bias: (K,); zeros by default.
        dtype: of the parameters (default: that of `weight`).
        device: of the parameters; default that of `weight` when it is a
            tensor, else the CUDA device, as for `MLPField` (with no CUDA
            device that raises: pass ``device='cpu'``).
    """
    MAX_OUTPUTS = 4

    def __init__(self, weight, time_coef=None, bias=None, *, dtype=None,
                 device=None):
        super().__init__()
        if device is None and not isinstance(weight, torch.Tensor):
            device = default_device(None)
        weight = torch.as_tensor(weight, dtype=dtype, device=device)
        if weight.dim() != 2 or not 1 <= weight.shape[0] <= self.MAX_OUTPUTS:
            raise ValueError(f"weight must be (K, D) with 1 <= K <= "
                             f"{self.MAX_OUTPUTS}, got {tuple(weight.shape)}")
        K = weight.shape[0]

        def vec(v):
            v = (torch.zeros(K, dtype=weight.dtype) if v is None
                 else torch.as_tensor(v, dtype=weight.dtype))
            if v.shape != (K,):
                raise ValueError(f"expected shape ({K},), got {tuple(v.shape)}")
            return nn.Parameter(v.to(weight.device))

        self.weight = nn.Parameter(weight)
        self.time_coef = vec(time_coef)
        self.bias = vec(bias)

    def forward(self, t, y):
        return y @ self.weight.T + self.time_coef * t + self.bias

    def lanes(self, tv, yv):
        """The outputs on the per-lane layout: t (1, B), y (D, B) -> (K, B)."""
        return (yv.T @ self.weight.T + self.time_coef * tv.T + self.bias).T


def default_device(device):
    """`device`, or the CUDA device when it is None; raises when it is None
    and there is no CUDA device, rather than build CPU tensors quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's models default to the card; pass "
            "device='cpu' to build them on the CPU")
    return torch.device("cuda")


def mlp_apply(model, x, activation=torch.tanh):
    """The layers of `model` on `x`, without the input power, `activation`
    between them (JAX `mlp_apply`, models/neural_ode.py:29).  Mixed
    dtypes promote as JAX's matmul does: float64 input (the fixed-grid
    stage states of a float32 state) through float32 weights computes in
    float64."""
    n = len(model.weights)
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt) @ w.to(dt) + b.to(dt)
        if i != n - 1:
            x = activation(x)
    return x


def init_mlp(sizes, scale=None, dtype=torch.float32, device=None,
             generator=None, activation=torch.tanh):
    """An MLP field (power 1) with layer sizes ``[in, h1, ..., out]``, on
    the card unless `device` says otherwise (as `MLPField`)."""
    return MLPField(sizes, scale=scale, dtype=dtype, device=device,
                    generator=generator, activation=activation)


def is_kernel_mlp(field):
    """Whether `field` is the family the hand-written CUDA kernels evaluate:
    an `MLPField` with tanh between its layers."""
    return isinstance(field, MLPField) and field.activation is torch.tanh


def mlp_vector_field(model, t, y, activation=torch.tanh,
                     time_dependent=False):
    """f(t, y) as the MLP of `model` over y, or over ``[y, t]`` with
    `time_dependent` (JAX `mlp_vector_field`, models/neural_ode.py:37-47;
    the input power of an `MLPField` is not applied)."""
    if time_dependent:
        tcol = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        inp = torch.cat([y, tcol.expand(y.shape[:-1] + (1,))], dim=-1)
    else:
        inp = y
    return mlp_apply(model, inp, activation)


def spiral_field(model, t, y):
    """The spiral demo's field: the MLP applied to ``y**3``."""
    return mlp_apply(model, y ** 3)


def init_spiral_model(hidden=50, dtype=torch.float32, device=None,
                      generator=None):
    """The spiral demo's 2 -> hidden -> 2 field, weights at scale 0.1, on
    the card unless `device` says otherwise (as `MLPField`)."""
    return MLPField([2, hidden, 2], power=3, scale=0.1, dtype=dtype,
                    device=device, generator=generator)


def mlp_params_from_jax(params, *, power=1, device=None,
                        activation=torch.tanh):
    """An `MLPField` holding the JAX package's ``[{'w', 'b'}, ...]``
    parameters (numpy or JAX arrays), so both packages compute the same
    function from the same numbers; on the card unless `device` says
    otherwise (as `MLPField`)."""
    import numpy as np
    ws = [np.asarray(layer['w']) for layer in params]
    bs = [np.asarray(layer['b']) for layer in params]
    sizes = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    model = MLPField(sizes, power=power,
                     dtype=torch.from_numpy(ws[0]).dtype, device=device,
                     generator=torch.Generator(),   # overwritten below
                     activation=activation)
    with torch.no_grad():
        for p, w in zip(model.weights, ws):
            p.copy_(torch.from_numpy(w.copy()))
        for p, b in zip(model.biases, bs):
            p.copy_(torch.from_numpy(b.copy()))
    return model


def ode_block(model, y0, t, *, field, use_adjoint=True, rtol=1e-3, atol=1e-4,
              method='dopri5', **kwargs):
    """Integrate ``field(model, t, y)`` over `t` and return the trajectory
    (JAX `ode_block`, models/neural_ode.py:58-66; the reference's ODEBlock,
    odenet_mnist.py:123-126).  Gradients come from the continuous adjoint
    either way: `odeint_adjoint` with `use_adjoint`, else plain `odeint`,
    which differentiates through the same adjoint (ROADMAP C4).  `model`
    goes to the solve as an argument, so every floating tensor of it (an
    ``nn.Module``'s parameters, or a tuple or dict of tensors) gets a
    gradient."""
    from ..adjoint import odeint_adjoint
    from ..odeint import odeint
    solver = odeint_adjoint if use_adjoint else odeint
    if isinstance(model, nn.Module):
        return solver(_ModuleField(model, field), y0, t, rtol=rtol,
                      atol=atol, method=method, **kwargs)
    return solver(lambda tt, yy, p: field(p, tt, yy), y0, t, rtol=rtol,
                  atol=atol, method=method, args=(model,), **kwargs)


class _ModuleField(nn.Module):
    """``field(model, t, y)`` as an ``nn.Module`` whose parameters are the
    model's, so plain `odeint` finds them for the adjoint."""

    def __init__(self, model, field):
        super().__init__()
        self.model = model
        self.field = field

    def forward(self, t, y):
        return self.field(self.model, t, y)
