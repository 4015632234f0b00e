"""The optax update rules the JAX examples train with (``optax.rmsprop``,
``optax.adam``, ``optax.sgd`` with momentum), as ``torch.optim.Optimizer``
subclasses that compute optax's arithmetic in its order.
``torch.optim.RMSprop`` is another rule (it decays by 0.99 and divides by
``sqrt(v) + eps``, where optax decays by 0.9 and multiplies by ``rsqrt(v +
eps)``), and ``torch.optim.Adam`` and ``SGD`` order theirs otherwise, so
the examples take these."""
from __future__ import annotations

import torch


class _Optax(torch.optim.Optimizer):
    """An optax rule on each parameter with a gradient: ``p += update``."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is not None:
                    p.add_(self._update(p.grad, self.state[p], group))
        return loss


class RMSprop(_Optax):
    """``optax.rmsprop(lr, decay=0.9, eps=1e-8)``: ``nu = (1 - decay) g**2
    + decay nu``, update ``-lr * rsqrt(nu + eps) * g``."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @staticmethod
    def _update(g, state, group):
        decay = group['decay']
        nu = state.get('nu', torch.zeros_like(g))
        nu = (1 - decay) * g ** 2 + decay * nu
        state['nu'] = nu
        return torch.rsqrt(nu + group['eps']) * g * (-group['lr'])


class Adam(_Optax):
    """``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)``: the moments' EMAs,
    their bias corrections ``1 - b**count``, update ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)``."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @staticmethod
    def _update(g, state, group):
        b1, b2 = group['b1'], group['b2']
        count = state.get('count', 0) + 1
        mu = (1 - b1) * g + b1 * state.get('mu', torch.zeros_like(g))
        nu = (1 - b2) * g ** 2 + b2 * state.get('nu', torch.zeros_like(g))
        state.update(count=count, mu=mu, nu=nu)
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        return mu_hat / (torch.sqrt(nu_hat) + group['eps']) * (-group['lr'])


class SGD(_Optax):
    """``optax.sgd(lr, momentum)``: ``trace = g + momentum * trace``,
    update ``-lr * trace``."""

    def __init__(self, params, lr, momentum=0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @staticmethod
    def _update(g, state, group):
        trace = g + group['momentum'] * state.get('trace', torch.zeros_like(g))
        state['trace'] = trace
        return trace * (-group['lr'])
