"""The optax update rules the JAX examples train with (``optax.rmsprop``,
``optax.adam``, ``optax.sgd`` with momentum), as ``torch.optim.Optimizer``
subclasses that compute optax's arithmetic in its order.
``torch.optim.RMSprop`` is another rule (it decays by 0.99 and divides by
``sqrt(v) + eps``, where optax decays by 0.9 and multiplies by ``rsqrt(v +
eps)``), and ``torch.optim.Adam`` and ``SGD`` order theirs otherwise, so
the examples take these.  The rules are `training`'s, which its
functional optimizers (`training.adam`, `rmsprop`, `sgd`) apply too."""
from __future__ import annotations

import torch

from ..training import adam_rule, rmsprop_rule, sgd_rule


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
    """``optax.rmsprop(lr, decay=0.9, eps=1e-8)`` (`training.rmsprop_rule`)."""
    _update = staticmethod(rmsprop_rule)

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))


class Adam(_Optax):
    """``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)``
    (`training.adam_rule`)."""
    _update = staticmethod(adam_rule)

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))


class SGD(_Optax):
    """``optax.sgd(lr, momentum)`` (`training.sgd_rule`)."""
    _update = staticmethod(sgd_rule)

    def __init__(self, params, lr, momentum=0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))
