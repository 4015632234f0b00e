"""Spiral ODE fit -- the port of ``examples/ode_demo.py``.

Learns dy/dt = MLP(y^3) (an `MLPField` 2 -> 50 -> 2 with power 3) to fit
a 2-D spiral generated by the true dynamics dy/dt = y^3 A.  Minibatches
are (y0, 10-point window) pairs; optimisation is optax's RMSprop
(``_optim.RMSprop``).  Gradients come from the continuous adjoint with
``--adjoint`` and without it (plain `odeint` differentiates through the
same adjoint, as the JAX package's does).

Run:  python -m torchdiffeq_tpu_torch.examples.ode_demo [--adjoint]
      [--niters 500] [--viz] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..adjoint import odeint_adjoint
from ..models import MLPField, mlp_params_from_jax
from ..odeint import odeint
from ._common import add_device_flag, device_of
from ._optim import RMSprop

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--method', type=str, default='dopri5')
parser.add_argument('--data_size', type=int, default=1000)
parser.add_argument('--batch_time', type=int, default=10)
parser.add_argument('--batch_size', type=int, default=20)
parser.add_argument('--niters', type=int, default=2000)
parser.add_argument('--test_freq', type=int, default=20)
parser.add_argument('--adjoint', action='store_true')
parser.add_argument('--viz', action='store_true')
parser.add_argument('--seed', type=int, default=0)


def make_data(args, device=None, dtype=None):
    """The true spiral: dopri5 at rtol 1e-7, atol 1e-9 over `data_size`
    points of [0, 25]; states of `dtype` (torch's default), times float64."""
    dtype = dtype or torch.get_default_dtype()
    true_y0 = torch.tensor([2., 0.], dtype=dtype, device=device)
    t = torch.linspace(0., 25., args.data_size, dtype=torch.float64)
    true_A = torch.tensor([[-0.1, 2.0], [-2.0, -0.1]], dtype=dtype,
                          device=device)

    def true_func(tt, y):
        return (y ** 3) @ true_A

    with torch.no_grad():
        true_y = odeint(true_func, true_y0, t, method='dopri5', rtol=1e-7,
                        atol=1e-9)
    return true_y0, t, true_y


def get_batch(s, args, t, true_y):
    """The minibatch of window starts `s` ((batch_size,) indices, drawn
    without replacement from ``range(data_size - batch_time)``)."""
    s = torch.as_tensor(s, device=true_y.device)
    batch_y0 = true_y[s]                                # (B, 2)
    batch_t = t[:args.batch_time]                       # (T,)
    batch_y = torch.stack([true_y[s + i] for i in range(args.batch_time)])
    return batch_y0, batch_t, batch_y                   # (T, B, 2)


def init_model(args, generator, device=None, dtype=None):
    """The learned field: MLP 2 -> 50 -> 2 of y**3, weights at scale 0.1."""
    return MLPField([2, 50, 2], power=3, scale=0.1,
                    dtype=dtype or torch.get_default_dtype(), device=device,
                    generator=generator)


def params_from_jax(params, device=None):
    """The JAX example's ``init_mlp(..., [2, 50, 2])`` parameters as the
    port's model."""
    return mlp_params_from_jax(params, power=3, device=device)


def loss_fn(model, batch_y0, batch_t, batch_y, args):
    """The JAX example's `loss_fn` (its main, ode_demo.py:81-83): the mean
    absolute error of the predicted windows."""
    solver = odeint_adjoint if args.adjoint else odeint
    pred_y = solver(model, batch_y0, batch_t, method=args.method, rtol=1e-7,
                    atol=1e-9)
    return torch.mean(torch.abs(pred_y - batch_y))


def train_step(model, opt, batch, args):
    """One step: the loss, its gradient, an RMSprop update."""
    opt.zero_grad()
    loss = loss_fn(model, *batch, args)
    loss.backward()
    opt.step()
    return loss.detach()


def draw_batch(generator, args):
    """`get_batch`'s window starts: `batch_size` of ``range(data_size -
    batch_time)`` without replacement."""
    return torch.randperm(args.data_size - args.batch_time,
                          generator=generator)[:args.batch_size]


def main(argv=None):
    args = parser.parse_args(argv)
    device = device_of(args.device)
    generator = torch.Generator().manual_seed(args.seed)

    true_y0, t, true_y = make_data(args, device)
    model = init_model(args, generator, device)
    opt = RMSprop(model.parameters(), 1e-3)

    start = time.time()
    test_loss = None
    for itr in range(1, args.niters + 1):
        batch = get_batch(draw_batch(generator, args), args, t, true_y)
        train_step(model, opt, batch, args)
        if itr % args.test_freq == 0:
            with torch.no_grad():
                pred_y = odeint(model, true_y0, t, method=args.method)
                test_loss = float(torch.mean(torch.abs(pred_y - true_y)))
            print(f'Iter {itr:04d} | Total Loss {test_loss:.6f} | '
                  f'{time.time() - start:.1f}s')

    if args.viz:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        with torch.no_grad():
            pred_y = odeint(model, true_y0, t).cpu().numpy()
        ty = true_y.cpu().numpy()
        plt.plot(ty[:, 0], ty[:, 1], 'g-')
        plt.plot(pred_y[:, 0], pred_y[:, 1], 'b--')
        plt.savefig('spiral.png')
        print('saved spiral.png')
    return dict(test_loss=test_loss, model=model)


if __name__ == '__main__':
    main()
