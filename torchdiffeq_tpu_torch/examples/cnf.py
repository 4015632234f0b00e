"""Continuous normalizing flow on the two-circles dataset -- the port of
``examples/cnf.py``.

A hypernetwork (1 -> 32 -> 32 -> 224, tanh) produces the time-varying
weights of a planar-flow mixture of width 32; the instantaneous change of
log-density is the exact negative divergence, one ``torch.func.jvp`` probe
per dimension inside the field (as the JAX example's ``jax.jvp``).  The
density is the solve of the (z, logp) tuple state from t1 = 10 back to
t0 = 0 at rtol = atol = 1e-5; optimisation is optax's Adam at 1e-2.

Gradients: plain `odeint` differentiates through the continuous adjoint, as
the JAX package's does, and ``--adjoint`` takes `odeint_adjoint`, the same
route.  The adjoint's backward differentiates the field, the jvp probes
included, by autograd at each evaluation: reverse over forward.

Run:  python -m torchdiffeq_tpu_torch.examples.cnf [--niters 1000]
      [--device cpu]  (``--viz`` is accepted and, as in the JAX example,
      draws nothing)
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch
from torch import nn

from ..adjoint import odeint_adjoint
from ..odeint import odeint
from ._common import add_device_flag, device_of
from ._optim import Adam

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--adjoint', action='store_true')
parser.add_argument('--niters', type=int, default=500)
parser.add_argument('--lr', type=float, default=1e-2)
parser.add_argument('--num_samples', type=int, default=512)
parser.add_argument('--width', type=int, default=32)
parser.add_argument('--hidden_dim', type=int, default=32)
parser.add_argument('--t0', type=float, default=0.0)
parser.add_argument('--t1', type=float, default=10.0)
parser.add_argument('--viz', action='store_true')
parser.add_argument('--seed', type=int, default=0)

IN_OUT_DIM = 2


class HyperNet(nn.Module):
    """The hypernetwork's layers, ``h @ w + b`` with tanh between them, and
    the flow's sizes."""

    def __init__(self, ws, bs, in_out_dim, width):
        super().__init__()
        self.weights = nn.ParameterList([nn.Parameter(w) for w in ws])
        self.biases = nn.ParameterList([nn.Parameter(b) for b in bs])
        self.in_out_dim = in_out_dim
        self.width = width


def init_hyper_net(in_out_dim, hidden_dim, width, generator, device=None,
                   dtype=None):
    """Hypernetwork: t -> (W, B, U) of the CNF field, weights normal with
    scale 1/sqrt(fan_in), biases 0 (the JAX example's `init_hyper_net`)."""
    dtype = dtype or torch.get_default_dtype()
    sizes = [1, hidden_dim, hidden_dim, 3 * width * in_out_dim + width]
    ws, bs = [], []
    for m, n in zip(sizes[:-1], sizes[1:]):
        ws.append((torch.randn((m, n), generator=generator, dtype=dtype)
                   * (1.0 / np.sqrt(m))).to(device))
        bs.append(torch.zeros(n, dtype=dtype, device=device))
    return HyperNet(ws, bs, in_out_dim, width)


def params_from_jax(params, in_out_dim, width, device=None):
    """The JAX example's ``[{'w', 'b'}, ...]`` as a `HyperNet`."""
    return HyperNet([torch.from_numpy(np.array(p['w'])).to(device)
                     for p in params],
                    [torch.from_numpy(np.array(p['b'])).to(device)
                     for p in params], in_out_dim, width)


def hyper_net(params, t, in_out_dim, width):
    blocksize = width * in_out_dim
    w0 = params.weights[0]
    h = torch.as_tensor(t).to(device=w0.device, dtype=w0.dtype).reshape(1, 1)
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = h @ w + b
        if i != n - 1:
            h = torch.tanh(h)
    h = h.reshape(-1)
    W = h[:blocksize].reshape(width, in_out_dim, 1)
    U = h[blocksize:2 * blocksize].reshape(width, 1, in_out_dim)
    G = torch.sigmoid(h[2 * blocksize:3 * blocksize]).reshape(width, 1,
                                                              in_out_dim)
    U = U * G
    B = h[3 * blocksize:].reshape(width, 1, 1)
    return W, B, U


def cnf_field(params, t, z, in_out_dim, width):
    """dz/dt = sum_k U_k tanh(W_k z + B_k) (planar-flow mixture)."""
    W, B, U = hyper_net(params, t, in_out_dim, width)
    # z: (batch, dim)
    h = torch.tanh(torch.einsum('kd,bd->bk', W[:, :, 0], z) + B[:, 0, 0][None])
    return torch.einsum('bk,kd->bd', h, U[:, 0, :])


def augmented_dynamics(t, state, params, in_out_dim, width):
    """d(z, logp)/dt with the exact trace by one forward-mode probe per
    dimension (``torch.func.jvp``), inside the field."""
    z, logp = state
    f = lambda zz: cnf_field(params, t, zz, in_out_dim, width)
    dz = f(z)
    # divergence: sum_i d f_i / d z_i via forward-mode probes
    div = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for i in range(in_out_dim):
        e = torch.zeros_like(z)
        e[:, i] = 1.0
        _, jv = torch.func.jvp(f, (z,), (e,))
        div = div + jv[:, i]
    return (dz, -div[:, None])


class CNF(nn.Module):
    """``augmented_dynamics`` as a module over the hypernetwork, so the
    solvers' adjoint finds its parameters."""

    def __init__(self, hyper):
        super().__init__()
        self.hyper = hyper

    def forward(self, t, state):
        return augmented_dynamics(t, state, self.hyper, self.hyper.in_out_dim,
                                  self.hyper.width)


def sample_circles(n, generator, device=None, dtype=None):
    """Two concentric circles (reference uses sklearn make_circles): angles
    uniform, radius 1 or 0.5 with equal odds, noise 0.02."""
    dtype = dtype or torch.get_default_dtype()
    theta = torch.rand(n, generator=generator, dtype=dtype) * 2 * np.pi
    r = torch.where(torch.rand(n, generator=generator) < 0.5,
                    torch.tensor(1.0, dtype=dtype), torch.tensor(0.5, dtype=dtype))
    x = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
    return (x + 0.02 * torch.randn((n, 2), generator=generator,
                                   dtype=dtype)).to(device)


def std_normal_logprob(z):
    return torch.sum(-0.5 * math.log(2 * math.pi) - z ** 2 / 2, dim=1,
                     keepdim=True)


def loss_fn(func, x, args, solve=None):
    """The JAX example's `loss_fn` (cnf.py:112-120): the negative
    log-likelihood of `x` under the flow.  `solve` (default `odeint`, or
    `odeint_adjoint` with ``--adjoint``) may be replaced to read the
    solve's Stats."""
    solver = solve or (odeint_adjoint if args.adjoint else odeint)
    logp_init = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    t_span = torch.tensor([args.t1, args.t0], dtype=torch.float64)
    z_t, logp_diff_t = solver(func, (x, logp_init), t_span, atol=1e-5,
                              rtol=1e-5)
    z0, logp_diff0 = z_t[-1], logp_diff_t[-1]
    logp_x = std_normal_logprob(z0) - logp_diff0
    return -torch.mean(logp_x)


def train_step(func, opt, x, args):
    opt.zero_grad()
    loss = loss_fn(func, x, args)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    args = parser.parse_args(argv)
    device = device_of(args.device)
    generator = torch.Generator().manual_seed(args.seed)
    func = CNF(init_hyper_net(IN_OUT_DIM, args.hidden_dim, args.width,
                              generator, device))
    opt = Adam(func.parameters(), args.lr)

    for itr in range(1, args.niters + 1):
        x = sample_circles(args.num_samples, generator, device)
        loss = train_step(func, opt, x, args)
        if itr % 50 == 0 or itr == 1:
            print(f'Iter {itr:04d} | NLL {float(loss):.4f}')

    print('final NLL:', float(loss))
    return dict(loss=float(loss), func=func)


if __name__ == '__main__':
    main()
