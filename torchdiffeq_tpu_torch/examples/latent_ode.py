"""Latent ODE VAE on irregularly-sampled spirals -- the port of
``examples/latent_ode.py``.

An RNN encoder consumes each trajectory backwards to produce q(z0 | x), the
latent dynamics are an MLP vector field with elu (4 -> 20 -> 20 -> 4), a
decoder maps latents to observations, and training maximises the ELBO with
optax's Adam (``_optim.Adam``).

The JAX example solves each trajectory on its own (``jax.vmap`` of
``odeint_adjoint``): its own controller, at rtol 1e-4, atol 1e-5.  Here
that is one per-sample solve, `parallel.odeint_per_sample`, with the
latent MLP's weights as shared args: each trajectory keeps its own
controller and backward solve, and a shared weight's gradient is the sum of
the trajectories'.  One (B, 4) solve with a single controller would take
other steps.  The encoder's ``lax.scan`` is a loop over time, the batch
of trajectories in each step.

The JAX example fixes float32 for its data and parameters; so does `main`.

Run:  python -m torchdiffeq_tpu_torch.examples.latent_ode [--niters 500]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
from torch import nn

from ..adjoint import odeint_adjoint
from ..models import MLPField, mlp_apply, mlp_params_from_jax
from ..parallel import odeint_per_sample, odeint_per_sample_with_stats
from ._common import add_device_flag, device_of
from ._optim import Adam

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--niters', type=int, default=500)
parser.add_argument('--lr', type=float, default=0.01)
parser.add_argument('--latent_dim', type=int, default=4)
parser.add_argument('--nhidden', type=int, default=20)
parser.add_argument('--rnn_nhidden', type=int, default=25)
parser.add_argument('--obs_dim', type=int, default=2)
parser.add_argument('--nspiral', type=int, default=100)
parser.add_argument('--ntotal', type=int, default=150)
parser.add_argument('--nsample', type=int, default=50)
parser.add_argument('--noise_std', type=float, default=0.3)
parser.add_argument('--train_dir', type=str, default=None)
parser.add_argument('--seed', type=int, default=0)

# the per-trajectory solves' tolerances (latent_ode.py:105-106)
RTOL, ATOL = 1e-4, 1e-5


def generate_spirals(args, device=None):
    """Clockwise/counter-clockwise noisy spirals on irregular samples, from
    numpy's RandomState(seed) as the JAX example draws them: (nspiral,
    nsample, 2) float32 trajectories and their (nsample,) float32 times."""
    ts = np.linspace(0.0, 4 * np.pi, args.ntotal)
    # two archetypes
    r_cw = 0.5 + ts / (4 * np.pi)
    cw = np.stack([r_cw * np.cos(ts) - 1, r_cw * np.sin(ts)], axis=1)
    r_cc = 1.5 - ts / (4 * np.pi)
    cc = np.stack([r_cc * np.cos(ts) + 1, r_cc * np.sin(ts)], axis=1)

    rng = np.random.RandomState(args.seed)
    start = rng.randint(0, args.ntotal - args.nsample, args.nspiral)
    trajs = []
    for i in range(args.nspiral):
        base = cw if rng.rand() > 0.5 else cc
        window = base[start[i]:start[i] + args.nsample]
        trajs.append(window + args.noise_std * rng.randn(*window.shape))
    samp_ts = ts[:args.nsample] / 10.0
    return (torch.from_numpy(np.stack(trajs).astype(np.float32)).to(device),
            torch.from_numpy(samp_ts.astype(np.float32)).to(device))


class LatentODE(nn.Module):
    """The example's parameters: the latent field `func` (MLP with elu), the
    RNN encoder (``rnn_w``, ``rnn_b``, and its head ``rnn_out``) and the
    decoder `dec` (MLPs with tanh)."""

    def __init__(self, func, rnn_w, rnn_b, rnn_out, dec):
        super().__init__()
        self.func = func
        self.rnn_w = nn.Parameter(rnn_w)
        self.rnn_b = nn.Parameter(rnn_b)
        self.rnn_out = rnn_out
        self.dec = dec

    def __getitem__(self, name):
        return getattr(self, name)


def init_params(args, generator, device=None, dtype=torch.float32):
    """The JAX example's initialisation (its `init_params`), drawn from
    `generator`."""
    def mlp(sizes, activation=torch.tanh):
        return MLPField(sizes, dtype=dtype, device=device,
                        generator=generator, activation=activation)

    func = mlp([args.latent_dim, args.nhidden, args.nhidden, args.latent_dim],
               nn.functional.elu)
    rnn_w = torch.randn((args.obs_dim + args.rnn_nhidden, args.rnn_nhidden),
                        generator=generator, dtype=dtype) * 0.1
    rnn_out = mlp([args.rnn_nhidden, 2 * args.latent_dim])
    dec = mlp([args.latent_dim, args.nhidden, args.obs_dim])
    return LatentODE(func, rnn_w.to(device),
                     torch.zeros(args.rnn_nhidden, dtype=dtype, device=device),
                     rnn_out, dec)


def params_from_jax(params, device=None):
    """The JAX example's parameter dict as a `LatentODE`."""
    return LatentODE(
        mlp_params_from_jax(params['func'], device=device,
                            activation=nn.functional.elu),
        torch.from_numpy(np.array(params['rnn_w'])).to(device),
        torch.from_numpy(np.array(params['rnn_b'])).to(device),
        mlp_params_from_jax(params['rnn_out'], device=device),
        mlp_params_from_jax(params['dec'], device=device))


def encode(params, traj):
    """Run the RNN backwards in time over (..., T, obs) trajectories: the
    (..., latent) mean and log-variance of q(z0 | x)."""
    h = traj.new_zeros(traj.shape[:-2] + params.rnn_b.shape)
    for i in range(traj.shape[-2] - 1, -1, -1):
        h = torch.tanh(torch.cat([traj[..., i, :], h], -1) @ params.rnn_w
                       + params.rnn_b)
    out = mlp_apply(params.rnn_out, h)
    d = out.shape[-1] // 2
    return out[..., :d], out[..., d:]  # mean, logvar


def latent_field(tt, z, *weights):
    """The latent dynamics of one trajectory: the `func` MLP (elu) whose
    weights and biases are `weights`, in layer order (w1, b1, w2, ...)."""
    n = len(weights) // 2
    for i in range(n):
        z = z @ weights[2 * i] + weights[2 * i + 1]
        if i != n - 1:
            z = nn.functional.elu(z)
    return z


def func_weights(params):
    """The latent MLP's tensors as `latent_field`'s args."""
    ws = []
    for w, b in zip(params.func.weights, params.func.biases):
        ws += [w, b]
    return tuple(ws)


def latent_solve(params, z0, ts, with_stats=False):
    """Every trajectory's latent solve, each with its own controller
    (``odeint_per_sample``): (B, T, latent), and (B,) Stats with
    `with_stats`."""
    solve = odeint_per_sample_with_stats if with_stats else odeint_per_sample
    return solve(latent_field, z0, ts, args=func_weights(params), rtol=RTOL,
                 atol=ATOL)


def elbo_loss(params, trajs, ts, eps, noise_std):
    """The negative ELBO averaged over the (B, T, obs) trajectories, with
    the reparameterisation noise `eps` (B, latent) drawn by the caller."""
    mean, logvar = encode(params, trajs)
    z0 = mean + eps * torch.exp(0.5 * logvar)
    zs = latent_solve(params, z0, ts)
    pred = mlp_apply(params.dec, zs)
    logpx = -0.5 * torch.sum(((pred - trajs) / noise_std) ** 2
                             + math.log(2 * math.pi * noise_std ** 2),
                             dim=(-2, -1))
    kl = -0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar), dim=-1)
    return torch.mean(-(logpx - kl))


def extrapolate(params, traj, ts_ext):
    """From the encoder's mean of `traj`, the latent path backwards to the
    negative times of `ts_ext` and forwards to the rest, each solve from 0
    (reference latent_ode.py:311-317)."""
    mean, _ = encode(params, traj)
    zero = ts_ext.new_zeros(1)
    ws = func_weights(params)
    zs_b = odeint_adjoint(latent_field, mean,
                          torch.cat([zero, ts_ext[ts_ext < 0].flip(0)]),
                          args=ws)
    zs_f = odeint_adjoint(latent_field, mean,
                          torch.cat([zero, ts_ext[ts_ext >= 0]]), args=ws)
    return zs_b, zs_f


def train_step(params, opt, trajs, ts, eps, noise_std):
    opt.zero_grad()
    loss = elbo_loss(params, trajs, ts, eps, noise_std)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    args = parser.parse_args(argv)
    device = device_of(args.device)
    generator = torch.Generator().manual_seed(args.seed)
    trajs, ts = generate_spirals(args, device)
    ts = ts.double().cpu()

    params = init_params(args, generator, device)
    opt = Adam(params.parameters(), args.lr)

    for itr in range(1, args.niters + 1):
        eps = torch.randn((args.nspiral, args.latent_dim),
                          generator=generator).to(device)
        loss = train_step(params, opt, trajs, ts, eps, args.noise_std)
        if itr % 20 == 0 or itr == 1:
            print(f'Iter: {itr}, neg elbo: {float(loss):.4f}')

    if args.train_dir is not None:
        os.makedirs(args.train_dir, exist_ok=True)
        flat = torch.cat([p.detach().reshape(-1).cpu()
                          for p in params.parameters()])
        np.savez(os.path.join(args.train_dir, 'ckpt.npz'),
                 params=flat.numpy())
        print('saved checkpoint')

    # extrapolation (incl. negative time, reference :311-317)
    ts_ext = torch.linspace(-1.0, 2.0, 30, dtype=torch.float32).double()
    with torch.no_grad():
        zs_b, zs_f = extrapolate(params, trajs[0], ts_ext)
    print('extrapolated (back, fwd):', tuple(zs_b.shape), tuple(zs_f.shape))
    return dict(loss=float(loss), zs_b=zs_b, zs_f=zs_f)


if __name__ == '__main__':
    main()
