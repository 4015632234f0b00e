"""ODE-Net image classifier -- the port of ``examples/odenet_mnist.py``.

Two strided 'SAME' convolutions downsample the image; an ODE block
integrates the conv ODE-Net field (``models/conv_ode.py``: cuDNN's
convolutions on a channels-last view of the NHWC state, as JAX's are
``lax.conv`` outside any Pallas kernel) over [0, 1] and takes the final
state; GroupNorm, relu, global average pooling and a 10-way head follow.
``--network resnet`` swaps the ODE block for two residual blocks.  The
NFE-F meter comes from `odeint_with_stats`.  Optimisation is optax's SGD
with momentum 0.9 (``_optim.SGD``).

``--data synthetic`` (the default) trains on a synthetic 10-class digit-like
dataset; ``--data mnist`` reads ``{data_dir}/mnist.npz`` (the Keras archive
layout: x_train, y_train, x_test, y_test) from disk, and nothing is
downloaded.

Run:  python -m torchdiffeq_tpu_torch.examples.odenet_mnist [--adjoint]
      [--network odenet|resnet] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..adjoint import odeint_adjoint
from ..models.conv_ode import (ConvField, conv_apply, conv_params_from_jax,
                               group_norm, init_conv)
from ..odeint import odeint, odeint_with_stats
from ._common import add_device_flag, device_of
from ._optim import SGD

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--network', choices=['resnet', 'odenet'], default='odenet')
parser.add_argument('--tol', type=float, default=1e-3)
parser.add_argument('--adjoint', action='store_true')
parser.add_argument('--nepochs', type=int, default=3)
parser.add_argument('--lr', type=float, default=0.1)
parser.add_argument('--batch_size', type=int, default=128)
parser.add_argument('--hidden', type=int, default=32)
parser.add_argument('--data', choices=['synthetic', 'mnist'], default='synthetic')
parser.add_argument('--data_dir', type=str, default='./data')
parser.add_argument('--steps_per_epoch', type=int, default=100)
parser.add_argument('--seed', type=int, default=0)


def load_mnist_npz(data_dir, device=None):
    """Real MNIST from ``{data_dir}/mnist.npz`` (x_train, y_train, x_test,
    y_test), NHWC float32 normalised as the reference does (mean 0.1307,
    std 0.3081); nothing is downloaded."""
    path = os.path.join(data_dir, 'mnist.npz')
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"--data mnist requires {path} with keys x_train/y_train/"
            f"x_test/y_test (e.g. the Keras mnist.npz archive); nothing is "
            f"downloaded -- use --data synthetic instead")
    with np.load(path) as d:
        xtr = (d['x_train'].astype(np.float32) / 255.0 - 0.1307) / 0.3081
        ytr = d['y_train'].astype(np.int64)
        xte = (d['x_test'].astype(np.float32) / 255.0 - 0.1307) / 0.3081
        yte = d['y_test'].astype(np.int64)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (xtr[..., None], ytr, xte[..., None], yte))


def synthetic_digits(n, generator, size=16, device=None, dtype=None):
    """10-class synthetic 'digit' dataset: each class is a fixed random
    blob pattern plus noise; NHWC images and integer labels."""
    dtype = dtype or torch.get_default_dtype()
    protos = torch.randn((10, size, size), generator=generator, dtype=dtype)
    labels = torch.randint(0, 10, (n,), generator=generator)
    imgs = protos[labels] + 0.5 * torch.randn((n, size, size),
                                              generator=generator, dtype=dtype)
    return imgs[..., None].to(device), labels.to(device)


def _conv_dict(p):
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


class Model(nn.Module):
    """The classifier's parameters: ``down1``, ``down2`` (convolutions,
    OIHW), ``fc`` and the ODE block's ``odefunc`` (a `ConvField`) or the
    residual blocks ``res``."""

    def __init__(self, down1, down2, fc, odefunc=None, res=None):
        super().__init__()
        self.down1 = _conv_dict(down1)
        self.down2 = _conv_dict(down2)
        self.fc = _conv_dict(fc)
        self.odefunc = odefunc
        self.res = None if res is None else nn.ModuleList(
            nn.ModuleDict({k: _conv_dict(v) for k, v in blk.items()})
            for blk in res)


def init_model(args, generator, device=None, dtype=None):
    """He-initialised convolutions, a head at scale 0.01 (the JAX example's
    `init_model`), drawn from `generator`."""
    dtype = dtype or torch.get_default_dtype()
    dim = args.hidden
    kw = dict(dtype=dtype, device=device, generator=generator)
    down1, down2 = init_conv(1, dim, **kw), init_conv(dim, dim, **kw)
    fc = dict(w=(torch.randn((dim, 10), generator=generator, dtype=dtype)
                 * 0.01).to(device),
              b=torch.zeros(10, dtype=dtype, device=device))
    if args.network == 'odenet':
        return Model(down1, down2, fc, odefunc=ConvField(dim, **kw))
    res = [dict(conv1=init_conv(dim, dim, **kw), conv2=init_conv(dim, dim, **kw))
           for _ in range(2)]
    return Model(down1, down2, fc, res=res)


def params_from_jax(params, device=None):
    """The JAX example's model dict as a `Model` (HWIO kernels transposed
    to OIHW)."""
    def conv(p):
        return dict(w=torch.from_numpy(np.asarray(p['w']).transpose(3, 2, 0, 1)
                                       .copy()).to(device),
                    b=torch.from_numpy(np.array(p['b'])).to(device))

    fc = dict(w=torch.from_numpy(np.array(params['fc']['w'])).to(device),
              b=torch.from_numpy(np.array(params['fc']['b'])).to(device))
    if 'odefunc' in params:
        return Model(conv(params['down1']), conv(params['down2']), fc,
                     odefunc=conv_params_from_jax(params['odefunc'],
                                                  device=device))
    return Model(conv(params['down1']), conv(params['down2']), fc,
                 res=[{k: conv(v) for k, v in blk.items()}
                      for blk in params['res']])


def forward(model, x, args, with_stats=False):
    """The logits of the NHWC images `x`, and the ODE block's Stats with
    `with_stats` (else None)."""
    h = torch.relu(conv_apply(model.down1, x, stride=2))
    h = torch.relu(conv_apply(model.down2, h, stride=2))
    stats = None
    if args.network == 'odenet':
        t = torch.tensor([0.0, 1.0], dtype=torch.float64)
        solver = odeint_adjoint if args.adjoint else odeint
        if with_stats:
            ys, stats = odeint_with_stats(model.odefunc, h, t, rtol=args.tol,
                                          atol=args.tol)
        else:
            ys = solver(model.odefunc, h, t, rtol=args.tol, atol=args.tol)
        h = ys[1]
    else:
        for blk in model.res:
            r = group_norm(h)
            r = torch.relu(r)
            r = conv_apply(blk['conv1'], r)
            r = group_norm(r)
            r = torch.relu(r)
            r = conv_apply(blk['conv2'], r)
            h = h + r
    h = group_norm(h)
    h = torch.relu(h)
    h = h.mean(dim=(1, 2))  # global average pool
    logits = h @ model.fc['w'] + model.fc['b']
    return logits, stats


def loss_fn(model, x, y, args):
    """Softmax cross-entropy with integer labels, averaged."""
    logits, _ = forward(model, x, args)
    return F.cross_entropy(logits, y)


def train_step(model, opt, x, y, args):
    opt.zero_grad()
    loss = loss_fn(model, x, y, args)
    loss.backward()
    opt.step()
    return loss.detach()


def accuracy(model, x, y, args):
    with torch.no_grad():
        logits, _ = forward(model, x, args)
    return torch.mean((torch.argmax(logits, -1) == y).to(logits.dtype))


def main(argv=None):
    args = parser.parse_args(argv)
    device = device_of(args.device)
    generator = torch.Generator().manual_seed(args.seed)

    if args.data == 'mnist':
        train_x, train_y, test_x, test_y = load_mnist_npz(args.data_dir,
                                                          device)
    else:
        all_x, all_y = synthetic_digits(5120, generator, device=device)
        train_x, train_y = all_x[:4096], all_y[:4096]
        test_x, test_y = all_x[4096:], all_y[4096:]

    model = init_model(args, generator, device)
    opt = SGD(model.parameters(), args.lr, momentum=0.9)

    n = train_x.shape[0]
    for epoch in range(args.nepochs):
        perm = torch.randperm(n, generator=generator).to(device)
        start = time.time()
        for i in range(args.steps_per_epoch):
            idx = perm[(i * args.batch_size) % n:][:args.batch_size]
            loss = train_step(model, opt, train_x[idx], train_y[idx], args)
        acc = float(accuracy(model, test_x[:512], test_y[:512], args))
        msg = (f'Epoch {epoch:02d} | Loss {float(loss):.4f} | '
               f'Test Acc {acc:.4f} | {time.time() - start:.1f}s')
        if args.network == 'odenet':
            with torch.no_grad():
                _, stats = forward(model, test_x[:8], args, with_stats=True)
            msg += f' | NFE-F {int(stats.nfe)}'
        print(msg)
    return dict(loss=float(loss), acc=acc, model=model)


if __name__ == '__main__':
    main()
