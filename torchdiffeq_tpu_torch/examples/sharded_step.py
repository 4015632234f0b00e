"""The sharded training step of the JAX package's
``__graft_entry__.dryrun_multichip`` -- its port on torch.distributed.

* the ranks of the launch form the mesh ``{'data': n // m, 'model': m}``,
  m = 2 when n is even, else 1;
* the spiral field ``mlp(y**3)``, 2 -> 64 m -> 2, has its hidden units split
  over ``'model'`` (`parallel.tensor_parallel_mlp`: W1 by column, b1 split,
  W2 by row, b2 replicated);
* the batch of 32 n/m spirals is split over ``'data'`` with one shared
  controller (`parallel.data_parallel_odeint`);
* one step is ``odeint_adjoint(dopri5, rtol=1e-2, atol=1e-3)`` over
  t = [0, 0.5], the loss ``mean((ys[-1] - target)**2)``, its backward and
  SGD at lr 1e-2 on each rank's shards.  Every rank receives the global
  gradient of its shards; none is all-reduced by hand.

The first step is held against the one-device step of the same weights,
which every rank also computes: the script prints ``loss_rel_diff`` and
``grad_rel_diff`` and fails above the JAX dry run's bounds (1e-3, 5e-2),
then times 3 steps.  ``--full-width`` runs bench.py's main cell on the same
mesh instead: 1024 spirals, H=64, T=10 outputs on [0, 1], rtol 1e-7, atol
1e-9, the loss over every output and lr 1e-3.  Weights, y0 and the target
come from ``torch.Generator`` seeds 0, 1 and 2.

Run:  torchrun --nproc_per_node=4 -m torchdiffeq_tpu_torch.examples.\
sharded_step [--device cpu] [--dtype float64] [--full-width]
      python -m torchdiffeq_tpu_torch.examples.sharded_step --device cpu
(a world of one).  On the card each rank takes its own card (NCCL); with
``--device cpu`` the ranks run on gloo.
"""
from __future__ import annotations

import argparse
import copy
import os
import time

import torch
import torch.distributed as dist

from ..adjoint import odeint_adjoint
from ..models.neural_ode import init_spiral_model
from ..parallel import data_parallel_odeint, make_mesh, tensor_parallel_mlp
from ._common import add_device_flag, device_of

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--dtype', default='float32',
                    choices=['float32', 'float64'])
parser.add_argument('--full-width', action='store_true',
                    help="bench.py's main cell (B=1024, H=64, T=10, rtol "
                    "1e-7, atol 1e-9) in place of the dry run's sizes")
parser.add_argument('--steps', type=int, default=3,
                    help='the timed steps after the first')

# the JAX dry run's bounds on the sharded step against one device
# (__graft_entry__.py:134-135)
LOSS_REL, GRAD_REL = 1e-3, 5e-2


def config(n, full_width=False):
    """The dry run's configuration for `n` ranks (`__graft_entry__.py:
    58-70`), or bench.py's main cell on the same mesh: dict(mesh, hidden,
    batch, t, rtol, atol, lr, last_only) -- `last_only` whether the loss
    reads the last output alone."""
    model = 2 if n % 2 == 0 else 1
    mesh = {'data': n // model, 'model': model}
    if full_width:
        return dict(mesh=mesh, hidden=64, batch=1024,
                    t=torch.linspace(0.0, 1.0, 10, dtype=torch.float64),
                    rtol=1e-7, atol=1e-9, lr=1e-3, last_only=False)
    return dict(mesh=mesh, hidden=64 * model, batch=32 * (n // model),
                t=torch.linspace(0.0, 0.5, 2, dtype=torch.float64),
                rtol=1e-2, atol=1e-3, lr=1e-2, last_only=True)


def make_problem(hidden, batch, dtype, device):
    """The spiral field (an `MLPField`), y0 and the target on `device`:
    weights from ``torch.Generator`` seed 0 (scale 0.1, as the JAX
    package's `init_spiral_model`), y0 and the target from seeds 1 and 2
    (the tests give the field JAX's weights with `mlp_params_from_jax`)."""
    field = init_spiral_model(hidden, dtype=dtype, device=device,
                              generator=torch.Generator().manual_seed(0))
    y0, target = (torch.randn(batch, 2, dtype=dtype,
                              generator=torch.Generator().manual_seed(s))
                  .to(device) for s in (1, 2))
    return field, y0, target


def loss_fn(ys, target, last_only=True):
    """mean((ys[-1] - target)**2), or over every output."""
    return ((ys[-1] if last_only else ys) - target).pow(2).mean()


def train_step(field, solve, y0, target, t, *, rtol, atol, lr,
               last_only=True, adjoint_options=None):
    """One step: ``solve`` (an odeint_adjoint-like call) of `field`, the
    loss, its backward and ``p -= lr * grad`` on the field's parameters.
    Returns (loss, the gradients, in ``field.parameters()`` order)."""
    ys = solve(field, y0, t, rtol=rtol, atol=atol, method='dopri5',
               adjoint_options=adjoint_options)
    loss = loss_fn(ys, target, last_only)
    loss.backward()
    grads = []
    with torch.no_grad():
        for p in field.parameters():
            grads.append(p.grad)
            p -= lr * p.grad
            p.grad = None
    return loss.detach(), grads


def rel_diffs(loss, grads, ref_loss, ref_grads):
    """The dry run's comparison (`__graft_entry__.py:125-133`): |loss -
    ref| / |ref| and max|g - ref| / max|ref| over every gradient."""
    loss_diff = abs(float(loss) - float(ref_loss)) / max(
        abs(float(ref_loss)), 1e-12)
    g = torch.cat([x.reshape(-1).double().cpu() for x in grads])
    rg = torch.cat([x.reshape(-1).double().cpu() for x in ref_grads])
    grad_diff = float((g - rg).abs().max()) / max(float(rg.abs().max()),
                                                  1e-12)
    return loss_diff, grad_diff


def run(mesh, field, y0, target, cfg, n_timed=3):
    """The sharded step on `mesh` from the full `field` (an `MLPField`, the
    same on every rank), y0 and target, against the one-device step of the
    same weights, then `n_timed` more steps timed (CUDA events on the card).
    Returns dict(loss, grads: the gathered gradients, ref_loss, ref_grads,
    loss_rel_diff, grad_rel_diff, step_ms, last_loss)."""
    kw = dict(rtol=cfg['rtol'], atol=cfg['atol'], lr=cfg['lr'],
              last_only=cfg['last_only'])
    t = cfg['t']
    ref_field = copy.deepcopy(field)
    tp = tensor_parallel_mlp(field, mesh, 'model')
    solve = data_parallel_odeint(odeint_adjoint, mesh, 'data')
    loss, grads = train_step(tp, solve, y0, target, t, **kw)
    grads = tp.gather(grads)
    ref_loss, ref_grads = train_step(ref_field, odeint_adjoint, y0, target,
                                     t, **kw)
    loss_diff, grad_diff = rel_diffs(loss, grads, ref_loss, ref_grads)
    cuda = mesh.device.type == 'cuda'
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(mesh.device)
        start.record()
    w0 = time.perf_counter()
    last = loss
    for _ in range(n_timed):
        last, _ = train_step(tp, solve, y0, target, t, **kw)
    if cuda:
        end.record()
        end.synchronize()
        total_ms = start.elapsed_time(end)
    else:
        total_ms = (time.perf_counter() - w0) * 1e3
    step_ms = total_ms / n_timed if n_timed else float('nan')
    return dict(loss=loss, grads=grads, ref_loss=ref_loss,
                ref_grads=ref_grads, loss_rel_diff=loss_diff,
                grad_rel_diff=grad_diff, step_ms=step_ms, last_loss=last)


def _world():
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', 1))


def main(argv=None):
    """The step.  Returns `run`'s dict with the mesh."""
    args = parser.parse_args(argv)
    device = device_of(args.device)
    dtype = getattr(torch, args.dtype)
    cfg = config(_world(), args.full_width)
    mesh = make_mesh(cfg['mesh'], device_type=device.type)
    field, y0, target = make_problem(cfg['hidden'], cfg['batch'], dtype,
                                     mesh.device)
    out = run(mesh, field, y0, target, cfg, args.steps)
    loss = float(out['loss'])
    rank = dist.get_rank()
    print(f"[rank {rank}] sharded_step: n={_world()} mesh=(data="
          f"{cfg['mesh']['data']}, model={cfg['mesh']['model']}) "
          f"{args.dtype} B={cfg['batch']} H={cfg['hidden']} loss={loss:.6f} "
          f"step={out['step_ms']:.2f}ms loss_rel_diff="
          f"{out['loss_rel_diff']:.2e} grad_rel_diff="
          f"{out['grad_rel_diff']:.2e}", flush=True)
    assert torch.isfinite(out['loss']) and torch.isfinite(out['last_loss']), \
        "non-finite loss in the sharded step"
    assert out['loss_rel_diff'] < LOSS_REL, \
        f"sharded-vs-single loss mismatch: {out['loss_rel_diff']}"
    assert out['grad_rel_diff'] < GRAD_REL, \
        f"sharded-vs-single grad mismatch: {out['grad_rel_diff']}"
    return dict(out, mesh=mesh)


if __name__ == '__main__':
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
