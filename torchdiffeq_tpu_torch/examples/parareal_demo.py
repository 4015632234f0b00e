"""Parallel-in-time integration demo (Parareal) -- the port of
``examples/parareal_demo.py``.

* a long-horizon forced oscillator is split into the output grid's time
  slices;
* the fine propagator (adaptive dopri5 at the requested tolerance) runs
  on every slice at once: one batched solve of the slices, each with its
  own controller (`parallel.odeint_parareal`);
* a cheap sequential coarse sweep (4 rk4 steps a slice) stitches the
  slices, converging geometrically: the script prints the per-iteration
  correction norm and the error against the slice-restarted sequential
  solve, and asserts it is below 100 * rtol.

``--mesh`` shards the slices over the ranks of a launch, one process a
rank (`parallel.make_mesh`): each rank fine-solves its block of slices on
its own device, and every rank returns the whole result (rank 0 prints
it).  With one rank the flag is ignored, as JAX ignores it on one device.

Run:  python -m torchdiffeq_tpu_torch.examples.parareal_demo [--slices 16]
      [--iters 5] [--rtol 1e-6] [--mesh] [--device cpu]
      torchrun --nproc_per_node=4 -m torchdiffeq_tpu_torch.examples.\
parareal_demo --mesh
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..odeint import odeint
from ..parallel import make_mesh, odeint_parareal_with_info
from ._common import add_device_flag, device_of

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--slices', type=int, default=16)
parser.add_argument('--iters', type=int, default=5)
parser.add_argument('--rtol', type=float, default=1e-6)
parser.add_argument('--mesh', action='store_true',
                    help='shard the slice axis over the ranks of the '
                    'launch (torchrun --nproc_per_node=N)')


def field(t, y):
    """Forced, lightly damped oscillator -- smooth but long-horizon."""
    x, v = y[0], y[1]
    return torch.stack([v, -x - 0.05 * v + 0.3 * torch.sin(1.3 * t)])


def sequential(y0, t, rtol):
    """The slice-restarted fine propagation, the oracle: (T, 2)."""
    u = y0
    seq = [y0]
    for s in range(t.shape[0] - 1):
        u = odeint(field, u, t[s:s + 2], rtol=rtol, atol=rtol * 1e-2)[-1]
        seq.append(u)
    return torch.stack(seq)


def _mesh(args, device):
    """JAX's choice of mesh: the slices over every rank of the launch (one
    device a rank) when they divide evenly, else None with its message."""
    if not args.mesh:
        return None
    n_dev = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get('WORLD_SIZE', 1)))
    if args.slices % n_dev == 0 and n_dev > 1:
        mesh = make_mesh({'time': n_dev}, device_type=device.type)
        _say(f"sharding {args.slices} slices over {n_dev} devices")
        return mesh
    if n_dev == 1:
        _say("--mesh ignored: only one device visible")
    else:
        _say(f"--mesh ignored: {args.slices} slices not divisible by "
              f"{n_dev} device(s)")
    return None


def _say(msg):
    """Print once a launch: on rank 0, or with no process group."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(msg)


def main(argv=None, dtype=torch.float32):
    """The demo; `dtype` is the state's (float32, as the JAX example runs
    without x64).  Returns dict(ys, deltas, seq, err)."""
    args = parser.parse_args(argv)
    device = device_of(args.device)
    mesh = _mesh(args, device)
    if mesh is not None:
        device = mesh.device          # this rank's card
    y0 = torch.tensor([1.0, 0.0], dtype=dtype, device=device)
    t = torch.linspace(0.0, 20.0, args.slices + 1, dtype=dtype,
                       device=device)

    ys_par, deltas = odeint_parareal_with_info(
        field, y0, t, rtol=args.rtol, atol=args.rtol * 1e-2,
        coarse_num_steps=4, n_iters=args.iters, mesh=mesh, axis='time')
    seq = sequential(y0, t, args.rtol)

    err = float((ys_par - seq).abs().max())
    _say("per-iteration correction norms: "
         + str(["%.2e" % d for d in deltas.cpu().tolist()]))
    _say(f"max |parareal - sequential| after {args.iters} iterations: "
         f"{err:.2e}")
    assert err < 100 * args.rtol, err
    _say("ok")
    return dict(ys=ys_par, deltas=deltas, seq=seq, err=err)


if __name__ == '__main__':
    main()
