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

``--mesh`` shards the slices over several devices in the JAX package; the
port's device mesh is still to come (ROADMAP queue A, the sharding slice):
with one device the flag is ignored, as in JAX, and with several it raises
`NotImplementedError`.

Run:  python -m torchdiffeq_tpu_torch.examples.parareal_demo [--slices 16]
      [--iters 5] [--rtol 1e-6] [--mesh] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..odeint import odeint
from ..parallel import odeint_parareal_with_info
from ._common import add_device_flag, device_of

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--slices', type=int, default=16)
parser.add_argument('--iters', type=int, default=5)
parser.add_argument('--rtol', type=float, default=1e-6)
parser.add_argument('--mesh', action='store_true',
                    help='shard the slice axis over all visible devices')


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
    """JAX's choice of mesh: the slices over every visible device when
    they divide evenly, else None with its message."""
    if not args.mesh:
        return None
    n_dev = torch.cuda.device_count() if device.type == 'cuda' else 1
    if args.slices % n_dev == 0 and n_dev > 1:
        print(f"sharding {args.slices} slices over {n_dev} devices")
        return {'time': n_dev}    # odeint_parareal raises: still to come
    if n_dev == 1:
        print("--mesh ignored: only one device visible")
    else:
        print(f"--mesh ignored: {args.slices} slices not divisible by "
              f"{n_dev} device(s)")
    return None


def main(argv=None, dtype=torch.float32):
    """The demo; `dtype` is the state's (float32, as the JAX example runs
    without x64).  Returns dict(ys, deltas, seq, err)."""
    args = parser.parse_args(argv)
    device = device_of(args.device)
    mesh = _mesh(args, device)
    y0 = torch.tensor([1.0, 0.0], dtype=dtype, device=device)
    t = torch.linspace(0.0, 20.0, args.slices + 1, dtype=dtype,
                       device=device)

    ys_par, deltas = odeint_parareal_with_info(
        field, y0, t, rtol=args.rtol, atol=args.rtol * 1e-2,
        coarse_num_steps=4, n_iters=args.iters, mesh=mesh, axis='time')
    seq = sequential(y0, t, args.rtol)

    err = float((ys_par - seq).abs().max())
    print("per-iteration correction norms:",
          ["%.2e" % d for d in deltas.cpu().tolist()])
    print(f"max |parareal - sequential| after {args.iters} iterations: "
          f"{err:.2e}")
    assert err < 100 * args.rtol, err
    print("ok")
    return dict(ys=ys_par, deltas=deltas, seq=seq, err=err)


if __name__ == '__main__':
    main()
