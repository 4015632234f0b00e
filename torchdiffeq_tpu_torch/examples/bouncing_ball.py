"""Bouncing ball with event handling -- the port of
``examples/bouncing_ball.py``.

The state is the tuple (pos, vel, log_radius); the event fires when the
ball touches the ground (pos == radius); after each event the velocity is
reflected and damped with a small nudge off the ground; bounces are chained
with `odeint_event` through `odeint_adjoint`.  The gradient of the last
event time with respect to the five physical inputs, t0 among them, is
checked against central finite differences.  Gravity reaches the solve as
an arg, which is how the adjoint gives it a gradient (JAX finds the
closed-over value by ``closure_convert``).

The example runs in float64 (torch's default dtype inside `main`, the
port's counterpart of ``jax_enable_x64``), on the card as on the CPU: in
float32 the perturbed solves of the finite differences land on other steps
and the quotient is noise, so the check runs only in float64.

Run:  python -m torchdiffeq_tpu_torch.examples.bouncing_ball [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..adjoint import odeint_adjoint
from ..events import odeint_event
from ._common import add_device_flag, default_dtype, device_of

parser = add_device_flag(argparse.ArgumentParser())


def dynamics(t, state, gravity):
    pos, vel, log_radius = state
    dpos = vel
    dvel = -gravity * torch.ones_like(vel)
    dlog_radius = torch.zeros_like(log_radius)
    return (dpos, dvel, dlog_radius)


def event_fn(t, state):
    # positive before the bounce, zero at contact
    pos, _, log_radius = state
    return pos - torch.exp(log_radius)


def get_collision_times(pos0, vel0, log_radius0, gravity, t0, nbounces=3):
    event_times = []
    state = (pos0, vel0, log_radius0)
    t = t0
    for _ in range(nbounces):
        event_t, solution = odeint_event(
            dynamics, state, t, event_fn=event_fn,
            odeint_interface=odeint_adjoint, atol=1e-8, rtol=1e-8,
            args=(gravity,))
        event_times.append(event_t)
        # instantaneous update: reflect + damp velocity, nudge off ground
        pos, vel, log_radius = (s[-1] for s in solution)
        pos = pos + 1e-7
        vel = -0.8 * vel
        state = (pos, vel, log_radius)
        t = event_t
    return event_times


def analytic_first_bounce(pos0, vel0, radius, gravity):
    # pos(t) = pos0 + vel0 t - g t^2 / 2 == radius
    a, b, c = -gravity / 2, vel0, pos0 - radius
    return (-b - np.sqrt(b * b - 4 * a * c)) / (2 * a)


def last_event_time(pos0, vel0, log_radius0, gravity, t0):
    return get_collision_times(pos0, vel0, log_radius0, gravity, t0)[-1]


def main(argv=None):
    args = parser.parse_args(argv)
    device = device_of(args.device)
    with default_dtype(torch.float64):
        return _run(device)


def _run(device):
    values = (10.0, -2.0, float(np.log(0.3)), 9.8, 0.0)
    inputs = [torch.tensor(v, device=device, requires_grad=True)
              for v in values]

    times = get_collision_times(*inputs)
    values_t = [float(t.detach()) for t in times]
    print("event times:", values_t)

    t1_exact = analytic_first_bounce(10.0, -2.0, 0.3, 9.8)
    print(f"first bounce: {values_t[0]:.8f} (exact {t1_exact:.8f})")
    assert abs(values_t[0] - t1_exact) < 1e-6

    # --- gradient of the *last* event time wrt all parameters, checked by
    # central finite differences (reference bouncing_ball.py:103-151) ------
    grads = torch.autograd.grad(times[-1], inputs)

    eps = 1e-5
    names = ['pos0', 'vel0', 'log_radius0', 'gravity', 't0']
    ok = True
    fds = []
    with torch.no_grad():
        for i, name in enumerate(names):
            pert = [torch.tensor(v, device=device) for v in values]
            pert[i] = pert[i] + eps
            hi = float(last_event_time(*pert))
            pert[i] = pert[i] - 2 * eps
            lo = float(last_event_time(*pert))
            fd = (hi - lo) / (2 * eps)
            fds.append(fd)
            match = abs(float(grads[i]) - fd) < 1e-3 * max(1.0, abs(fd))
            ok &= match
            print(f"d(event_t)/d{name}: autodiff {float(grads[i]):+.6f} "
                  f"fd {fd:+.6f} {'OK' if match else 'MISMATCH'}")
    assert ok, "event-time gradient check failed"
    print("all event-time gradients match finite differences")
    return dict(times=values_t, exact=t1_exact,
                grads=[float(g) for g in grads], fds=fds)


if __name__ == '__main__':
    main()
