"""Learning dynamics + events + instantaneous updates from trajectory data
-- the port of ``examples/learn_physics.py``.

A bouncing-ball system where the dynamics (gravity) and the instantaneous
bounce update (restitution) are learned from an observed trajectory.
Gravity reaches each solve as an arg, so the adjoint and the event time's
implicit-function reroute give it its gradient (JAX finds the closed-over
value by ``closure_convert``); restitution enters through the update
between solves.  The event function guards on a terminal time; bounces are
chained up to `max_events`, and each segment's prediction is closed-form.
The example runs in float64, as the JAX one does (its data are float64).

Run:  python -m torchdiffeq_tpu_torch.examples.learn_physics [--niters 200]
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..adjoint import odeint_adjoint
from ..events import odeint_event
from ._common import add_device_flag, default_dtype, device_of
from ._optim import Adam

parser = add_device_flag(argparse.ArgumentParser())
parser.add_argument('--niters', type=int, default=300)
parser.add_argument('--lr', type=float, default=0.05)
parser.add_argument('--max_events', type=int, default=3)
parser.add_argument('--t_end', type=float, default=3.0)
parser.add_argument('--seed', type=int, default=0)

TRUE_GRAVITY = 9.8
TRUE_RESTITUTION = 0.8


def simulate_true(t_obs, max_events=6):
    """Ground-truth bouncing ball via exact kinematics (numpy)."""
    g, e = TRUE_GRAVITY, TRUE_RESTITUTION
    pos, vel, t0 = 2.0, 0.0, 0.0
    segs = []  # (t_start, pos, vel)
    for _ in range(max_events):
        segs.append((t0, pos, vel))
        disc = vel * vel + 2 * g * pos
        t_hit = (vel + np.sqrt(disc)) / g
        t0, vel, pos = t0 + t_hit, -e * (vel - g * t_hit), 0.0
    out = np.zeros_like(t_obs)
    for (ts, p, v) in segs:
        m = t_obs >= ts
        out[m] = p + v * (t_obs[m] - ts) - 0.5 * g * (t_obs[m] - ts) ** 2
    return np.maximum(out, 0.0)


def dynamics(t, state, gravity):
    pos, vel = state
    return (vel, -gravity * torch.ones_like(vel))


def trajectory_loss(params, t_obs, y_obs, t_end, max_events):
    """Piecewise model trajectory evaluated at observation times."""
    gravity = torch.exp(params['log_gravity'])
    restitution = torch.sigmoid(params['logit_restitution'])

    def event_fn(t, state):
        pos, vel = state
        return torch.minimum(pos[0], t_end - t)

    device = t_obs.device
    state = (torch.tensor([2.0], device=device),
             torch.tensor([0.0], device=device))
    t = torch.tensor(0.0, device=device)
    loss = 0.0
    seg_starts, seg_states = [], []
    for _ in range(max_events):
        seg_starts.append(t)
        seg_states.append(state)
        event_t, sol = odeint_event(
            dynamics, state, t, event_fn=event_fn,
            odeint_interface=odeint_adjoint, rtol=1e-6, atol=1e-8,
            args=(gravity,))
        pos, vel = (s[-1] for s in sol)
        state = (pos + 1e-6, -restitution * vel)
        t = event_t

    seg_starts.append(t)
    # closed-form within segments (dynamics are exactly integrable given
    # the segment initial conditions, which carry solver gradients)
    for i in range(max_events):
        t0 = seg_starts[i]
        t1 = seg_starts[i + 1]
        p0, v0 = seg_states[i]
        m = (t_obs >= t0) & (t_obs < t1)
        dt = t_obs - t0
        pred = p0[0] + v0[0] * dt - 0.5 * gravity * dt ** 2
        loss = loss + torch.sum(torch.where(m, (pred - y_obs) ** 2,
                                            torch.zeros_like(pred)))
    return loss / t_obs.shape[0]


def init_params(device):
    return dict(log_gravity=torch.tensor(float(np.log(5.0)), device=device,
                                         requires_grad=True),
                logit_restitution=torch.tensor(0.0, device=device,
                                               requires_grad=True))


def params_from_jax(params, device=None):
    """The JAX example's parameter dict as leaf tensors that take
    gradients."""
    return {k: torch.tensor(float(np.asarray(v)), dtype=torch.float64,
                            device=device, requires_grad=True)
            for k, v in params.items()}


def main(argv=None):
    args = parser.parse_args(argv)
    device = device_of(args.device)
    with default_dtype(torch.float64):
        return _run(args, device)


def _run(args, device):
    t_np = np.linspace(0.0, args.t_end, 100)
    t_obs = torch.from_numpy(t_np).to(device)
    y_obs = torch.from_numpy(simulate_true(t_np)).to(device)

    params = init_params(device)
    opt = Adam(list(params.values()), args.lr)

    for itr in range(1, args.niters + 1):
        opt.zero_grad()
        loss = trajectory_loss(params, t_obs, y_obs, args.t_end,
                               args.max_events)
        loss.backward()
        opt.step()
        if itr % 25 == 0 or itr == 1:
            g = float(torch.exp(params['log_gravity']))
            e = float(torch.sigmoid(params['logit_restitution']))
            print(f'Iter {itr:04d} | loss {float(loss):.5f} | '
                  f'gravity {g:.3f} (true {TRUE_GRAVITY}) | '
                  f'restitution {e:.3f} (true {TRUE_RESTITUTION})')

    g = float(torch.exp(params['log_gravity']))
    assert abs(g - TRUE_GRAVITY) < 0.5, f"gravity not recovered: {g}"
    print('learned physics parameters recovered')
    return dict(gravity=g, loss=float(loss))


if __name__ == '__main__':
    main()
