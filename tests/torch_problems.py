"""PyTorch twins of the closed-form problems of tests/problems.py (the
reference's fixtures), for the port's parity tests: the same fields on the
same numbers, so a solve of each through the JAX package and through the
port can be compared; and the helpers that run such a pair."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torchdiffeq_tpu as tde
import torchdiffeq_tpu_torch as tt


class ConstantODE:
    """dy/dt = a + (y - (a t + b))^5, exact y = a t + b."""

    def __init__(self):
        self.a = torch.tensor(0.2, dtype=torch.float64)
        self.b = torch.tensor(3.0, dtype=torch.float64)

    def __call__(self, t, y):
        return self.a + (y - (self.a * t + self.b)) ** 5


class SineODE:
    def __call__(self, t, y):
        return 2 * y / t + t ** 4 * torch.sin(2 * t) - t ** 2 + 4 * t ** 3


class LinearODE:
    """dy/dt = A y, A from RandomState(0) as problems.LinearODE."""

    def __init__(self, dim=10):
        self.dim = dim
        rng = np.random.RandomState(0)
        U = rng.randn(dim, dim) * 0.1
        self.A = torch.from_numpy(2 * U - (U + U.T))

    def __call__(self, t, y):
        return (self.A @ y.reshape(self.dim, 1)).reshape(-1)


class ExpODE:
    def __call__(self, t, y):
        return -0.1 * torch.exp(-0.1 * t) * torch.ones_like(y)


PROBLEMS = {'constant': ConstantODE, 'linear': LinearODE, 'sine': SineODE,
            'exp': ExpODE}


def construct_problem(npts=10, ode='constant', reverse=False):
    """problems.construct_problem's JAX field, its torch twin, y0 and the
    output times (float64 numpy arrays, the inputs of both packages)."""
    import problems
    f_j, y0, t, _ = problems.construct_problem(npts=npts, ode=ode,
                                               reverse=reverse)
    return f_j, PROBLEMS[ode](), np.array(y0), np.array(t)


def counters(st):
    return [int(x) for x in st[:5]]


def solve_pair(f_j, f_t, y0, t, **kw):
    """`odeint_with_stats` through both packages on the same numpy inputs:
    (ys_jax, counters_jax, ys_port, counters_port), values as numpy."""
    ys_j, st_j = tde.odeint_with_stats(f_j, jnp.asarray(y0), jnp.asarray(t),
                                       **kw)
    with torch.no_grad():
        ys_t, st_t = tt.odeint_with_stats(f_t, torch.from_numpy(y0),
                                          torch.from_numpy(t), **kw)
    return np.asarray(ys_j), counters(st_j), ys_t.numpy(), counters(st_t)


def grads_pair(f_j, f_t, y0, t, project_j, project_t, **kw):
    """The gradients of ``project(odeint(f, y0, t, **kw))`` to y0 and t
    through both packages: ((g_y0, g_t) JAX, (g_y0, g_t) port)."""
    gj = jax.grad(lambda y, s: project_j(tde.odeint(f_j, y, s, **kw)),
                  argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(t))
    y = torch.from_numpy(y0).requires_grad_()
    s = torch.from_numpy(t).requires_grad_()
    project_t(tt.odeint(f_t, y, s, **kw)).backward()
    return ((np.asarray(gj[0]), np.asarray(gj[1])),
            (y.grad.numpy(), s.grad.numpy()))


def assert_grads_close(got, want, rel):
    """Each gradient within `rel` of its largest entry."""
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-300)
        assert float(np.abs(g - w).max()) <= rel * scale, \
            (float(np.abs(g - w).max()), scale)

