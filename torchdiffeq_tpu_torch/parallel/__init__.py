"""Batched solves with per-sample step control, and Parareal on one
device (the JAX package's device-mesh helpers, `sharding.py`, are still to
come: ROADMAP queue A)."""
from .batched import odeint_per_sample, odeint_per_sample_with_stats
from .parareal import odeint_parareal, odeint_parareal_with_info

__all__ = ['odeint_per_sample', 'odeint_per_sample_with_stats',
           'odeint_parareal', 'odeint_parareal_with_info']
