"""Batched solves with per-sample step control."""
from .batched import odeint_per_sample, odeint_per_sample_with_stats

__all__ = ['odeint_per_sample', 'odeint_per_sample_with_stats']
