"""torchdiffeq_tpu_torch: the PyTorch / CUDA port of torchdiffeq_tpu.

The JAX package `torchdiffeq_tpu` is the reference; this package mirrors
its module paths and calling conventions (``func(t, y, *args)``, the
``(T, B, D)``, ``(D, B)`` and ``(B, T, D)`` layouts) in PyTorch, and never
imports JAX.  Every JAX module has its counterpart here but those
ROADMAP.md lists as not to port: every solver tier and gradient mode on
tensor and pytree states, events, dense output, the per-sample route and
its CUDA kernels, Parareal, the training loops, the examples, and the
device mesh (`parallel.sharding`, on torch.distributed, one process a
rank).
"""
from .misc import Perturb
from .odeint import odeint, odeint_with_stats
from .adjoint import odeint_adjoint
from .events import odeint_event
from .dense import odeint_dense, DenseSolution
from .parallel.batched import odeint_per_sample, odeint_per_sample_with_stats
from .solvers.solution import Stats

__all__ = ['odeint', 'odeint_with_stats', 'odeint_adjoint',
           'odeint_event', 'odeint_dense',
           'DenseSolution', 'odeint_per_sample',
           'odeint_per_sample_with_stats', 'Stats', 'Perturb']
