"""torchdiffeq_tpu_torch: the PyTorch / CUDA port of torchdiffeq_tpu.

The JAX package `torchdiffeq_tpu` is the reference; this package mirrors
its module paths and calling conventions (``func(t, y, *args)``, the
``(T, B, D)``, ``(D, B)`` and ``(B, T, D)`` layouts) in PyTorch, and never
imports JAX.  The explicit tier is ported whole: the adaptive and
fixed-grid methods with every option they take (the PI/PID controllers,
callbacks, 16-bit states with ``error_dtype``), their events, dense
output, and both gradient routes (the continuous adjoint, and backprop
through the fixed-grid loop), with the CUDA kernels of their routes.
What is still to come is listed in ROADMAP.md and raises
`NotImplementedError` naming its ROADMAP item.
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
